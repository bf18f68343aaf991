"""Host-side KV block-pool allocator for the paged serving layout.

The port's own copy of ``eventgpt_tpu/serve_blocks.BlockPool``, with the
same free-list order, so that the same sequence of calls hands out the
same block ids as the JAX pool. The paged cache (``models/llama.
init_paged_kv_cache``) is one arena of ``n_blocks`` blocks of
``block_size`` positions plus a per-row block table; which pool block
backs which row position is decided here, on the host.

  * ``alloc(n)`` hands out ``n`` blocks at refcount 1, or None when the
    pool cannot cover them all (never a partial grant: the admission gate
    admits a request only when its whole reservation fits);
  * ``incref``/``decref`` count owners; a block returns to the free list
    when its last owner drops it;
  * block 0 is the reserved SCRATCH block: free and finished rows' tables
    point at it, so the unconditional writes of frozen rows during a
    decode segment land in storage nothing reads.

Copy-on-write, spill/restore and the spill store belong to prefix sharing
and preemption, which the port does not have yet.

Threading: the owning ``ContinuousBatcher`` is serialized by its engine,
but HTTP handler threads read ``stats()``, so every mutation and compound
read holds ``_lock``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

# Free and finished rows' block tables point here.
SCRATCH_BLOCK = 0


class BlockPoolError(RuntimeError):
    """An allocator invariant was violated (double free, unknown block,
    the scratch block): a bug, never an overload signal (overload is
    ``alloc`` returning None)."""


class BlockPool:
    """Refcounted free-list allocator over ``n_blocks`` blocks of
    ``block_size`` positions. ``n_blocks`` counts the scratch block, so
    ``usable`` (= n_blocks - 1) is what admission can hand out.
    ``block_bytes`` is carried for ``stats()`` only."""

    def __init__(self, n_blocks: int, block_size: int, block_bytes: int = 0):
        if n_blocks < 2:
            raise ValueError(
                f"block pool needs >= 2 blocks (1 scratch + 1 usable), got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.block_bytes = int(block_bytes)
        self._lock = threading.Lock()
        # Scratch is pinned at refcount 1: never handed out, never freed.
        self._refs: List[int] = [0] * self.n_blocks
        self._refs[SCRATCH_BLOCK] = 1
        # LIFO free list, the JAX pool's order: the last freed block is
        # the next one handed out.
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self.allocs = 0
        self.frees = 0
        self.alloc_failures = 0

    @property
    def usable(self) -> int:
        """Blocks the allocator can ever hand out (scratch excluded)."""
        return self.n_blocks - 1

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def used_blocks(self) -> int:
        with self._lock:
            return self.usable - len(self._free)

    def blocks_for(self, positions: int) -> int:
        """Blocks covering ``positions`` KV slots (ceil at the block grain)."""
        return (max(int(positions), 0) + self.block_size - 1) // self.block_size

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks at refcount 1, or None when fewer are free."""
        if n <= 0:
            return []
        with self._lock:
            if n > len(self._free):
                self.alloc_failures += 1
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
            self.allocs += n
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        """Add one owner to each block."""
        with self._lock:
            for b in blocks:
                self._check_live_locked(b)
                self._refs[b] += 1

    def decref(self, blocks: Sequence[int]) -> int:
        """Drop one owner from each block; blocks reaching refcount 0
        return to the free list. Returns how many were freed."""
        freed = 0
        with self._lock:
            for b in blocks:
                self._check_live_locked(b)
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    self._free.append(b)
                    freed += 1
            self.frees += freed
        return freed

    def ref(self, block: int) -> int:
        with self._lock:
            return self._refs[block]

    def _check_live_locked(self, b: int) -> None:
        if b == SCRATCH_BLOCK:
            raise BlockPoolError("scratch block is not refcounted")
        if not 0 < b < self.n_blocks:
            raise BlockPoolError(f"block {b} out of range")
        if self._refs[b] <= 0:
            raise BlockPoolError(f"block {b} is free (double free?)")

    def stats(self) -> Dict[str, Any]:
        """Snapshot for ``GET /stats`` and the smoke run's record."""
        with self._lock:
            free = len(self._free)
            return {
                "n_blocks": self.n_blocks,
                "block_size": self.block_size,
                "block_bytes": self.block_bytes,
                "usable_blocks": self.usable,
                "free_blocks": free,
                "used_blocks": self.usable - free,
                "allocs": self.allocs,
                "frees": self.frees,
                "alloc_failures": self.alloc_failures,
            }
