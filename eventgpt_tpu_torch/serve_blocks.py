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
    decode segment land in storage nothing reads;
  * ``cow`` is the copy-on-write primitive: a writer that holds a shared
    block trades its reference for a private one, and ``note_cow`` counts
    a copy the serving admission makes through its own scatter. Both
    count ``cow_copies``;
  * the spill registry (``spill_out``/``restore``/``drop_spilled``): a
    preempted row's exclusively owned run leaves the arena (its bytes
    already gathered to the host ``SpillStore``) and comes back as fresh
    blocks. Every call validates before it mutates anything.

Threading: the owning ``ContinuousBatcher`` is serialized by its engine,
but HTTP handler threads read ``stats()``, so every mutation and compound
read holds ``_lock``.

Telemetry, at the JAX pool's sites: the ``egpt_serve_kv_blocks_used`` /
``_free`` gauges after every move of the free list, and the
``egpt_serve_kv_alloc_failures_total`` / ``egpt_serve_kv_cow_copies_total``
counters. The ``SpillStore`` prices its records into the memory ledger's
``spill`` component.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from eventgpt_tpu_torch.obs import memory as obs_memory
from eventgpt_tpu_torch.obs import metrics as obs_metrics

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
    ``block_bytes`` is carried for ``stats()`` and ``free_bytes()``."""

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
        self.cow_copies = 0
        # Spill registry: run id -> the block count of a run whose bytes
        # left the arena for the host store. Its blocks returned to the
        # free list at spill time; ``restore`` allocates that many again.
        self._spilled: Dict[int, int] = {}
        self._next_spill_id = 0
        self.spills = 0
        self.restores = 0

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

    def free_bytes(self) -> int:
        """Free capacity in bytes (``free_blocks * block_bytes``): the
        headroom a process fleet places handoffs by, which compares across
        workers of different geometry where block counts do not."""
        with self._lock:
            return len(self._free) * self.block_bytes

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
                obs_metrics.SERVE_KV_ALLOC_FAILURES.inc()
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
            self.allocs += n
            self._export_gauges_locked()
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
            self._export_gauges_locked()
        return freed

    def cow(self, block: int) -> Optional[int]:
        """Copy-on-write: trade one reference on a shared ``block`` for a
        private block. Returns the private block (the caller copies the
        bytes), ``block`` itself when it is already exclusively owned (no
        copy), or None when no block is free. Counts only real copies."""
        with self._lock:
            self._check_live_locked(block)
            if self._refs[block] == 1:
                return block
            if not self._free:
                self.alloc_failures += 1
                obs_metrics.SERVE_KV_ALLOC_FAILURES.inc()
                return None
            new = self._free.pop()
            self._refs[new] = 1
            self._refs[block] -= 1
            self.allocs += 1
            self.cow_copies += 1
            obs_metrics.SERVE_KV_COW_COPIES.inc()
            self._export_gauges_locked()
            return new

    def note_cow(self) -> None:
        """Count a copy-on-write copy made outside ``cow``: the serving
        admission re-creates a shared block's head in the row's first
        owned block through its own scatter (copy and write in one)."""
        with self._lock:
            self.cow_copies += 1
        obs_metrics.SERVE_KV_COW_COPIES.inc()

    def spill_out(self, blocks: Sequence[int]) -> int:
        """Evict an exclusively owned run from the arena: every block must
        be live at refcount 1 (an aliased block has another owner whose
        table would dangle: ``BlockPoolError``, nothing changed, and the
        caller drops and re-prefills instead). The blocks return to the
        free list (the caller gathered their bytes already); the returned
        run id names the registry entry ``restore`` checks. A second spill
        of the same blocks raises: the first one freed them."""
        blocks = list(blocks)
        with self._lock:
            for b in blocks:
                self._check_live_locked(b)
                if self._refs[b] != 1:
                    raise BlockPoolError(
                        f"block {b} has refcount {self._refs[b]}: spill-while-pinned refused "
                        f"(an aliased owner would dangle)")
            for b in blocks:
                self._refs[b] = 0
                self._free.append(b)
            run_id = self._next_spill_id
            self._next_spill_id += 1
            self._spilled[run_id] = len(blocks)
            self.frees += len(blocks)
            self.spills += 1
            self._export_gauges_locked()
        return run_id

    def restore(self, run_id: int, n: int) -> Optional[List[int]]:
        """Re-admit a spilled run: ``n`` fresh blocks at refcount 1 (the
        caller scatters the host bytes back), or None when fewer are free;
        the run then stays registered. An unknown, restored or dropped run
        raises."""
        with self._lock:
            if run_id not in self._spilled:
                raise BlockPoolError(f"spill run {run_id} is not registered (already "
                                     f"restored, dropped, or never spilled)")
            n = max(int(n), 0)
            if n > len(self._free):
                self.alloc_failures += 1
                obs_metrics.SERVE_KV_ALLOC_FAILURES.inc()
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
            del self._spilled[run_id]
            self.allocs += n
            self.restores += 1
            self._export_gauges_locked()
        return out

    def drop_spilled(self, run_id: int) -> None:
        """Forget a spilled run without restoring it (its request finished
        or left). An unknown run raises: two owners thought they held it."""
        with self._lock:
            if run_id not in self._spilled:
                raise BlockPoolError(f"spill run {run_id} is not registered (double drop, or "
                                     f"already restored)")
            del self._spilled[run_id]

    def spilled_runs(self) -> int:
        with self._lock:
            return len(self._spilled)

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

    def _export_gauges_locked(self) -> None:
        obs_metrics.SERVE_KV_BLOCKS_FREE.set(len(self._free))
        obs_metrics.SERVE_KV_BLOCKS_USED.set(self.usable - len(self._free))

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
                "cow_copies": self.cow_copies,
                "spills": self.spills,
                "restores": self.restores,
                "spilled_runs": len(self._spilled),
            }


class SpillStore:
    """Host-RAM store of spilled KV runs, one record per preempted request:
    its gathered K/V planes and the state its re-activation needs (length,
    logits row, speculative ids), as host tensors (pinned on a card). A
    byte budget (``--spill_capacity_mb``) bounds the resident bytes:
    ``put`` refuses a record over it (the caller drops and re-prefills)
    and never evicts, since a record is live request state, not a cache
    entry. The resident bytes are the memory ledger's ``spill`` component
    under ``{owner}/spill``, as in the JAX store: host bytes, which the
    ledger prices but ``reconcile`` does not find on the card (pinned host
    memory is not in ``torch.cuda.memory_allocated``). On a serving mesh a
    rank's record holds its KV heads of the run while ``put`` counts the
    whole row's bytes against the budget, so that every rank and the
    one-device store decide alike: the ledger then holds the rank's bytes
    (``held_bytes``).

    Threading: as ``BlockPool``: mutations and ``stats()`` hold ``_lock``;
    the ledger and metric locks are leaves below it.
    """

    def __init__(self, capacity_bytes: int, owner: str = "spill"):
        self.capacity_bytes = max(int(capacity_bytes), 0)
        self._mem_key = f"{owner}/spill"
        self._lock = threading.Lock()
        self._recs: Dict[Any, Dict[str, Any]] = {}
        self.used_bytes = 0
        self.held_bytes = 0
        self._held: Dict[Any, int] = {}
        self.puts = 0
        self.takes = 0
        self.drops = 0
        self.rejects = 0

    @property
    def enabled(self) -> bool:
        return self.capacity_bytes > 0

    def would_fit(self, nbytes: int) -> bool:
        with self._lock:
            return self.capacity_bytes - self.used_bytes >= int(nbytes)

    def put(self, rid, record: Dict[str, Any], nbytes: int, held: Optional[int] = None) -> bool:
        """Admit one record of ``nbytes`` against the budget, or refuse
        (False) when the budget cannot cover it. ``held`` is what this
        process holds of it (default ``nbytes``). A second record for one
        request raises."""
        nbytes = int(nbytes)
        held = nbytes if held is None else int(held)
        with self._lock:
            if rid in self._recs:
                raise BlockPoolError(f"request {rid} already holds a spill record "
                                     f"(double spill?)")
            if nbytes > self.capacity_bytes - self.used_bytes:
                self.rejects += 1
                return False
            record = dict(record)
            record["nbytes"] = nbytes
            self._recs[rid] = record
            self._held[rid] = held
            self.used_bytes += nbytes
            self.held_bytes += held
            self.puts += 1
            obs_memory.LEDGER.resize("spill", self._mem_key, self.held_bytes)
            obs_metrics.SERVE_SPILL_STORE_BYTES.set(self.used_bytes)
            obs_metrics.SERVE_SPILL_BYTES.inc(nbytes)
        return True

    def peek(self, rid) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._recs.get(rid)

    def take(self, rid) -> Dict[str, Any]:
        """Remove and return a record (its restore succeeded). An unknown
        request raises: a double restore, or one never spilled."""
        with self._lock:
            rec = self._recs.pop(rid, None)
            if rec is None:
                raise BlockPoolError(f"request {rid} holds no spill record (double restore, "
                                     f"or never spilled)")
            self.used_bytes -= int(rec["nbytes"])
            self.held_bytes -= self._held.pop(rid)
            self.takes += 1
            obs_memory.LEDGER.resize("spill", self._mem_key, self.held_bytes)
            obs_metrics.SERVE_SPILL_STORE_BYTES.set(self.used_bytes)
        return rec

    def drop(self, rid) -> None:
        """Discard a record without restoring it. An unknown request is a
        no-op: terminal sweeps may repeat."""
        with self._lock:
            rec = self._recs.pop(rid, None)
            if rec is None:
                return
            self.used_bytes -= int(rec["nbytes"])
            self.held_bytes -= self._held.pop(rid)
            self.drops += 1
            obs_memory.LEDGER.resize("spill", self._mem_key, self.held_bytes)
            obs_metrics.SERVE_SPILL_STORE_BYTES.set(self.used_bytes)

    def clear(self) -> None:
        with self._lock:
            self._recs.clear()
            self._held.clear()
            self.used_bytes = self.held_bytes = 0
            obs_memory.LEDGER.release("spill", self._mem_key)
            obs_metrics.SERVE_SPILL_STORE_BYTES.set(0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity_bytes": self.capacity_bytes,
                "used_bytes": self.used_bytes,
                "records": len(self._recs),
                "puts": self.puts,
                "takes": self.takes,
                "drops": self.drops,
                "rejects": self.rejects,
            }
