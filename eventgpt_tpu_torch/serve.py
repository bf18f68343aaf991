"""Continuous-batching serving loop (row-level request scheduling).

Port of ``eventgpt_tpu/serve.py``'s ``ContinuousBatcher``: one resident KV
cache of ``max_batch`` rows whose ROWS are the resource -- requests join
the running batch as rows free up, instead of waiting for the whole batch
to drain.

  * The cache is dense ((L, max_batch, max_len, KV, hd) per plane) or
    paged (one arena of SEQ_BUCKET-slot blocks plus per-row block tables,
    ``kv_layout="paged"``, allocated by ``serve_blocks.BlockPool``), in
    the compute dtype or int8 with per-vector scales (``kv_quant``).
  * Admission prefills the requests that are ready at one step as ONE
    padded batch (``_admit_wave``; a single request takes the batch-1
    path) into a dense row cache, then writes it into the shared cache
    at the free rows (dense) or scatters it into the rows' pool blocks
    and installs their tables (paged).
  * Decode runs in segments of up to ``chunk`` steps over every row
    (``_decode_segment``). The segment computes the next segment's
    control state (frozen mask, budgets) on the device, and it stops on a
    per-step "any row live" flag that the host reads one launched step
    late, so the host never waits on the step it has just launched.
  * PIPELINED scheduling (``pipeline=True``, the default): segment N+1 is
    dispatched from that device-resident carry before segment N is
    fetched, so the host's harvest and admission work runs while the card
    computes. Anything that changes rows (a deadline, a cancel, an
    admission into a freed row, a chunked prefill, a finishing lane)
    drains the pipeline first.
  * The TTFT ramp (``first_chunk``): while a fresh row owes its first
    token, segments are ``first_chunk`` steps long and harvested at once.
  * Chunked prefill (``prefill_chunk``): with rows decoding, a full
    admission advances one chunk per step through ``llama.decode_kstep``.
  * The PREFIX-KV cache (``PrefixCache``): a token-id trie of prompt-head
    KV blocks, filled on admission prefill and by ``set_prefix``, matched
    longest-prefix at admission (then only the suffix is prefilled),
    pinned while rows decode from it, LRU-evicted under a byte budget.
    Dense entries are copies; paged entries alias the row's block run with
    a refcount, and a consumer re-creates the shared tail block in its own
    first block (copy-on-write).
  * Piggyback LANES (``prefill_budget > 0``): with rows decoding, an
    admission becomes a lane whose prompt advances ``chunk_p`` positions
    inside every decode dispatch (``_mixed_decode_segment``), so the rows
    keep committing tokens while it prefills. The lane cache is never
    quantized; an int8 server quantizes the finished lane once.
  * SPECULATIVE serving (``speculative=K``): each segment runs up to
    ``chunk // K`` draft-and-verify iterations (``_spec_segment`` over
    ``eventchat._spec_draft_verify``): drafts by suffix lookup over the
    row's committed ids (``ids_buf``) and a server-wide ``history`` of
    served text, or from Medusa heads (``draft_head``) carried in
    ``spec_drafts``; commits capped at each row's budget. The first token
    is committed at admission, so the TTFT ramp is dropped. With
    ``spec_buckets`` the window is chosen at each dispatch boundary by
    ``serve_spec.SpecController`` from measured acceptance, with a
    per-row depth mask. A verify window writes ``window`` slots past the
    last commit, so every reservation carries ``1 + spec_max`` slots of
    slack.
  * Frozen and free rows keep flowing through every decode step, as in
    the JAX package; their writes land at slot ``length`` (in the scratch
    block for a free paged row, inside the reservation's slack for an
    exhausted one), are masked out of every read, and their ``length`` is
    rolled back, so a row resumes exactly where it stopped.
  * ``warmup()`` runs every function a request can reach once on the idle
    server (kernel builds, cuBLAS handles, the allocator's first growth).
  * SLO classes (``submit(slo=)``, ``workload.SLO``): every terminal path
    scores the request against its class targets (``slo_stats()``);
    scheduling reads the class only for preemption.
  * Block-tier PREEMPTION (``preempt``, paged): an ``interactive`` queue
    head that the free list cannot cover evicts ``batch`` rows, worst
    deadline headroom first. Each victim's exclusively owned block run is
    gathered to host RAM (``serve_blocks.SpillStore``, budget
    ``spill_capacity_mb``) and restored byte-exact through the paged
    admission scatter, or released for re-prefill, whichever the JAX
    package's closed-form price favours; the victim re-queues at the back.
  * Prefill/decode ROLES (``role``, paged): a ``prefill`` batcher admits
    only and moves each activated row into an outbox of gathered block-run
    records (``pop_handoffs``); a ``decode`` batcher splices such a record
    into its own arena (``import_handoff``) instead of prefilling. The
    record is an in-process dict of host tensors.
  * ``export_requests()`` strips every unfinished request out of the
    scheduler (the drain seam of fleets) and returns its re-admission
    record.

The functions on the module update the resident cache in place under
``torch.inference_mode``: that takes the place of the JAX package's
``jit`` with donated buffers.

Telemetry (``eventgpt_tpu_torch/obs``), at the JAX batcher's sites: the
``egpt_serve_*`` metrics, the request lifecycle as async trace events and
flight-recorder journeys, the memory ledger's components, and the memory
headroom guard (``mem_headroom_bytes``: an admission boundary whose wave
the ledger predicts past capacity - headroom defers, which changes timing,
never a chain). It reads host values the scheduler already holds: no
device read is added to the dispatch path, and chains are byte-identical
with telemetry armed or disarmed.

On a serving mesh (``mesh=``, ``parallel/mesh.Mesh``) every rank runs this
scheduler over the same rows with the same host decisions and generator
seed, on its shard of the tree (``parallel/serving.shard_params_for_serving``)
and its KV heads: the rows replicate over the batch axes, as the JAX paged
arena does, where the JAX dense batcher splits them over (data, fsdp).
The host decisions agree because every rank computes bitwise-equal
logits (the collectives give each rank the same bits). A decision that
reads its process's own state is taken once and shared over the mesh's
``control`` group, and only while its feature is armed: the deadline clock
is rank 0's (``_now``, agreed once a step while a deadline is queued or
live; a submit's stamp is rank 0's), the spill-or-drop price is rank 0's,
the headroom guard defers when any rank's ledger passes its budget, and a
fault drawn at ``serve.preempt``, ``serve.spill`` or ``serve.mem_guard`` on
any rank is taken by every rank. Each rank spills and restores its own KV
heads of a victim's run (the scheduler is replicated, so the block ids
agree), and the store counts the whole row's bytes. A handoff record
leaves the mesh whole: the prefill side gathers the KV heads over
``model``, and ``import_handoff`` slices the rank's heads back out, so a
record crosses between a mesh and one device either way. Greedy chains at f32
equal the JAX ``ContinuousBatcher``'s and the port's one-shot ``generate``
with every scheduler feature on or off (``tests/test_torch_serve*.py``,
``tests/test_torch_prefix_cache.py``, ``tests/test_torch_mixed_segments.py``,
``tests/test_torch_spec_adaptive.py``, ``tests/test_torch_preempt_spill.py``,
``tests/test_torch_handoff.py``).
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from eventgpt_tpu_torch import faults, serve_spec
from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX, SEQ_BUCKET
from eventgpt_tpu_torch.data.tokenizer import split_at_event
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import eventchat
from eventgpt_tpu_torch.models import llama as llama_mod
from eventgpt_tpu_torch.models import medusa as medusa_mod
from eventgpt_tpu_torch.obs import journey as obs_journey
from eventgpt_tpu_torch.obs import memory as obs_memory
from eventgpt_tpu_torch.obs import metrics as obs_metrics
from eventgpt_tpu_torch.obs import profiling as obs_profiling
from eventgpt_tpu_torch.obs import series as obs_series
from eventgpt_tpu_torch.obs import trace as obs_trace
from eventgpt_tpu_torch.ops.sampling import sample
from eventgpt_tpu_torch.parallel import serving as serving_mod
from eventgpt_tpu_torch.serve_blocks import SCRATCH_BLOCK, BlockPool, BlockPoolError, SpillStore
from eventgpt_tpu_torch.workload import SLO, SLO_CLASSES


class QueueFullError(RuntimeError):
    """submit() refused: the admission queue is at ``max_queue``. The HTTP
    layer maps this to 429 + Retry-After (backpressure, not failure)."""


# Terminal request statuses (``ContinuousBatcher.finish_status``). "ok"
# covers both EOS and budget exhaustion; the others are forced finishes
# whose row was freed without spending the rest of the budget.
# "resource_exhausted": an interactive head found neither blocks nor
# victims, and the spill store cannot take one more block (HTTP 503).
STATUS_OK = "ok"
STATUS_DEADLINE = "deadline_exceeded"
STATUS_CANCELLED = "cancelled"
STATUS_NAN = "nan_quarantined"
STATUS_RESOURCE = "resource_exhausted"

# Forced-finish statuses -> the flight-recorder event that marks them.
_JOURNEY_FORCED_KIND = {
    STATUS_DEADLINE: "deadline",
    STATUS_CANCELLED: "cancel",
    STATUS_NAN: "nan_quarantine",
}

_GRAIN = 2 * SEQ_BUCKET  # prompt buckets and max_len round to this


def _bucket(n: int, cap: int) -> int:
    return min((n + _GRAIN - 1) // _GRAIN * _GRAIN, cap)


def _h2d(arr, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a stream synchronize: on the card
    through a pinned staging copy and an asynchronous transfer (a plain
    pageable copy would wait for every queued kernel, emptying the
    pipeline)."""
    t = torch.tensor(np.asarray(arr))  # a copy: the host may change ``arr`` next
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _fetch_async(tensors: List[torch.Tensor]):
    """Start copying device tensors to the host: (host tensors, event), the
    event recorded after the copies (None on the CPU, where the tensors are
    returned as they are). The harvest waits on the event."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list tree (a parameter tree, or a
    record whose planes may be {"q", "s"} dicts), in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_host(tree):
    """Copy a record of device tensors to host memory: (host record,
    seconds of the allocation, seconds of the copy). On the card the host
    buffers are pinned and the copy is timed alone, once the tensors are
    computed and the buffers allocated. On the CPU the tensors are fresh
    copies already (a gather) and come back as they are."""
    src = _leaves(tree)
    if src[0].device.type != "cuda":
        return tree, 0.0, 0.0
    torch.cuda.synchronize(src[0].device)
    t0 = time.perf_counter()
    host = _map_tree(tree, lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
    t1 = time.perf_counter()
    for h, t in zip(_leaves(host), src):
        h.copy_(t, non_blocking=True)
    torch.cuda.synchronize(src[0].device)
    return host, t1 - t0, time.perf_counter() - t1


def _on_device(x, device: torch.device) -> torch.Tensor:
    """A record plane (a host tensor, or a numpy array from a record the
    JAX package gathered) on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device, non_blocking=True)


def _pixels_key(pixel_values) -> bytes:
    """Content key of an event-pixel array (shape + sha1 of the f32 bytes):
    the event-block prefix entry's identity check, since token ids alone
    cannot tell two streams apart. Hashes the host array that ``submit``
    received; a device tensor is refused, never fetched."""
    if isinstance(pixel_values, torch.Tensor) and pixel_values.device.type != "cpu":
        raise TypeError("prefix keys hash host pixels: submit host arrays, not device tensors")
    arr = np.ascontiguousarray(np.asarray(pixel_values, np.float32))
    return str(arr.shape).encode() + hashlib.sha1(arr.tobytes()).digest()


@dataclass
class _PrefixEntry:
    """One cached prompt-head KV block. ``ids`` is the token path (with the
    event sentinel for a through-event entry); ``pixels_key`` pins an event
    entry to its stream. ``kv`` holds the (L, 1, bucket, KV, hd) K/V
    copies of a dense entry; a paged entry is a refcounted run of pool
    ``blocks`` instead (``kv`` None)."""
    ids: tuple
    pixels_key: Optional[bytes]
    has_event: bool
    kv: Optional[Dict[str, Any]]
    length: int          # real cache positions the entry covers
    bucket: int          # stored block length (the prompt grain)
    nbytes: int
    pins: int = 0        # admissions, lanes and rows reading the entry
    tick: int = 0        # LRU clock at the last insert or hit
    hits: int = 0
    blocks: Optional[List[int]] = None
    # Evicted or replaced while pinned: a paged entry's blocks are
    # released at its last pin drain (``ContinuousBatcher._drain_entry_pin``).
    detached: bool = False


class PrefixCache:
    """Token-id trie of prompt-head KV blocks with LRU eviction: the port of
    the JAX ``PrefixCache``, with its rules.

      * longest-prefix match wins (``lookup``); an event entry never serves
        a request whose own pixels are another stream;
      * ``budget`` bytes (0 = unbounded): an insert evicts the least
        recently used UNPINNED entries until the total fits;
      * a pinned entry is never evicted; a replaced or evicted paged entry
        that is pinned keeps its blocks until its last pin drains.

    Host-side dict operations under ``_lock`` (the scheduler inserts and
    looks up; HTTP handler threads read ``stats()``). ``pool`` is set by a
    paged server: dropping an entry then decrefs its block run. The entry
    bytes are one ``prefix_cache`` entry of the memory ledger under
    ``_mem_key``, resized inside the same critical section as ``bytes``
    (lock order: ``_lock`` -> the ledger's -> the metrics').
    """

    def __init__(self, budget_bytes: int = 0):
        self.budget = int(budget_bytes)
        self.pool: Optional[BlockPool] = None
        self._root: Dict[str, Any] = {"c": {}, "e": {}}
        self._lock = threading.Lock()
        self.bytes = 0
        self.n_entries = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.insertions = 0
        self._tick = 0
        self._mem_key = f"pc{id(self):x}/entries"

    def _iter_nodes_locked(self):
        stack = [self._root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node["c"].values())

    def entries(self) -> List[_PrefixEntry]:
        with self._lock:
            return [e for node in self._iter_nodes_locked() for e in node["e"].values()]

    def get(self, ids, pixels_key) -> Optional[_PrefixEntry]:
        """The entry at exactly this key, or None (insert-on-prefill's dedupe)."""
        with self._lock:
            node = self._root
            for tok in ids:
                node = node["c"].get(tok)
                if node is None:
                    return None
            return node["e"].get(pixels_key)

    def lookup(self, ids, pixels_key) -> Optional[_PrefixEntry]:
        """Longest-prefix match: the deepest entry whose token path is a
        PROPER prefix of ``ids`` and whose stream fits the request -- a
        text entry needs the event sentinel in the remaining suffix, an
        event entry needs it consumed and the request's own pixels to be
        its stream (``pixels_key`` None = session traffic, which inherits
        the entry's stream). Among entries at one node the most recently
        used wins. Hits and misses are counted by the caller."""
        ids = list(ids)
        sent = ids.index(EVENT_TOKEN_INDEX) if EVENT_TOKEN_INDEX in ids else -1
        best = None
        with self._lock:
            node = self._root
            for d, tok in enumerate(ids):
                node = node["c"].get(tok)
                if node is None:
                    break
                if d + 1 >= len(ids):
                    break  # the entry must be a PROPER prefix
                cand = None
                for e in node["e"].values():
                    if e.has_event:
                        if sent < 0 or sent > d:
                            continue  # the sentinel must be inside the entry
                        if pixels_key is not None and e.pixels_key != pixels_key:
                            continue  # another stream: never serve this KV
                    elif sent <= d:
                        continue  # a text entry: the sentinel must be in the suffix
                    if cand is None or e.tick > cand.tick:
                        cand = e
                if cand is not None:
                    best = cand  # deeper nodes come later: the longest wins
        return best

    def count_hit(self, entry: _PrefixEntry) -> None:
        with self._lock:
            self._tick += 1
            entry.tick = self._tick
            entry.hits += 1
            self.hits += 1
        obs_metrics.SERVE_PREFIX_HITS.inc()

    def count_miss(self) -> None:
        with self._lock:
            self.misses += 1
        obs_metrics.SERVE_PREFIX_MISSES.inc()

    def insert(self, entry: _PrefixEntry) -> bool:
        """Insert (or replace) the entry at its ``(ids, pixels_key)`` key,
        then evict LRU unpinned entries until the budget holds. False =
        refused (the entry alone exceeds the budget)."""
        if self.budget and entry.nbytes > self.budget:
            return False
        with self._lock:
            node = self._root
            for tok in entry.ids:
                node = node["c"].setdefault(tok, {"c": {}, "e": {}})
            old = node["e"].pop(entry.pixels_key, None)
            if old is not None:
                self.bytes -= old.nbytes
                self.n_entries -= 1
                self._release_blocks_locked(old)
            self._tick += 1
            entry.tick = self._tick
            node["e"][entry.pixels_key] = entry
            self.bytes += entry.nbytes
            self.n_entries += 1
            self.insertions += 1
            self._evict_locked()
            self._export_gauges_locked()
            obs_memory.LEDGER.resize("prefix_cache", self._mem_key, self.bytes)
        obs_metrics.SERVE_PREFIX_INSERTIONS.inc()
        return True

    def _evict_locked(self) -> None:
        if not self.budget:
            return
        while self.bytes > self.budget:
            victim_node, victim_key, victim = None, None, None
            for node in self._iter_nodes_locked():
                for key, e in node["e"].items():
                    if e.pins > 0:
                        continue
                    if victim is None or e.tick < victim.tick:
                        victim_node, victim_key, victim = node, key, e
            if victim is None:
                return  # all pinned: over budget until the pins drain
            del victim_node["e"][victim_key]
            self.bytes -= victim.nbytes
            self.n_entries -= 1
            self.evictions += 1
            self._release_blocks_locked(victim)
            obs_metrics.SERVE_PREFIX_EVICTIONS.inc()

    def _release_blocks_locked(self, entry: _PrefixEntry) -> None:
        """Drop a detached paged entry's block references (its share only);
        a pinned entry defers that to its last pin drain."""
        if entry.blocks and self.pool is not None:
            if entry.pins > 0:
                entry.detached = True
                return
            self.pool.decref(entry.blocks)
            entry.blocks = None

    def reclaim_blocks(self, pool: BlockPool, need: int) -> int:
        """Evict LRU unpinned paged entries until ``pool`` has ``need`` free
        blocks or nothing evictable is left (the paged admission gate's
        reclaim). Returns the number of entries evicted."""
        evicted = 0
        with self._lock:
            while pool.free_blocks() < need:
                victim_node, victim_key, victim = None, None, None
                for node in self._iter_nodes_locked():
                    for key, e in node["e"].items():
                        if e.pins > 0 or not e.blocks:
                            continue
                        if victim is None or e.tick < victim.tick:
                            victim_node, victim_key, victim = node, key, e
                if victim is None:
                    break
                del victim_node["e"][victim_key]
                self.bytes -= victim.nbytes
                self.n_entries -= 1
                self.evictions += 1
                evicted += 1
                self._release_blocks_locked(victim)
                obs_metrics.SERVE_PREFIX_EVICTIONS.inc()
            if evicted:
                self._export_gauges_locked()
                obs_memory.LEDGER.resize("prefix_cache", self._mem_key, self.bytes)
        return evicted

    def evict_covering(self, blocks) -> int:
        """Evict every unpinned entry whose block run meets ``blocks``: the
        spill path's sweep. An insert-on-prefill entry aliases its creator
        row's run at refcount 2, and the pool refuses to spill a block
        another owner could read, so preempting that row first evicts the
        idle entries riding its blocks. Pinned entries stay (a lane or a
        selected admission still reads them; the caller then drops the
        victim instead). Returns the number of entries evicted."""
        want = set(blocks)
        if not want:
            return 0
        evicted = 0
        with self._lock:
            for node in self._iter_nodes_locked():
                for key in [k for k, e in node["e"].items()
                            if e.pins <= 0 and e.blocks and not want.isdisjoint(e.blocks)]:
                    victim = node["e"].pop(key)
                    self.bytes -= victim.nbytes
                    self.n_entries -= 1
                    self.evictions += 1
                    evicted += 1
                    self._release_blocks_locked(victim)
                    obs_metrics.SERVE_PREFIX_EVICTIONS.inc()
            if evicted:
                self._export_gauges_locked()
                obs_memory.LEDGER.resize("prefix_cache", self._mem_key, self.bytes)
        return evicted

    def _export_gauges_locked(self) -> None:
        obs_metrics.SERVE_PREFIX_BYTES.set(self.bytes)
        obs_metrics.SERVE_PREFIX_ENTRIES.set(self.n_entries)

    def __del__(self):
        # A dropped cache leaves no stale bytes in the ledger (best effort:
        # interpreter teardown may have torn the ledger down first).
        try:
            obs_memory.LEDGER.release("prefix_cache", self._mem_key)
        except Exception:
            pass

    def clear(self) -> None:
        """Drop every entry (paged blocks under the deferred-on-pins rule);
        the counters keep counting."""
        with self._lock:
            for node in self._iter_nodes_locked():
                for e in node["e"].values():
                    self._release_blocks_locked(e)
            self._root = {"c": {}, "e": {}}
            self.bytes = 0
            self.n_entries = 0
            self._export_gauges_locked()
            obs_memory.LEDGER.resize("prefix_cache", self._mem_key, 0)

    def stats(self) -> Dict[str, Any]:
        """Snapshot for ``GET /prefix_cache``."""
        with self._lock:
            entries = [{"ids_len": len(e.ids), "has_event": e.has_event, "length": e.length,
                        "bucket": e.bucket, "nbytes": e.nbytes, "pins": e.pins, "hits": e.hits,
                        "blocks": len(e.blocks) if e.blocks else 0}
                       for node in self._iter_nodes_locked() for e in node["e"].values()]
            held = {b for node in self._iter_nodes_locked() for e in node["e"].values()
                    for b in (e.blocks or ())}
            return {
                "entries": sorted(entries, key=lambda d: -d["hits"]),
                "n_entries": self.n_entries, "bytes": self.bytes, "budget_bytes": self.budget,
                "blocks_held": len(held),
                "hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "insertions": self.insertions,
                "hit_ratio": (self.hits / (self.hits + self.misses)
                              if (self.hits + self.misses) else 0.0),
            }


class _LiveFlags:
    """Per-step "any row live" flags of a decode segment, which the segment
    writes and the host reads one launched step late. On the card each
    flag is an asynchronous copy into pinned memory followed by an event;
    on the CPU it is the 0-dim result itself. One set per batcher, reused
    by every segment: a segment's copies queue behind the previous
    segment's on the one stream."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.host = torch.zeros((n,), dtype=torch.bool, pin_memory=True)
            self.events = [torch.cuda.Event() for _ in range(n)]
        else:
            self.host = [None] * n


def _flag_record(flags: _LiveFlags, i: int, any_live: torch.Tensor) -> None:
    if flags.cuda:
        flags.host[i].copy_(any_live, non_blocking=True)
        flags.events[i].record()
    else:
        flags.host[i] = any_live


def _flag_read(flags: _LiveFlags, i: int) -> bool:
    """Flag ``i``, waiting for the event recorded with it."""
    if flags.cuda:
        flags.events[i].synchronize()
    return bool(flags.host[i])


def _frozen_reader(flags: _LiveFlags, run: bool, steps: int, n: int):
    """A segment's ``all_frozen``, for one that ran ``steps`` of at most
    ``n``: a function telling whether the host knows the segment's
    ``frozen_out`` is all True. A segment that ran none, or stopped on its
    flag, knows it. One that ran all ``n`` knows it when no row was live
    entering its last step, a flag read only when asked: the next dispatch
    asks before any segment records flags again, so the segment's own end
    waits on nothing."""
    if not run or steps < n:
        return lambda: True
    return lambda: not _flag_read(flags, n - 1)


@torch.inference_mode()
def _decode_segment(params, cfg: EventChatConfig, logits, cache, generator, frozen, n_rem,
                    chunk: int, eos_token_id: int, temperature: float = 0.0,
                    top_p: float = 1.0, flags: Optional[_LiveFlags] = None,
                    after_first_step=None, run: bool = True, mesh=None):
    """Up to ``chunk`` decode steps over the shared batch, the cache
    updated in place (on a serving ``mesh``, this rank's share).

    ``frozen`` (B,) bool marks free rows and rows already finished;
    ``n_rem`` (B,) int32 is each row's remaining budget. Returns (tokens
    (B, chunk), n_new (B,), done (B,), finite (B,), logits, frozen_out,
    n_rem_out, lived, steps, all_frozen): ``tokens[r, :n_new[r]]`` are
    row r's newly committed tokens, ``done`` marks rows that hit EOS inside this
    segment, ``finite`` whether each row's final logits are all finite;
    ``frozen_out``/``n_rem_out`` are the next segment's control state,
    computed on the device with the host harvest's bookkeeping (freeze on
    EOS, an exhausted budget or non-finite logits); ``lived`` counts on
    the device the steps that had a live row (the JAX loop's count),
    ``steps`` is the host count of steps run, and ``all_frozen`` the
    ``_frozen_reader`` that tells whether the host knows ``frozen_out`` is
    all True.

    The stop rule: before step t >= 1 the host reads whether any row was
    live entering step t - 1, a flag written before step t - 1 was
    launched, and stops when none was. So it never waits on the step it
    has just launched; at most one step past the last live one runs, and
    it commits nothing. Synchronous and pipelined schedulers run the same
    rule, so they run the same steps and draw the same samples.

    ``run=False`` is the segment whose carry the host knows is all frozen:
    it runs no step, as the JAX loop runs none, and makes the draw of the
    step it skips (the stop rule's first step), so that a scheduler that
    still launches that step draws the same.

    ``after_first_step`` is called once the first step is launched (at the
    end when none runs): the pipelined scheduler harvests the previous
    segment there, while the card runs this one (the host launches every
    step itself, so waiting for the whole launch would hold the previous
    segment's tokens back by a segment of host time).
    """
    b = logits.shape[0]
    dev = logits.device
    if flags is None:
        flags = _LiveFlags(chunk, dev)
    tokens = torch.full((b, chunk), eos_token_id, dtype=torch.int32, device=dev)
    n_new = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    lived = torch.zeros((), dtype=torch.int32, device=dev)
    eos = torch.full((), eos_token_id, dtype=torch.int32, device=dev)
    live = ~frozen & (n_rem > 0)
    any_live = live.any()
    _flag_record(flags, 0, any_live)
    steps = 0
    if not run:
        sample(logits, generator, temperature, top_p)
    for t in range(chunk if run else 0):
        if t and not _flag_read(flags, t - 1):
            break
        nxt = sample(logits, generator, temperature, top_p)
        commit = live
        lived += any_live
        nxt = torch.where(commit, nxt, eos)
        tokens[:, t] = torch.where(commit, nxt, tokens[:, t])
        n_new = n_new + commit.to(torch.int32)
        done = done | (commit & (nxt == eos))
        # Every row advances; frozen rows keep their logits and length.
        emb = llama_mod.embed_tokens(params["llama"], nxt[:, None].long(), mesh)
        new_logits, cache = llama_mod.decode_step(params["llama"], cfg.llama, emb, cache, mesh)
        logits = torch.where(commit[:, None], new_logits, logits)
        cache["length"].copy_(torch.where(commit, cache["length"], cache["length"] - 1))
        steps += 1
        live = ~(frozen | done) & (n_new < n_rem)
        if t + 1 < chunk:
            any_live = live.any()
            _flag_record(flags, t + 1, any_live)
        if t == 0 and after_first_step is not None:
            after_first_step()
    if not steps and after_first_step is not None:
        after_first_step()
    all_frozen = _frozen_reader(flags, run, steps, chunk)
    finite = torch.isfinite(logits).all(dim=-1)
    n_rem_out = n_rem - n_new
    frozen_out = frozen | done | (n_rem_out <= 0) | ~finite
    n_rem_out = torch.where(frozen_out, torch.zeros_like(n_rem_out), n_rem_out)
    return tokens, n_new, done, finite, logits, frozen_out, n_rem_out, lived, steps, all_frozen


@torch.inference_mode()
def _lane_advance(params, cfg: EventChatConfig, lane_embeds, lane_cache, start, new_len,
                  last_idx, chunk_p: int, mesh=None):
    """One piggybacked prefill advance over the K resident lanes: each lane
    row takes its own ``chunk_p``-wide window of prompt embeddings at
    ``start`` and runs it through ``decode_kstep`` against its own lane
    cache row; the length is then pinned to ``new_len`` (positions past
    the prompt write garbage above it, masked from every read). Idle and
    ready slots pass ``start == new_len`` and advance nothing real. The
    lane cache holds ``chunk_p`` slots past the lane bucket, so no window
    writes out of bounds. Returns (last_logits (K, V), last_hidden (K, D))
    at each lane's last real window position."""
    k, s, d = lane_embeds.shape
    idx = (start[:, None].long() + torch.arange(chunk_p, device=start.device)[None, :])
    idx = idx.clamp(0, s - 1)
    emb = torch.gather(lane_embeds, 1, idx[:, :, None].expand(k, chunk_p, d))
    lane_cache["length"].copy_(start)
    logits, hidden, _ = llama_mod.decode_kstep(params["llama"], cfg.llama, emb, lane_cache,
                                               return_hidden=True, mesh=mesh)
    rows = torch.arange(k, device=start.device)
    lane_cache["length"].copy_(new_len)
    return logits[rows, last_idx.long()], hidden[rows, last_idx.long()]


@torch.inference_mode()
def _mixed_decode_segment(params, cfg: EventChatConfig, logits, cache, generator, frozen, n_rem,
                          lane_embeds, lane_cache, lane_start, lane_new_len, lane_last_idx,
                          chunk: int, chunk_p: int, eos_token_id: int, temperature: float = 0.0,
                          top_p: float = 1.0, flags: Optional[_LiveFlags] = None,
                          after_first_step=None, run: bool = True, mesh=None):
    """The mixed segment: ``_decode_segment`` plus the piggybacked prefill
    lanes in one dispatch. The halves touch disjoint state (shared cache
    rows against lane cache rows), so the decode rows commit tokens in the
    same dispatch that advances the admissions. With ``run=False`` (every
    row frozen) the lanes advance alone, and the previous segment is
    harvested once they are launched. Returns the decode outputs followed
    by ``_lane_advance``'s."""
    dec = _decode_segment(params, cfg, logits, cache, generator, frozen, n_rem, chunk,
                          eos_token_id, temperature, top_p, flags,
                          after_first_step if run else None, run, mesh)
    lane = _lane_advance(params, cfg, lane_embeds, lane_cache, lane_start, lane_new_len,
                         lane_last_idx, chunk_p, mesh)
    if not run and after_first_step is not None:
        after_first_step()
    return dec + lane


@torch.inference_mode()
def _spec_segment(params, cfg: EventChatConfig, cache, generator, ids_buf, base_pos, frozen,
                  n_rem, n_iters: int, window: int, eos_token_id: int,
                  temperature: float = 0.0, top_p: float = 1.0, history=None, medusa=None,
                  drafts=None, depth=None, flags: Optional[_LiveFlags] = None,
                  after_first_step=None, run: bool = True, mesh=None):
    """Up to ``n_iters`` speculative verify iterations over the shared
    batch, the serving form of ``eventchat._spec_loop`` (the same drafts
    and verification), with per-row budgets and a frozen mask. The cache,
    ``ids_buf`` (B, S) and, in Medusa mode, ``drafts`` are updated in
    place.

    ``ids_buf`` holds each row's committed ids (-1 over the event block
    and pad); ``base_pos`` (B,) is the next unwritten slot at segment
    start. Invariant per active row: ``cache["length"] == base_pos +
    n_new - 1`` (every committed token but the newest is cached; admission
    commits the first token). Commits are capped at the remaining budget,
    and a row is ``done`` only when its EOS lands within that cap.
    ``drafts`` (B, >= window - 1) carries Medusa drafts from one verify to
    the next; a bucket touches only its first ``window - 1`` columns.
    ``depth`` (B,) caps each row's drafts (None = full depth).

    Returns (n_new, done, iterations, frozen_out, n_rem_out, base_pos_out,
    row_acc, row_off, pos_acc, pos_off) on the device, then ``steps``, the
    host count of iterations run, and ``all_frozen`` (``_decode_segment``'s).
    ``iterations`` counts the verifies that had a live row (the JAX loop's
    count), ``*_out`` are the next segment's control state, and the four
    before ``steps`` are the uncapped accepted / offered draft counts per
    row and per draft position, the adaptive controller's input.

    The stop rule is ``_decode_segment``'s: before iteration t >= 1 the
    host reads whether any row was live entering iteration t - 1. The one
    iteration past the last live one commits nothing. ``run=False`` runs
    no iteration and makes the draws of the verify it skips, as
    ``_decode_segment`` makes its step's.
    """
    b, s_ids = ids_buf.shape
    dev = ids_buf.device
    if flags is None:
        flags = _LiveFlags(n_iters, dev)
    bidx = torch.arange(b, device=dev)
    iarr = torch.arange(window, device=dev)[None, :]
    d_w = max(window - 1, 0)
    iarr1 = torch.arange(d_w, device=dev)[None, :]
    if drafts is None:
        drafts = torch.zeros((b, d_w), dtype=torch.int32, device=dev)
    full = torch.full((b,), d_w, dtype=torch.int32, device=dev)
    offer = full if depth is None else torch.minimum(depth.to(torch.int32), full)
    n_new = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    row_acc = torch.zeros((b,), dtype=torch.int32, device=dev)
    row_off = torch.zeros((b,), dtype=torch.int32, device=dev)
    pos_acc = torch.zeros((d_w,), dtype=torch.int32, device=dev)
    pos_off = torch.zeros((d_w,), dtype=torch.int32, device=dev)
    live = ~frozen & (n_rem > 0)
    any_live = live.any()
    _flag_record(flags, 0, any_live)
    steps = 0
    if not run and temperature > 0.0:
        # The skipped verify's draws; they do not depend on the values of
        # its probabilities and drafts.
        eventchat._spec_sample_accept(
            torch.ones((b, window, eventchat._vocab_size(params)), device=dev),
            torch.full((b, window - 1), -1, dtype=torch.int32, device=dev), generator)
    for t in range(n_iters if run else 0):
        if t and not _flag_read(flags, t - 1):
            break
        active = live
        iters += any_live
        pos = base_pos + n_new
        commit, m_count, first_eos, hit, drafts_w = eventchat._spec_draft_verify(
            params, cfg, ids_buf, pos, cache, generator, window, temperature, top_p,
            eos_token_id, history=history, medusa=medusa, drafts_in=drafts[:, :d_w],
            depth=depth, mesh=mesh)
        if medusa is not None and d_w:
            drafts[:, :d_w] = drafts_w
        m_count, first_eos = m_count.to(torch.int32), first_eos.to(torch.int32)
        # Acceptance, uncapped by the budget: accepted = m_count - 1 (the
        # correction is no draft), offered = the row's depth.
        offered = torch.where(active, offer, 0)
        acc_i = torch.where(active, m_count - 1, 0)
        row_acc += acc_i
        row_off += offered
        if d_w:
            pos_acc += ((iarr1 < acc_i[:, None]) & active[:, None]).to(torch.int32).sum(0)
            pos_off += ((iarr1 < offered[:, None]) & active[:, None]).to(torch.int32).sum(0)
        cap = torch.where(active, n_rem - n_new, 0)
        m_eff = torch.minimum(torch.where(hit, first_eos + 1, m_count), cap)
        # Clipped as the JAX package clips them: torch indexing raises on
        # the out-of-bounds slot that XLA drops.
        wpos = (pos[:, None] + iarr).clamp(0, s_ids - 1)
        cur = ids_buf[bidx[:, None], wpos]
        ids_buf[bidx[:, None], wpos] = torch.where(iarr < m_eff[:, None],
                                                   commit.to(ids_buf.dtype), cur)
        n_new = n_new + m_eff
        done = done | (active & hit & (first_eos + 1 <= cap))
        cache["length"] += m_eff.to(cache["length"].dtype)
        steps += 1
        live = ~(frozen | done) & (n_new < n_rem)
        if t + 1 < n_iters:
            any_live = live.any()
            _flag_record(flags, t + 1, any_live)
        if t == 0 and after_first_step is not None:
            after_first_step()
    if not steps and after_first_step is not None:
        after_first_step()
    all_frozen = _frozen_reader(flags, run, steps, n_iters)
    n_rem_out = n_rem - n_new
    frozen_out = frozen | done | (n_rem_out <= 0)
    n_rem_out = torch.where(frozen_out, torch.zeros_like(n_rem_out), n_rem_out)
    return (n_new, done, iters, frozen_out, n_rem_out, base_pos + n_new,
            row_acc, row_off, pos_acc, pos_off, steps, all_frozen)


@torch.inference_mode()
def _mixed_spec_segment(params, cfg: EventChatConfig, cache, generator, ids_buf, base_pos,
                        frozen, n_rem, lane_embeds, lane_cache, lane_start, lane_new_len,
                        lane_last_idx, n_iters: int, window: int, chunk_p: int,
                        eos_token_id: int, temperature: float = 0.0, top_p: float = 1.0,
                        history=None, medusa=None, drafts=None, depth=None,
                        flags: Optional[_LiveFlags] = None, after_first_step=None,
                        run: bool = True, mesh=None):
    """The mixed segment, speculative form: ``_spec_segment`` plus the
    piggybacked prefill lanes in one dispatch (see
    ``_mixed_decode_segment``, also for ``run``); the lane cache keeps its
    own ``length``. Returns the spec outputs followed by ``_lane_advance``'s."""
    spec = _spec_segment(params, cfg, cache, generator, ids_buf, base_pos, frozen, n_rem,
                         n_iters, window, eos_token_id, temperature, top_p, history=history,
                         medusa=medusa, drafts=drafts, depth=depth, flags=flags,
                         after_first_step=after_first_step if run else None, run=run,
                         mesh=mesh)
    lane = _lane_advance(params, cfg, lane_embeds, lane_cache, lane_start, lane_new_len,
                         lane_last_idx, chunk_p, mesh)
    if not run and after_first_step is not None:
        after_first_step()
    return spec + lane


def _gather_new(ids_buf: torch.Tensor, base_pos: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row window ``ids_buf[r, base_pos[r] : base_pos[r] + width]``
    (clipped at the edge): the speculative harvest fetches only the slots
    a segment could have written, not the whole (B, max_len) buffer."""
    b, s = ids_buf.shape
    idx = (base_pos[:, None].long()
           + torch.arange(width, device=ids_buf.device)[None, :]).clamp(0, s - 1)
    return ids_buf[torch.arange(b, device=ids_buf.device)[:, None], idx]


def _rows_in_bounds(rows: np.ndarray, limit: int):
    """Index of the entries of ``rows`` below ``limit``. The JAX scheduler
    marks pad and quarantined wave slots with row ``max_batch`` (and
    aliased or pad blocks with ``n_blocks``) and lets XLA drop those
    out-of-bounds scatter updates; torch indexing would raise, so the
    port keeps the sentinels and filters them before each scatter."""
    return np.nonzero(np.asarray(rows) < limit)[0]


def _ins(buf, src, fn):
    """Apply ``fn(plane, src_plane)`` to a cache buffer, plane by plane for
    an int8 buffer."""
    if isinstance(buf, dict):
        fn(buf["q"], src["q"])
        fn(buf["s"], src["s"])
    else:
        fn(buf, src)


def _planes(buf, fn):
    """``fn`` of each plane of a cache buffer (a dict for an int8 one)."""
    if isinstance(buf, dict):
        return {"q": fn(buf["q"]), "s": fn(buf["s"])}
    return fn(buf)


@torch.inference_mode()
def _admit_row(cache, logits_buf, row: int, row_cache, row_logits) -> None:
    """Write a batch-1 prefill result into batch row ``row`` of the shared
    dense cache."""
    s1 = llama_mod._kv_max_len(row_cache)

    def put(buf, rbuf):
        buf[:, row:row + 1, :s1] = rbuf.to(buf.dtype)

    _ins(cache["k"], row_cache["k"], put)
    _ins(cache["v"], row_cache["v"], put)
    cache["length"][row] = row_cache["length"][0]
    logits_buf[row] = row_logits[0]


@torch.inference_mode()
def _admit_wave(cache, logits_buf, rows: np.ndarray, wave_k, wave_v, wave_len,
                wave_logits) -> None:
    """Write one batched admission prefill into the shared dense cache:
    wave slot i lands at row ``rows[i]``; slots with row >= max_batch (pow2
    pad, NaN quarantine) write nothing."""
    keep = _rows_in_bounds(rows, logits_buf.shape[0])
    dev = logits_buf.device
    src = torch.as_tensor(keep, dtype=torch.long, device=dev)
    dst = torch.as_tensor(np.asarray(rows)[keep], dtype=torch.long, device=dev)
    s1 = (wave_k["q"] if isinstance(wave_k, dict) else wave_k).shape[2]

    def put(buf, wbuf):
        buf[:, dst, :s1] = wbuf[:, src].to(buf.dtype)

    _ins(cache["k"], wave_k, put)
    _ins(cache["v"], wave_v, put)
    cache["length"][dst] = wave_len[src].to(cache["length"].dtype)
    logits_buf[dst] = wave_logits[src]


def _pool_scatter(buf, dst_blocks: np.ndarray, src) -> None:
    """Scatter a dense (L, n_src_rows, S, ...) cache buffer into pool
    blocks: the position axis splits into S / block_size whole blocks, and
    source block i of the flattened (row, block) order lands at pool block
    ``dst_blocks.reshape(-1)[i]``. Destinations >= n_blocks (the JAX
    package's drop sentinel: prefix-aliased blocks, pad rows, blocks
    beyond a reservation) write nothing."""
    if isinstance(buf, dict):
        _pool_scatter(buf["q"], dst_blocks, src["q"])
        _pool_scatter(buf["s"], dst_blocks, src["s"])
        return
    n_layers, n_blocks, bs = buf.shape[0], buf.shape[1], buf.shape[2]
    n_src = (src.shape[1] * src.shape[2]) // bs
    r = src.reshape((n_layers, n_src, bs) + tuple(buf.shape[3:]))
    flat = np.asarray(dst_blocks).reshape(-1)
    keep = _rows_in_bounds(flat, n_blocks)
    dev = buf.device
    buf[:, torch.as_tensor(flat[keep], dtype=torch.long, device=dev)] = \
        r[:, torch.as_tensor(keep, dtype=torch.long, device=dev)].to(buf.dtype)


@torch.inference_mode()
def _admit_row_paged(cache, logits_buf, row: int, dst_blocks: np.ndarray, bt_row: np.ndarray,
                     row_cache, row_logits) -> None:
    """Paged form of ``_admit_row``: scatter the batch-1 row cache into the
    row's pool blocks (``dst_blocks`` per source block) and install its
    block table ``bt_row``."""
    _pool_scatter(cache["k"], dst_blocks, row_cache["k"])
    _pool_scatter(cache["v"], dst_blocks, row_cache["v"])
    dev = logits_buf.device
    cache["bt"][row] = torch.as_tensor(bt_row, dtype=torch.int32, device=dev)
    cache["length"][row] = row_cache["length"][0]
    logits_buf[row] = row_logits[0]


@torch.inference_mode()
def _admit_wave_paged(cache, logits_buf, rows: np.ndarray, dst_blocks: np.ndarray,
                      bt_rows: np.ndarray, wave_k, wave_v, wave_len, wave_logits) -> None:
    """Paged form of ``_admit_wave``: every member's row cache scatters into
    its block run (``dst_blocks`` (Nb, s1 / bs)) and its table and length
    are installed; pad and quarantined slots write nothing."""
    _pool_scatter(cache["k"], dst_blocks, wave_k)
    _pool_scatter(cache["v"], dst_blocks, wave_v)
    keep = _rows_in_bounds(rows, logits_buf.shape[0])
    dev = logits_buf.device
    src = torch.as_tensor(keep, dtype=torch.long, device=dev)
    dst = torch.as_tensor(np.asarray(rows)[keep], dtype=torch.long, device=dev)
    cache["bt"][dst] = torch.as_tensor(np.asarray(bt_rows)[keep], dtype=torch.int32,
                                       device=dev)
    cache["length"][dst] = wave_len[src].to(cache["length"].dtype)
    logits_buf[dst] = wave_logits[src]


@torch.inference_mode()
def _gather_blocks(cache, blocks: Sequence[int]):
    """Dense (L, 1, m * bs, KV, hd) K/V views of ``m`` pool blocks: a paged
    prefix entry's KV for the suffix and lane paths (a gather is a copy of
    the same values a dense entry holds)."""
    dev = cache["length"].device
    idx = torch.as_tensor(list(blocks), dtype=torch.long, device=dev)

    def g(buf):
        x = buf[:, idx]
        return x.reshape((x.shape[0], 1, x.shape[1] * x.shape[2]) + tuple(x.shape[3:]))

    return _planes(cache["k"], g), _planes(cache["v"], g)


def _slice_prefix_block(k, v, row: int, bucket: int):
    """A copy of cache positions [0, bucket) of batch row ``row``: the dense
    insert-on-prefill entry (the source row cache is still owed to the
    admission scatter, and must not be kept alive by a view)."""

    def sl(buf):
        return buf[:, row:row + 1, :bucket].clone()

    return _planes(k, sl), _planes(v, sl)


@torch.inference_mode()
def _chunk_prefill(params, cfg: EventChatConfig, embeds, cache, start: int, new_len: int,
                   last_idx: int, chunk: int, mesh=None):
    """One chunked-admission advance: prompt positions [start, start +
    chunk) of ``embeds`` (1, S1, D) through ``decode_kstep`` (query i at
    position start + i sees slots [0, start + i], as in one-shot prefill),
    then the length pinned to ``new_len``, the real prompt filled so far.
    ``chunk`` divides the bucket grain, so the window never leaves the
    bucket. Returns the (1, V) f32 logits and the (1, D) final-norm hidden
    at window index ``last_idx`` (the hidden seeds Medusa drafts)."""
    cache["length"].fill_(start)
    logits, hidden, _ = llama_mod.decode_kstep(params["llama"], cfg.llama,
                                               embeds[:, start:start + chunk], cache,
                                               return_hidden=True, mesh=mesh)
    cache["length"].fill_(new_len)
    return logits[:, last_idx], hidden[:, last_idx]


@torch.inference_mode()
def _prefix_prefill(params, cfg: EventChatConfig, pk, pv, plen, cache, suffix_embeds, new_len,
                    last_idx, mesh=None):
    """Admission from cached prefix KV: copy each row's entry block (``pk``/
    ``pv``, (L, N, s_pre, ...)) into the fresh row cache, pin the length to
    the entry length ``plen`` and run ONLY the suffix (N, chunk, D) through
    ``decode_kstep`` -- the attention of prefilling the whole prompt, at
    the cost of the suffix. Trailing suffix pad writes above ``new_len``.
    ``plen``/``new_len``/``last_idx`` are (N,) device tensors. Returns the
    (N, V) logits and (N, D) final-norm hidden at each row's last suffix
    token."""

    def copy(buf, src):
        buf[:, :, :src.shape[2]] = src.to(buf.dtype)

    _ins(cache["k"], pk, copy)
    _ins(cache["v"], pv, copy)
    cache["length"].copy_(plen)
    logits, hidden, _ = llama_mod.decode_kstep(params["llama"], cfg.llama, suffix_embeds, cache,
                                               return_hidden=True, mesh=mesh)
    cache["length"].copy_(new_len)
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, last_idx.long()], hidden[rows, last_idx.long()]


@torch.inference_mode()
def _lane_seed(lane_cache, slot: int, pk, pv) -> None:
    """Copy a prefix entry's KV block into lane row ``slot`` at position 0:
    the lane then advances only the suffix. The lane cache is never
    quantized, so an int8 entry block is dequantized here -- the values
    the suffix path's attention reads."""

    def ins(buf, src):
        if isinstance(src, dict):
            src = llama_mod._kv_dequant(src, buf.dtype)
        buf[:, slot:slot + 1, :src.shape[2]] = src.to(buf.dtype)

    ins(lane_cache["k"], pk)
    ins(lane_cache["v"], pv)


@torch.inference_mode()
def _lane_extract(lane_k, lane_v, slot: int, pk, pv, bucket: int, quant: bool, plen: int = 0):
    """Lane row ``slot`` as a (1, bucket) admission row cache. The lane
    prefills unquantized; an int8 server quantizes it here, once, from the
    values one-shot prefill's cache write would see. A seeded entry's own
    (q, s) block is laid over its real region [0, plen) afterwards, so the
    prefix lands exactly as the suffix path copies it."""
    k, v = _slice_prefix_block(lane_k, lane_v, slot, bucket)
    if not quant:
        return k, v
    k, v = llama_mod._kv_quantize(k), llama_mod._kv_quantize(v)
    if pk is not None:
        def overlay(buf, src):
            buf[:, :, :plen] = src[:, :, :plen].to(buf.dtype)

        _ins(k, pk, overlay)
        _ins(v, pv, overlay)
    return k, v


@dataclass
class _Request:
    rid: int
    input_ids: Sequence[int]
    pixel_values: Any
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    row: int = -1
    # Cache positions the prompt occupies (text + event tokens).
    prompt_len: int = 0
    # perf_counter stamps at submit / first committed token / completion,
    # and of the last harvest that committed tokens for the row (the
    # request's mean inter-token gap, ``request_stats[rid]["itl_s"]``).
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    t_last: Optional[float] = None
    # An imported handoff rebases ``t_submit`` into the past; its journey
    # leg stays local and begins here.
    t_journey: Optional[float] = None
    # The request's open async trace span: "queued" until it leaves the
    # queue, then "active"; the terminal path closes whichever is open.
    phase: str = "queued"
    # Absolute perf_counter deadline (None = none).
    deadline: Optional[float] = None
    # The prefix entry this row admitted from (a pin, drained at finish).
    prefix_entry: Optional[_PrefixEntry] = None
    # Paged layout: the pool blocks this request holds at refcount 1
    # (``owned``) and shared with a prefix entry (``aliased``), and whether
    # its row's device table points at them (reset to scratch at release).
    kv_blocks_owned: List[int] = field(default_factory=list)
    kv_blocks_aliased: List[int] = field(default_factory=list)
    kv_bt_written: bool = False
    # ``_pixels_key`` of the submitted pixels, computed once.
    pixels_key: Optional[bytes] = None
    # The class and targets the request is scored against at finish
    # (None = unscored).
    slo: Optional[SLO] = None
    # Preemption: while a spilled victim waits re-queued, its pool spill
    # registry entry (None: dropped for re-prefill, or never preempted);
    # the spill store holds its record under ``rid``. ``preempts`` counts
    # its evictions.
    spill_run: Optional[int] = None
    preempts: int = 0
    # Decode role: the gathered block-run record the request arrived with;
    # admission splices it instead of prefilling, then clears it.
    handoff_rec: Optional[Dict[str, Any]] = None


@dataclass
class _PendingLane:
    """One piggybacked admission: the row is reserved (frozen), the prompt
    embeddings sit in lane slot ``slot``, and every mixed segment advances
    the lane ``chunk_p`` positions until ``filled >= prompt_len``; then
    the lane row joins the shared cache through ``_finish_admission``. A
    prefix hit's entry KV was seeded at [0, filled0)."""
    req: _Request
    row: int
    slot: int
    prompt_len: int
    filled: int = 0
    entry: Optional[_PrefixEntry] = None
    last_logits: Any = None  # (1, V), valid after the final chunk
    last_hidden: Any = None  # (1, D), the same position: seeds Medusa drafts


@dataclass
class _PendingAdmission:
    """A chunked admission in flight: the row is reserved (frozen), the
    prompt prefix [0, filled) is prefilled into ``row_cache``, and one
    chunk advances per scheduler step while the other rows decode."""
    req: _Request
    row: int
    embeds: Any          # (1, S1, D) padded prompt embeddings
    prompt_len: int
    row_cache: Any
    filled: int = 0


class ContinuousBatcher:
    """Row-level continuous batching over one resident KV cache.

    >>> srv = ContinuousBatcher(params, cfg, max_batch=4, max_len=1024)
    >>> rid = srv.submit(input_ids, pixel_values, max_new_tokens=64)
    >>> answers = srv.run_until_drained()   # {rid: [token ids]}

    Greedy by default (temperature 0); sampling settings apply serverwide.
    Runs on ``device`` (default ``cuda``, which raises without a card);
    ``params`` must already live there. The defaults are the JAX
    batcher's: pipelined, the prefix cache on, lanes off
    (``prefill_budget=0``). Single-threaded: the owning
    ``cli.serve.ServingEngine`` serializes every call behind its lock;
    only ``BlockPool.stats()`` and ``PrefixCache.stats()`` are read from
    other threads.

    Dispatch-path contract: ``step``, ``_dispatch_segment`` and the
    segment functions read nothing back from the device, except the
    segment's lagged stop flag; ``_harvest_segment`` and ``_drain`` are
    where the host waits (``tests/test_torch_serve_hot_path.py``).
    """

    def __init__(
        self,
        params,
        cfg: EventChatConfig,
        max_batch: int = 4,
        max_len: int = 1024,
        chunk: int = 32,
        temperature: float = 0.0,
        top_p: float = 1.0,
        eos_token_id: Optional[int] = 2,
        seed: int = 0,
        kv_quant: bool = False,
        max_queue: int = 0,
        kv_layout: str = "dense",
        kv_pool_blocks: int = 0,
        device="cuda",
        speculative: int = 0,
        draft_head=None,
        mesh=None,
        prefill_chunk: int = 0,
        prefill_budget: int = 0,
        prefill_lane_chunk: int = 0,
        prefix_cache: bool = True,
        prefix_cache_bytes: int = 0,
        prefix_insert: bool = True,
        preempt: bool = False,
        spill_capacity_mb: int = 0,
        spec_buckets=None,
        role: str = "colocated",
        first_chunk: int = 0,
        pipeline: bool = True,
        mem_headroom_bytes: int = 0,
        mem_capacity_bytes: int = 0,
        history_len: int = 2048,
        spec_ema_alpha: float = 0.3,
        spec_draft_cost: float = 0.05,
        spec_hysteresis: float = 0.05,
        spec_row_window: int = 4,
        spec_head_min_yield: float = 0.05,
        slo_window: int = 256,
    ):
        if mesh is not None:
            serving_mod._require_serving_mesh(mesh)
        self.mesh = mesh
        # The parts the KV heads split into over the mesh: block and record
        # bytes count the whole row (the one-device batcher's), so that the
        # spill store's budget and the price decide as it does.
        self._kv_split = serving_mod.kv_head_parts(cfg.llama, mesh)
        # The deadline clock (``_now``): on a mesh rank 0's, agreed once a
        # step while a deadline is queued or live.
        self._clock = time.perf_counter
        self._in_step = False
        self._step_now: Optional[float] = None
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}")
        # "colocated" admits and decodes. "prefill" only admits: each
        # activated row's block run is gathered into ``handoff_ready``
        # (``_handoff_sweep``). "decode" also takes gathered records
        # (``import_handoff``). The record moves block runs, so the split
        # roles need the paged layout.
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"role must be 'colocated', 'prefill' or 'decode', got {role!r}")
        if role != "colocated" and kv_layout != "paged":
            raise ValueError(f"role={role!r} requires kv_layout='paged' (the handoff moves "
                             f"block runs)")
        self.role = role
        if role == "prefill":
            # Lanes advance only inside a decode dispatch, which a prefill
            # role never runs: they would starve.
            prefill_budget = 0
        if prefill_chunk and _GRAIN % prefill_chunk:
            # A chunk off the grain would let the last chunk's window leave
            # the bucket (positions out of step with the cache slots).
            raise ValueError(f"prefill_chunk must divide the prompt bucket grain {_GRAIN}, "
                             f"got {prefill_chunk}")
        self.device = resolve_device(device)
        embed = params["llama"]["embed_tokens"]
        if embed.device.type != self.device.type:
            raise ValueError(f"ContinuousBatcher on {self.device}: the parameters are on "
                             f"{embed.device}")
        self.device = embed.device
        self.params, self.cfg = params, cfg
        # Telemetry identities: this server's ledger entries live under
        # ``_mem_owner/`` (a fleet's replicas each report their share), and
        # its journeys under a process-unique owner id (request ids are
        # per batcher).
        self._mem_owner = f"b{id(self):x}"
        self._journey_owner = obs_journey.register_owner(self._mem_owner)
        # A max_len off the prompt grain would let a bucketed row cache
        # outgrow the shared cache.
        max_len = (max_len + _GRAIN - 1) // _GRAIN * _GRAIN
        self.max_batch, self.max_len, self.chunk = max_batch, max_len, chunk
        # The TTFT ramp: while an active row owes its first token, segments
        # are this long instead of ``chunk`` (0 = off). Speculative rows
        # commit their first token at admission, so no segment could
        # select it there: the flag is dropped.
        self.first_chunk = (min(int(first_chunk), chunk)
                            if first_chunk and not speculative and not spec_buckets else 0)
        self.temperature, self.top_p = float(temperature), float(top_p)
        self.eos = int(eos_token_id) if eos_token_id is not None else -1
        self.eos_token_id = eos_token_id
        # A quantized weight tree computes in bf16, like the JAX package.
        self._dtype = embed.dtype if embed.dtype in (torch.bfloat16, torch.float32) \
            else torch.bfloat16
        self.kv_quant = bool(kv_quant)
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        self._pool: Optional[BlockPool] = None
        if self._paged:
            self._kv_block_size = SEQ_BUCKET
            self._nbpr = max_len // SEQ_BUCKET  # table width (blocks per row)
            # Default pool: the dense layout's capacity plus the scratch
            # block, so the layout alone never shrinks what fits.
            n_blocks = int(kv_pool_blocks) or (max_batch * self._nbpr + 1)
            min_blocks = _GRAIN // SEQ_BUCKET + 1
            if n_blocks < min_blocks:
                raise ValueError(f"kv_pool_blocks={n_blocks} cannot hold one prompt bucket "
                                 f"({min_blocks - 1} blocks + 1 scratch)")
            self.cache = llama_mod.init_paged_kv_cache(
                cfg.llama, max_batch, max_len, n_blocks, SEQ_BUCKET, dtype=self._dtype,
                device=self.device, quant=self.kv_quant, mesh=mesh)
        else:
            self.cache = llama_mod.init_kv_cache(cfg.llama, max_batch, max_len,
                                                 dtype=self._dtype, device=self.device,
                                                 quant=self.kv_quant, mesh=mesh)
        self.kv_bytes = _nbytes([self.cache["k"], self.cache["v"]])
        # Per-position K+V bytes of one cache row: the prefix cache's unit
        # (an entry's nbytes = bucket * this; int8 halves it).
        positions = n_blocks * SEQ_BUCKET if self._paged else max_batch * max_len
        self._kv_pos_bytes = max(1, self.kv_bytes // positions)
        self._prefix_cache = PrefixCache(int(prefix_cache_bytes)) if prefix_cache else None
        self.prefix_insert = bool(prefix_insert)
        if self._paged:
            self._pool = BlockPool(n_blocks, SEQ_BUCKET,
                                   block_bytes=SEQ_BUCKET * self._kv_pos_bytes * self._kv_split)
            self.block_deferrals = 0
            if self._prefix_cache is not None:
                self._prefix_cache.pool = self._pool
        # Block-tier preemption (paged only): an interactive head that the
        # free list cannot cover evicts batch rows, each spilled to the
        # host store or dropped for re-prefill by the price below.
        self.preempt = bool(preempt) and self._paged
        self._spill_store: Optional[SpillStore] = (
            SpillStore(max(int(spill_capacity_mb), 0) * (1 << 20), owner=self._mem_owner)
            if self._paged else None)
        self.preemptions = 0
        # The spill-or-recompute price, the JAX package's: a device-to-host
        # bandwidth EWMA (re-measured at every gather) against ~2 * params
        # * positions FLOPs re-prefilled at an assumed rate. The constants
        # set timing, never a chain.
        self._spill_bw_Bps = 5e9
        self._spill_param_count = max(self._tree_bytes(params) // 2, 1)
        self._recompute_flops_per_s = 5e12
        # The prefill role's outbox of gathered records (``pop_handoffs``)
        # and the handoff counters of both roles.
        self.handoff_ready: List[Dict[str, Any]] = []
        self.handoffs_gathered = 0
        self.handoffs_gathered_bytes = 0
        self.handoffs_spliced = 0
        self.handoffs_spliced_bytes = 0
        self._slo_window_len = max(int(slo_window), 1)
        # Vocab from the lm_head leaf: special tokens may have grown it.
        vocab = eventchat._vocab_size(params)
        self.logits = torch.zeros((max_batch, vocab), dtype=torch.float32, device=self.device)
        # Speculative serving (window > 0): rows draft from their own
        # committed ids; admission commits the first token, so no logits
        # carry between segments. ``spec_buckets`` (e.g. "0,2,4") makes
        # the window a per-boundary choice of the ``SpecController`` from
        # measured acceptance, with a per-row depth mask; ``speculative``
        # is then the default window (the largest bucket when 0). Chains
        # are the same at any window: verification makes any draft exact.
        self.speculative = int(speculative)
        buckets = (serve_spec.parse_spec_buckets(spec_buckets)
                   if isinstance(spec_buckets, (str, type(None)))
                   else tuple(sorted({max(int(k), 1) for k in spec_buckets})))
        self._spec_ctl: Optional[serve_spec.SpecController] = None
        self.spec_windows: Optional[tuple] = None
        if buckets:
            if not self.speculative:
                self.speculative = max(buckets)
            self._spec_ctl = serve_spec.SpecController(
                buckets, default_window=self.speculative, ema_alpha=spec_ema_alpha,
                draft_cost=spec_draft_cost, hysteresis=spec_hysteresis,
                row_window=spec_row_window, head_min_yield=spec_head_min_yield,
                # Drafts and piggybacked prefill share one boundary budget.
                draft_budget=max(int(prefill_budget), 0))
            self.spec_windows = self._spec_ctl.windows
        # The largest window any boundary can select: the slack and the
        # draft buffer are sized to it.
        self.spec_max = self._spec_ctl.max_window if self._spec_ctl else self.speculative
        self.draft_head = draft_head
        if draft_head is not None:
            if not self.speculative:
                raise ValueError("draft_head requires speculative=K > 0 (the heads draft into "
                                 "the K-token verification window)")
            n_heads = medusa_mod.num_draft_heads(draft_head)
            if n_heads < self.spec_max - 1:
                # At construction: the first draft call would otherwise
                # raise at admission, mid-drain.
                raise ValueError(f"draft_head has {n_heads} heads but the largest speculation "
                                 f"window {self.spec_max} needs {self.spec_max - 1}")
        if self.speculative:
            self.ids_buf = torch.full((max_batch, self.max_len), -1, dtype=torch.int32,
                                      device=self.device)
            self.base_pos = np.zeros((max_batch,), np.int64)
            # Medusa drafts carried from one verify to the next, as wide as
            # the largest bucket; a bucket touches its first W - 1 columns.
            self.spec_drafts = torch.zeros((max_batch, max(self.spec_max - 1, 0)),
                                           dtype=torch.int32, device=self.device)
        # Server-wide served text (prompts and answers of every request),
        # extra lookup context for the speculative drafts. 0 disables.
        self._history = (np.full((int(history_len),), -1, np.int64)
                         if self.speculative and history_len else None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.frozen = np.ones((max_batch,), bool)  # all rows FREE
        self.n_rem = np.zeros((max_batch,), np.int64)
        self.rows: List[Optional[_Request]] = [None] * max_batch
        self.queue: deque = deque()
        self.finished: Dict[int, List[int]] = {}
        self.finish_status: Dict[int, str] = {}
        self.request_stats: Dict[int, Dict[str, float]] = {}
        self.max_queue = int(max_queue)
        self._n_deadlines = 0
        self._next_rid = 0
        self.prefill_chunk = int(prefill_chunk)
        self._pending: Optional[_PendingAdmission] = None
        self.pipeline = bool(pipeline)
        # Piggyback lanes: up to ``_lane_cap`` admissions ride the decode
        # dispatch, each advanced ``_lane_chunk`` prompt positions per
        # mixed segment (lanes * chunk_p <= prefill_budget tokens).
        self.prefill_budget = max(int(prefill_budget), 0)
        lane_chunk = int(prefill_lane_chunk) or min(self.prefill_budget, SEQ_BUCKET)
        self._lane_chunk = (max(1, min(lane_chunk, self.prefill_budget))
                            if self.prefill_budget else 0)
        self._lane_cap = (max(1, min(self.prefill_budget // self._lane_chunk, max_batch))
                          if self.prefill_budget else 0)
        self._lanes: List[_PendingLane] = []
        self._lane_free: List[int] = list(range(self._lane_cap))
        self._lane_cache = None   # resident (K_cap, S_lane + chunk_p) KV rows
        self._lane_embeds = None  # resident (K_cap, S_lane, D) prompt embeddings
        self._lane_bucket = 0     # S_lane: grown to the largest member
        self._inflight: Optional[dict] = None  # dispatched, not harvested
        # (frozen, n_rem) on the device as of the last dispatch; None =
        # stale (the host changed rows, always drained) -> uploaded from
        # the host mirror at the next dispatch.
        self._dev_carry = None
        self._dev_carry_frozen = None  # the carry's segment's ``all_frozen``
        self._flags = _LiveFlags(chunk, self.device)
        self._register_memory(params, draft_head, max_batch)
        # The admission headroom guard: a boundary defers its wave while the
        # ledger predicts it past capacity - headroom (0 = off). Capacity:
        # the explicit override, else the card's total (0 on the CPU: the
        # guard is inert there without one).
        self.mem_headroom_bytes = max(int(mem_headroom_bytes), 0)
        self._mem_capacity = int(mem_capacity_bytes) or (
            obs_memory.device_capacity_bytes(self.device) if self.mem_headroom_bytes else 0)
        self.mem_deferrals = 0
        # The last chosen speculation window: journeys record a switch.
        self._spec_last_window = self.speculative
        self.reset_serving_stats()

    def _register_memory(self, params, draft_head, max_batch: int) -> None:
        """The resident buffers' ledger entries, the JAX batcher's: the
        weight tree keyed by its identity (replicas over one tree share the
        entry; each holds it until it is dropped), every other component
        under this server's owner."""
        led = obs_memory.LEDGER
        if self._prefix_cache is not None:
            self._prefix_cache._mem_key = f"{self._mem_owner}/prefix_cache"
        self._mem_shared = [("weights", f"shared/params-{id(params):x}")]
        led.hold(*self._mem_shared[0], obs_memory.params_bytes(params))
        if self._paged:
            led.register("kv_pool", f"{self._mem_owner}/kv_pool",
                         obs_memory.params_bytes([self.cache["k"], self.cache["v"]]))
            led.register("kv_block_table", f"{self._mem_owner}/kv_block_table",
                         obs_memory.params_bytes([self.cache["bt"], self.cache["length"]]))
        else:
            led.register("kv_cache", f"{self._mem_owner}/kv_cache",
                         obs_memory.params_bytes(self.cache))
        led.register("logits", f"{self._mem_owner}/logits", obs_memory.params_bytes(self.logits))
        if self.speculative:
            led.register("ids_buf", f"{self._mem_owner}/ids_buf",
                         obs_memory.params_bytes(self.ids_buf))
            led.register("draft", f"{self._mem_owner}/spec_drafts",
                         obs_memory.params_bytes(self.spec_drafts))
        if draft_head is not None:
            self._mem_shared.append(("draft", f"shared/medusa-{id(draft_head):x}"))
            led.hold(*self._mem_shared[-1], obs_memory.params_bytes(draft_head))
        if self.pipeline:
            # The device carry: frozen (bool), n_rem (int32) and, speculative,
            # base_pos (int32) per row.
            led.register("carry", f"{self._mem_owner}/carry",
                         max_batch * (1 + 4 + (4 if self.speculative else 0)))

    def __del__(self):
        # A dropped batcher leaves no owner-keyed bytes in the ledger, and
        # lets go of the shared weight entries: the last holder releases
        # them (the JAX batcher leaves them).
        owner = getattr(self, "_mem_owner", None)
        if owner is None:
            return
        try:
            for comp, key in (("kv_cache", "kv_cache"), ("kv_pool", "kv_pool"),
                              ("kv_block_table", "kv_block_table"), ("logits", "logits"),
                              ("ids_buf", "ids_buf"), ("draft", "spec_drafts"),
                              ("carry", "carry"), ("lanes", "lanes"), ("spill", "spill")):
                obs_memory.LEDGER.release(comp, f"{owner}/{key}")
            for comp, key in getattr(self, "_mem_shared", ()):
                obs_memory.LEDGER.unhold(comp, key)
        except Exception:
            pass

    def reset_serving_stats(self) -> None:
        """Zero the phase counters, so that a measured window reports only
        its own traffic.

        Host time: ``admission_s`` (max ``admission_max_s``) in admission,
        ``decode_s`` in dispatch and harvest calls. Pipeline overlap
        (host-observable, the JAX package's definitions):
        ``device_segment_s`` is the host time blocked on a segment's
        fetch, ``host_gap_s`` the host time between one fetch's end and
        the next fetch, ``overlap_hidden_s`` the part of that gap spent
        while the fetched segment was still running on the card.
        ``carry_uploads`` counts host-to-device uploads of the frozen/
        budget state. ``dispatches`` counts admission dispatches by kind:
        "full" and "wave" run the model's prefill (K1 on the card),
        "suffix", "suffix_wave", "chunk" and "piggyback" run
        ``decode_kstep``, "prefix_set" is ``set_prefix``'s prefill."""
        self.admission_s = 0.0
        self.admission_max_s = 0.0
        self.decode_s = 0.0
        self.prefill_dispatches = 0
        self.seg_count = 0
        self.decode_steps = 0
        self.decode_steps_run = 0
        # Decode steps and verifies run with no live row (the stop rule's
        # one step past the last live one): the JAX loop runs none.
        self.idle_steps = 0
        self.idle_verifies = 0
        self.device_segment_s = 0.0
        self.host_gap_s = 0.0
        self.overlap_hidden_s = 0.0
        self._t_prev_fetch_end: Optional[float] = None
        self.carry_uploads = 0
        self.dispatches: Dict[str, int] = {}
        # Stall-free evidence: harvested segments that carried live lanes
        # beside live decode rows, those where the rows committed nothing
        # (0 by construction), prompt positions advanced in lanes, mixed
        # segments dispatched, and lanes opened by kind.
        self.mixed_boundaries = 0
        self.mixed_zero_harvests = 0
        self.mixed_prefill_tokens = 0
        self.mixed_segments = 0
        self.lanes_started = {"full": 0, "suffix": 0}
        # Speculation: committed tokens and verify iterations (their
        # ratio is the realized acceptance), dispatch boundaries, the sum
        # of their windows, rows masked below full depth, and the trace
        # of chosen windows. The controller's own state is policy, not a
        # statistic, and is not reset.
        self.spec_iterations = 0
        self.spec_tokens = 0
        self.spec_dispatches = 0
        self.spec_depth_sum = 0
        self.spec_masked_rows = 0
        self.spec_depth_trace: deque = deque(maxlen=4096)
        # SLO attainment: (class, met) -> finished requests, and the ring of
        # the last ``slo_window`` scored finishes (the windowed goodput).
        self.slo_counts: Dict[tuple, int] = {}
        self._slo_window: deque = deque(maxlen=self._slo_window_len)
        # Each block-run gather to the host (a spill or a handoff):
        # {"kind", "bytes", "blocks", "alloc_s", "copy_s"}; on the card the
        # copy into pinned memory is timed apart from its allocation.
        self.gather_timings: deque = deque(maxlen=256)

    def slo_stats(self) -> Dict[str, Any]:
        """SLO attainment: per class the finished and met counts and their
        ratio, and the goodput ratio over the last ``slo_window`` scored
        finishes (``GET /stats``'s ``slo``)."""
        classes: Dict[str, Dict[str, Any]] = {}
        for (name, met), n in sorted(self.slo_counts.items()):
            c = classes.setdefault(name, {"finished": 0, "met": 0})
            c["finished"] += n
            if met:
                c["met"] += n
        for c in classes.values():
            c["attainment"] = c["met"] / c["finished"] if c["finished"] else 0.0
        w = len(self._slo_window)
        return {"classes": classes, "window_n": w, "window_size": self._slo_window_len,
                "goodput_ratio": (sum(self._slo_window) / w) if w else 0.0}

    def overlap_ratio(self) -> float:
        """Share of the host's scheduler time hidden behind the card's
        compute (~0 on the synchronous path, where a fetch starts right
        after its own dispatch)."""
        return self.overlap_hidden_s / self.host_gap_s if self.host_gap_s > 0 else 0.0

    def _count_dispatch(self, kind: str) -> None:
        self.dispatches[kind] = self.dispatches.get(kind, 0) + 1
        if kind in ("full", "wave"):
            self.prefill_dispatches += 1
        if kind != "prefix_set":  # set_prefix's prefill is no admission
            obs_metrics.SERVE_PREFILL_DISPATCHES.inc(kind=kind)

    def spec_tokens_per_iteration(self) -> float:
        """Realized acceptance: committed tokens per verify iteration,
        summed over the batch's rows (one weight pass each)."""
        return self.spec_tokens / max(self.spec_iterations, 1)

    def spec_stats(self) -> Dict[str, Any]:
        """Speculation snapshot (``GET /stats``'s ``spec``): accepted tokens
        per dispatch, the mean chosen window, masked rows, and the adaptive
        controller's state."""
        out: Dict[str, Any] = {
            "speculative": self.speculative,
            "accepted_per_dispatch": round(self.spec_tokens / max(self.spec_dispatches, 1), 3),
            "spec_depth_mean": round(self.spec_depth_sum / max(self.spec_dispatches, 1), 3),
            "masked_rows": self.spec_masked_rows,
            "dispatches": self.spec_dispatches,
            "tokens_per_iteration": round(self.spec_tokens_per_iteration(), 3),
        }
        if self._spec_ctl is not None:
            out["adaptive"] = self._spec_ctl.stats()
        return out

    # -- client surface ---------------------------------------------------

    @torch.inference_mode()
    def warmup(self, prompt_lens=None) -> int:
        """Run every function a request can reach once, on the idle server,
        so that the first request does not pay for the first calls: on the
        card the kernel builds (``ops/_build.build_all``, K1 and, for an
        int4 tree, K4 in parallel), cuBLAS handle and plan creation and
        the allocator's first growth. The functions, as the JAX package's
        ``warmup`` compiles them: the vision encoder, one prefill per
        prompt bucket (``prompt_lens``: prompt lengths in cache positions;
        default every bucket up to max_len and the context length), the
        chunked prefill when it is
        on, the row admission, one segment per speculation bucket (and per
        ramp length) with every row frozen, the mixed segment with idle
        lanes when lanes are on, and one suffix admission per prefix-cache
        entry shape. Returns the number of functions warmed, the count the
        JAX package's ``warmup`` returns for the same server.

        It runs against the live resident state, which only holds on an
        idle server: the dummy admission lands in free row 0 (dead storage;
        a paged one writes no pool block), every cache length is zeroed, and
        the frozen segments commit nothing. The sampling generator's state
        is restored afterwards, so the chains are those of a server that
        was not warmed."""
        if (self.queue or self._pending is not None or self._lanes
                or any(r is not None for r in self.rows)):
            raise RuntimeError("warmup() must run before any request is admitted: it writes "
                               "dummy state into row 0 and resets cache lengths, which would "
                               "corrupt in-flight rows")
        self._drain()  # a trailing all-frozen segment, if any
        if self.device.type == "cuda":
            from eventgpt_tpu_torch.ops import quant
            from eventgpt_tpu_torch.ops._build import build_all
            from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
            from eventgpt_tpu_torch.ops.int4_matmul import INT4_KERNEL

            layers = self.params["llama"]["layers"]
            int4 = any(quant.is_quantized4(leaf) for layer in layers for leaf in layer.values())
            build_all([k for k, used in ((FLASH_KERNEL, self.cfg.llama.attn_impl == "flash"),
                                         (INT4_KERNEL, int4)) if used])
        if prompt_lens is None:
            limit = min(self.max_len, _bucket(self.cfg.llama.max_seq_len, 1 << 30))
            buckets = list(range(_GRAIN, limit + 1, _GRAIN))
        else:
            buckets = sorted({_bucket(max(int(p), 1), self.max_len) for p in prompt_lens})
        rng_state = self.generator.get_state()
        n = 0
        size = self.cfg.vision.image_size
        pv = torch.zeros((1, self.cfg.num_event_frames, 3, size, size), dtype=self._dtype,
                         device=self.device)
        eventchat.encode_events_batch(self.params, self.cfg, pv)
        n += 1
        d = self.cfg.llama.hidden_size
        for s1 in buckets:
            padded = torch.zeros((1, s1, d), dtype=self._dtype, device=self.device)
            mask = torch.ones((1, s1), dtype=torch.bool, device=self.device)
            row_cache = self._new_row_cache(s1)
            row_logits = llama_mod.prefill(self.params["llama"], self.cfg.llama, padded, mask,
                                           row_cache, last_only=True,
                                           return_hidden=self.draft_head is not None,
                                           mesh=self.mesh)[0]
            n += 1
            if self.prefill_chunk:
                _chunk_prefill(self.params, self.cfg, padded, self._new_row_cache(s1), 0, 1, 0,
                               self.prefill_chunk, self.mesh)
                n += 1
            if self._paged:
                # Every destination is the drop sentinel: no pool block is
                # written; row 0's table stays the scratch block.
                _admit_row_paged(self.cache, self.logits, 0,
                                 np.full((s1 // self._kv_block_size,), self._pool.n_blocks,
                                         np.int32),
                                 np.full((self._nbpr,), SCRATCH_BLOCK, np.int32), row_cache,
                                 row_logits)
            else:
                _admit_row(self.cache, self.logits, 0, row_cache, row_logits)
            n += 1
        # The dummy row's frozen writes then land far from the edge.
        self.cache["length"].zero_()
        frozen = torch.ones((self.max_batch,), dtype=torch.bool, device=self.device)
        zeros = torch.zeros((self.max_batch,), dtype=torch.int32, device=self.device)
        carry = (frozen, zeros, zeros if self.speculative else None)
        chunks = [None] + ([self.first_chunk] if self.first_chunk else [])
        windows = list(self.spec_windows) if self.spec_windows else [None]
        mixed = [False]
        if self.prefill_budget:
            self._ensure_lane_buffers(buckets[-1])
            mixed.append(True)
        for warm_mixed in mixed:
            for ck in chunks:
                for w in windows:
                    rec = self._dispatch_segment(ck, carry=carry, record=False,
                                                 warm_mixed=warm_mixed, window=w)
                    if rec["event"] is not None:
                        rec["event"].synchronize()
                    n += 1
        self._dev_carry = None
        if self._prefix_cache is not None and self._prefix_cache.n_entries:
            dummy_pv = np.zeros((self.cfg.num_event_frames, 3, size, size), np.float32)
            shapes = set()
            for entry in self._prefix_cache.entries():
                key = (entry.bucket, entry.has_event, entry.length)
                if key in shapes:
                    continue
                dummy = [0] if entry.has_event else [EVENT_TOKEN_INDEX]
                if self._prefix_admit(entry, dummy_pv, dummy, record=False) is not None:
                    shapes.add(key)
                    n += 1
        self.generator.set_state(rng_state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def submit(self, input_ids: Sequence[int], pixel_values, max_new_tokens: int = 64,
               deadline_s: Optional[float] = None, slo: Optional[SLO] = None,
               t_submit: Optional[float] = None) -> int:
        """Enqueue one request; raises at once if it cannot fit, so one bad
        request never tears down the serving loop mid-drain.

        ``deadline_s``: seconds from now after which the request finishes
        with ``STATUS_DEADLINE`` and the tokens committed so far. ``slo``:
        its class and targets (``workload.SLO``), scored at finish; the
        class must be one of ``SLO_CLASSES``. Raises ``QueueFullError``
        when the queue is at ``max_queue``. ``t_submit`` is the stamp of a
        replayed submit (``cli/serve.MeshLeader`` carries rank 0's clock);
        without it a mesh agrees rank 0's stamp where a deadline needs
        one."""
        if slo is not None and slo.name not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {slo.name!r}: one of {SLO_CLASSES} (class "
                             f"names are metric labels and must stay a closed set)")
        if self.max_queue and len(self.queue) >= self.max_queue:
            raise QueueFullError(f"admission queue is full ({len(self.queue)}/"
                                 f"{self.max_queue} requests queued); retry later")
        ids = list(input_ids)
        n_ev = sum(1 for t in ids if t == EVENT_TOKEN_INDEX)
        if n_ev != 1:
            raise ValueError(f"prompt must contain exactly one {EVENT_TOKEN_INDEX} event "
                             f"sentinel, got {n_ev}")
        prompt_len = min(len(ids) - 1 + self.cfg.num_event_tokens,
                         self.cfg.llama.max_seq_len)
        # A finished row's frozen writes land one slot (a speculative
        # row's: one verify window) past its last commit: they must stay
        # inside the row.
        slack = 1 + self.spec_max
        if prompt_len + max_new_tokens + slack > self.max_len:
            raise ValueError(f"request does not fit: prompt {prompt_len} + budget "
                             f"{max_new_tokens} exceeds server max_len {self.max_len}")
        if self._paged:
            need = self._blocks_needed(prompt_len, max_new_tokens)
            if need > self._pool.usable:
                raise ValueError(f"request does not fit: needs {need} KV blocks, the pool "
                                 f"holds {self._pool.usable} (raise --kv_pool_blocks)")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, ids, pixel_values, max_new_tokens)
        req.prompt_len = prompt_len
        req.slo = slo
        if t_submit is not None:
            req.t_submit = float(t_submit)
        else:
            req.t_submit = self._now() if deadline_s is not None else time.perf_counter()
        if deadline_s is not None:
            req.deadline = req.t_submit + float(deadline_s)
            self._n_deadlines += 1
        self.queue.append(req)
        obs_metrics.SERVE_QUEUE_DEPTH.set(len(self.queue))
        slo_field = {"slo_class": slo.name} if slo is not None else {}
        obs_trace.async_begin("queued", rid, prompt_len=prompt_len, budget=max_new_tokens,
                              **slo_field)
        obs_journey.begin(self._journey_owner, rid, t=req.t_submit, prompt_len=prompt_len,
                          budget=max_new_tokens, **slo_field)
        obs_series.note_submit()
        return rid

    @torch.inference_mode()
    def cancel(self, rid: int) -> bool:
        """Cancel a queued, pending, piggybacked or in-flight request: it
        leaves the queue or its row is freed, and it finishes under
        ``STATUS_CANCELLED`` with the tokens it committed. False when the
        rid is unknown or finished."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._record_finish(req, STATUS_CANCELLED)
                return True
        if self._pending is not None and self._pending.req.rid == rid:
            p, self._pending = self._pending, None
            self.rows[p.row] = None  # the row stays frozen; the cache is untouched
            self._record_finish(p.req, STATUS_CANCELLED)
            return True
        for lane in self._lanes:
            if lane.req.rid == rid:
                self._drop_lane(lane)
                self._record_finish(lane.req, STATUS_CANCELLED)
                return True
        for r, req in enumerate(self.rows):
            if req is not None and req.rid == rid:
                # Settle the in-flight segment first: the forced finish
                # applies at the dispatch boundary, with that segment's
                # tokens kept.
                self._drain()
                if self.rows[r] is not req:
                    return False  # the drained segment finished the row
                self._finish_row(r, status=STATUS_CANCELLED)
                return True
        return False

    def run_until_drained(self) -> Dict[int, List[int]]:
        while self.queue or any(r is not None for r in self.rows):
            self.step()
        # A trailing all-frozen segment can still be in flight.
        self._drain()
        out, self.finished = self.finished, {}
        return out

    @torch.inference_mode()
    def export_requests(self, journey_status: str = "exported") -> List[Dict[str, Any]]:
        """The drain seam: settle the pipeline, then strip every unfinished
        request (active rows, lanes, the pending chunked admission, the
        queue) out of the scheduler and return their re-admission records
        in rid order: ids, pixels, budget, the remaining deadline headroom
        and the SLO. Committed tokens are dropped (a survivor re-decodes
        from the prompt; greedy chains are deterministic per row). Pool
        blocks, spill runs and prefix pins are released in the JAX
        batcher's order, and every block table is reset to scratch.
        Nothing reaches ``finished``: the requests are moving, not over.
        Their journeys here close as ``journey_status`` (the engine's
        breaker trip, which fails them, passes ``engine_fault``)."""
        self._drain()
        by_rid: Dict[int, _Request] = {}
        for req in self.queue:
            by_rid[req.rid] = req
        self.queue.clear()
        if self._pending is not None:
            p, self._pending = self._pending, None
            self.rows[p.row] = None
            by_rid[p.req.rid] = p.req
        for lane in self._lanes:
            self.rows[lane.row] = None  # the lane KV is dead storage
            if lane.entry is not None:
                self._drain_entry_pin(lane.entry)
            by_rid[lane.req.rid] = lane.req
        self._lanes = []
        self._lane_free = list(range(self._lane_cap))
        for r, req in enumerate(self.rows):
            if req is None:
                continue
            self.rows[r] = None
            self.frozen[r] = True
            self.n_rem[r] = 0
            by_rid[req.rid] = req
        self._dev_carry = None
        # The headroom each record carries is read on the agreed clock.
        now = (self._now() if any(r.deadline is not None for r in by_rid.values())
               else time.perf_counter())
        out: List[Dict[str, Any]] = []
        for rid in sorted(by_rid):
            req = by_rid[rid]
            if self._paged:
                req.kv_bt_written = False  # every table resets below
                self._paged_release(req)
                self._drop_spill(req)
            if req.prefix_entry is not None:
                self._drain_entry_pin(req.prefix_entry)
                req.prefix_entry = None
            if req.deadline is not None:
                self._n_deadlines -= 1
            if self._spec_ctl is not None:
                self._spec_ctl.forget(req.rid)
            # Not over but moving: this server's timeline closes as
            # "exported" (finish_status is never written).
            if journey_status == "exported":
                obs_trace.async_end(req.phase, req.rid, status="exported")
                obs_journey.event(self._journey_owner, req.rid, "exported", t=now)
            obs_journey.finish(self._journey_owner, req.rid, journey_status,
                               t_submit=req.t_submit, t_done=now,
                               slo_class=req.slo.name if req.slo is not None else None)
            out.append({"rid": req.rid, "input_ids": list(req.input_ids),
                        "pixel_values": req.pixel_values, "max_new_tokens": req.max_new_tokens,
                        "deadline_s": req.deadline - now if req.deadline is not None else None,
                        "slo": req.slo})
        if self._paged:
            self.cache["bt"].zero_()
        obs_metrics.SERVE_QUEUE_DEPTH.set(0)
        obs_metrics.SERVE_ACTIVE_ROWS.set(0)
        return out

    def abort_pipeline(self) -> None:
        """Discard the in-flight segment and the device carry (the engine's
        fault path): the dangling dispatch's outputs are ignored, and the
        next dispatch uploads the host's view."""
        self._inflight = None
        self._dev_carry = None

    @torch.inference_mode()
    def abort_rows(self) -> List[int]:
        """Free every row, lane and pending admission without finishing its
        request (the engine's fault path fails those requests itself; their
        journeys close here as ``engine_fault``); returns their rids. Pool
        blocks and prefix pins are returned. A spilled victim waits in the
        queue, which stays: its run and record stay restorable."""
        t_sweep = time.perf_counter()
        for req in self.rows:  # lanes and the pending admission hold rows too
            if req is not None:
                obs_journey.finish(self._journey_owner, req.rid, "engine_fault",
                                   t_submit=req.t_submit, t_done=t_sweep,
                                   slo_class=req.slo.name if req.slo is not None else None)
        self.abort_pipeline()
        self._pending = None  # its row is among the rows below
        rids = []
        for lane in list(self._lanes):
            self._drop_lane(lane)
            rids.append(lane.req.rid)
            if lane.req.deadline is not None:
                self._n_deadlines -= 1
        for r, req in enumerate(self.rows):
            if req is None:
                continue
            if self._spec_ctl is not None:
                self._spec_ctl.forget(req.rid)
            if self._paged:
                self._paged_release(req)
            if req.prefix_entry is not None:
                self._drain_entry_pin(req.prefix_entry)
                req.prefix_entry = None
            if req.deadline is not None:
                self._n_deadlines -= 1
            self.rows[r] = None
            self.frozen[r] = True
            self.n_rem[r] = 0
            rids.append(req.rid)
        return rids

    def pool_stats(self) -> Optional[Dict[str, Any]]:
        """The block pool's snapshot with the deferral and preemption
        counts (paged only)."""
        if not self._paged:
            return None
        return {**self._pool.stats(), "deferrals": self.block_deferrals,
                "preemptions": self.preemptions}

    def spill_stats(self) -> Optional[Dict[str, Any]]:
        """The spill store's snapshot and whether preemption is armed
        (paged only)."""
        if not self._paged:
            return None
        return {**self._spill_store.stats(), "preempt": self.preempt}

    # -- the prefix-KV cache ----------------------------------------------

    @torch.inference_mode()
    def set_prefix(self, input_ids: Sequence[int], pixel_values=None) -> int:
        """Prefill a shared prompt prefix once and insert it into the
        prefix cache (an insert, beside the entries admission prefill adds).
        A text prefix (the system-prompt head) serves suffixes that carry
        the event sentinel; a prefix through the event block
        (``pixel_values`` given) serves plain-text suffixes over that one
        stream. Returns the prefix length in cache positions."""
        if self._prefix_cache is None:
            raise RuntimeError("prefix cache is disabled (prefix_cache=False); set_prefix "
                               "has nowhere to insert")
        ids = list(input_ids)
        n_ev = sum(1 for t in ids if t == EVENT_TOKEN_INDEX)
        if n_ev > 1:
            raise ValueError(f"prefix may contain at most one event sentinel, got {n_ev}")
        if n_ev == 1 and pixel_values is None:
            raise ValueError("prefix contains the event sentinel; pixel_values is required")
        if n_ev == 1:
            ev = eventchat.encode_events_batch(self.params, self.cfg,
                                               self._pixels(pixel_values)[None])
            embeds = [eventchat.splice_embeddings(self.params, self.cfg, split_at_event(ids),
                                                  ev[0], mesh=self.mesh)]
        else:
            tok = _h2d(np.asarray(ids, np.int64), self.device)
            embeds = [llama_mod.embed_tokens(self.params["llama"], tok, self.mesh)]
        padded, mask, lens = eventchat._pad_batch(embeds)
        p_len = int(lens[0])
        if p_len + SEQ_BUCKET > self.max_len:
            raise ValueError(f"prefix ({p_len} positions) does not fit server max_len "
                             f"{self.max_len} with room for a suffix")
        s1p = _bucket(p_len, self.max_len)
        padded = F.pad(padded, (0, 0, 0, s1p - p_len))
        mask = F.pad(mask, (0, s1p - p_len))
        row_cache = self._new_row_cache(s1p)
        llama_mod.prefill(self.params["llama"], self.cfg.llama, padded, mask, row_cache,
                          last_only=True, mesh=self.mesh)
        self._count_dispatch("prefix_set")
        blocks = None
        kv = {"k": row_cache["k"], "v": row_cache["v"]}
        if self._paged:
            # The operator entry owns its block run (refcount 1 from the
            # cache); admissions alias it like any other entry.
            nblk = s1p // self._kv_block_size
            blocks = self._pool.alloc(nblk)
            if blocks is None:
                self._prefix_cache.reclaim_blocks(self._pool, nblk)
                blocks = self._pool.alloc(nblk)
            if blocks is None:
                raise ValueError(f"prefix entry needs {nblk} pool blocks; only "
                                 f"{self._pool.free_blocks()} free (raise --kv_pool_blocks)")
            dst = np.asarray(blocks, np.int32)
            _pool_scatter(self.cache["k"], dst, row_cache["k"])
            _pool_scatter(self.cache["v"], dst, row_cache["v"])
            kv = None
        entry = _PrefixEntry(ids=tuple(ids),
                             pixels_key=_pixels_key(pixel_values) if n_ev == 1 else None,
                             has_event=n_ev == 1, kv=kv, blocks=blocks, length=p_len,
                             bucket=s1p, nbytes=s1p * self._kv_pos_bytes)
        if not self._prefix_cache.insert(entry):
            if blocks:
                self._pool.decref(blocks)
            raise ValueError(f"prefix entry ({entry.nbytes} bytes at bucket {s1p}) exceeds "
                             f"the prefix-cache budget {self._prefix_cache.budget} (raise "
                             f"--prefix_cache_mb)")
        return p_len

    def reset_prefix_cache(self) -> None:
        """Swap in a fresh cache of the same budget; the old entries' blocks
        are released under the deferred-on-pins rule. The supported reset:
        replacing ``_prefix_cache`` by hand would strand a paged cache's
        blocks."""
        if self._prefix_cache is None:
            return
        old = self._prefix_cache
        old.clear()
        # The old cache's key moves aside: its release at collection must
        # not drop the new cache's entry (the same owner-derived key).
        old._mem_key = f"{self._mem_owner}/prefix_cache_dropped{id(old):x}"
        self._prefix_cache = PrefixCache(old.budget)
        self._prefix_cache._mem_key = f"{self._mem_owner}/prefix_cache"
        if self._paged:
            self._prefix_cache.pool = self._pool

    def prefix_cache_stats(self) -> Dict[str, Any]:
        """Prefix-KV cache snapshot (``GET /prefix_cache``)."""
        if self._prefix_cache is None:
            return {"enabled": False}
        return {"enabled": True, "insert_on_prefill": self.prefix_insert,
                **self._prefix_cache.stats()}

    # -- telemetry surfaces -----------------------------------------------

    def journey(self, rid: int) -> Optional[Dict[str, Any]]:
        """One request's flight-recorder timeline and, once finished, its
        phase decomposition and dominant cause (``GET /request?rid=N``);
        None when the recorder is disarmed or the rid left its ring."""
        return obs_journey.get(self._journey_owner, rid)

    def journey_index(self, n: int = 64) -> List[Dict[str, Any]]:
        """Recent finished requests, newest first (``GET /requests``)."""
        return obs_journey.index(self._journey_owner, n)

    def memory_summary(self) -> Dict[str, Any]:
        """The cheap ledger view (host ints; ``/stats``' ``memory``): the
        process totals, this server's components, the guard's state and,
        paged, the pool and the spill store."""
        s = obs_memory.LEDGER.summary()
        s["owner"] = obs_memory.LEDGER.snapshot(self._mem_owner)
        s["guard"] = {"headroom_bytes": self.mem_headroom_bytes,
                      "capacity_bytes": self._mem_capacity, "deferrals": self.mem_deferrals}
        if self._paged:
            s["kv_blocks"] = self.pool_stats()
            s["spill"] = self.spill_stats()
        return s

    def _tree_bytes(self, params) -> int:
        """The weight tree's bytes: the tree's own, or on a mesh whose ranks
        hold shards the whole model's (the port's meta-device init at the
        tree's weight types), which a one-device batcher holds."""
        if self.mesh is None or max(self.mesh.shape.values()) == 1:
            return _nbytes(params)
        layer = params["llama"]["layers"][0]
        leaves = [v.get("w", v) if isinstance(v, dict) else v for v in layer.values()]
        quant = ("int4" if any(isinstance(v, dict) and "q4" in v for v in leaves)
                 else "int8" if any(isinstance(v, dict) and "q" in v for v in leaves) else "bf16")
        dtype_bytes = params["llama"]["embed_tokens"].element_size()
        return obs_memory.abstract_params_bytes(self.cfg, quant, dtype_bytes)

    def memory_estimate(self) -> Dict[str, Any]:
        """The static capacity model at this server's config
        (``obs.memory.estimate``), which equals its live buffers; on a mesh
        the whole model's, with its ``per_device`` view."""
        mesh_shape = dict(self.mesh.shape) if self.mesh is not None else None
        return obs_memory.estimate(
            self.cfg, max_batch=self.max_batch, max_len=self.max_len, kv_quant=self.kv_quant,
            dtype_bytes=torch.finfo(self._dtype).bits // 8,
            speculative=self.spec_max, prefill_budget=self.prefill_budget,
            prefill_lane_chunk=self._lane_chunk, lane_bucket=self._lane_bucket or None,
            prefix_cache_bytes=self._prefix_cache.budget if self._prefix_cache is not None else 0,
            weights_bytes=self._tree_bytes(self.params), vocab=self.logits.shape[1],
            kv_layout=self.kv_layout, kv_pool_blocks=self._pool.n_blocks if self._paged else 0,
            kv_block_size=self._kv_block_size if self._paged else 0, mesh_shape=mesh_shape,
            spill_capacity_bytes=self._spill_store.capacity_bytes if self._paged else 0)

    def memory_stats(self) -> Dict[str, Any]:
        """The ``GET /memory`` payload: the summary, a fresh reconciliation
        against the device's allocated bytes, the static estimate and the
        compiled footprint (unavailable in eager PyTorch)."""
        out = self.memory_summary()
        out["reconcile"] = obs_memory.LEDGER.reconcile(self.device)
        out["estimate"] = self.memory_estimate()
        out["compiled"] = self.compiled_footprint()
        return out

    def compiled_footprint(self) -> Dict[str, Any]:
        """The JAX batcher's XLA footprint of its segment executable; the
        port's segments are eager, so the probe reports it unavailable."""
        return {"segment": "spec" if self.speculative else "decode", "chunk": self.chunk,
                **obs_memory.compiled_stats()}

    def _req_pixels_key(self, req: _Request) -> Optional[bytes]:
        if req.pixel_values is None:
            return None
        if req.pixels_key is None:
            req.pixels_key = _pixels_key(req.pixel_values)
        return req.pixels_key

    def _prefix_lookup(self, req) -> Optional[tuple]:
        """(entry, suffix_ids) of the deepest compatible entry for ``req``'s
        prompt, or None (full prefill). The wrong-stream guard lives in
        ``PrefixCache.lookup``."""
        pc = self._prefix_cache
        if pc is None or pc.n_entries == 0:
            return None
        pk = self._req_pixels_key(req) if isinstance(req, _Request) else (
            None if req.pixel_values is None else _pixels_key(req.pixel_values))
        ids = list(req.input_ids)
        entry = pc.lookup(ids, pk)
        if entry is None:
            return None
        return entry, ids[len(entry.ids):]

    def _prefix_fit(self, entry: _PrefixEntry, suffix_ids) -> Optional[tuple]:
        """(suf_len, prompt_len, chunk, s1) of a suffix admission against
        ``entry``, or None when the row bucket cannot hold the entry block
        and the padded suffix (full prefill instead)."""
        p_len = entry.length
        if entry.has_event:
            suf_len = len(suffix_ids)
        else:
            suf_len = (sum(1 for t in suffix_ids if t != EVENT_TOKEN_INDEX)
                       + self.cfg.num_event_tokens)
        prompt_len = p_len + suf_len
        chunk = (suf_len + SEQ_BUCKET - 1) // SEQ_BUCKET * SEQ_BUCKET
        s1 = _bucket(max(prompt_len, p_len + chunk), self.max_len)
        if p_len + chunk > s1 or s1 < entry.bucket:
            return None
        return suf_len, prompt_len, chunk, s1

    def _suffix_embed(self, entry: _PrefixEntry, pixel_values, suffix_ids, chunk: int,
                      suf_len: int):
        """(1, chunk, D) padded suffix embeddings: a through-event entry's
        suffix is plain text (no CLIP); a text entry's suffix carries the
        sentinel and pays its own encode."""
        if entry.has_event:
            tok = _h2d(np.asarray([suffix_ids], np.int64), self.device)
            emb = llama_mod.embed_tokens(self.params["llama"], tok, self.mesh)
        else:
            ev = eventchat.encode_events_batch(self.params, self.cfg,
                                               self._pixels(pixel_values)[None])
            emb = eventchat.splice_embeddings(self.params, self.cfg,
                                              split_at_event(suffix_ids), ev[0],
                                              mesh=self.mesh)[None]
        assert emb.shape[1] == suf_len, (emb.shape, suf_len)
        return F.pad(emb, (0, 0, 0, chunk - suf_len))

    def _entry_kv(self, entry: _PrefixEntry) -> Dict[str, Any]:
        """The entry's dense (L, 1, bucket) K/V: its copies (dense) or a
        gather of its pool blocks (paged)."""
        if entry.kv is not None:
            return entry.kv
        k, v = _gather_blocks(self.cache, entry.blocks)
        return {"k": k, "v": v}

    def _drain_entry_pin(self, entry: _PrefixEntry) -> None:
        """Drop one pin; the last drain of a detached paged entry releases
        its block run."""
        entry.pins -= 1
        if entry.pins <= 0 and entry.detached and entry.blocks and self._pool is not None:
            self._pool.decref(entry.blocks)
            entry.blocks = None
            entry.detached = False

    def _prefix_admit(self, entry: _PrefixEntry, pixel_values, suffix_ids,
                      record: bool = True):
        """Suffix-only admission against one entry: (row_cache, row_logits,
        row_hidden, prompt_len), or None when ``_prefix_fit`` refuses.
        ``record=False`` (warmup) leaves the dispatch counts alone."""
        fit = self._prefix_fit(entry, suffix_ids)
        if fit is None:
            return None
        suf_len, prompt_len, chunk, s1 = fit
        t0 = time.perf_counter()
        emb = self._suffix_embed(entry, pixel_values, suffix_ids, chunk, suf_len)
        if record:
            # The entry copy is a fault site: a fault here lands with a row
            # reserved and the entry about to be read.
            faults.maybe_fail("serve.prefix_copy")
            faults.maybe_delay("serve.prefix_copy")
        row_cache = self._new_row_cache(s1)
        ekv = self._entry_kv(entry)
        last, hidden = _prefix_prefill(
            self.params, self.cfg, ekv["k"], ekv["v"],
            _h2d(np.asarray([entry.length], np.int32), self.device), row_cache, emb,
            _h2d(np.asarray([prompt_len], np.int32), self.device),
            _h2d(np.asarray([suf_len - 1], np.int64), self.device), self.mesh)
        if record:
            self._count_dispatch("suffix")
            tr = obs_trace.active()
            if tr is not None:
                tr.complete("prefix_copy", t0, time.perf_counter(), cat="sched",
                            args={"plen": entry.length, "suffix": suf_len})
        return row_cache, last, hidden, prompt_len

    @torch.inference_mode()
    def _admit_suffix_wave(self, members: List[tuple]) -> None:
        """Batched suffix admission: N prefix hits of one padded (chunk, s1)
        shape run one stacked entry copy + ``decode_kstep``, scattered
        into the shared cache like ``_admit_wave``. The entries may differ
        per member. Members: (req, row, entry, suffix_ids, fit)."""
        n = len(members)
        nb = 1 << (n - 1).bit_length()
        _, _, chunk, s1 = members[0][4]
        for m in members:
            self._prefix_cache.count_hit(m[2])
        faults.maybe_fail("serve.prefix_copy")
        faults.maybe_delay("serve.prefix_copy")
        t0 = time.perf_counter()
        s_pre = max(m[2].bucket for m in members)

        def stack(blocks):
            def pad(buf):
                return F.pad(buf, (0, 0) * (buf.ndim - 3) + (0, s_pre - buf.shape[2]))
            padded = [_planes(b, pad) for b in blocks]
            padded += [padded[0]] * (nb - n)  # pad slots reuse the first block
            if isinstance(padded[0], dict):
                return {p: torch.cat([b[p] for b in padded], dim=1) for p in ("q", "s")}
            return torch.cat(padded, dim=1)

        ekvs = [self._entry_kv(m[2]) for m in members]
        wave_pk = stack([kv["k"] for kv in ekvs])
        wave_pv = stack([kv["v"] for kv in ekvs])
        embs = [self._suffix_embed(m[2], m[0].pixel_values, m[3], chunk, m[4][0])
                for m in members]
        emb = torch.cat(embs + [torch.zeros_like(embs[0])] * (nb - n), dim=0)
        plen = _h2d(np.asarray([m[2].length for m in members] + [1] * (nb - n), np.int32),
                    self.device)
        new_len = _h2d(np.asarray([m[4][1] for m in members] + [1] * (nb - n), np.int32),
                       self.device)
        last_idx = _h2d(np.asarray([m[4][0] - 1 for m in members] + [0] * (nb - n), np.int64),
                        self.device)
        row_cache = self._new_row_cache(s1, batch=nb)
        last, hidden = _prefix_prefill(self.params, self.cfg, wave_pk, wave_pv, plen, row_cache,
                                       emb, new_len, last_idx, self.mesh)
        self._count_dispatch("suffix_wave")
        tr = obs_trace.active()
        if tr is not None:
            tr.complete("prefix_copy", t0, time.perf_counter(), cat="sched", args={"wave": n})
        self._scatter_wave([(m[0], m[1]) for m in members], row_cache, last, hidden,
                           [m[4][1] for m in members], entries=[m[2] for m in members],
                           path="suffix_wave")
        for m in members:
            # Selection pins drain once the wave read every entry.
            self._drain_entry_pin(m[2])

    def _insert_prefix_on_prefill(self, req: _Request, row_cache, src_row: int = 0) -> None:
        """After an admission that prefilled a whole prompt, insert its
        reusable heads: the TEXT head before the sentinel (any stream) and
        the head THROUGH the event block (this stream). Repeat heads
        dedupe on the exact key. Paged entries alias the row's blocks over
        [0, bucket) -- one incref, no copy; dense entries copy."""
        pc = self._prefix_cache
        if pc is None or not self.prefix_insert:
            return
        ids = list(req.input_ids)
        if EVENT_TOKEN_INDEX not in ids:
            return
        sent = ids.index(EVENT_TOKEN_INDEX)
        heads = []
        if sent >= 1:
            heads.append((tuple(ids[:sent]), None, False, sent))
        if req.pixel_values is not None:
            heads.append((tuple(ids[:sent + 1]), self._req_pixels_key(req), True,
                          sent + self.cfg.num_event_tokens))
        for hid, pk, has_ev, hlen in heads:
            if hlen + SEQ_BUCKET > self.max_len:
                continue  # no room for any suffix
            if pc.get(hid, pk) is not None:
                continue  # already cached
            bucket = _bucket(hlen, self.max_len)
            nbytes = bucket * self._kv_pos_bytes
            if pc.budget and nbytes > pc.budget:
                continue  # would be refused: skip the copy
            if self._paged:
                # Positions < hlen are never rewritten; the creator's own
                # writes above hlen in the tail block are masked from every
                # consumer, which pins length = hlen.
                nblk = bucket // self._kv_block_size
                run = (req.kv_blocks_aliased + req.kv_blocks_owned)[:nblk]
                if len(run) < nblk:
                    continue
                self._pool.incref(run)
                if not pc.insert(_PrefixEntry(ids=hid, pixels_key=pk, has_event=has_ev,
                                              kv=None, blocks=run, length=hlen, bucket=bucket,
                                              nbytes=nbytes)):
                    self._pool.decref(run)
                continue
            k, v = _slice_prefix_block(row_cache["k"], row_cache["v"], src_row, bucket)
            pc.insert(_PrefixEntry(ids=hid, pixels_key=pk, has_event=has_ev,
                                   kv={"k": k, "v": v}, length=hlen, bucket=bucket,
                                   nbytes=nbytes))

    # -- scheduler core ---------------------------------------------------

    @torch.inference_mode()
    def step(self) -> None:
        """One scheduling iteration: expire deadlines, admit (or advance a
        chunked or piggybacked admission), dispatch one decode segment,
        harvest. On a mesh the deadline clock is agreed at most once in it
        (``_now``)."""
        self._in_step, self._step_now = True, None
        try:
            self._step()
        finally:
            self._in_step, self._step_now = False, None

    def _step(self) -> None:
        """``step``'s body.

        Pipelined: the segment is dispatched from the device carry first,
        and the PREVIOUS segment is fetched once its first step is launched,
        so the harvest runs while the card computes. Anything that changes
        rows drains the pipeline at the dispatch boundary first; a lane
        joining does not (it reserves a row on the host and touches only
        the lane buffers). Without the pipeline, or while the TTFT ramp
        runs, every segment is harvested in its own step."""
        faults.maybe_fail("serve.step")
        faults.maybe_delay("serve.step")
        piggy = self.prefill_budget > 0 and (len(self._lanes) > 0 or not self.frozen.all())
        if self._inflight is not None and (
                self._deadline_expired()
                or self._pending is not None
                or any(lane.filled >= lane.prompt_len for lane in self._lanes)
                or (self.queue and not piggy and any(r is None for r in self.rows))):
            self._drain()
        self._expire_deadlines()
        t0 = time.perf_counter()
        admitted = self._admit()
        dt = time.perf_counter() - t0
        self.admission_s += dt
        self.admission_max_s = max(self.admission_max_s, dt)
        if admitted:
            # Only boundaries that did admission work are observed.
            obs_metrics.SERVE_ADMISSION.observe(dt)
            tr = obs_trace.active()
            if tr is not None:
                tr.complete("admit", t0, t0 + dt, cat="sched")
        if self.role == "prefill":
            # Admission is the prefill role's whole job: each activated row
            # leaves through the handoff outbox, and nothing is dispatched
            # (so nothing is ever in flight).
            self._handoff_sweep()
            return
        if all(r is None for r in self.rows):
            self._drain()  # a trailing all-frozen segment, if any
            return
        if self.frozen.all() and not self._lanes:
            # Only reserved (pending) rows: nothing to decode yet. The
            # mirror lags only toward more frozen, so the carry is all
            # frozen too. Live lanes fall through: the mixed dispatch
            # advances them alone, with no decode step and no verify
            # (``_dispatch_segment``'s ``run``).
            self._drain()
            return
        chunk = self.chunk
        ramp = self.first_chunk > 0 and any(
            req is not None and not self.frozen[r] and req.t_first is None
            for r, req in enumerate(self.rows))
        if ramp:
            chunk = self.first_chunk
        t0 = time.perf_counter()
        prev, self._inflight = self._inflight, None
        rec = self._dispatch_segment(chunk, prev)
        if self.pipeline and not ramp:
            self._inflight = rec
        else:
            self._harvest_segment(rec)
        self.decode_s += time.perf_counter() - t0

    # A harvest point: the host waits here.
    def _drain(self) -> None:
        """Harvest the in-flight segment, if any: afterwards the host mirror
        of frozen/n_rem is settled and rows may be changed."""
        if self._inflight is not None:
            rec, self._inflight = self._inflight, None
            self._harvest_segment(rec)

    def _now(self) -> float:
        """The clock of deadlines: ``perf_counter``; on a mesh rank 0's,
        agreed once a step (read first where a deadline is queued or live)
        and once a call outside ``step``, so that every rank expires,
        orders victims and exports headroom alike."""
        if self.mesh is None or self.mesh.control is None:
            return self._clock()
        if self._step_now is not None:
            return self._step_now
        now = self.mesh.agree(self._clock())
        if self._in_step:
            self._step_now = now
        return now

    def _tripped(self, site: str) -> bool:
        """A fault drawn at ``site``: on a mesh, a trip on any rank is taken
        by every rank."""
        try:
            faults.maybe_fail(site)
            faults.maybe_delay(site)
            tripped = False
        except faults.InjectedFault:
            tripped = True
        return tripped if self.mesh is None else self.mesh.agree_max(int(tripped)) > 0

    def _deadline_expired(self) -> bool:
        """Does any live deadline need a forced finish this step? (Gates the
        pipeline drain: deadline-less traffic never serializes on it.)"""
        if self._n_deadlines <= 0:
            return False
        now = self._now()

        def expired(req):
            return req.deadline is not None and now > req.deadline

        return (any(expired(q) for q in self.queue)
                or (self._pending is not None and expired(self._pending.req))
                or any(req is not None and expired(req) for req in self.rows))

    def _expire_deadlines(self) -> None:
        """Forced finish of every request past its deadline: queued ones
        leave the queue, a pending admission or a lane is dropped (its row
        freed), active rows are frozen mid-decode -- each with
        ``STATUS_DEADLINE`` and its committed tokens."""
        if self._n_deadlines <= 0:
            return
        now = self._now()

        def expired(req):
            return req.deadline is not None and now > req.deadline

        if any(expired(q) for q in self.queue):
            keep = deque()
            for req in self.queue:
                if expired(req):
                    self._record_finish(req, STATUS_DEADLINE)
                else:
                    keep.append(req)
            self.queue = keep
        if self._pending is not None and expired(self._pending.req):
            p, self._pending = self._pending, None
            self.rows[p.row] = None
            self._record_finish(p.req, STATUS_DEADLINE)
        for lane in [x for x in self._lanes if expired(x.req)]:
            # No drain needed: the lane never touched the decode carry.
            self._drop_lane(lane)
            self._record_finish(lane.req, STATUS_DEADLINE)
        for r, req in enumerate(self.rows):
            if req is not None and not self.frozen[r] and expired(req):
                # Settle an in-flight segment first and re-check: its
                # harvest may have finished the row.
                self._drain()
                if self.rows[r] is req and not self.frozen[r]:
                    self._finish_row(r, status=STATUS_DEADLINE)

    def _spec_boundary(self, forced: Optional[int] = None, mixed: bool = False,
                       record: bool = True) -> tuple:
        """This boundary's speculation window and per-row depth tensor. A
        fixed-K server returns (K, None). An adaptive one asks the
        ``SpecController`` (or takes ``forced``: warmup running one
        bucket) and always passes a depth tensor. ``record=False``
        (warmup) counts nothing."""
        if self._spec_ctl is None:
            w = forced if forced is not None else self.speculative
            depth = None
            masked = 0
        else:
            w = forced
            depths = None
            masked = 0
            if w is None:
                try:
                    # The choice is a fault site: a trip takes the fixed
                    # default window at full depth for this boundary.
                    faults.maybe_fail("serve.spec_adapt")
                    faults.maybe_delay("serve.spec_adapt")
                    live = sum(1 for r, req in enumerate(self.rows)
                               if req is not None and not self.frozen[r])
                    w = self._spec_ctl.select_window(live_rows=live, mixed=mixed)
                    depths, masked = self._spec_ctl.depths(
                        [req.rid if req is not None else None for req in self.rows], w)
                except faults.InjectedFault:
                    w, depths, masked = self._spec_ctl.default_window, None, 0
            if depths is None:
                depths = [w - 1] * self.max_batch
            depth = _h2d(np.asarray(depths, np.int32), self.device)
        if record:
            self.spec_dispatches += 1
            self.spec_depth_sum += w
            self.spec_masked_rows += masked
            self.spec_depth_trace.append(w)
            obs_metrics.SERVE_SPEC_DEPTH.observe(w)
            if masked:
                obs_metrics.SERVE_SPEC_MASKED.inc(masked)
            if w != self._spec_last_window:
                # A window switch lands in every live row's timeline.
                self._spec_last_window = w
                for r, req in enumerate(self.rows):
                    if req is not None and not self.frozen[r]:
                        obs_journey.event(self._journey_owner, req.rid, "spec_depth", window=w)
        return w, depth

    def _dispatch_segment(self, chunk: Optional[int] = None, prev: Optional[dict] = None,
                          carry: Optional[tuple] = None, record: bool = True,
                          warm_mixed: bool = False, window: Optional[int] = None) -> dict:
        """Dispatch one decode or speculative segment (a mixed one with
        live lanes) on the resident state and advance the device carry,
        without waiting for the card; ``prev``, the segment in flight, is
        harvested once this one's first step is launched. Returns the
        in-flight record ``_harvest_segment`` consumes: host copies of the
        outputs, started now, and their event.

        Warmup passes an all-frozen ``carry`` with ``record=False`` (the
        resident carry and every counter stay as they are),
        ``warm_mixed`` for the mixed segment with idle lanes, and
        ``window`` for one speculation bucket.

        The dispatch boundary is the ``serve.dispatch`` fault site (not in
        warmup): a fault there lands with ``prev`` possibly in flight, which
        the engine's fault path drops with the device carry. Its pinned host
        buffers are not reused before their copies end (the caching host
        allocator records the copy's stream), and the live-flag buffers are
        written only in stream order. With live lanes the lane boundary is
        the ``serve.mixed_dispatch`` site: a trip re-queues every lane
        (``_requeue_lanes``) and the boundary dispatches a plain segment."""
        chunk = chunk or self.chunk
        if record:
            faults.maybe_fail("serve.dispatch")
            faults.maybe_delay("serve.dispatch")
        harvest_prev = None if prev is None else (lambda: self._harvest_segment(prev))
        if carry is not None:
            frozen, n_rem, base_pos = carry
        elif self._dev_carry is not None:
            frozen, n_rem, base_pos = self._dev_carry
        else:
            # The host changed rows (always drained): the mirror is
            # authoritative.
            frozen = _h2d(self.frozen, self.device)
            n_rem = _h2d(self.n_rem.astype(np.int32), self.device)
            base_pos = (_h2d(self.base_pos.astype(np.int32), self.device)
                        if self.speculative else None)
            self.carry_uploads += 1
        mixed = (warm_mixed or len(self._lanes) > 0) and self._lane_cache is not None
        if mixed and self._lanes:
            try:
                faults.maybe_fail("serve.mixed_dispatch")
                faults.maybe_delay("serve.mixed_dispatch")
            except faults.InjectedFault:
                self._requeue_lanes()
                mixed = False
        # No step and no verify when the host knows every row is frozen: the
        # mirror shows it (it lags only toward more frozen), or the segment
        # before knows that its carry is (its ``all_frozen``, asked here).
        # The JAX loop runs zero iterations there. Warmup's carry runs its
        # step.
        run = carry is not None or not (self.frozen.all() or (
            self._dev_carry is not None and self._dev_carry_frozen()))
        rec = {"chunk": chunk, "wait_at_dispatch": self.device_segment_s}
        if record:
            # Warmup's dispatches stay out of the telemetry as they stay out
            # of the counters. Occupancy: the rows unfrozen on the host.
            obs_metrics.SERVE_SEGMENTS.inc()
            obs_metrics.SERVE_OCCUPANCY.observe(sum(1 for f in self.frozen if not f))
        t_disp0 = time.perf_counter()
        ann = obs_profiling.annotation("serve.segment_dispatch")
        ann.__enter__()
        lane_out = None
        if mixed:
            lane_start, lane_new_len, lane_last_idx, lane_adv, lane_tok = self._lane_args()
            lane_args = (self._lane_embeds, self._lane_cache, lane_start, lane_new_len,
                         lane_last_idx)
        if self.speculative:
            # The window and depth are chosen on the host before the
            # dispatch, from what the harvests so far observed.
            w, depth = self._spec_boundary(window, mixed=mixed and len(self._lanes) > 0,
                                           record=record)
            n_iters = max(1, chunk // w)
            history = (_h2d(self._history.astype(np.int32), self.device)
                       if self._history is not None else None)
            kw = dict(history=history, medusa=self.draft_head, drafts=self.spec_drafts,
                      depth=depth, flags=self._flags, after_first_step=harvest_prev, run=run,
                      mesh=self.mesh)
            head = (self.params, self.cfg, self.cache, self.generator, self.ids_buf, base_pos,
                    frozen, n_rem)
            if mixed:
                out = _mixed_spec_segment(*head, *lane_args, n_iters, w, self._lane_chunk,
                                          self.eos, self.temperature, self.top_p, **kw)
                out, lane_out = out[:12], out[12:]
            else:
                out = _spec_segment(*head, n_iters, w, self.eos, self.temperature, self.top_p,
                                    **kw)
            (n_new, done, iters, frozen_out, n_rem_out, base_pos_out,
             row_acc, row_off, pos_acc, pos_off, steps, all_frozen) = out
            # Only the slots the segment could have written come back
            # (n_iters * window <= max(chunk, window) a row), from the
            # segment's own base.
            new = _gather_new(self.ids_buf, base_pos, max(chunk, w))
            rec["spec"] = True
            host = [new, iters, n_new, done, frozen, row_acc, row_off, pos_acc, pos_off]
        else:
            if mixed:
                out = _mixed_decode_segment(
                    self.params, self.cfg, self.logits, self.cache, self.generator, frozen,
                    n_rem, *lane_args, chunk, self._lane_chunk, self.eos, self.temperature,
                    self.top_p, self._flags, harvest_prev, run, self.mesh)
                out, lane_out = out[:10], out[10:]
            else:
                out = _decode_segment(
                    self.params, self.cfg, self.logits, self.cache, self.generator, frozen,
                    n_rem, chunk, self.eos, self.temperature, self.top_p, self._flags,
                    harvest_prev, run, self.mesh)
            (tokens, n_new, done, fin, self.logits, frozen_out, n_rem_out, lived, steps,
             all_frozen) = out
            base_pos_out = None
            host = [tokens, n_new, done, fin, frozen, lived]
        if lane_out is not None:
            # Lane bookkeeping at dispatch: the advance is deterministic, so
            # the next boundary's lane arguments need no fetch. A finished
            # lane keeps its last logits and hidden on the device.
            lane_last, lane_hidden = lane_out
            for lane, end in lane_adv:
                lane.filled = end
                if lane.filled >= lane.prompt_len:
                    lane.last_logits = lane_last[lane.slot:lane.slot + 1]
                    lane.last_hidden = lane_hidden[lane.slot:lane.slot + 1]
            if record and lane_adv:
                self.mixed_prefill_tokens += lane_tok
                self.mixed_segments += 1
                self._count_dispatch("piggyback")
                obs_metrics.SERVE_MIXED_SEGMENTS.inc()
                obs_metrics.SERVE_MIXED_LANES.observe(len(lane_adv))
                obs_metrics.SERVE_MIXED_PREFILL_TOKENS.inc(lane_tok)
                rec["n_lanes"] = len(lane_adv)
        if record:
            self._dev_carry = (frozen_out, n_rem_out, base_pos_out)
            self._dev_carry_frozen = all_frozen
            self.seg_count += 1
            self.decode_steps_run += steps
            rec["steps"] = steps
        rec["host"], rec["event"] = _fetch_async(host)
        ann.__exit__(None, None, None)
        rec["t_dispatch"] = time.perf_counter()
        tr = obs_trace.active()
        if tr is not None:
            tr.complete("dispatch", t_disp0, rec["t_dispatch"], cat="sched",
                        args={"chunk": chunk})
        return rec

    # A harvest point: the host waits here.
    def _harvest_segment(self, rec: dict) -> None:
        """Fetch one dispatched segment's outputs (the host blocks here) and
        apply the row bookkeeping: commit tokens, stamp the first token,
        decrement budgets, finish EOS / exhausted / non-finite rows -- the
        transitions the segment already applied to the device carry."""
        t_fetch = time.perf_counter()
        if self._t_prev_fetch_end is not None:
            gap = t_fetch - self._t_prev_fetch_end
            self.host_gap_s += gap
            obs_metrics.SERVE_HOST_GAP.inc(gap)
        if rec["event"] is not None:
            rec["event"].synchronize()
        spec = rec.get("spec", False)
        if spec:
            (new_ids, iters, n_new, done, frozen_in, row_acc, row_off, pos_acc,
             pos_off) = (t.numpy() for t in rec["host"])
            tokens = finite = None
        else:
            tokens, n_new, done, finite, frozen_in, lived = (t.numpy() for t in rec["host"])
        t_end = time.perf_counter()
        wait = t_end - t_fetch
        if wait > 1e-4:
            # The card was still busy when the host arrived: the host work
            # since this dispatch (minus its own blocked fetches) was hidden.
            blocked_since = self.device_segment_s - rec["wait_at_dispatch"]
            hidden = max(0.0, t_fetch - rec["t_dispatch"] - blocked_since)
            self.overlap_hidden_s += hidden
            obs_metrics.SERVE_OVERLAP_HIDDEN.inc(hidden)
        self.device_segment_s += wait
        # Observed here, at the harvest, from the clocks just read.
        obs_metrics.SERVE_SEGMENT.observe(wait)
        tr = obs_trace.active()
        if tr is not None:
            tr.complete("segment_fetch", t_fetch, t_end, cat="sched",
                        args={"wait_s": round(wait, 6)})
        self._t_prev_fetch_end = t_end
        self.decode_steps += int(n_new.max(initial=0))
        if spec:
            self.idle_verifies += rec["steps"] - int(iters)
            self.spec_iterations += int(iters)
            self.spec_tokens += int(n_new.sum())
            if self._spec_ctl is not None:
                # The segment's uncapped acceptance feeds the next boundary's
                # choice (pipelined: one boundary later, deterministically).
                self._spec_ctl.observe(
                    [(req.rid, int(row_acc[r]), int(row_off[r]))
                     for r, req in enumerate(self.rows) if req is not None and not frozen_in[r]],
                    [int(x) for x in pos_acc], [int(x) for x in pos_off])
                obs_metrics.SERVE_SPEC_ACCEPT.set(self._spec_ctl.accept_ema or 0.0)
        else:
            self.idle_steps += rec["steps"] - int(lived)
        if rec.get("n_lanes"):
            live = ~frozen_in
            if live.any():
                self.mixed_boundaries += 1
                if int(n_new[live].sum()) == 0:
                    self.mixed_zero_harvests += 1
        now = time.perf_counter()
        for r, req in enumerate(self.rows):
            # frozen_in is the segment's input mask (the host mirror may be
            # a segment ahead): rows frozen at dispatch produced nothing.
            if req is None or frozen_in[r]:
                continue
            if finite is not None and not finite[r]:
                # Non-finite logits poison only this row: its segment
                # tokens are discarded and the request fails.
                self._finish_row(r, status=STATUS_NAN, stale_carry=False)
                continue
            if spec:
                new = new_ids[r, : n_new[r]]
                self.base_pos[r] += int(n_new[r])
            else:
                new = tokens[r, : n_new[r]]
            if len(new):
                obs_journey.event(self._journey_owner, req.rid, "segment", t=now,
                                  tokens=len(new))
                if req.t_first is None:
                    req.t_first = now
                elif req.t_last is not None:
                    # The per-token gap of this harvest interval, weighted by
                    # its tokens (a row's first harvest lies inside its TTFT).
                    obs_metrics.SERVE_ITL.observe((now - req.t_last) / len(new), n=len(new))
                req.t_last = now
                obs_metrics.SERVE_TOKENS.inc(len(new))
            req.tokens.extend(int(t) for t in new)
            self.n_rem[r] -= int(n_new[r])
            if done[r] or self.n_rem[r] <= 0:
                # The carry froze the row on the device already.
                self._finish_row(r, stale_carry=False)

    def _finish_row(self, r: int, status: str = STATUS_OK, stale_carry: bool = True) -> None:
        req = self.rows[r]
        self.rows[r] = None
        self.frozen[r] = True
        self.n_rem[r] = 0
        if stale_carry:
            # A forced finish (deadline, cancel; always drained): the carry
            # no longer matches the host, so the next dispatch uploads.
            # Harvest-driven finishes keep it: the segment froze the row on
            # the device, and dropping the carry would roll it back behind
            # a segment already in flight.
            self._dev_carry = None
        self._record_finish(req, status)

    def _record_finish(self, req: _Request, status: str) -> None:
        if self._paged:
            # The reservation returns on every terminal path, and so do the
            # spill run and record of a request that ends while spilled.
            self._paged_release(req)
            self._drop_spill(req)
        if req.prefix_entry is not None:
            self._drain_entry_pin(req.prefix_entry)
            req.prefix_entry = None
        if req.deadline is not None:
            self._n_deadlines -= 1
        if self._spec_ctl is not None:
            # The controller's per-row window goes on every terminal path.
            self._spec_ctl.forget(req.rid)
        ids = req.tokens
        if self.eos_token_id is not None and ids and ids[-1] == self.eos_token_id:
            ids = ids[:-1]
        if status == STATUS_OK:
            self._history_append(ids)
        req.t_done = time.perf_counter()
        # Bounded: a long-lived server must not grow host state forever.
        while len(self.request_stats) >= 8192:
            self.request_stats.pop(next(iter(self.request_stats)))
        while len(self.finish_status) >= 8192:
            self.finish_status.pop(next(iter(self.finish_status)))
        ttft = (req.t_first if req.t_first is not None else req.t_done) - req.t_submit
        latency = req.t_done - req.t_submit
        # The mean inter-token gap, the first token excluded (that interval
        # is the TTFT); tokens land in harvest-sized groups.
        n_commit = len(req.tokens)
        itl = ((req.t_last - req.t_first) / (n_commit - 1)
               if req.t_first is not None and req.t_last is not None and n_commit > 1 else 0.0)
        self.request_stats[req.rid] = {"ttft_s": ttft, "latency_s": latency, "itl_s": itl}
        if req.t_first is not None:
            # A request that never committed has no first token.
            obs_metrics.SERVE_TTFT.observe(ttft)
        obs_metrics.SERVE_LATENCY.observe(latency)
        obs_metrics.SERVE_REQUESTS.inc(status=status)
        met = None
        if req.slo is not None:
            # Scored on every terminal path: a forced finish stays in the
            # denominator (a never-committed one on its t_done stand-in).
            met = req.slo.met(ttft, itl, latency)
            key = (req.slo.name, met)
            self.slo_counts[key] = self.slo_counts.get(key, 0) + 1
            self._slo_window.append(met)
            self.request_stats[req.rid]["slo_met"] = float(met)
            cls = req.slo.name
            obs_metrics.SERVE_SLO_REQUESTS.inc(slo_class=cls, met="true" if met else "false")
            if req.t_first is not None:
                obs_metrics.SERVE_SLO_TTFT.observe(ttft, slo_class=cls)
            if n_commit > 1:
                obs_metrics.SERVE_SLO_ITL.observe(itl, slo_class=cls)
            obs_metrics.SERVE_SLO_LATENCY.observe(latency, slo_class=cls)
            obs_metrics.SERVE_SLO_GOODPUT.set(sum(self._slo_window) / len(self._slo_window))
        obs_metrics.SERVE_ACTIVE_ROWS.set(sum(r is not None for r in self.rows))
        obs_metrics.SERVE_QUEUE_DEPTH.set(len(self.queue))
        slo_fields = {"slo_class": req.slo.name, "slo_met": met} if req.slo is not None else {}
        obs_trace.async_end(req.phase, req.rid, status=status, tokens=len(ids), **slo_fields)
        forced_kind = _JOURNEY_FORCED_KIND.get(status)
        if forced_kind is not None:
            obs_journey.event(self._journey_owner, req.rid, forced_kind, t=req.t_done)
        jrec = obs_journey.finish(
            self._journey_owner, req.rid, status,
            t_submit=req.t_journey if req.t_journey is not None else req.t_submit,
            t_done=req.t_done, slo_class=req.slo.name if req.slo is not None else None,
            slo_met=met)
        if jrec is not None and req.slo is not None and not met:
            obs_metrics.SERVE_SLO_MISS_CAUSE.inc(slo_class=req.slo.name, cause=jrec["cause"])
        self.finished[req.rid] = ids
        self.finish_status[req.rid] = status

    # -- piggyback lanes --------------------------------------------------

    def _ensure_lane_buffers(self, s1: int) -> None:
        """Allocate (or grow to bucket ``s1``) the resident lane buffers: a
        (K_cap, S_lane + chunk_p) KV cache, always unquantized, and a
        (K_cap, S_lane, D) prompt-embedding buffer. Growth pads the
        position axis, keeping live lanes' state."""
        s1 = _bucket(s1, self.max_len)
        if self._lane_cache is not None and s1 <= self._lane_bucket:
            return
        d = self.cfg.llama.hidden_size
        if self._lane_cache is None:
            self._lane_cache = llama_mod.init_kv_cache(
                self.cfg.llama, self._lane_cap, s1 + self._lane_chunk, dtype=self._dtype,
                device=self.device, quant=False, mesh=self.mesh)
            self._lane_embeds = torch.zeros((self._lane_cap, s1, d), dtype=self._dtype,
                                            device=self.device)
        else:
            pad = s1 - self._lane_bucket
            for plane in ("k", "v"):
                buf = self._lane_cache[plane]
                self._lane_cache[plane] = F.pad(buf, (0, 0) * (buf.ndim - 3) + (0, pad))
            self._lane_embeds = F.pad(self._lane_embeds, (0, 0, 0, pad))
        self._lane_bucket = s1
        # The one resident allocation that moves mid-service.
        obs_memory.LEDGER.resize("lanes", f"{self._mem_owner}/lanes",
                                 obs_memory.params_bytes([self._lane_cache, self._lane_embeds]))

    def _start_full_lane(self, req: _Request, row: int) -> None:
        """A lane for a full-prefill admission: the whole prompt's
        embeddings load into the lane slot, advanced from position 0."""
        padded, _, prompt_len = self._prep_request(req)
        self._ensure_lane_buffers(padded.shape[1])
        slot = self._lane_free.pop()
        self._lane_embeds[slot, :padded.shape[1]] = padded[0]
        self._lanes.append(_PendingLane(req, row, slot, prompt_len))
        self.lanes_started["full"] += 1
        obs_journey.event(self._journey_owner, req.rid, "lane_join", slot=slot, filled=0,
                          prompt_len=prompt_len)

    def _start_suffix_lane(self, req: _Request, row: int, entry: _PrefixEntry, suffix_ids,
                           fit: tuple) -> None:
        """A lane for a prefix hit: the entry's KV seeds the lane row at
        [0, entry.length) and only the suffix embeddings load; the lane
        advances from ``filled = entry.length``. The lane pins the entry
        until it finishes (its finish re-reads the entry)."""
        suf_len, prompt_len, _, s1 = fit
        self._prefix_cache.count_hit(entry)
        # The copy boundary's fault site, before the lane's pin, so that a
        # tripped admission leaks none.
        faults.maybe_fail("serve.prefix_copy")
        faults.maybe_delay("serve.prefix_copy")
        entry.pins += 1
        t0 = time.perf_counter()
        self._ensure_lane_buffers(max(s1, entry.bucket))
        slot = self._lane_free.pop()
        ekv = self._entry_kv(entry)
        _lane_seed(self._lane_cache, slot, ekv["k"], ekv["v"])
        emb = self._suffix_embed(entry, req.pixel_values, suffix_ids, suf_len, suf_len)
        plen = entry.length
        self._lane_embeds[slot, plen:plen + suf_len] = emb[0]
        tr = obs_trace.active()
        if tr is not None:
            tr.complete("prefix_copy", t0, time.perf_counter(), cat="sched",
                        args={"plen": plen, "suffix": suf_len, "lane": slot})
        self._lanes.append(_PendingLane(req, row, slot, prompt_len, filled=plen, entry=entry))
        self.lanes_started["suffix"] += 1
        obs_journey.event(self._journey_owner, req.rid, "lane_join", slot=slot, filled=plen,
                          prompt_len=prompt_len)

    def _lane_args(self) -> tuple:
        """This boundary's lane inputs over all K_cap slots: (start,
        new_len, last_idx) on the device, the (lane, end) pairs it advances
        and their real prompt tokens. Idle and ready slots run a no-op
        window (start == new_len)."""
        k = self._lane_cap
        start = np.zeros((k,), np.int32)
        new_len = np.zeros((k,), np.int32)
        last_idx = np.zeros((k,), np.int64)
        advancing: List[tuple] = []
        n_tok = 0
        for lane in self._lanes:
            start[lane.slot] = lane.filled
            if lane.filled >= lane.prompt_len:
                new_len[lane.slot] = lane.filled  # ready: pinned, no advance
                continue
            end = min(lane.filled + self._lane_chunk, lane.prompt_len)
            new_len[lane.slot] = end
            last_idx[lane.slot] = max(0, min(lane.prompt_len - 1 - lane.filled,
                                             self._lane_chunk - 1))
            advancing.append((lane, end))
            n_tok += end - lane.filled
        return (_h2d(start, self.device), _h2d(new_len, self.device),
                _h2d(last_idx, self.device), advancing, n_tok)

    def _drop_lane(self, lane: _PendingLane) -> None:
        """Remove a lane mid-prefill (cancel, deadline, fault): its slot and
        its reserved row are freed, its entry pin drained; the lane KV is
        dead storage."""
        self._lanes.remove(lane)
        self._lane_free.append(lane.slot)
        self.rows[lane.row] = None
        if self._paged:
            self._paged_release(lane.req)
        if lane.entry is not None:
            self._drain_entry_pin(lane.entry)

    def _requeue_lanes(self) -> None:
        """The ``serve.mixed_dispatch`` fault's handler: every lane's request
        goes back to the front of the queue in its order, its row, slot,
        reservation and entry pin are released, and the decode rows are not
        touched. The request re-admits from scratch later."""
        for lane in reversed(self._lanes):
            self.rows[lane.row] = None  # the row stays frozen; the lane KV is dead
            lane.req.row = -1
            if self._paged:
                self._paged_release(lane.req)
            if lane.entry is not None:
                self._drain_entry_pin(lane.entry)
            self.queue.appendleft(lane.req)
        self._lanes = []
        self._lane_free = list(range(self._lane_cap))
        obs_metrics.SERVE_QUEUE_DEPTH.set(len(self.queue))

    def _finish_ready_lanes(self) -> bool:
        """Complete every lane whose prompt is prefilled: slice its lane row
        out and run the normal admission tail (``_finish_admission``: NaN
        quarantine, insert-on-prefill, scatter, activation). Callers have
        drained the pipeline (activation rewrites the carry)."""
        done = False
        for lane in [x for x in self._lanes if x.filled >= x.prompt_len]:
            self._lanes.remove(lane)
            self._lane_free.append(lane.slot)
            done = True
            pk = pv = None
            plen = 0
            if self.kv_quant and lane.entry is not None:
                ekv = self._entry_kv(lane.entry)
                pk, pv, plen = ekv["k"], ekv["v"], lane.entry.length
            k, v = _lane_extract(self._lane_cache["k"], self._lane_cache["v"], lane.slot, pk,
                                 pv, self._lane_bucket, self.kv_quant, plen)
            row_cache = {"k": k, "v": v,
                         "length": torch.full((1,), lane.prompt_len, dtype=torch.int32,
                                              device=self.device)}
            obs_journey.event(self._journey_owner, lane.req.rid, "lane_finish", slot=lane.slot,
                              prompt_len=lane.prompt_len)
            self._finish_admission(lane.req, lane.row, lane.prompt_len, row_cache,
                                   lane.last_logits, lane.last_hidden, prefix_entry=lane.entry,
                                   path="lane")
            if lane.entry is not None:
                self._drain_entry_pin(lane.entry)  # the activation holds its own pin
        return done

    # -- paged KV block pool ----------------------------------------------

    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks one request reserves at admission: its prompt bucket (the
        admission scatter writes whole blocks) and its decode horizon
        prompt + budget + slack (``submit``'s). The whole horizon is reserved up front,
        so an admitted row can always finish."""
        bucket = _bucket(prompt_len, self.max_len)
        cover = min(max(bucket, prompt_len + max_new + 1 + self.spec_max), self.max_len)
        return self._pool.blocks_for(cover)

    def _paged_admit_gate(self) -> bool:
        """The queue head admits only when its whole reservation fits the
        free list; under pressure the gate first evicts LRU unpinned prefix
        entries (their runs are the only idle pool capacity), then, with
        ``preempt`` and an interactive head, evicts batch rows
        (``_preempt_for``); else the head stays queued and finishing rows
        free the blocks it needs. An interactive head that finds no victim
        while the spill store cannot take one more block is refused at once
        (``STATUS_RESOURCE``) rather than left to wait past its deadline.
        Deferral and preemption change timing, never a chain."""
        req = self.queue[0]
        need = self._blocks_needed(req.prompt_len, req.max_new_tokens)
        if self._pool.free_blocks() >= need:
            return True
        if self._prefix_cache is not None:
            self._prefix_cache.reclaim_blocks(self._pool, need)
            if self._pool.free_blocks() >= need:
                return True
        if self.preempt and self._preempt_for(req, need):
            return True
        if (self.preempt and req.slo is not None and req.slo.name == "interactive"
                and self._spill_store.enabled
                and not self._spill_store.would_fit(self._pool.block_bytes or 1)):
            self.queue.popleft()
            obs_metrics.SERVE_QUEUE_DEPTH.set(len(self.queue))
            self._record_finish(req, STATUS_RESOURCE)
            return False
        self._paged_defer(req, need)
        return False

    def _paged_defer(self, req: _Request, need: int) -> None:
        self.block_deferrals += 1
        obs_metrics.SERVE_KV_BLOCK_DEFERRALS.inc()
        free = self._pool.free_blocks()
        obs_trace.instant("kv_block_defer", cat="mem", need_blocks=need, free_blocks=free)
        obs_journey.event(self._journey_owner, req.rid, "kv_block_defer", need_blocks=need,
                          free_blocks=free)

    def _paged_requeue(self, req: _Request, row: int) -> None:
        """Undo a pop whose reservation failed: free the row and put the
        request back at the queue front."""
        self.rows[row] = None
        req.row = -1
        self.queue.appendleft(req)
        obs_metrics.SERVE_QUEUE_DEPTH.set(len(self.queue))
        self._paged_defer(req, self._blocks_needed(req.prompt_len, req.max_new_tokens))

    def _paged_reserve(self, req: _Request, s1: int,
                       entry: Optional[_PrefixEntry] = None) -> bool:
        """Allocate the request's reservation, aliasing a prefix entry's
        full blocks below the divergence point on a hit; False when the
        pool cannot cover it now (never a partial grant)."""
        cover = min(max(s1, req.prompt_len + req.max_new_tokens + 1 + self.spec_max),
                    self.max_len)
        total = self._pool.blocks_for(cover)
        aliased: List[int] = []
        if entry is not None and entry.blocks:
            n_shared = min(entry.length // self._kv_block_size, total, len(entry.blocks))
            aliased = list(entry.blocks[:n_shared])
        owned = self._pool.alloc(total - len(aliased))
        if owned is None:
            return False
        if aliased:
            self._pool.incref(aliased)
            if entry.length % self._kv_block_size:
                # The entry ends inside a block: the admission scatter
                # re-creates that block's shared head in the row's first
                # OWNED block -- the copy-on-write copy.
                self._pool.note_cow()
        req.kv_blocks_aliased = aliased
        req.kv_blocks_owned = owned
        return True

    def _paged_bt_row(self, req: _Request) -> np.ndarray:
        """The row's block table: aliased run, then owned blocks, then
        scratch block 0."""
        bt = np.full((self._nbpr,), SCRATCH_BLOCK, np.int32)
        run = req.kv_blocks_aliased + req.kv_blocks_owned
        bt[: len(run)] = run
        return bt

    def _paged_dst_blocks(self, req: _Request, s1: int) -> np.ndarray:
        """Scatter destinations of the row's s1-slot prefilled cache:
        aliased source blocks (shared, never rewritten) and blocks beyond
        the reservation take the drop sentinel n_blocks."""
        n_src = s1 // self._kv_block_size
        dst = np.full((n_src,), self._pool.n_blocks, np.int32)
        na = len(req.kv_blocks_aliased)
        own = req.kv_blocks_owned[: max(n_src - na, 0)]
        dst[na:na + len(own)] = own
        return dst

    def _paged_release(self, req: _Request) -> None:
        """Return the reservation, and point the dead row's table back at
        scratch so its frozen writes never reach a recycled block."""
        if req.kv_blocks_owned:
            self._pool.decref(req.kv_blocks_owned)
            req.kv_blocks_owned = []
        if req.kv_blocks_aliased:
            self._pool.decref(req.kv_blocks_aliased)
            req.kv_blocks_aliased = []
        if req.kv_bt_written and req.row >= 0:
            self.cache["bt"][req.row] = SCRATCH_BLOCK
            req.kv_bt_written = False

    def _drop_spill(self, req: _Request) -> None:
        """Forget a spilled request's run and host record (it ends or
        leaves while spilled: the one exit of a spill but its restore)."""
        if req.spill_run is not None:
            self._pool.drop_spilled(req.spill_run)
            req.spill_run = None
            self._spill_store.drop(req.rid)

    # -- block-tier preemption and the host spill store -------------------

    def _preempt_for(self, req: _Request, need: int) -> bool:
        """Evict batch rows, worst deadline headroom first (a row with no
        deadline has nothing to miss and goes first), until the interactive
        head's ``need`` blocks are free. An interactive row is never a
        victim and a batch head never evicts; free, pending and lane rows
        (frozen) never are victims. Returns whether the head now fits."""
        if req.slo is None or req.slo.name != "interactive":
            return False
        if self._tripped("serve.preempt"):
            return False  # this admission defers; no victim is touched
        # Rows change only drained: the pipelined scheduler may have a
        # segment in flight, and its harvest may itself free the blocks.
        self._drain()
        if self._pool.free_blocks() >= need:
            return True
        # Only a victim with a deadline reads the clock.
        now = self._now() if self._n_deadlines > 0 else 0.0
        victims = []
        for r, vic in enumerate(self.rows):
            if vic is None or self.frozen[r]:
                continue
            if vic.slo is not None and vic.slo.name == "interactive":
                continue
            headroom = vic.deadline - now if vic.deadline is not None else float("-inf")
            victims.append((headroom, r, vic))
        if not victims:
            return False
        victims.sort(key=lambda x: (x[0], x[1]))
        for _, r, vic in victims:
            if self._pool.free_blocks() >= need:
                break
            if self.rows[r] is not vic or self.frozen[r]:
                continue  # the drain's harvest finished it
            self._preempt_row(vic)
        return self._pool.free_blocks() >= need

    @torch.inference_mode()
    def _preempt_row(self, vic: _Request) -> None:
        """Evict one active row: spill its KV run to the host store when the
        price says so (falling back to a drop when the store or the pool
        refuses), else release its blocks for re-prefill, dropping its
        committed tokens (the re-admission re-decodes them). Either way it
        re-queues at the back."""
        row = vic.row
        mode = "spill"
        if not (self._spill_choose(vic) and self._spill_victim(vic)):
            mode = "drop"
            self._paged_release(vic)
            vic.tokens = []
        if vic.prefix_entry is not None:
            self._drain_entry_pin(vic.prefix_entry)
            vic.prefix_entry = None
        self.rows[row] = None
        vic.row = -1
        self.frozen[row] = True
        self.n_rem[row] = 0
        if self.speculative:
            self.base_pos[row] = 0
        if self._spec_ctl is not None:
            self._spec_ctl.forget(vic.rid)
        # The host changed rows under the device carry (drained).
        self._dev_carry = None
        obs_trace.async_end("active", vic.rid, status="preempted")
        obs_trace.async_begin("queued", vic.rid)
        vic.phase = "queued"
        vic.preempts += 1
        self.preemptions += 1
        self.queue.append(vic)
        obs_metrics.SERVE_QUEUE_DEPTH.set(len(self.queue))
        obs_metrics.SERVE_ACTIVE_ROWS.set(sum(r is not None for r in self.rows))
        obs_metrics.SERVE_PREEMPTIONS.inc(mode=mode)
        obs_journey.event(self._journey_owner, vic.rid, "preempt", mode=mode, row=row)

    def _spill_choose(self, vic: _Request) -> bool:
        """The spill-or-recompute price: spill only an exclusively owned run
        that fits the store's budget, and only when its round trip (out and
        back at the measured gather rate) costs less than re-prefilling the
        positions so far (~2 * params * positions FLOPs at the assumed
        rate)."""
        store = self._spill_store
        if store is None or not store.enabled or vic.kv_blocks_aliased or not vic.kv_blocks_owned:
            return False
        if any(self._pool.ref(b) != 1 for b in vic.kv_blocks_owned):
            # Idle insert-on-prefill entries alias the run (refcount 2):
            # evict them; a surviving pin is a live reader, so drop.
            if self._prefix_cache is not None:
                self._prefix_cache.evict_covering(vic.kv_blocks_owned)
            if any(self._pool.ref(b) != 1 for b in vic.kv_blocks_owned):
                return False
        nbytes = len(vic.kv_blocks_owned) * (self._pool.block_bytes or self._kv_block_size)
        if not store.would_fit(nbytes):
            return False
        positions = vic.prompt_len + len(vic.tokens)
        spill_s = 2.0 * nbytes / max(self._spill_bw_Bps, 1.0)
        recompute_s = (2.0 * self._spill_param_count * positions
                       / max(self._recompute_flops_per_s, 1.0))
        # The measured rate is this process's: on a mesh rank 0 prices.
        spill = spill_s <= recompute_s
        return spill if self.mesh is None else self.mesh.agree(spill)

    def _spill_victim(self, vic: _Request) -> bool:
        """One spill: the gather and the store's admission come before any
        pool change, so a refusal leaves the pool and the victim's
        reservation as they were (the caller drops instead). The gather is
        the ``serve.spill`` fault site: a trip there drops the victim with
        the pool intact. On a mesh each rank spills its own KV heads of the
        run; the store counts the whole row's bytes and holds the rank's."""
        if self._tripped("serve.spill"):
            return False
        rec = self._gather_spill_record(vic)
        if not self._spill_store.put(vic.rid, rec, rec["nbytes_kv"], held=_nbytes(rec)):
            return False
        try:
            run_id = self._pool.spill_out(vic.kv_blocks_owned)
        except BlockPoolError:
            self._spill_store.drop(vic.rid)
            return False
        vic.spill_run = run_id
        vic.kv_blocks_owned = []
        if vic.kv_bt_written and vic.row >= 0:
            # The dead row's table points at scratch before its blocks are
            # handed out again.
            self.cache["bt"][vic.row] = SCRATCH_BLOCK
            vic.kv_bt_written = False
        obs_journey.event(self._journey_owner, vic.rid, "spill", bytes=rec["nbytes_kv"],
                          blocks=rec["n_blocks"])
        return True

    # A harvest point: the host waits here, at a drained admission boundary
    # (a spill or a handoff), outside the pipelined dispatch.
    @torch.inference_mode()
    def _gather_spill_record(self, vic: _Request, blocks: Optional[List[int]] = None,
                             kind: str = "spill", whole: bool = False) -> Dict[str, Any]:
        """A row's whole re-activation state, gathered to host memory: its
        block run's K/V (``_gather_blocks``; an int8 arena's scale planes
        with it), cache length, logits row and, speculative, its ``ids_buf``
        row, ``base_pos`` and Medusa drafts. Whole blocks are copied byte
        for byte, so the restore scatter reproduces the row exactly.
        ``blocks`` overrides the run (the handoff ships the table's run up
        to the length); the default is the spill's owned run. The bandwidth
        EWMA of the price reads the copy's time alone. On a mesh the planes
        are the rank's KV heads, and ``nbytes_kv`` counts the whole row's;
        ``whole`` (a handoff, which leaves the mesh) gathers every rank's
        heads over ``model`` first."""
        row = vic.row
        block_ids = vic.kv_blocks_owned if blocks is None else blocks
        k, v = _gather_blocks(self.cache, block_ids)
        if whole:
            k, v = (serving_mod.gather_kv_heads(x, self.cfg.llama, self.mesh) for x in (k, v))
        dev = {"k": k, "v": v, "length": self.cache["length"][row].clone(),
               "logits": self.logits[row].clone()}
        if self.speculative:
            dev["ids"] = self.ids_buf[row].clone()
        if self.draft_head is not None and self.spec_max > 1:
            dev["drafts"] = self.spec_drafts[row].clone()
        host, alloc_s, copy_s = _to_host(dev)
        nbytes = _nbytes(host)
        if copy_s > 0.0:
            self._spill_bw_Bps = 0.7 * self._spill_bw_Bps + 0.3 * nbytes / max(copy_s, 1e-6)
        self.gather_timings.append({"kind": kind, "bytes": nbytes, "blocks": len(block_ids),
                                    "alloc_s": alloc_s, "copy_s": copy_s})
        host["n_blocks"] = len(block_ids)
        split = 1 if whole else self._kv_split
        host["nbytes_kv"] = nbytes + (split - 1) * _nbytes([host["k"], host["v"]])
        host["base_pos"] = int(self.base_pos[row]) if self.speculative else 0
        return host

    @torch.inference_mode()
    def _install_record(self, req: _Request, row: int, rec: Dict[str, Any],
                        blocks: List[int], n_ship: int) -> None:
        """The restore and the splice: the record's planes scatter into
        ``blocks[:n_ship]`` through the paged admission (``_admit_row_paged``),
        the row's table, length and logits are installed, and the row goes
        live with its speculative state."""
        req.kv_blocks_owned = blocks
        req.kv_blocks_aliased = []
        dev = self.device
        row_cache = {"k": _map_tree(rec["k"], lambda t: _on_device(t, dev)),
                     "v": _map_tree(rec["v"], lambda t: _on_device(t, dev)),
                     "length": _on_device(rec["length"], dev).reshape(1)}
        _admit_row_paged(self.cache, self.logits, row, np.asarray(blocks[:n_ship], np.int32),
                         self._paged_bt_row(req), row_cache,
                         _on_device(rec["logits"], dev)[None])
        req.kv_bt_written = True
        self.rows[row] = req
        req.row = row
        self.frozen[row] = False
        self.n_rem[row] = req.max_new_tokens - len(req.tokens)
        if self.speculative:
            self.ids_buf[row] = _on_device(rec["ids"], dev)
            self.base_pos[row] = rec["base_pos"]
        if "drafts" in rec:
            self.spec_drafts[row] = _on_device(rec["drafts"], dev)
        # The host changed rows (drained): the next dispatch uploads.
        self._dev_carry = None

    def _paged_restore(self, req: _Request, row: int) -> bool:
        """Re-admit a spilled request: fresh blocks from the pool's spill
        registry, then its record through the paged admission scatter.
        False when the pool cannot cover the run now (the caller re-queues;
        the run and the record stay)."""
        rec = self._spill_store.peek(req.rid)
        if rec is None:
            raise BlockPoolError(f"request {req.rid} has spill_run={req.spill_run} but no "
                                 f"spill record")
        blocks = self._pool.restore(req.spill_run, rec["n_blocks"])
        if blocks is None:
            return False
        self._spill_store.take(req.rid)
        req.spill_run = None
        self._install_record(req, row, rec, blocks, len(blocks))
        obs_trace.async_end("queued", req.rid)
        obs_trace.async_begin("active", req.rid)
        req.phase = "active"
        obs_metrics.SERVE_RESTORES.inc()
        obs_metrics.SERVE_ACTIVE_ROWS.set(sum(r is not None for r in self.rows))
        obs_journey.event(self._journey_owner, req.rid, "restore", row=row,
                          blocks=rec["n_blocks"])
        return True

    # -- prefill/decode roles: the block-run handoff ----------------------

    def _handoff_sweep(self) -> None:
        """Prefill role (``step`` calls it instead of dispatching): every
        activated row leaves through the handoff outbox, so the next
        admission finds free rows and blocks. Pending and lane rows stay
        until they activate."""
        for row, req in enumerate(self.rows):
            if req is None or self.frozen[row]:
                continue
            if self.n_rem[row] <= 0:
                # The budget was met at admission (a speculative row's first
                # token): nothing is left to decode.
                self._finish_row(row)
                continue
            self._handoff_gather(req)

    def _handoff_gather(self, req: _Request) -> None:
        """Gather one activated row into a handoff record and tear the row
        down. The record is the spill record plus routing state: the KV of
        the table's run up to the row's length (nothing past the length is
        read before it is written), with ``n_total`` naming the whole
        reservation the decode side allocates again. Prefix-aliased blocks
        ship in the run: the decode side owns a private copy."""
        row = req.row
        length = req.prompt_len + len(req.tokens)
        run = req.kv_blocks_aliased + req.kv_blocks_owned
        n_ship = min(max(self._pool.blocks_for(length), 1), len(run))
        rec = self._gather_spill_record(req, blocks=run[:n_ship], kind="handoff", whole=True)
        rec["n_total"] = len(run)
        self._paged_release(req)
        if req.prefix_entry is not None:
            self._drain_entry_pin(req.prefix_entry)
            req.prefix_entry = None
        self.rows[row] = None
        req.row = -1
        self.frozen[row] = True
        self.n_rem[row] = 0
        if self.speculative:
            self.base_pos[row] = 0
        if self._spec_ctl is not None:
            self._spec_ctl.forget(req.rid)
        if req.deadline is not None:
            self._n_deadlines -= 1
        self._dev_carry = None
        # The record's headroom is read on the agreed clock.
        now = self._now() if req.deadline is not None else time.perf_counter()
        obs_trace.async_end(req.phase, req.rid, status="handoff")
        self.handoffs_gathered += 1
        self.handoffs_gathered_bytes += rec["nbytes_kv"]
        obs_metrics.PROCFLEET_HANDOFFS.inc(stage="gathered")
        obs_metrics.SERVE_ACTIVE_ROWS.set(sum(r is not None for r in self.rows))
        obs_journey.event(self._journey_owner, req.rid, "kv_handoff", stage="gathered",
                          bytes=rec["nbytes_kv"], blocks=rec["n_blocks"])
        # Not over but moving: the prefill leg's journey closes as
        # "handoff" (finish_status is never written) and rides the record.
        obs_journey.finish(self._journey_owner, req.rid, "handoff", t_submit=req.t_submit,
                           t_done=now, slo_class=req.slo.name if req.slo is not None else None)
        # Durations, not stamps: the decode side rebases its own clock.
        self.handoff_ready.append({
            "rid": req.rid, "input_ids": list(req.input_ids), "tokens": list(req.tokens),
            "max_new_tokens": req.max_new_tokens, "prompt_len": req.prompt_len,
            "t_gather": now, "elapsed_s": now - req.t_submit,
            "ttft_s": req.t_first - req.t_submit if req.t_first is not None else None,
            "deadline_s": req.deadline - now if req.deadline is not None else None,
            "slo": req.slo, "preempts": req.preempts,
            "journey": obs_journey.get(self._journey_owner, req.rid), "rec": rec})

    def pop_handoffs(self) -> List[Dict[str, Any]]:
        """Take the handoff outbox."""
        out, self.handoff_ready = self.handoff_ready, []
        return out

    def import_handoff(self, input_ids: Sequence[int], max_new_tokens: int, rec: Dict[str, Any],
                       tokens: Sequence[int] = (), prompt_len: int = 0,
                       deadline_s: Optional[float] = None, slo: Optional[SLO] = None,
                       elapsed_s: float = 0.0, ttft_s: Optional[float] = None) -> int:
        """Decode role (or colocated): accept a prefill batcher's gathered
        record. The request queues like a submit but is spliced at
        admission (``_handoff_splice``), never prefilled, and it bypasses
        ``max_queue`` (it was admitted already, and its KV exists nowhere
        else). The record's planes may be host tensors or numpy arrays.
        The clock is rebased by the prefill leg: ``t_submit`` moves
        ``elapsed_s`` into the past and ``t_first`` to ``ttft_s`` after it,
        so the stats and the SLO score the request's whole life; the
        deadline (remaining headroom) starts now."""
        if self.role == "prefill":
            raise ValueError("a prefill-role scheduler cannot import handoffs")
        if not self._paged:
            raise ValueError("import_handoff requires kv_layout='paged'")
        if slo is not None and slo.name not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {slo.name!r}: one of {SLO_CLASSES}")
        need = self._blocks_needed(int(prompt_len), max_new_tokens)
        if need > self._pool.usable:
            raise ValueError(f"handoff does not fit: needs {need} KV blocks, the pool holds "
                             f"{self._pool.usable} (raise --kv_pool_blocks)")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, list(input_ids), None, max_new_tokens)
        req.tokens = list(tokens)
        req.prompt_len = int(prompt_len)
        req.slo = slo
        now = self._now() if deadline_s is not None else time.perf_counter()
        req.t_submit = now - max(float(elapsed_s or 0.0), 0.0)
        req.t_journey = now
        if ttft_s is not None:
            req.t_first = req.t_submit + float(ttft_s)
        if deadline_s is not None:
            req.deadline = now + float(deadline_s)
            self._n_deadlines += 1
        if self._kv_split > 1:
            # A record is the whole row's: this rank splices its KV heads.
            rec = {**rec, "k": serving_mod.slice_kv_heads(rec["k"], self.cfg.llama, self.mesh),
                   "v": serving_mod.slice_kv_heads(rec["v"], self.cfg.llama, self.mesh)}
        req.handoff_rec = rec
        self.queue.append(req)
        obs_metrics.SERVE_QUEUE_DEPTH.set(len(self.queue))
        obs_trace.async_begin("queued", rid, prompt_len=req.prompt_len, budget=max_new_tokens)
        # No note_submit: the arrival counted at the prefill side. The
        # journey leg is local (t=now, not the rebased stamp).
        obs_journey.begin(self._journey_owner, rid, t=now, prompt_len=req.prompt_len,
                          budget=max_new_tokens,
                          **({"slo_class": slo.name} if slo is not None else {}))
        return rid

    def _handoff_splice(self, req: _Request, row: int) -> bool:
        """Splice an imported record into the local arena: fresh owned
        blocks for the whole reservation (``n_total``), then the shipped
        run through the paged admission scatter. False when the pool cannot
        cover the reservation now (the caller re-queues)."""
        rec = req.handoff_rec
        total = rec.get("n_total", rec["n_blocks"])
        blocks = self._pool.alloc(total)
        if blocks is None:
            return False
        req.handoff_rec = None
        self._install_record(req, row, rec, blocks, rec["n_blocks"])
        obs_trace.async_end("queued", req.rid)
        obs_trace.async_begin("active", req.rid)
        req.phase = "active"
        nbytes = rec.get("nbytes_kv", 0)
        self.handoffs_spliced += 1
        self.handoffs_spliced_bytes += nbytes
        obs_metrics.PROCFLEET_HANDOFFS.inc(stage="spliced")
        obs_metrics.SERVE_ACTIVE_ROWS.set(sum(r is not None for r in self.rows))
        obs_journey.event(self._journey_owner, req.rid, "kv_handoff", stage="spliced", row=row,
                          blocks=rec["n_blocks"], bytes=nbytes)
        return True

    # -- admission --------------------------------------------------------

    def _admit(self) -> bool:
        """Admit queued requests into free rows. Returns True when it did
        admission work.

        Per popped request: with ``prefill_budget`` armed and rows decoding
        (or lanes live), it becomes a piggyback lane -- a prefix hit seeds
        the lane with the entry, a miss loads the whole prompt -- up to
        ``_lane_cap`` at once. Otherwise: a prefix hit admits suffix-only
        (hits of one shape share a wave), a miss with rows decoding and
        ``prefill_chunk`` set becomes a chunked admission, and the rest
        join this step's full-prefill wave."""
        faults.maybe_fail("serve.admit")
        faults.maybe_delay("serve.admit")
        did_work = False
        if self._lanes:
            # step() drained when a lane was ready.
            did_work |= self._finish_ready_lanes()
        if self._pending is not None:
            did_work = True
            self._advance_pending()
        piggy = self.prefill_budget > 0 and (len(self._lanes) > 0 or not self.frozen.all())
        # The memory headroom guard: a wave the ledger predicts past
        # capacity - headroom stays queued this boundary.
        mem_defer = self._mem_guard_defers()
        wave: List[tuple] = []  # (req, row) full-prefill admissions
        hits: List[tuple] = []  # (req, row, entry, suffix_ids, fit)
        while (self._pending is None and self.queue and not mem_defer
               and any(r is None for r in self.rows)):
            if piggy and not self._lane_free:
                break  # lanes at the token budget: the rest stay queued
            if self._paged and not self._paged_admit_gate():
                break
            req = self.queue.popleft()
            did_work = True
            t_deq = time.perf_counter()
            obs_metrics.SERVE_QUEUE_DEPTH.set(len(self.queue))
            obs_metrics.SERVE_QUEUE_WAIT.observe(t_deq - req.t_submit)
            obs_journey.event(self._journey_owner, req.rid, "queue", t=t_deq,
                              depth=len(self.queue))
            if req.phase == "queued":
                obs_trace.async_end("queued", req.rid)
                obs_trace.async_begin("active", req.rid)
                req.phase = "active"
            row = next(r for r in range(self.max_batch) if self.rows[r] is None)
            # Reserve the row now; it stays frozen until activation.
            self.rows[row] = req
            req.row = row
            if self._paged and (req.spill_run is not None or req.handoff_rec is not None):
                # Installing a record makes the row live at once: the
                # in-flight segment is harvested first, or the row would
                # decode from that segment's stale state (lanes armed skip
                # step()'s drain; ROADMAP Queue 3, F3).
                self._drain()
            if self._paged and req.spill_run is not None:
                # A spilled victim restores its gathered KV instead of
                # prefilling; the gate checked the same reservation, so a
                # failure here is only a race.
                if self._paged_restore(req, row):
                    continue
                self._paged_requeue(req, row)
                break
            if self._paged and req.handoff_rec is not None:
                # An imported handoff splices through the same seam.
                if self._handoff_splice(req, row):
                    continue
                self._paged_requeue(req, row)
                break
            hit = None
            if self._prefix_cache is not None:
                t0 = time.perf_counter()
                hit = self._prefix_lookup(req)
                tr = obs_trace.active()
                if tr is not None:
                    tr.complete("prefix_lookup", t0, time.perf_counter(), cat="sched",
                                args={"hit": hit is not None})
            if hit is not None:
                entry, suffix_ids = hit
                fit = self._prefix_fit(entry, suffix_ids)
                if fit is not None and self._paged and not self._paged_reserve(req, fit[3],
                                                                              entry):
                    self._paged_requeue(req, row)
                    break
                if fit is not None:
                    obs_journey.event(self._journey_owner, req.rid, "prefix", hit=True,
                                      matched=entry.length, entry_tokens=len(entry.ids))
                    if piggy:
                        self._start_suffix_lane(req, row, entry, suffix_ids, fit)
                        continue
                    # Selection pin: the entry (and a paged entry's blocks)
                    # must survive until this boundary's admission read it.
                    entry.pins += 1
                    hits.append((req, row, entry, suffix_ids, fit))
                    continue
            if self._prefix_cache is not None:
                self._prefix_cache.count_miss()
                obs_journey.event(self._journey_owner, req.rid, "prefix", hit=False)
            if self._paged and not self._paged_reserve(req, _bucket(req.prompt_len,
                                                                     self.max_len)):
                self._paged_requeue(req, row)
                break
            if piggy:
                self._start_full_lane(req, row)
                continue
            if self.prefill_chunk and not self.frozen.all():
                # Rows are decoding: a chunked admission, one chunk per step.
                padded, _, prompt_len = self._prep_request(req)
                self._pending = _PendingAdmission(req, row, padded, prompt_len,
                                                  self._new_row_cache(padded.shape[1]))
                self._advance_pending()
                break
            wave.append((req, row))
        # Suffix admissions first, grouped into waves by padded shape.
        groups: Dict[tuple, List[tuple]] = {}
        for h in hits:
            groups.setdefault((h[4][2], h[4][3]), []).append(h)
        ordered = [members for _, members in sorted(groups.items())]
        for gi, members in enumerate(ordered):
            obs_metrics.SERVE_ADMISSION_WAVE.observe(len(members))
            try:
                if len(members) == 1:
                    req, row, entry, suffix_ids, _ = members[0]
                    row_cache, row_logits, row_hidden, prompt_len = self._prefix_admit(
                        entry, req.pixel_values, suffix_ids)
                    self._prefix_cache.count_hit(entry)
                    self._finish_admission(req, row, prompt_len, row_cache, row_logits,
                                           row_hidden, prefix_entry=entry, path="suffix")
                    self._drain_entry_pin(entry)  # the selection pin
                else:
                    self._admit_suffix_wave(members)  # drains its members' pins
            except BaseException:
                # A fault: this group's selection pins and the later groups'
                # drain, or the entries would stay pinned for good.
                for m in (m for later in ordered[gi:] for m in later):
                    self._drain_entry_pin(m[2])
                raise
        if not wave:
            return did_work
        obs_metrics.SERVE_ADMISSION_WAVE.observe(len(wave))
        if len(wave) > 1:
            self._admit_wave(wave)
            return True
        req, row = wave[0]
        padded, mask, prompt_len = self._prep_request(req)
        row_cache = self._new_row_cache(padded.shape[1])
        # Medusa mode also needs the prompt's last hidden: it seeds the
        # row's first drafts.
        pre = llama_mod.prefill(self.params["llama"], self.cfg.llama, padded, mask, row_cache,
                                last_only=True, return_hidden=self.draft_head is not None,
                                mesh=self.mesh)
        self._count_dispatch("full")
        self._finish_admission(req, row, prompt_len, row_cache, pre[0],
                               pre[1] if len(pre) == 3 else None)
        return True

    def _mem_next_wave_bytes(self) -> int:
        """Predicted device bytes of admitting the queue heads that could
        land this boundary (one per free row): a paged head's whole block
        reservation; a dense head's prompt-bucket row cache, doubled when
        insert-on-prefill also copies a prefix entry. Conservative on
        purpose: a guard that under-predicts is a guard that runs out. On a
        mesh it is this rank's share (its KV heads)."""
        free = sum(1 for r in self.rows if r is None)
        heads = [req for i, req in enumerate(self.queue) if i < free]
        if self._paged:
            return sum(self._blocks_needed(req.prompt_len, req.max_new_tokens)
                       * (self._pool.block_bytes // self._kv_split) for req in heads)
        factor = 2 if self._prefix_cache is not None and self.prefix_insert else 1
        return sum(factor * _bucket(req.prompt_len, self.max_len) * self._kv_pos_bytes
                   for req in heads)

    def _mem_guard_defers(self) -> bool:
        """One headroom-guard decision per admission boundary: True defers
        the wave (timing only; the chains are unchanged). Off without a
        headroom or a capacity; never defers an idle server, where nothing
        in flight would ever free the bytes. The decision is the
        ``serve.mem_guard`` fault site: a trip admits as if the guard were
        off. On a mesh the wave defers when any rank's ledger plus its share
        of the wave passes that rank's budget (an OOM on any rank ends the
        mesh), and a trip on any rank admits on every rank."""
        mesh = self.mesh is not None and self.mesh.control is not None
        if not (self.mem_headroom_bytes and (self._mem_capacity or mesh) and self.queue):
            return False
        if self._pending is None and not self._lanes and all(r is None for r in self.rows):
            return False
        tripped = False
        try:
            faults.maybe_fail("serve.mem_guard")
            faults.maybe_delay("serve.mem_guard")
        except faults.InjectedFault:
            tripped = True
        predicted = self._mem_next_wave_bytes()
        over = self._mem_capacity > 0 and (obs_memory.LEDGER.total() + predicted
                                           > self._mem_capacity - self.mem_headroom_bytes)
        if mesh:
            code = self.mesh.agree_max(2 if tripped else int(over))
            tripped, over = code == 2, code == 1
        if tripped or not over:
            return False
        self.mem_deferrals += 1
        obs_metrics.MEM_GUARD_DEFERRALS.inc()
        obs_trace.instant("mem_guard_defer", cat="mem", predicted_bytes=predicted)
        if obs_journey.enabled():
            # In the timeline of every head that could have admitted.
            free = sum(1 for r in self.rows if r is None)
            for i, q in enumerate(self.queue):
                if i >= free:
                    break
                obs_journey.event(self._journey_owner, q.rid, "mem_guard_defer",
                                  predicted_bytes=predicted)
        return True

    def _advance_pending(self) -> None:
        """Run one prefill chunk of the pending admission; with no row
        decoding (nothing to stall) run every remaining chunk at once."""
        while self._pending is not None:
            self._advance_pending_one()
            if self._pending is None or not self.frozen.all():
                return

    def _advance_pending_one(self) -> None:
        p = self._pending
        c = self.prefill_chunk
        start = p.filled
        end = min(start + c, p.prompt_len)
        last, hidden = _chunk_prefill(self.params, self.cfg, p.embeds, p.row_cache, start, end,
                                      max(0, min(p.prompt_len - 1 - start, c - 1)), c, self.mesh)
        self._count_dispatch("chunk")
        p.filled = end
        if p.filled >= p.prompt_len:
            self._pending = None
            self._finish_admission(p.req, p.row, p.prompt_len, p.row_cache, last, hidden,
                                   path="chunk")

    def _pixels(self, pixel_values) -> torch.Tensor:
        return _h2d(np.asarray(pixel_values, np.float32), self.device).to(self._dtype)

    @torch.inference_mode()
    def _prep_request(self, req: _Request):
        """CLIP encode, splice and pad one request to its prompt bucket:
        (padded (1, s1, D), mask (1, s1), prompt_len)."""
        ev = eventchat.encode_events_batch(self.params, self.cfg,
                                           self._pixels(req.pixel_values)[None])
        embeds = [eventchat.splice_embeddings(self.params, self.cfg,
                                              split_at_event(req.input_ids), ev[0],
                                              mesh=self.mesh)]
        padded, mask, lens = eventchat._pad_batch(embeds)
        prompt_len = int(lens[0])
        s1 = _bucket(prompt_len, self.max_len)
        padded = F.pad(padded, (0, 0, 0, s1 - prompt_len))
        mask = F.pad(mask, (0, s1 - prompt_len))
        return padded, mask, prompt_len

    def _new_row_cache(self, s1: int, batch: int = 1):
        return llama_mod.init_kv_cache(self.cfg.llama, batch, s1, dtype=self._dtype,
                                       device=self.device, quant=self.kv_quant, mesh=self.mesh)

    @torch.inference_mode()
    def _admit_wave(self, wave: List[tuple]) -> None:
        """Batched admission prefill: the members pad to the widest member's
        prompt bucket and to the next power-of-two wave size; pad slots keep
        one real position (finite garbage KV instead of an all-masked
        softmax) and scatter nowhere."""
        n = len(wave)
        nb = 1 << (n - 1).bit_length()
        pv = torch.stack([self._pixels(req.pixel_values) for req, _ in wave])
        if nb > n:
            pv = torch.cat([pv, torch.zeros((nb - n,) + tuple(pv.shape[1:]), dtype=pv.dtype,
                                            device=pv.device)])
        ev = eventchat.encode_events_batch(self.params, self.cfg, pv)
        embeds = [eventchat.splice_embeddings(self.params, self.cfg,
                                              split_at_event(req.input_ids), ev[i],
                                              mesh=self.mesh)
                  for i, (req, _) in enumerate(wave)]
        padded, mask, lens = eventchat._pad_batch(embeds)
        prompt_lens = [int(x) for x in lens]
        s1 = _bucket(max(prompt_lens), self.max_len)
        padded = F.pad(padded, (0, 0, 0, s1 - padded.shape[1], 0, nb - n))
        mask = F.pad(mask, (0, s1 - mask.shape[1], 0, nb - n))
        if nb > n:
            mask[n:, 0] = True
        wave_cache = self._new_row_cache(s1, batch=nb)
        pre = llama_mod.prefill(self.params["llama"], self.cfg.llama, padded, mask, wave_cache,
                                last_only=True, return_hidden=self.draft_head is not None,
                                mesh=self.mesh)
        self._count_dispatch("wave")
        self._scatter_wave(wave, wave_cache, pre[0], pre[1] if len(pre) == 3 else None,
                           prompt_lens, path="wave")

    # Reads the wave logits back (the admission NaN quarantine); every
    # caller has drained the pipeline.
    def _scatter_wave(self, members: List[tuple], wave_cache, wave_logits, wave_hidden,
                      prompt_lens: List[int], entries: Optional[List[_PrefixEntry]] = None,
                      path: str = "wave") -> None:
        """Per-member NaN quarantine, insert-on-prefill, the one scatter of
        every surviving row into the shared cache, then row activation.
        Quarantined and pad slots keep row ``max_batch`` (written
        nowhere)."""
        nb = wave_logits.shape[0]
        rows = np.full((nb,), self.max_batch, np.int32)
        finite = torch.isfinite(wave_logits[: len(members)]).all(dim=-1).cpu().numpy()
        good = []
        for i, (req, row) in enumerate(members):
            if not finite[i]:
                # The poisoned member never touches the shared cache.
                self.rows[row] = None
                self.frozen[row] = True
                self._record_finish(req, STATUS_NAN)
                continue
            self._insert_prefix_on_prefill(req, wave_cache, src_row=i)
            rows[i] = row
            good.append((i, req, row))
        if self._paged:
            s1 = llama_mod._kv_max_len(wave_cache)
            dst = np.full((nb, s1 // self._kv_block_size), self._pool.n_blocks, np.int32)
            bt_rows = np.full((nb, self._nbpr), SCRATCH_BLOCK, np.int32)
            for i, req, row in good:
                dst[i] = self._paged_dst_blocks(req, s1)
                bt_rows[i] = self._paged_bt_row(req)
                req.kv_bt_written = True
            _admit_wave_paged(self.cache, self.logits, rows, dst, bt_rows, wave_cache["k"],
                              wave_cache["v"], wave_cache["length"], wave_logits)
        else:
            _admit_wave(self.cache, self.logits, rows, wave_cache["k"], wave_cache["v"],
                        wave_cache["length"], wave_logits)
        for i, req, row in good:
            obs_journey.event(self._journey_owner, req.rid, "admit", path=path, row=row)
            self._activate_row(req, row, prompt_lens[i], wave_logits[i:i + 1],
                               wave_hidden[i:i + 1] if wave_hidden is not None else None,
                               entries[i] if entries is not None else None)

    # Reads the row logits back (the admission NaN quarantine); every
    # caller has drained the pipeline.
    def _finish_admission(self, req: _Request, row: int, prompt_len: int, row_cache,
                          row_logits, row_hidden=None,
                          prefix_entry: Optional[_PrefixEntry] = None,
                          path: str = "full") -> None:
        """Write the prefilled row into the shared cache and activate it,
        unless its logits are not finite (then the request fails before it
        touches the shared cache)."""
        if not bool(torch.isfinite(row_logits).all()):
            self.rows[row] = None
            self.frozen[row] = True
            self._record_finish(req, STATUS_NAN)
            return
        self._insert_prefix_on_prefill(req, row_cache)
        if self._paged:
            s1 = llama_mod._kv_max_len(row_cache)
            _admit_row_paged(self.cache, self.logits, row, self._paged_dst_blocks(req, s1),
                             self._paged_bt_row(req), row_cache, row_logits)
            req.kv_bt_written = True
        else:
            _admit_row(self.cache, self.logits, row, row_cache, row_logits)
        obs_journey.event(self._journey_owner, req.rid, "admit", path=path, row=row)
        self._activate_row(req, row, prompt_len, row_logits, row_hidden, prefix_entry)

    def _activate_row(self, req: _Request, row: int, prompt_len: int, row_logits,
                      row_hidden=None, prefix_entry: Optional[_PrefixEntry] = None) -> None:
        self.rows[row] = req
        req.row = row
        if prefix_entry is not None:
            # The row pins its entry while it decodes from it.
            prefix_entry.pins += 1
            req.prefix_entry = prefix_entry
        obs_metrics.SERVE_ACTIVE_ROWS.set(sum(r is not None for r in self.rows))
        # The host changes frozen/n_rem (and base_pos; drained): upload
        # at the next dispatch.
        self._dev_carry = None
        if self.draft_head is not None and self.spec_max > 1:
            # The heads at the prompt's last hidden predict the tokens after
            # the first commit: the row's first drafts, the whole buffer's
            # width, so that any bucket finds its columns fresh.
            self.spec_drafts[row] = medusa_mod.medusa_drafts(
                self.params["llama"], self.draft_head, row_hidden, self.spec_max - 1,
                self.mesh)[0]
        if self.speculative:
            self._admit_speculative(req, row, prompt_len, row_logits)
            return
        self.frozen[row] = False
        self.n_rem[row] = req.max_new_tokens

    # Reads the first token back (its commit decides EOS and the budget on
    # the host, as in the JAX package); every caller has drained the
    # pipeline.
    def _admit_speculative(self, req: _Request, row: int, prompt_len: int, row_logits) -> None:
        """A speculative row's admission: its token-id view of the spliced
        prompt (the lookup context; the text joins the history too) goes
        into ``ids_buf``, and the prefill's token is committed as the first
        generated one (the ``_spec_segment`` invariant: cache length ==
        committed - 1). A zero budget returns zero tokens."""
        if req.max_new_tokens == 0:
            req.tokens = []
            self._finish_row(row)
            return
        row_ids = eventchat._spliced_text_ids(split_at_event(req.input_ids),
                                              self.cfg.num_event_tokens,
                                              self.cfg.llama.max_seq_len)[:self.max_len]
        self._history_append(row_ids)
        t0 = int(sample(row_logits, self.generator, self.temperature, self.top_p)[0])
        req.t_first = time.perf_counter()
        ids = np.full((self.max_len,), -1, np.int32)
        ids[:len(row_ids)] = row_ids
        ids[prompt_len] = t0
        self.ids_buf[row] = _h2d(ids, self.device)
        self.base_pos[row] = prompt_len + 1
        req.tokens = [t0]
        self.n_rem[row] = req.max_new_tokens - 1
        if (self.eos_token_id is not None and t0 == self.eos_token_id) or self.n_rem[row] <= 0:
            self._finish_row(row)
        else:
            self.frozen[row] = False

    def _history_append(self, toks) -> None:
        """Append prompt text or committed answers to the history ring
        (the oldest tokens shift out; -1 fillers are dropped)."""
        if self._history is None:
            return
        arr = np.asarray([t for t in toks if t >= 0], np.int64)
        if not len(arr):
            return
        h = len(self._history)
        if len(arr) >= h:
            self._history[:] = arr[-h:]
        else:
            self._history[:-len(arr)] = self._history[len(arr):]
            self._history[-len(arr):] = arr
