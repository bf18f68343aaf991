"""Device-memory ledger: per-component byte accounting.

The port of ``eventgpt_tpu/obs/memory.py``, in torch terms:

  * **Ledger** (``LEDGER``, process-global, thread-safe): named components
    (the weight tree, the resident KV cache or the paged pool and its
    tables, the logits and ids buffers, prefix-cache entries, the lane
    buffers, Medusa drafts, the pipelined carry, the host spill store)
    updated by ``register``/``resize``/``release`` at every allocation
    site (``ContinuousBatcher``, ``PrefixCache``, ``SpillStore``, the lane
    allocator, model load). It tracks current and peak totals and exports
    the ``egpt_mem_*`` gauges and ``mem_alloc``/``mem_release`` trace
    instants.
  * **Static capacity model** (``estimate``): closed-form bytes of one
    ``ContinuousBatcher`` from its config, which equal the port's live
    buffers byte for byte. It follows the port's own buffers, which
    differ from the JAX package's in one place: a lane's KV rows carry
    ``chunk_p`` positions beyond the lane bucket (ROADMAP Queue 3).
  * **Compiled footprint** (``compiled_stats``): the port runs eager
    kernels and has no compiled executable to ask, so it answers
    ``{"unavailable": ...}``, the JAX contract for a backend without
    memory analysis; the ``egpt_mem_compiled_*`` gauges stay unset.
  * **Shared entries** (``hold``/``unhold``): a weight tree that several
    batchers serve is one entry, held once by each batcher over it (and by
    ``cli/infer.prepare_model`` while the tree's embedding table lives) and
    released with its last holder. The JAX ledger keeps such an entry after
    its tree is dropped, so a process that builds several trees counted
    past its device's bytes there (ROADMAP Queue 3).
  * **Reconciliation** (``reconcile``): the allocator's bytes on a card
    (``torch.cuda.memory_allocated``), the live CPU tensor storages on the
    CPU, against the ledger's total.

The ledger core is stdlib-only (``torch`` is imported inside the
functions that need it) and chain-neutral: it reads sizes and counts
allocations, never a tensor's values. Lock order: callers may hold their
own lock (``PrefixCache._lock``, ``SpillStore._lock``) when calling in;
the ledger lock is a leaf below them and above the metric locks.
"""

from __future__ import annotations

import gc
import threading
from typing import Any, Dict, Optional, Tuple

from eventgpt_tpu_torch.obs import metrics as obs_metrics
from eventgpt_tpu_torch.obs import trace as obs_trace

# The component taxonomy: a CLOSED set, because component names are the
# egpt_mem_component_bytes label values (METRIC_LABELS keeps the same
# tuple).
COMPONENTS = ("weights", "kv_cache", "kv_pool", "kv_block_table", "logits",
              "ids_buf", "prefix_cache", "lanes", "draft", "carry", "spill",
              "other")

# The prompt bucket grain of the server (``serve._GRAIN``): prompt buckets
# and max_len round to it. 64 is ``constants.SEQ_BUCKET``, kept here so the
# module imports nothing of the port.
_SEQ_BUCKET = 64


class MemoryLedger:
    """Process-global device-byte ledger: ``(component, key)`` -> bytes.

    ``key`` namespaces an entry to its owner (``"b1a2f/kv_cache"``) so a
    fleet of in-process replicas can each report THEIR resident bytes
    (``snapshot(owner=...)``) while the process totals stay the sum.
    Registering an existing key is a resize (idempotent re-registration
    of a shared weight tree costs nothing); ``release`` drops the entry.

    Thread-safety: the scheduler thread registers/releases while HTTP
    handler threads read ``summary()`` — every mutation and compound
    read takes ``_lock``. Peak tracking (``peak_bytes``) is phase-scoped
    via ``reset_peak()`` (the bench's per-point reset, like
    ``reset_serving_stats``)."""

    # Lock-discipline contract: byte counters
    # and the entry map only move under the ledger lock. The last
    # reconcile results are snapshot/flag reads (``/w``) — swapped
    # whole under the lock, read lock-free by summary consumers.
    _GUARDED_BY = {
        "_entries": "_lock",
        "_holders": "_lock",
        "_component_totals": "_lock",
        "total_bytes": "_lock",
        "peak_bytes": "_lock",
        "_live_bytes": "_lock/w",
        "_unaccounted_bytes": "_lock/w",
    }

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], int] = {}
        # Holders of each shared entry (``hold``/``unhold``).
        self._holders: Dict[Tuple[str, str], int] = {}
        self._component_totals: Dict[str, int] = {}
        self.total_bytes = 0
        self.peak_bytes = 0
        # Last reconcile() results (None until the first run): summary()
        # reads them lock-free -- GET /memory refreshes, /stats must not
        # reconcile once per scheduler step.
        self._live_bytes: Optional[int] = None
        self._unaccounted_bytes: Optional[int] = None

    def register(self, component: str, key: str, nbytes: int) -> None:
        """Attribute ``nbytes`` device bytes to ``(component, key)``.
        Re-registering a key RESIZES it (the delta moves the totals), so
        growth sites (lane-bucket growth, prefix-cache totals) call this
        unconditionally."""
        if component not in COMPONENTS:
            raise ValueError(
                f"unknown memory component {component!r}: one of "
                f"{COMPONENTS} (the taxonomy is a closed metric-label "
                f"enum — extend COMPONENTS + METRIC_LABELS together)")
        nbytes = int(nbytes)
        with self._lock:
            old = self._entries.get((component, key), 0)
            delta = nbytes - old
            if delta == 0 and (component, key) in self._entries:
                return
            self._entries[(component, key)] = nbytes
            self._component_totals[component] = (
                self._component_totals.get(component, 0) + delta)
            self.total_bytes += delta
            if self.total_bytes > self.peak_bytes:
                self.peak_bytes = self.total_bytes
            self._export_gauges_locked(component)
        # Trace outside the lock (instants take the tracer's own lock);
        # armed tracing shows every allocation move on the timeline.
        obs_trace.instant("mem_alloc" if delta > 0 else "mem_release",
                          cat="mem", component=component,
                          delta_bytes=delta, total_bytes=nbytes)

    # resize IS register (the delta form); the alias documents intent at
    # call sites that shrink/grow an existing allocation.
    resize = register

    def release(self, component: str, key: str) -> None:
        """Drop an entry (the allocation was freed). Unknown keys are a
        no-op — release paths run in sweeps that may repeat."""
        with self._lock:
            old = self._drop_locked(component, key)
        if old is not None:
            obs_trace.instant("mem_release", cat="mem", component=component,
                              delta_bytes=-old, total_bytes=0)

    def _drop_locked(self, component: str, key: str) -> Optional[int]:
        old = self._entries.pop((component, key), None)
        if old is not None:
            self._component_totals[component] = (
                self._component_totals.get(component, 0) - old)
            self.total_bytes -= old
            self._export_gauges_locked(component)
        return old

    def hold(self, component: str, key: str, nbytes: int) -> None:
        """``register`` a shared entry and count one holder more: the
        entry stays until its last holder calls ``unhold``."""
        with self._lock:
            self._holders[(component, key)] = self._holders.get((component, key), 0) + 1
        self.register(component, key, nbytes)

    def unhold(self, component: str, key: str) -> None:
        """One holder of a shared entry fewer; the last one releases it."""
        with self._lock:
            n = self._holders.get((component, key), 0) - 1
            if n > 0:
                self._holders[(component, key)] = n
                return
            self._holders.pop((component, key), None)
            old = self._drop_locked(component, key)
        if old is not None:
            obs_trace.instant("mem_release", cat="mem", component=component,
                              delta_bytes=-old, total_bytes=0)

    def _export_gauges_locked(self, component: str) -> None:
        obs_metrics.MEM_TOTAL.set(self.total_bytes)
        obs_metrics.MEM_PEAK.set(self.peak_bytes)
        obs_metrics.MEM_COMPONENT.set(
            self._component_totals.get(component, 0), component=component)

    def reset_peak(self) -> None:
        """Phase-scope the peak to the traffic that follows (the bench's
        per-point reset)."""
        with self._lock:
            self.peak_bytes = self.total_bytes
            obs_metrics.MEM_PEAK.set(self.peak_bytes)

    def component_bytes(self, component: str) -> int:
        with self._lock:
            return self._component_totals.get(component, 0)

    def total(self) -> int:
        with self._lock:
            return self.total_bytes

    def snapshot(self, owner: Optional[str] = None) -> Dict[str, int]:
        """Per-component byte totals; ``owner`` filters to keys under
        ``"{owner}/"`` (one replica's resident share of the process)."""
        with self._lock:
            if owner is None:
                return {c: n for c, n in
                        sorted(self._component_totals.items()) if n}
            pre = owner + "/"
            out: Dict[str, int] = {}
            for (comp, key), n in sorted(self._entries.items()):
                if key.startswith(pre):
                    out[comp] = out.get(comp, 0) + n
            return out

    def summary(self) -> Dict[str, Any]:
        """The /stats merge + bench record body: ledger totals plus the
        LAST reconcile's accounted/unaccounted split (None until one
        ran) -- all host ints."""
        with self._lock:
            out: Dict[str, Any] = {
                "total_bytes": self.total_bytes,
                "peak_bytes": self.peak_bytes,
                "components": {c: n for c, n in
                               sorted(self._component_totals.items()) if n},
                "entries": len(self._entries),
            }
        out["live_bytes"] = self._live_bytes
        out["unaccounted_bytes"] = self._unaccounted_bytes
        return out

    def reconcile(self, device=None) -> Dict[str, Any]:
        """Honesty check: the device bytes the process holds against the
        ledger's total, and the accounted/unaccounted split. On a card
        the live bytes are ``torch.cuda.memory_allocated(device)`` (the
        caching allocator's tensors, not its reserved slack); on the CPU,
        which has no device total, the bytes of every live CPU tensor
        storage, each counted once -- the counterpart of the JAX
        package's walk of ``jax.live_arrays()`` there. Called from
        ``GET /memory``, never per scheduler step."""
        live = live_device_bytes(device)
        with self._lock:
            total = self.total_bytes
            unaccounted = live - total
            self._live_bytes = live
            self._unaccounted_bytes = unaccounted
        obs_metrics.MEM_LIVE.set(live)
        obs_metrics.MEM_UNACCOUNTED.set(unaccounted)
        return {
            "live_bytes": live,
            "accounted_bytes": total,
            "unaccounted_bytes": unaccounted,
            "accounted_ratio": (total / live) if live else 1.0,
        }


LEDGER = MemoryLedger()


def _tensors(tree):
    """The tensors and arrays of a nested dict / list tree."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif tree is not None and (hasattr(tree, "element_size") or hasattr(tree, "nbytes")):
        yield tree


def _leaf_bytes(x) -> int:
    if hasattr(x, "element_size"):
        return int(x.numel()) * int(x.element_size())
    return int(x.nbytes)


def params_bytes(tree: Any) -> int:
    """Sum of ``numel() * element_size()`` over the tensors of a (nested)
    tree, numpy arrays by their ``nbytes``: metadata only, no device
    read. The weight-tree registration helper."""
    return sum(_leaf_bytes(x) for x in _tensors(tree))


def abstract_params_bytes(cfg, quant: str = "bf16", dtype_bytes: int = 2) -> int:
    """Weight-tree bytes without materializing weights: the port's own
    init runs on the ``meta`` device (shapes and dtypes, no storage), then
    its int8/int4 quantizer over those shapes, and the leaf sizes are
    summed."""
    import torch

    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops import quant as quant_mod

    dtype = {2: torch.bfloat16, 4: torch.float32}[int(dtype_bytes)]
    tree = init_eventchat_params(cfg, torch.Generator(), dtype, device="meta")
    if quant in ("int8", "int4"):
        quant_mod.quantize_llama_params(tree["llama"], bits=4 if quant == "int4" else 8)
    return params_bytes(tree)


def _grain_round(n: int, grain: int) -> int:
    return ((int(n) + grain - 1) // grain) * grain


def kv_pos_bytes(cfg, kv_quant: bool = False, dtype_bytes: int = 2) -> int:
    """K+V bytes of ONE cache position of ONE row, the unit every
    row/lane/entry estimate multiplies. Mirrors ``llama.init_kv_cache``:
    the compute dtype stores ``L x 2 x KV x hd``; int8 stores one byte a
    value and one f32 scale per (layer, position, kv-head)."""
    lc = cfg.llama
    hd = lc.resolved_head_dim()
    per_plane = lc.num_layers * lc.num_kv_heads
    if kv_quant:
        return 2 * per_plane * (hd * 1 + 4)
    return 2 * per_plane * hd * dtype_bytes


def _mesh_divisors(cfg, mesh_shape: Optional[Dict[str, int]], batch: int) -> Dict[str, int]:
    """The serving layout's sharding divisors, from
    ``parallel.serving.serving_divisors``, so that the capacity model and
    the placement code cannot drift."""
    if not mesh_shape:
        return {"batch": 1, "kv_heads": 1, "weights": 1}
    from eventgpt_tpu_torch.parallel.serving import serving_divisors

    return serving_divisors(cfg.llama.num_kv_heads, mesh_shape, batch)


def estimate(cfg, *, max_batch: int, max_len: int, kv_quant: bool = False,
             dtype_bytes: int = 2, speculative: int = 0,
             prefill_budget: int = 0, prefill_lane_chunk: int = 0,
             lane_bucket: Optional[int] = None,
             prefix_cache_bytes: int = 0, weights_bytes: int = 0,
             vocab: Optional[int] = None,
             mesh_shape: Optional[Dict[str, int]] = None,
             kv_layout: str = "dense", kv_pool_blocks: int = 0,
             kv_block_size: int = 0, spill_capacity_bytes: int = 0) -> Dict[str, Any]:
    """Static capacity model: closed-form component bytes of one
    ``ContinuousBatcher`` from its config, the constructor's own
    arithmetic (grain-rounded ``max_len``, the lane cap and chunk policy,
    the unquantized lane cache), so that it equals the live buffers byte
    for byte. ``speculative`` is the widest window (the draft buffer's
    width + 1). ``weights_bytes`` is the caller's weight-tree term
    (``params_bytes`` of a live tree, ``abstract_params_bytes`` of one
    never built). ``mesh_shape`` ({"data": d, "fsdp": f, "model": m})
    applies the serving layout's divisors, as the JAX package's estimate
    does, and adds a ``per_device`` view. That view is the JAX layout's,
    whose dense batcher splits its rows over (data, fsdp); the port's
    batcher runs every row on every rank (``ContinuousBatcher(mesh=)``),
    so its rank holds the cache's KV-head share of all rows, which each
    rank's live ledger (``GET /memory``) reports. ``spill_capacity_bytes``
    adds the host spill store's budget as ``spill`` (the JAX estimate has
    no such term): the store counts whole rows against it, and a rank holds
    its KV heads' share of each record. A prefill role's handoff records
    are gathered whole and leave at once; neither package's ledger counts
    them."""
    grain = 2 * _SEQ_BUCKET
    max_len = _grain_round(max_len, grain)
    pos_bytes = kv_pos_bytes(cfg, kv_quant, dtype_bytes)
    row_bytes = max_len * pos_bytes
    vocab = int(vocab if vocab is not None else cfg.llama.vocab_size)

    comp: Dict[str, int] = {}
    if weights_bytes:
        comp["weights"] = int(weights_bytes)
    if kv_layout == "paged":
        # One arena of n_blocks blocks (scratch included) plus the
        # (B, max_len / bs) int32 tables and the (B,) length plane.
        bs = int(kv_block_size) or _SEQ_BUCKET
        nbpr = max_len // bs
        n_blocks = int(kv_pool_blocks) or (max_batch * nbpr + 1)
        comp["kv_pool"] = n_blocks * bs * pos_bytes
        comp["kv_block_table"] = max_batch * nbpr * 4 + max_batch * 4
    else:
        # B rows + the (B,) int32 length plane.
        comp["kv_cache"] = max_batch * row_bytes + max_batch * 4
    comp["logits"] = max_batch * vocab * 4
    if speculative:
        comp["ids_buf"] = max_batch * max_len * 4
        comp["draft"] = max_batch * max(speculative - 1, 0) * 4
    if prefill_budget > 0:
        # The constructor's lane policy: chunk_p = prefill_lane_chunk or
        # min(budget, SEQ_BUCKET); K_cap = budget // chunk_p capped at
        # max_batch. The lane KV (always unquantized) holds S_lane +
        # chunk_p positions a lane, the embeddings S_lane; plus the (K,)
        # length plane.
        lane_chunk = int(prefill_lane_chunk) or min(prefill_budget, _SEQ_BUCKET)
        lane_chunk = max(1, min(lane_chunk, prefill_budget))
        k_cap = max(1, min(prefill_budget // lane_chunk, max_batch))
        s_lane = _grain_round(lane_bucket or grain, grain)
        s_lane = min(s_lane, max_len)
        lane_pos = kv_pos_bytes(cfg, False, dtype_bytes)
        comp["lanes"] = k_cap * ((s_lane + lane_chunk) * lane_pos
                                 + s_lane * cfg.llama.hidden_size * dtype_bytes) + k_cap * 4
    if prefix_cache_bytes:
        comp["prefix_cache"] = int(prefix_cache_bytes)
    if spill_capacity_bytes:
        comp["spill"] = int(spill_capacity_bytes)
    total = sum(comp.values())
    out: Dict[str, Any] = {
        "components": comp,
        "total_bytes": total,
        "row_bytes": row_bytes,
        "kv_pos_bytes": pos_bytes,
        "entry_bytes_per_bucket": grain * pos_bytes,
        "max_len": max_len,
    }
    if mesh_shape:
        div = _mesh_divisors(cfg, mesh_shape, max_batch)
        per: Dict[str, int] = {}
        for name, n in comp.items():
            if name == "weights":
                per[name] = n // div["weights"]
            elif name in ("kv_cache", "lanes"):
                # Rows over (data, fsdp) and KV heads over model compose.
                per[name] = n // (div["batch"] * div["kv_heads"])
            elif name in ("kv_pool", "prefix_cache", "spill"):
                # The arena (and a spilled run of it) has no batch axis: only
                # the KV heads split.
                per[name] = n // div["kv_heads"]
            elif name in ("kv_block_table", "logits", "ids_buf", "draft"):
                per[name] = n // div["batch"]
            else:
                per[name] = n
        out["divisors"] = div
        out["per_device"] = per
        out["per_device_total_bytes"] = sum(per.values())
    return out


def compiled_stats(*args, **kwargs) -> Dict[str, Any]:
    """The JAX package's compiled-footprint probe reads XLA's
    ``memory_analysis()`` of a compiled executable. The port's segments
    are eager kernels with no compiled executable, so this answers as the
    JAX probe does on a backend without memory analysis."""
    return {"unavailable": "eager PyTorch: the segment has no compiled executable to analyse"}


def live_device_bytes(device=None) -> int:
    """The bytes the process holds on ``device``: the CUDA caching
    allocator's allocated bytes on a card; on the CPU the storages of
    every live CPU tensor, each once."""
    import torch

    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.memory_allocated(dev))
    seen = {}
    for obj in gc.get_objects():
        try:
            # type(), not isinstance(): the latter reads ``__class__``, which
            # some module proxies among the gc's objects answer with a warning.
            if not issubclass(type(obj), torch.Tensor) or obj.device.type != "cpu":
                continue
            st = obj.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        except Exception:
            continue
    return int(sum(seen.values()))


def device_capacity_bytes(device=None) -> int:
    """The card's total memory (``torch.cuda.mem_get_info``); 0 on the CPU,
    which reports none: the headroom guard is inert there without an
    explicit ``--mem_capacity_mb``."""
    try:
        import torch

        dev = torch.device("cpu") if device is None else torch.device(device)
        if dev.type == "cuda" and torch.cuda.is_available():
            return int(torch.cuda.mem_get_info(dev)[1])
    except Exception:
        pass
    return 0
