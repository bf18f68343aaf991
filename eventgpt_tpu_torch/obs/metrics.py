"""Process-global metrics registry with Prometheus text exposition.

The port of ``obs/metrics.py``: the one place a number must
be registered to become operable -- scrapeable at ``GET /metrics``
(Prometheus text format 0.0.4), summarized into ``/stats``, and dumped
per train step into ``telemetry.jsonl``.

  * every metric name matches ``egpt_[a-z0-9_]+`` and is registered
    EXACTLY ONCE, at import time, in THIS module -- call sites import the
    metric object (``SERVE_TTFT.observe(dt)``), they never register;
  * hot paths time with ``time.perf_counter`` (monotonic), never
    ``time.time``.

The catalogue below carries the JAX package's names, help strings,
buckets and label enums verbatim, fleet metrics included, so the same
events render byte-identical exposition in both packages
(``tests/test_torch_obs.py``). Help strings are data and stay as the
reference wrote them, even where they name the reference's own parts.

Thread-safety: every mutation takes the metric's lock (scheduler,
handler and trainer threads all observe). A histogram observe is one
bisect + three dict writes under a lock.

Histograms are FIXED-BUCKET log2: upper bounds at powers of two, so
bucket assignment is a bisect over ~30 floats, merging across processes
is trivial (same bounds always), and the exposition stays small.

Disarm with ``configure(enabled=False)`` (one module-global bool read
per call when off). Telemetry reads host values only, never a device
tensor, so chains are byte-identical on/off.
"""

from __future__ import annotations

import json
import math
import re
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

NAME_RE = re.compile(r"^egpt_[a-z0-9_]+$")

_INF = float("inf")

# Fixed label-value enums per metric: every labelled observation draws
# its values from the set declared HERE -- bounded cardinality by
# construction. A request-shaped label (rid, user id, session id) would
# grow the exposition without bound. The metric classes enforce the
# enums at observe time. The dict equals the JAX package's
# ``METRIC_LABELS`` (tests/test_torch_obs.py).
METRIC_LABELS = {
    "egpt_serve_requests_total": {
        "status": ("ok", "deadline_exceeded", "cancelled",
                   "nan_quarantined", "engine_fault",
                   "resource_exhausted"),
    },
    "egpt_serve_prefill_dispatches_total": {
        "kind": ("full", "wave", "chunk", "suffix", "suffix_wave",
                 "piggyback"),
    },
    "egpt_fault_trips_total": {
        # Mirrors the JAX package's wired maybe_fail/maybe_delay sites;
        # "other" absorbs synthetic/ad-hoc drill sites
        # (faults._site_label clamps).
        "site": ("fleet.probe", "fleet.replica_kill", "fleet.route",
                 "multiproc.launch", "multiproc.worker",
                 "procfleet.handoff", "procfleet.rpc", "procfleet.spawn",
                 "procfleet.worker_kill", "serve.admit",
                 "serve.dispatch", "serve.loop", "serve.mem_guard",
                 "serve.mixed_dispatch", "serve.preempt",
                 "serve.prefix_copy", "serve.spec_adapt", "serve.spill",
                 "serve.step", "train.step", "other"),
        "kind": ("fail", "delay"),
    },
    "egpt_mem_component_bytes": {
        # The memory ledger's component taxonomy (obs/memory.py
        # COMPONENTS — keep the two literals identical; the ledger
        # validates at register time, this enum at observe time).
        # kv_pool / kv_block_table are the paged-layout split of
        # kv_cache: the arena scales with blocks, the table
        # with max_batch.
        "component": ("weights", "kv_cache", "kv_pool", "kv_block_table",
                      "logits", "ids_buf", "prefix_cache", "lanes",
                      "draft", "carry", "spill", "other"),
    },
    "egpt_fleet_routed_total": {
        # Routing decisions: affinity = the session's pinned
        # replica (its radix prefix is hot), least_queue = fallback by
        # queue depth, repin = failover re-route that moved the
        # session's pin to a survivor.
        "reason": ("affinity", "least_queue", "repin"),
    },
    "egpt_fleet_shed_total": {
        "slo_class": ("interactive", "batch"),
    },
    "egpt_serve_slo_requests_total": {
        "slo_class": ("interactive", "batch"),
        "met": ("true", "false"),
    },
    "egpt_serve_slo_ttft_seconds": {
        "slo_class": ("interactive", "batch"),
    },
    "egpt_serve_slo_itl_seconds": {
        "slo_class": ("interactive", "batch"),
    },
    "egpt_serve_slo_latency_seconds": {
        "slo_class": ("interactive", "batch"),
    },
    "egpt_procfleet_failovers_total": {
        # How a lost worker's requests moved: drain = the
        # worker still answered RPC and export_requests() re-routed its
        # in-flight work; redo = the worker died hard (SIGKILL/crash)
        # and the coordinator re-submitted from its own records.
        "path": ("drain", "redo"),
    },
    "egpt_serve_slo_miss_cause_total": {
        # The flight recorder's dominant-miss-cause enum (obs/journey.py
        # MISS_CAUSES — keep the two literals identical; this enum
        # enforces at observe time).
        "slo_class": ("interactive", "batch"),
        "cause": ("queue", "defer", "preempt", "admission", "decode",
                  "host_gap", "failover_redo", "handoff",
                  "nan_quarantine", "shed", "other"),
    },
    "egpt_procfleet_handoff_total": {
        # Prefill->decode KV handoff stages: gathered = the
        # prefill worker pulled the block run to host RAM, shipped =
        # the coordinator moved it to a decode worker over RPC,
        # spliced = the decode worker scattered it into its arena.
        # gathered/spliced increment in the worker processes' own
        # registries, shipped in the coordinator's; /stats aggregates
        # the fleet-wide totals from the handoff counters instead.
        "stage": ("gathered", "shipped", "spliced"),
    },
    "egpt_serve_preemptions_total": {
        # How a preempted victim's KV left the arena: spill =
        # gathered to the host SpillStore for a byte-exact restore,
        # drop = released for re-prefill on re-admission (policy choice
        # or spill-path fallback).
        "mode": ("spill", "drop"),
    },
    "egpt_alert_active": {
        # The alert evaluator's CLOSED rule enum (obs/series.py
        # ALERT_RULES — keep the two literals identical; this enum
        # enforces at observe time).
        "rule": ("slo_burn", "queue_trend", "cause_shift", "breaker_flap",
                 "mem_shrink"),
    },
    "egpt_alert_transitions_total": {
        # Same enum as egpt_alert_active (ALERT_RULES, obs/series.py).
        "rule": ("slo_burn", "queue_trend", "cause_shift", "breaker_flap",
                 "mem_shrink"),
    },
}


def log2_buckets(lo: float, hi: float) -> Tuple[float, ...]:
    """Power-of-two upper bounds covering [lo, hi]: the first bound is
    the largest 2^k <= lo, the last the smallest 2^k >= hi. (+Inf is
    implicit — every histogram has an overflow bucket.)"""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    e = math.floor(math.log2(lo) + 1e-12)
    out = []
    while True:
        b = 2.0 ** e
        out.append(b)
        if b >= hi:
            return tuple(out)
        e += 1


# Shared bucket families:
#   LATENCY — 61 us .. 128 s: request-scale times (TTFT, queue wait,
#             completion, admission, train step).
#   SHORT   — 0.95 us .. 8 s: per-token / per-segment times (ITL,
#             segment wait, data wait).
#   ROWS    — 1 .. 1024: batch-occupancy style small counts.
LATENCY_BUCKETS = log2_buckets(2.0 ** -14, 2.0 ** 7)
SHORT_BUCKETS = log2_buckets(2.0 ** -20, 2.0 ** 3)
ROWS_BUCKETS = tuple(float(2 ** e) for e in range(0, 11))


def _fmt(v: float) -> str:
    """Prometheus sample value / le formatting: integral floats render
    without the trailing .0 (golden-test stable across Python versions)."""
    if v == _INF:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    """Base: one name, one help string, samples keyed by sorted label
    tuples. Subclasses hold the per-key state under ``self._lock``."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "Registry"):
        self.name = name
        self.help = help
        self._reg = registry
        self._lock = threading.Lock()
        # Declared label enums for THIS metric (None = unlisted, e.g. a
        # test's private registry): an out-of-enum value raises instead
        # of minting a fresh unbounded series.
        self._enums = METRIC_LABELS.get(name)

    def _key(self, labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        if not labels:
            return ()
        if self._enums is not None:
            for k, v in labels.items():
                vals = self._enums.get(k)
                if vals is None or str(v) not in vals:
                    raise ValueError(
                        f"metric {self.name}: label {k}={v!r} outside "
                        f"the declared enum (METRIC_LABELS, "
                        f"obs/metrics.py) — labels are bounded-"
                        f"cardinality by contract")
        return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter(_Metric):
    kind = "counter"

    # Lock contract: the sample map only
    # mutates/reads under the metric's own lock — scheduler, handler
    # and trainer threads all observe concurrently. Gauge inherits
    # this declaration (same-module base resolution).
    _GUARDED_BY = {"_values": "_lock"}

    def __init__(self, name, help, registry):
        super().__init__(name, help, registry)
        self._values: Dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if not self._reg.enabled:
            return
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def labeled(self) -> Dict[tuple, float]:
        """Snapshot of every label set's value, keyed by the sorted
        ``((key, value), ...)`` tuple — the time-series sampler's
        cumulative read (obs/series.py derives windowed per-label
        rates from deltas of this)."""
        with self._lock:
            return dict(self._values)

    def _reset(self) -> None:
        with self._lock:
            self._values.clear()

    def _render(self, common: tuple) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            items = [((), 0.0)]
        return [f"{self.name}{_label_str(common + k)} {_fmt(v)}"
                for k, v in items]

    def _summary(self):
        with self._lock:
            if not self._values:
                return 0.0
            if list(self._values) == [()]:
                return self._values[()]
            return {_label_str(k) or "_": v
                    for k, v in sorted(self._values.items())}


class Gauge(Counter):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._values[self._key(labels)] = float(v)


class Histogram(_Metric):
    """Fixed-bucket log2 histogram. ``observe(v, n=k)`` adds ``k``
    observations of value ``v`` (one lock round-trip for a whole decode
    segment's worth of per-token gaps)."""

    kind = "histogram"

    _GUARDED_BY = {"_counts": "_lock", "_sums": "_lock",
                   "_totals": "_lock"}

    def __init__(self, name, help, registry,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help, registry)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)) or (bounds and bounds[-1] == _INF):
            raise ValueError(f"buckets must be strictly increasing and "
                             f"finite (+Inf is implicit): {bounds}")
        self.bounds = bounds
        # per label-key: [counts per bound + overflow], sum, count
        self._counts: Dict[tuple, List[float]] = {}
        self._sums: Dict[tuple, float] = {}
        self._totals: Dict[tuple, float] = {}

    def observe(self, v: float, n: int = 1, **labels) -> None:
        if not self._reg.enabled or n <= 0:
            return
        i = bisect_left(self.bounds, v)  # bucket upper bounds: le semantics
        k = self._key(labels)
        with self._lock:
            c = self._counts.get(k)
            if c is None:
                c = self._counts[k] = [0.0] * (len(self.bounds) + 1)
                self._sums[k] = 0.0
                self._totals[k] = 0.0
            c[i] += n
            self._sums[k] += v * n
            self._totals[k] += n

    def count(self, **labels) -> float:
        with self._lock:
            return self._totals.get(self._key(labels), 0.0)

    def agg_counts(self) -> List[float]:
        """Per-bucket counts aggregated over every label set (overflow
        last, same order as ``bounds`` + implicit +Inf) — the
        time-series sampler's cumulative read: windowed quantiles come
        from deltas of consecutive snapshots (obs/series.py)."""
        with self._lock:
            agg = [0.0] * (len(self.bounds) + 1)
            for c in self._counts.values():
                for i, v in enumerate(c):
                    agg[i] += v
            return agg

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile, aggregated over every
        label set: the smallest bucket bound whose cumulative count
        reaches q * total (log2 buckets -> factor-2 resolution). 0.0
        when empty; the last finite bound stands in for +Inf overflow."""
        with self._lock:
            total = sum(self._totals.values())
            if total <= 0:
                return 0.0
            agg = [0.0] * (len(self.bounds) + 1)
            for c in self._counts.values():
                for i, v in enumerate(c):
                    agg[i] += v
        need = q * total
        cum = 0.0
        for i, v in enumerate(agg):
            cum += v
            if cum >= need - 1e-9:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]

    def _reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()

    def _render(self, common: tuple) -> List[str]:
        with self._lock:
            keys = sorted(self._counts)
            rows = [(k, list(self._counts[k]), self._sums[k], self._totals[k])
                    for k in keys]
        if not rows:
            rows = [((), [0.0] * (len(self.bounds) + 1), 0.0, 0.0)]
        out = []
        for k, counts, s, total in rows:
            cum = 0.0
            for bound, c in zip(self.bounds + (_INF,), counts):
                cum += c
                lk = common + k + (("le", _fmt(bound)),)
                out.append(f"{self.name}_bucket{_label_str(lk)} {_fmt(cum)}")
            out.append(f"{self.name}_sum{_label_str(common + k)} {_fmt(s)}")
            out.append(f"{self.name}_count{_label_str(common + k)} {_fmt(total)}")
        return out

    def _summary(self):
        with self._lock:
            total = sum(self._totals.values())
            s = sum(self._sums.values())
        if total <= 0:
            return {"count": 0}
        return {
            "count": int(total),
            "sum": round(s, 6),
            "mean": round(s / total, 6),
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


class Registry:
    """Name -> metric, rendered in registration order. One process-global
    instance (``REGISTRY``) below; tests build private ones.

    Lock contract: the metric map and the common-label tuple mutate
    under ``_lock``; ``_common`` reads are lock-free (``/w`` — an
    atomically swapped tuple, set once at worker start). ``enabled`` is
    deliberately undeclared: a bare bool flag read once per observation
    (the A/B disarm switch), GIL-atomic by construction."""

    _GUARDED_BY = {"_metrics": "_lock", "_common": "_lock/w"}

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._common: Tuple[Tuple[str, str], ...] = ()
        self.enabled = True

    def _register(self, m: _Metric) -> _Metric:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(
                    f"metric {m.name!r} is already registered — metrics are "
                    f"defined exactly once, at import, in obs/metrics.py")
            if not NAME_RE.match(m.name):
                raise ValueError(
                    f"metric name {m.name!r} must match {NAME_RE.pattern}")
            self._metrics[m.name] = m
        return m

    def counter(self, name: str, help: str) -> Counter:
        return self._register(Counter(name, help, self))

    def gauge(self, name: str, help: str) -> Gauge:
        return self._register(Gauge(name, help, self))

    def histogram(self, name: str, help: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help, self, buckets))

    def configure(self, enabled: bool) -> None:
        """Arm/disarm every metric in this registry (the A/B switch the
        overhead bench and the chain-neutrality test flip)."""
        self.enabled = bool(enabled)

    def set_common_labels(self, **labels) -> None:
        """Labels stamped on every exposed sample — e.g. the per-process
        ``process="3"`` label multiproc workers set so one scrape target
        per host stays disambiguated (DISTRIBUTED.md)."""
        with self._lock:
            self._common = tuple(
                sorted((k, str(v)) for k, v in labels.items()))

    def reset(self) -> None:
        """Zero every value (registration survives) — phase-scoped
        measurement, e.g. bench excluding its warmup traffic."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._render(self._common))
        return "\n".join(lines) + "\n"

    def summary(self, prefixes: Optional[Iterable[str]] = None) -> Dict:
        """Compact dict view (the ``/stats`` merge and the trainer's
        ``telemetry.jsonl`` lines): counters/gauges as values, histograms
        as {count, sum, mean, p50, p99}."""
        pf = tuple(prefixes) if prefixes else None
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m._summary() for m in metrics
                if pf is None or m.name.startswith(pf)}


REGISTRY = Registry()

# --------------------------------------------------------------------------
# The metric catalogue. Every metric in the process is defined HERE, once
# -- call sites import these objects.

# -- serving (serve.py + cli/serve.py) --
SERVE_TTFT = REGISTRY.histogram(
    "egpt_serve_ttft_seconds",
    "Submit to first committed token, per request")
SERVE_ITL = REGISTRY.histogram(
    "egpt_serve_itl_seconds",
    "Inter-token latency: mean commit gap per row per harvest, "
    "weighted by tokens (excludes the first token - that is TTFT)",
    SHORT_BUCKETS)
SERVE_QUEUE_WAIT = REGISTRY.histogram(
    "egpt_serve_queue_wait_seconds",
    "Submit to leaving the admission queue, per request")
SERVE_LATENCY = REGISTRY.histogram(
    "egpt_serve_latency_seconds",
    "Submit to terminal status (any status), per request")
SERVE_ADMISSION = REGISTRY.histogram(
    "egpt_serve_admission_seconds",
    "Host admission stall per scheduler step (encode + prefill + insert)",
    SHORT_BUCKETS)
SERVE_SEGMENT = REGISTRY.histogram(
    "egpt_serve_segment_seconds",
    "Host time blocked fetching one decode/spec segment (the un-hidden "
    "device time; pipelined overlap shrinks it, not the device work)",
    SHORT_BUCKETS)
SERVE_OCCUPANCY = REGISTRY.histogram(
    "egpt_serve_batch_occupancy_rows",
    "Unfrozen rows at segment dispatch (batch utilization)",
    ROWS_BUCKETS)
SERVE_REQUESTS = REGISTRY.counter(
    "egpt_serve_requests_total",
    "Finished requests by terminal status "
    "(ok / deadline_exceeded / cancelled / nan_quarantined / "
    "engine_fault / resource_exhausted)")
SERVE_TOKENS = REGISTRY.counter(
    "egpt_serve_tokens_total", "Committed (served) tokens")
SERVE_SEGMENTS = REGISTRY.counter(
    "egpt_serve_segments_total", "Dispatched decode/spec segments")
SERVE_HOST_GAP = REGISTRY.counter(
    "egpt_serve_host_gap_seconds_total",
    "Host scheduler time between segment fetches (harvest bookkeeping, "
    "admission prep, dispatch)")
SERVE_OVERLAP_HIDDEN = REGISTRY.counter(
    "egpt_serve_overlap_hidden_seconds_total",
    "Share of the host gap spent while a dispatched segment was "
    "verifiably still running on the device")
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "egpt_serve_queue_depth", "Requests waiting in the admission queue")
SERVE_ACTIVE_ROWS = REGISTRY.gauge(
    "egpt_serve_active_rows", "Rows holding a live request")
SERVE_BREAKER_OPEN = REGISTRY.gauge(
    "egpt_serve_breaker_open",
    "1 while the circuit breaker refuses work (health=degraded), else 0")
SERVE_SCHED_FAULTS = REGISTRY.counter(
    "egpt_serve_scheduler_faults_total",
    "Scheduler-thread faults survived by the engine")
SERVE_SCHED_RESTARTS = REGISTRY.counter(
    "egpt_serve_scheduler_restarts_total",
    "Scheduler-thread restarts after a fault")
# -- prefix-KV cache + batched admission (serve.py) --
SERVE_PREFIX_HITS = REGISTRY.counter(
    "egpt_serve_prefix_cache_hits_total",
    "Admissions served from a cached prefix-KV entry (suffix-only prefill)")
SERVE_PREFIX_MISSES = REGISTRY.counter(
    "egpt_serve_prefix_cache_misses_total",
    "Admissions that found no usable prefix entry (full prefill)")
SERVE_PREFIX_EVICTIONS = REGISTRY.counter(
    "egpt_serve_prefix_cache_evictions_total",
    "Prefix entries LRU-evicted under the HBM byte budget")
SERVE_PREFIX_INSERTIONS = REGISTRY.counter(
    "egpt_serve_prefix_cache_insertions_total",
    "Prefix entries inserted (set_prefix or insert-on-prefill)")
SERVE_PREFIX_BYTES = REGISTRY.gauge(
    "egpt_serve_prefix_cache_bytes",
    "HBM bytes held by cached prefix-KV entries")
SERVE_PREFIX_ENTRIES = REGISTRY.gauge(
    "egpt_serve_prefix_cache_entries",
    "Live prefix-KV cache entries")
SERVE_ADMISSION_WAVE = REGISTRY.histogram(
    "egpt_serve_admission_wave_rows",
    "Full-prefill admissions batched into one prefill dispatch (wave size)",
    ROWS_BUCKETS)
SERVE_PREFILL_DISPATCHES = REGISTRY.counter(
    "egpt_serve_prefill_dispatches_total",
    "Admission prefill dispatches by kind: full (batch-1), wave (one per "
    "BATCH of admissions), chunk (per chunked-prefill advance), suffix "
    "(prefix-cache hit), piggyback (mixed segment carrying prefill lanes)")
# -- stall-free admission: mixed prefill+decode segments --
SERVE_MIXED_SEGMENTS = REGISTRY.counter(
    "egpt_serve_mixed_segments_total",
    "Dispatched MIXED segments: decode/spec body plus live piggyback "
    "prefill lanes in one executable")
SERVE_MIXED_LANES = REGISTRY.histogram(
    "egpt_serve_mixed_lane_rows",
    "Piggyback prefill lanes advanced per mixed segment",
    ROWS_BUCKETS)
SERVE_MIXED_PREFILL_TOKENS = REGISTRY.counter(
    "egpt_serve_mixed_prefill_tokens_total",
    "Prompt positions prefilled inside mixed segments (piggyback lanes), "
    "bounded per boundary by --prefill_budget")
# -- adaptive speculation (serve.py +
#    serve_spec.py) --
SERVE_SPEC_DEPTH = REGISTRY.histogram(
    "egpt_serve_spec_depth",
    "Speculation window selected per dispatch boundary by the adaptive "
    "controller (--spec_buckets; 1 = the draft-free fallback segment, "
    "the K=0 bucket). Constant at the fixed K without buckets",
    ROWS_BUCKETS)
SERVE_SPEC_ACCEPT = REGISTRY.gauge(
    "egpt_serve_spec_accept_ratio",
    "Controller acceptance EMA: accepted draft positions / offered "
    "draft positions across harvested verifies (the depth-selection "
    "signal; 0 until the first drafted verify lands)")
SERVE_SPEC_MASKED = REGISTRY.counter(
    "egpt_serve_spec_masked_rows",
    "Rows whose per-row draft depth was masked below the selected "
    "bucket's full depth, summed over dispatch boundaries (per-row "
    "windowed acceptance undershot the bucket, or a pruned head/level "
    "capped it)")
# -- SLO classes + goodput (serve.py) --
SERVE_SLO_REQUESTS = REGISTRY.counter(
    "egpt_serve_slo_requests_total",
    "Finished SLO-classed requests by class and attainment (met=true "
    "when every armed target held, inclusive)")
SERVE_SLO_TTFT = REGISTRY.histogram(
    "egpt_serve_slo_ttft_seconds",
    "Submit to first committed token by SLO class (requests that never "
    "committed are excluded, as in egpt_serve_ttft_seconds)")
SERVE_SLO_ITL = REGISTRY.histogram(
    "egpt_serve_slo_itl_seconds",
    "Per-request mean inter-token gap by SLO class (first token "
    "excluded - that interval is TTFT; single-token requests excluded)",
    SHORT_BUCKETS)
SERVE_SLO_LATENCY = REGISTRY.histogram(
    "egpt_serve_slo_latency_seconds",
    "Submit to terminal status by SLO class (every terminal path - "
    "forced finishes stay in the goodput denominator)")
SERVE_SLO_GOODPUT = REGISTRY.gauge(
    "egpt_serve_slo_goodput_ratio",
    "Fraction of the last slo_window SLO-classed finishes that met "
    "their targets (windowed SLO-attainment goodput)")
SERVE_SLO_MISS_CAUSE = REGISTRY.counter(
    "egpt_serve_slo_miss_cause_total",
    "SLO-missed finishes by class and the flight recorder's dominant "
    "miss cause (the largest phase of the request's decomposition: "
    "queue / defer / preempt / admission / decode / host_gap / "
    "failover_redo, plus the non-time causes nan_quarantine / shed / "
    "other); counted while the recorder is armed (--journey_keep > 0)")

# -- fleet serving: replica supervisor + router (fleet.py) --
# Aggregate-only on purpose: a per-replica label would be computed
# (str(idx)); per-replica numbers live in the
# fleet's /stats JSON and the bench artifact, read from each replica's
# host-side counters.
FLEET_REPLICAS = REGISTRY.gauge(
    "egpt_fleet_replicas", "Configured replicas in the fleet")
FLEET_ROUTABLE = REGISTRY.gauge(
    "egpt_fleet_replicas_routable",
    "Replicas currently in the routing pool (healthy: breaker closed, "
    "heartbeat fresh, not killed)")
FLEET_QUEUE_DEPTH = REGISTRY.gauge(
    "egpt_fleet_queue_depth",
    "Requests queued across every replica (the router's aggregate "
    "backlog — one of the two shedding signals)")
FLEET_ROUTED = REGISTRY.counter(
    "egpt_fleet_routed_total",
    "Routed submits by decision: affinity (session's pinned replica), "
    "least_queue (fallback), repin (failover moved the pin)")
FLEET_SHED = REGISTRY.counter(
    "egpt_fleet_shed_total",
    "Requests shed by the router's SLO-aware overload policy, by class "
    "(batch sheds first; interactive is never policy-shed)")
FLEET_FAILOVERS = REGISTRY.counter(
    "egpt_fleet_failovers_total",
    "Requests re-routed to a surviving replica after their replica "
    "died or faulted them (re-decoded from the prompt: greedy chains "
    "stay byte-identical)")
FLEET_REPLICA_DEATHS = REGISTRY.counter(
    "egpt_fleet_replica_deaths_total",
    "Replica kills observed by the supervisor (chaos fleet.replica_kill "
    "trips and operator kill_replica calls)")

# -- process fleet: worker processes behind the RPC coordinator
#    (fleet_proc.py + rpc.py) --
# Aggregate-only like the egpt_fleet_* family (a per-slot label would
# be unbounded); per-worker numbers live in /fleet and
# the PROCFLEET bench artifact.
PROCFLEET_WORKERS = REGISTRY.gauge(
    "egpt_procfleet_workers",
    "Configured worker-process slots in the process fleet")
PROCFLEET_ROUTABLE = REGISTRY.gauge(
    "egpt_procfleet_workers_routable",
    "Worker processes currently in the routing pool (ready, heartbeat "
    "fresh, answering RPC, not crash-looped)")
PROCFLEET_RPC_RETRIES = REGISTRY.counter(
    "egpt_procfleet_rpc_retries_total",
    "RPC attempts retried after a transport failure (refused/reset "
    "connection, short read, injected procfleet.rpc trip) — each retry "
    "backed off exponentially with jitter under the per-call deadline")
PROCFLEET_WORKER_DEATHS = REGISTRY.counter(
    "egpt_procfleet_worker_deaths_total",
    "Worker processes lost: unexpected exits (SIGKILL/crash), "
    "stale-heartbeat/unreachable drains, and operator kill_worker calls")
PROCFLEET_RESPAWNS = REGISTRY.counter(
    "egpt_procfleet_respawns_total",
    "Worker processes respawned into a dead slot (per-slot exponential "
    "backoff; stops when the crash-loop breaker gives the slot up)")
PROCFLEET_FAILOVERS = REGISTRY.counter(
    "egpt_procfleet_failovers_total",
    "Requests moved off a lost worker, by path: drain (exported over "
    "RPC from a still-answering worker) or redo (re-submitted from the "
    "coordinator's own records after a hard death); both re-decode "
    "from the prompt, so greedy chains stay byte-identical")
PROCFLEET_CRASH_LOOPS = REGISTRY.counter(
    "egpt_procfleet_crash_loop_slots_total",
    "Worker slots the crash-loop breaker gave up on (K crashes inside "
    "the window): capacity degrades, /health stays green while any "
    "other worker is routable")
PROCFLEET_HANDOFFS = REGISTRY.counter(
    "egpt_procfleet_handoff_total",
    "Prefill->decode KV handoffs by stage (ISSUE 17): gathered (block "
    "run pulled to host on the prefill worker), shipped (moved to a "
    "decode worker over the raw-binary RPC frame), spliced (scattered "
    "into the decode worker's arena); per-process registries — "
    "gathered/spliced count in the workers, shipped in the coordinator")
PROCFLEET_HANDOFF_BYTES = REGISTRY.counter(
    "egpt_procfleet_handoff_bytes_total",
    "Bytes of gathered KV handoff records shipped prefill->decode "
    "(coordinator-side; the raw-frame payload, KV planes + scales + "
    "row state, b64-free on the wire)")
PROCFLEET_HANDOFF_SECONDS = REGISTRY.histogram(
    "egpt_procfleet_handoff_seconds",
    "Coordinator wall time to move one handoff record: collect from "
    "the prefill worker through import acknowledged by the decode "
    "worker (the stitched handoff_s phase sums these durations)")

# -- HBM memory ledger (obs/memory.py) --
MEM_COMPONENT = REGISTRY.gauge(
    "egpt_mem_component_bytes",
    "Device bytes the memory ledger attributes to each named component "
    "(weights / kv_cache / kv_pool / kv_block_table / logits / ids_buf "
    "/ prefix_cache / lanes / draft / carry / spill / other; kv_pool + "
    "kv_block_table are the paged layout's split of kv_cache; spill is "
    "HOST bytes — the pinned spill store tier)")
MEM_TOTAL = REGISTRY.gauge(
    "egpt_mem_total_bytes",
    "Sum of all ledger-registered device bytes (the accounted side of "
    "the reconciliation split)")
MEM_PEAK = REGISTRY.gauge(
    "egpt_mem_peak_bytes",
    "High-water mark of egpt_mem_total_bytes since the last "
    "reset_peak() (phase-scoped, like reset_serving_stats)")
MEM_LIVE = REGISTRY.gauge(
    "egpt_mem_live_bytes",
    "jax.live_arrays() device bytes at the last ledger reconcile "
    "(GET /memory refreshes it)")
MEM_UNACCOUNTED = REGISTRY.gauge(
    "egpt_mem_unaccounted_bytes",
    "live_bytes minus ledger total at the last reconcile - bytes no "
    "component claims (transient admission caches, jit constants)")
MEM_GUARD_DEFERRALS = REGISTRY.counter(
    "egpt_mem_guard_deferrals_total",
    "Admission waves deferred by the --mem_headroom_mb guard (the "
    "ledger predicted the next wave would exceed capacity - headroom)")

# -- paged KV block pool (serve_blocks.py) --
SERVE_KV_BLOCKS_USED = REGISTRY.gauge(
    "egpt_serve_kv_blocks_used",
    "Pool blocks currently owned by rows and prefix entries (used "
    "tokens at the SEQ_BUCKET block grain — the quantity that now "
    "gates admission instead of batch x max_len)")
SERVE_KV_BLOCKS_FREE = REGISTRY.gauge(
    "egpt_serve_kv_blocks_free",
    "Pool blocks on the free list (admission headroom in blocks)")
SERVE_KV_COW_COPIES = REGISTRY.counter(
    "egpt_serve_kv_cow_copies_total",
    "Copy-on-write block copies: a prefix-shared run diverged mid-"
    "block and the admission scatter re-created the boundary block in "
    "the row's private reservation")
SERVE_KV_ALLOC_FAILURES = REGISTRY.counter(
    "egpt_serve_kv_alloc_failures_total",
    "Block allocations the pool could not cover (each one defers an "
    "admission or refuses a prefix insert; never a partial grant)")
SERVE_KV_BLOCK_DEFERRALS = REGISTRY.counter(
    "egpt_serve_kv_block_deferrals_total",
    "Admissions deferred by the used-token block gate (the queue head's "
    "whole reservation did not fit the free list, even after "
    "reclaiming unpinned prefix entries)")

# -- block-tier preemption + host-RAM KV spill (serve_blocks.py
#    SpillStore + serve.py preemption) --
SERVE_PREEMPTIONS = REGISTRY.counter(
    "egpt_serve_preemptions_total",
    "Active rows preempted to admit higher-value work, by KV "
    "disposition (mode=spill: gathered to the host SpillStore for a "
    "byte-exact restore; mode=drop: released for re-prefill — the "
    "policy's recompute choice or the spill-path fallback)")
SERVE_SPILL_BYTES = REGISTRY.counter(
    "egpt_serve_spill_bytes_total",
    "KV bytes gathered from the device arena into the host SpillStore "
    "(restore scatters the same bytes back; drops re-prefill instead)")
SERVE_RESTORES = REGISTRY.counter(
    "egpt_serve_restores_total",
    "Spilled requests whose KV run was scattered back into the arena "
    "on re-admission (the byte-exact restore path; drop-and-re-prefill "
    "re-admissions do not count here)")
SERVE_SPILL_STORE_BYTES = REGISTRY.gauge(
    "egpt_serve_spill_store_bytes",
    "Host bytes currently resident in the spill store (bounded by "
    "--spill_capacity_mb; also priced into the ledger's spill "
    "component)")
MEM_COMPILED_TEMP = REGISTRY.gauge(
    "egpt_mem_compiled_temp_bytes",
    "XLA temp allocation of the probed decode/spec segment executable "
    "(compiled-footprint probe, lowered.compile().memory_analysis())")
MEM_COMPILED_ARGUMENT = REGISTRY.gauge(
    "egpt_mem_compiled_argument_bytes",
    "XLA argument size of the probed segment executable (resident "
    "buffers the dispatch reads; donated args alias into outputs)")
MEM_COMPILED_OUTPUT = REGISTRY.gauge(
    "egpt_mem_compiled_output_bytes",
    "XLA output size of the probed segment executable")

# -- time-series store + burn-rate alerting (obs/series.py) --
ALERT_ACTIVE = REGISTRY.gauge(
    "egpt_alert_active",
    "1 while the named alert rule is firing, 0 once it cleared "
    "(hysteresis + multi-window burn rates; the rule enum is "
    "ALERT_RULES in obs/series.py)")
ALERT_TRANSITIONS = REGISTRY.counter(
    "egpt_alert_transitions_total",
    "Alert rule state transitions (firing and cleared both count; an "
    "odd count means the rule is currently active)")

# -- fault injection (faults.py) --
FAULT_TRIPS = REGISTRY.counter(
    "egpt_fault_trips_total",
    "Armed fault-plan fires, by site and kind (fail / delay)")

# -- training (train/trainer.py) --
TRAIN_LOSS = REGISTRY.gauge(
    "egpt_train_loss", "Mean loss over the last logged accumulation window")
TRAIN_GRAD_NORM = REGISTRY.gauge(
    "egpt_train_grad_norm",
    "Mean global grad norm over the last logged accumulation window")
TRAIN_STEP_SECONDS = REGISTRY.histogram(
    "egpt_train_step_seconds",
    "Wall time per optimizer step (one accumulation window)")
TRAIN_DATA_WAIT = REGISTRY.histogram(
    "egpt_train_data_wait_seconds",
    "Per micro-batch: host wait for data (iterator + host-to-device)",
    SHORT_BUCKETS)
TRAIN_COMPUTE = REGISTRY.histogram(
    "egpt_train_compute_seconds",
    "Per optimizer step: wall time minus data wait (step dispatch plus "
    "device wait at readback boundaries - the compute side of the split)",
    SHORT_BUCKETS)
TRAIN_STEPS = REGISTRY.counter(
    "egpt_train_steps_total", "Completed optimizer steps")
TRAIN_TOKENS = REGISTRY.counter(
    "egpt_train_tokens_total", "Attention-masked tokens consumed")


def configure(enabled: bool) -> None:
    """Arm/disarm the process-global registry."""
    REGISTRY.configure(enabled)


def enabled() -> bool:
    return REGISTRY.enabled


def serve_summary() -> Dict:
    """The /stats merge: compact summaries of every serving metric."""
    return REGISTRY.summary(("egpt_serve_",))


class JsonlSink:
    """Append-per-record JSONL writer (the trainer's ``telemetry.jsonl``):
    one ``json.dumps`` + append per call, no retained handle, so it is
    preemption-safe and costs nothing when unused."""

    def __init__(self, path: str):
        self.path = path

    def write(self, record: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
