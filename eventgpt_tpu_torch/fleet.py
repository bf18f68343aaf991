"""Fleet serving: the replica supervisor and prefix-affinity router.

Port of ``eventgpt_tpu/fleet.py``. A ``Fleet`` owns N ``ServingEngine``
replicas (threads of one process over one weight tree, each with its own KV
pool, generator and scheduler thread) and decides, per request, where it
runs and whether it runs at all:

  * **Prefix-affinity routing.** A request is keyed by its prompt head
    through the event sentinel and its stream's content hash
    (``affinity_key``), the identity the ``PrefixCache`` keys its
    through-event entries on, and the key is pinned to the replica that
    served it first. Later turns of a session land where the prefix cache
    holds their head. Unpinned keys, and pins whose replica left the pool,
    go to the least queue depth.
  * **SLO-aware shedding.** While the aggregate windowed goodput ratio is
    below ``shed_goodput_ratio`` (once ``shed_min_window`` finishes are in
    the windows) or the queued requests reach ``shed_queue_depth``, the
    router refuses ``batch``-class requests at submit (``FleetShedError``)
    with a class-aware ``retry_after_s``. ``interactive`` requests are
    never shed by policy.
  * **Supervision and failover.** A supervisor thread probes each replica
    (its breaker, its heartbeat's age, its kill state) and marks unhealthy
    ones unroutable. A dead replica's unfinished requests, queued and in
    flight, are drained through ``ServingEngine.kill`` (which calls
    ``ContinuousBatcher.export_requests``) and re-routed to survivors, and
    their sessions re-pinned; requests that a scheduler fault failed
    (``engine_fault``) fail over the same way. Failover re-decodes from the
    prompt, so a greedy chain is the one an uninterrupted engine gives.
    ``restart_replica`` (or ``replica_restart_s``) brings a replica back.

Fault sites: ``fleet.route`` (the submit falls back to least-queue),
``fleet.probe`` (the probed replica is unroutable until a clean probe) and
``fleet.replica_kill`` (the trip is the kill, of the busiest replica).

The lock order is fleet before engine: ``submit_ids`` holds the fleet's lock
across ``engine.submit_ids``, and ``kill_replica`` calls ``engine.kill``
outside it (a kill holds the engine lock through a whole drain). The flight
recorder's journeys, the time series and alerts, the memory ledger and the
Prometheus gauges of the JAX fleet are the fleets' half of telemetry, not
ported yet (ROADMAP Queue 1 item 6b; each replica's engine has its own):
``journey``, ``journeys``, ``series``, ``alerts`` and ``memory_stats``
raise ``NotImplementedError``, and ``stats`` leaves those parts out. Streaming
responses are not ported either.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from eventgpt_tpu_torch import faults
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX

# Per-class base backoff of a refused request's Retry-After: batch traffic
# has latency headroom by definition, so it is told to stay away longer.
_RETRY_BASE_S = {"interactive": 1.0, "batch": 4.0}
_RETRY_MAX_S = 60.0
_TELEMETRY = "the fleets' telemetry (ROADMAP Queue 1 item 6b) is not ported yet"


class FleetShedError(RuntimeError):
    """The router refused a request under its overload policy (a batch-class
    shed: backpressure, not failure), with the class-aware backoff that the
    HTTP layer sends as Retry-After."""

    def __init__(self, msg: str, slo_class: str, retry_after_s: float):
        super().__init__(msg)
        self.slo_class = slo_class
        self.retry_after_s = retry_after_s


def retry_after_s(slo_class: str, goodput_ratio: float = 1.0, queue_depth: int = 0,
                  max_queue: int = 0) -> float:
    """Seconds a refused client should wait: the class's base (batch backs
    off harder than interactive), scaled linearly up to 4x as the windowed
    SLO attainment falls below 1, and again by the relative queue pressure
    when known; at most ``_RETRY_MAX_S``."""
    base = _RETRY_BASE_S.get(slo_class, _RETRY_BASE_S["batch"])
    g = min(max(float(goodput_ratio), 0.0), 1.0)
    scale = 1.0 + 3.0 * (1.0 - g)
    if max_queue > 0 and queue_depth > 0:
        scale *= 1.0 + min(queue_depth / float(max_queue), 1.0)
    return min(base * scale, _RETRY_MAX_S)


def affinity_key(input_ids: Sequence[int], pixel_values: Any) -> tuple:
    """A request's routing identity: its prompt head through the event
    sentinel, and its stream's shape and sha1 of the contiguous
    little-endian f32 bytes (a numpy array or a host tensor), the same key
    as the JAX package's for the same ids and pixels."""
    ids = list(input_ids)
    try:
        head = tuple(ids[: ids.index(EVENT_TOKEN_INDEX) + 1])
    except ValueError:
        head = tuple(ids)
    if isinstance(pixel_values, torch.Tensor):
        pixel_values = pixel_values.detach().to("cpu", torch.float32).numpy()
    arr = np.ascontiguousarray(np.asarray(pixel_values, "<f4"))
    return head, str(arr.shape).encode() + hashlib.sha1(arr.tobytes()).digest()


@dataclass
class _FleetRequest:
    """One request the router owns to its end. ``replica``/``rid`` are the
    current assignment (failover re-points them); the client waits on
    ``done``, which the supervisor sets."""
    frid: int
    input_ids: List[int]
    pixel_values: Any
    max_new_tokens: int
    deadline: Optional[float]  # absolute perf_counter, or None
    slo: Any
    key: tuple
    replica: int
    rid: int
    t_submit: float
    failovers: int = 0
    done: threading.Event = field(default_factory=threading.Event)
    tokens: Optional[List[int]] = None
    status: str = "ok"
    stats: Dict[str, float] = field(default_factory=dict)


@dataclass
class Replica:
    """One supervised engine. Only ``ok`` replicas take new work;
    ``degraded`` (breaker open, stale heartbeat, probe fault) and ``dead``
    (killed) are skipped until a clean probe or a restart."""
    idx: int
    engine: Any
    state: str = "ok"  # ok | degraded | dead
    t_dead: float = 0.0
    kills: int = 0
    probe_faults: int = 0

    @property
    def routable(self) -> bool:
        return self.state == "ok"

    def depth(self) -> int:
        """The routing load: queued and active rows (host reads)."""
        b = self.engine.batcher
        return len(b.queue) + sum(r is not None for r in b.rows)


class _FleetRequestStats:
    """``.get(frid)`` over finished fleet requests: the shape the handler
    reads from ``engine.batcher.request_stats``."""

    def __init__(self, fleet: "Fleet"):
        self._fleet = fleet

    def get(self, frid: int, default=None):
        freq = self._fleet._requests.get(frid)
        if freq is None or not freq.done.is_set():
            return default if default is not None else {}
        return freq.stats


class _FleetBatcherView:
    """The ``engine.batcher`` surface the HTTP handler reads (request stats,
    the prefix cache), across the fleet."""

    def __init__(self, fleet: "Fleet"):
        self._fleet = fleet
        self.request_stats = _FleetRequestStats(fleet)

    def prefix_cache_stats(self) -> Dict[str, Any]:
        per = []
        hits = misses = 0
        for rep in self._fleet.replicas:
            st = rep.engine.batcher.prefix_cache_stats()
            st.pop("entries", None)  # per-entry dumps do not add up
            per.append({"replica": rep.idx, **st})
            hits += st.get("hits", 0)
            misses += st.get("misses", 0)
        return {"enabled": any(p.get("enabled") for p in per), "hits": hits, "misses": misses,
                "hit_ratio": hits / (hits + misses) if (hits + misses) else 0.0,
                "replicas": per}

    def slo_stats(self) -> Dict[str, Any]:
        return self._fleet.slo_stats()


class Fleet:
    """The replica supervisor and router, with the client surface of a
    ``ServingEngine`` (submit, result, status, cancel, stats, breaker_open,
    set_prefix), so that ``cli/serve.make_handler`` serves a fleet as it
    is. The routing table, the request map's writes and the counters move
    under ``_lock``; ``result`` waits without it. Replica ``state`` is
    written by the supervisor, and by the operator's kill and restart."""

    def __init__(self, engines: Sequence[Any], tokenizer=None, conv_mode: str = "eventgpt_v1",
                 probe_interval_s: float = 0.05, heartbeat_stale_s: float = 5.0,
                 shed_goodput_ratio: float = 0.5, shed_min_window: int = 8,
                 shed_queue_depth: int = 0, max_failovers: int = 3,
                 replica_restart_s: Optional[float] = None):
        if not engines:
            raise ValueError("a fleet needs at least one replica engine")
        self.replicas = [Replica(i, e) for i, e in enumerate(engines)]
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self.probe_interval_s = float(probe_interval_s)
        self.heartbeat_stale_s = float(heartbeat_stale_s)
        # 0 disarms a shedding signal. The goodput signal waits for
        # shed_min_window finishes: an empty window must not shed a cold
        # fleet forever.
        self.shed_goodput_ratio = float(shed_goodput_ratio)
        self.shed_min_window = int(shed_min_window)
        self.shed_queue_depth = int(shed_queue_depth)
        self.max_failovers = int(max_failovers)
        self.replica_restart_s = replica_restart_s
        self._lock = threading.Lock()
        self._requests: Dict[int, _FleetRequest] = {}
        self._pins: Dict[tuple, int] = {}  # affinity key -> replica index
        self._next_frid = 0
        self._stop = False
        self.t_start = time.time()
        self.n_requests = 0
        self.n_shed: Dict[str, int] = {}
        self.n_failovers = 0
        self.n_kills = 0
        self.n_route_faults = 0
        self.fault: Any = None  # repr of the last replica loss
        self._thread = threading.Thread(target=self._supervise, daemon=True)
        self._thread.start()

    # -- client surface ---------------------------------------------------

    @property
    def batcher(self) -> _FleetBatcherView:
        return _FleetBatcherView(self)

    @property
    def n_faults(self) -> int:
        return sum(r.engine.n_faults for r in self.replicas)

    @property
    def n_restarts(self) -> int:
        return sum(r.engine.n_restarts for r in self.replicas)

    def breaker_open(self) -> bool:
        """The fleet refuses work only when no replica is routable."""
        return not any(r.routable for r in self.replicas)

    def goodput_ratio(self) -> float:
        """The replicas' windowed SLO attainment, weighted by how full each
        window is; 1.0 until a window holds anything."""
        met = 0.0
        n = 0
        for rep in self.replicas:
            st = rep.engine.batcher.slo_stats()
            w = st.get("window_n", 0)
            met += st.get("goodput_ratio", 0.0) * w
            n += w
        return met / n if n else 1.0

    def queue_depth(self) -> int:
        return sum(len(r.engine.batcher.queue) for r in self.replicas)

    def submit(self, query: str, pixels, max_new_tokens: int,
               deadline_s: Optional[float] = None, slo=None) -> int:
        from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
        from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event

        ids = tokenize_with_event(prepare_event_prompt(query, self.conv_mode), self.tokenizer)
        return self.submit_ids(ids, pixels, max_new_tokens, deadline_s=deadline_s, slo=slo)

    def submit_ids(self, input_ids: Sequence[int], pixels, max_new_tokens: int,
                   deadline_s: Optional[float] = None, slo=None) -> int:
        """Route one request: the shed check, a replica (affinity, else the
        least queue), the submit there. Raises ``FleetShedError`` (a policy
        shed), the replica's ``QueueFullError``, or ``RuntimeError`` when no
        replica is routable."""
        self._maybe_shed(slo)
        key = affinity_key(input_ids, pixels)
        with self._lock:
            rep, _ = self._route_locked(key)
            rid = rep.engine.submit_ids(list(input_ids), pixels, max_new_tokens,
                                        deadline_s=deadline_s, slo=slo)
            frid = self._next_frid
            self._next_frid += 1
            self._requests[frid] = _FleetRequest(
                frid=frid, input_ids=list(input_ids), pixel_values=pixels,
                max_new_tokens=max_new_tokens,
                deadline=(time.perf_counter() + deadline_s if deadline_s is not None else None),
                slo=slo, key=key, replica=rep.idx, rid=rid, t_submit=time.perf_counter())
            self._pins[key] = rep.idx
            self.n_requests += 1
        return frid

    def result(self, frid: int, timeout: float = 600.0) -> List[int]:
        freq = self._requests[frid]
        if not freq.done.wait(timeout):
            raise TimeoutError(f"fleet request {frid} did not finish in {timeout}s")
        if freq.tokens is None:
            raise RuntimeError(f"fleet request {frid} failed after {freq.failovers} "
                               f"failover(s): {freq.status} ({self.fault})")
        return freq.tokens

    def status(self, frid: int) -> str:
        freq = self._requests.get(frid)
        return freq.status if freq is not None else "ok"

    def replica_of(self, frid: int) -> int:
        """The replica that served (or serves) the request."""
        return self._requests[frid].replica

    def cancel(self, frid: int) -> bool:
        with self._lock:
            freq = self._requests.get(frid)
            if freq is None or freq.done.is_set():
                return False
            rep = self.replicas[freq.replica]
        return rep.engine.cancel(freq.rid)

    def stream_queue(self, frid: int):
        raise NotImplementedError("streaming responses are not ported to eventgpt_tpu_torch yet")

    def set_prefix(self, prefix_prompt: str, pixels=None) -> int:
        """An operator's prefix insert, on every routable replica: a session
        may land anywhere before it has a pin."""
        plen = 0
        for rep in self.replicas:
            if rep.routable:
                plen = rep.engine.set_prefix(prefix_prompt, pixels)
        return plen

    def stats(self) -> Dict[str, Any]:
        reps = []
        for rep in self.replicas:
            s = rep.engine.snapshot()
            reps.append({
                "replica": rep.idx, "state": rep.state,
                "active_rows": s.get("active_rows", 0), "queued": s.get("queued", 0),
                "faults": rep.engine.n_faults, "restarts": rep.engine.n_restarts,
                "kills": rep.kills,
                "goodput_ratio": s.get("slo", {}).get("goodput_ratio", 0.0),
                "prefix_cache_hit_ratio":
                    rep.engine.batcher.prefix_cache_stats().get("hit_ratio", 0.0),
            })
        with self._lock:
            n_pins = len(self._pins)
            shed = dict(self.n_shed)
        return {
            "uptime_s": round(time.time() - self.t_start, 1),
            "requests": self.n_requests,
            "status": "degraded" if self.breaker_open() else "ok",
            "active_rows": sum(r["active_rows"] for r in reps),
            "queued": sum(r["queued"] for r in reps),
            "fleet": {
                "replicas": len(self.replicas),
                "routable": sum(r.routable for r in self.replicas),
                "pins": n_pins, "goodput_ratio": round(self.goodput_ratio(), 4),
                "shed": shed, "failovers": self.n_failovers, "kills": self.n_kills,
                "route_faults": self.n_route_faults, "per_replica": reps,
            },
        }

    def fleet_stats(self) -> Dict[str, Any]:
        """The ``GET /fleet`` body: topology, policy and live state."""
        return {**self.stats()["fleet"], "policy": {
            "shed_goodput_ratio": self.shed_goodput_ratio,
            "shed_min_window": self.shed_min_window,
            "shed_queue_depth": self.shed_queue_depth,
            "max_failovers": self.max_failovers,
            "probe_interval_s": self.probe_interval_s,
            "heartbeat_stale_s": self.heartbeat_stale_s,
            "replica_restart_s": self.replica_restart_s,
        }}

    def slo_stats(self) -> Dict[str, Any]:
        """Per-class attainment across the replicas."""
        classes: Dict[str, Dict[str, Any]] = {}
        for rep in self.replicas:
            for name, c in rep.engine.batcher.slo_stats().get("classes", {}).items():
                agg = classes.setdefault(name, {"finished": 0, "met": 0})
                agg["finished"] += c["finished"]
                agg["met"] += c["met"]
        for c in classes.values():
            c["attainment"] = c["met"] / c["finished"] if c["finished"] else 0.0
        return {"classes": classes, "goodput_ratio": self.goodput_ratio()}

    def journey(self, frid: int):
        raise NotImplementedError(f"fleet journeys: {_TELEMETRY}")

    def journeys(self, n: int = 64):
        raise NotImplementedError(f"fleet journeys: {_TELEMETRY}")

    def series(self, window_s: Optional[float] = None, n: Optional[int] = None):
        raise NotImplementedError(f"fleet series: {_TELEMETRY}")

    def alerts(self):
        raise NotImplementedError(f"fleet alerts: {_TELEMETRY}")

    def memory_stats(self):
        raise NotImplementedError(f"the fleet's memory ledger: {_TELEMETRY}")

    def reset_stats(self) -> None:
        """Zero the fleet's own counters (the replicas' are their callers')."""
        with self._lock:
            self.n_shed = {}
            self.n_failovers = 0
            self.n_kills = 0
            self.n_route_faults = 0

    def shutdown(self) -> None:
        self._stop = True
        self._thread.join(timeout=10)
        for rep in self.replicas:
            rep.engine.shutdown()

    # -- routing ----------------------------------------------------------

    def _route_locked(self, key: tuple):
        """(replica, reason) of one submit: the key's pinned replica while
        it is routable, else the least queue. A ``fleet.route`` trip takes
        the least queue: a broken table costs locality, not service."""
        pool = [r for r in self.replicas if r.routable]
        if not pool:
            raise RuntimeError(f"no routable replica ({len(self.replicas)} configured): "
                               f"{self.fault}")
        try:
            faults.maybe_fail("fleet.route")
            faults.maybe_delay("fleet.route")
            pinned = self._pins.get(key)
            if pinned is not None and self.replicas[pinned].routable:
                return self.replicas[pinned], "affinity"
        except faults.InjectedFault:
            self.n_route_faults += 1
        return min(pool, key=lambda r: (r.depth(), r.idx)), "least_queue"

    def _maybe_shed(self, slo) -> None:
        """Admission control at the router: only ``batch`` requests are ever
        shed by policy; the rest meet the replicas' own queue bounds."""
        if slo is None or getattr(slo, "name", None) != "batch":
            return
        overloaded, why = self._overloaded()
        if not overloaded:
            return
        ra = retry_after_s("batch", self.goodput_ratio(), queue_depth=self.queue_depth(),
                           max_queue=max(self.shed_queue_depth, 1))
        with self._lock:
            self.n_shed["batch"] = self.n_shed.get("batch", 0) + 1
        raise FleetShedError(f"fleet shed batch-class request ({why}); retry in ~{ra:.0f}s",
                             "batch", ra)

    def _overloaded(self):
        if self.shed_queue_depth > 0:
            q = self.queue_depth()
            if q >= self.shed_queue_depth:
                return True, f"queue depth {q} >= {self.shed_queue_depth}"
        if self.shed_goodput_ratio > 0.0:
            n = sum(r.engine.batcher.slo_stats().get("window_n", 0) for r in self.replicas)
            g = self.goodput_ratio()
            if n >= self.shed_min_window and g < self.shed_goodput_ratio:
                return True, f"windowed goodput {g:.2f} < {self.shed_goodput_ratio}"
        return False, ""

    # -- supervision ------------------------------------------------------

    def kill_replica(self, idx: int) -> int:
        """Kill one replica now (the operator's call and the chaos handler):
        mark it dead, drain its unfinished requests and re-route them to
        survivors. Returns the number of requests moved."""
        rep = self.replicas[idx]
        if rep.state == "dead":
            return 0
        rep.state = "dead"
        rep.t_dead = time.monotonic()
        rep.kills += 1
        with self._lock:
            self.n_kills += 1
            self.fault = f"replica {idx} killed"
        exported = rep.engine.kill()  # outside the fleet lock: fleet -> engine
        by_rid = {rec["rid"]: rec for rec in exported}
        moved = 0
        with self._lock:
            for freq in [f for f in self._requests.values()
                         if f.replica == idx and not f.done.is_set()]:
                rec = by_rid.get(freq.rid)
                if rec is None:
                    # Finished at the engine but not collected: the kill
                    # harvested it, so the next collection delivers it.
                    continue
                self._failover_locked(freq, rec.get("deadline_s"))
                moved += 1
        return moved

    def restart_replica(self, idx: int) -> None:
        """Revive a killed replica and return it to the routing pool."""
        rep = self.replicas[idx]
        rep.engine.revive()
        rep.state = "ok"

    def _failover_locked(self, freq: _FleetRequest, deadline_s: Optional[float]) -> None:
        """Re-route one request to a survivor (the caller holds the lock).
        The session's pin moves with it, so later turns follow it."""
        freq.failovers += 1
        if freq.failovers > self.max_failovers:
            self._finish_locked(freq, None, "engine_fault")
            return
        pool = [r for r in self.replicas if r.routable and r.idx != freq.replica]
        if not pool:
            pool = [r for r in self.replicas if r.routable]
        if not pool:
            self._finish_locked(freq, None, "engine_fault")
            return
        rep = min(pool, key=lambda r: (r.depth(), r.idx))
        try:
            freq.rid = rep.engine.submit_ids(freq.input_ids, freq.pixel_values,
                                             freq.max_new_tokens, deadline_s=deadline_s,
                                             slo=freq.slo)
        except Exception as e:  # the survivor refused (full, degraded): give up
            self.fault = repr(e)
            self._finish_locked(freq, None, "engine_fault")
            return
        freq.replica = rep.idx
        self._pins[freq.key] = rep.idx
        self.n_failovers += 1

    def _finish_locked(self, freq: _FleetRequest, tokens, status: str) -> None:
        freq.tokens = tokens
        freq.status = status
        freq.done.set()
        # A bounded map of finished requests; a live one is never evicted.
        while len(self._requests) >= 8192:
            oldest = next(iter(self._requests))
            if not self._requests[oldest].done.is_set():
                break
            self._requests.pop(oldest)

    def _supervise(self) -> None:
        """Probe health, run the scripted chaos kill, collect finished and
        faulted requests, restart dead replicas. It must never die: a probe
        failure is a health signal here."""
        while not self._stop:
            try:
                faults.maybe_delay("fleet.probe")
                for rep in self.replicas:
                    self._probe(rep)
                try:
                    faults.maybe_fail("fleet.replica_kill")
                except faults.InjectedFault:
                    # The trip is the kill, of the busiest routable replica
                    # (the worst case: it holds decodes in flight).
                    pool = [r for r in self.replicas if r.routable]
                    if pool:
                        self.kill_replica(max(pool, key=lambda r: (r.depth(), -r.idx)).idx)
                self._collect()
            except Exception as e:  # supervision must survive
                with self._lock:
                    self.fault = repr(e)
            time.sleep(self.probe_interval_s)

    def _probe(self, rep: Replica) -> None:
        if rep.state == "dead":
            if (self.replica_restart_s is not None
                    and time.monotonic() - rep.t_dead >= self.replica_restart_s):
                self.restart_replica(rep.idx)
            return
        try:
            faults.maybe_fail("fleet.probe")
        except faults.InjectedFault:
            # Health unknown: out of the pool until a clean probe.
            rep.probe_faults += 1
            rep.state = "degraded"
            return
        eng = rep.engine
        healthy = not eng.breaker_open()
        hb = getattr(eng, "_heartbeat", None)
        if healthy and hb is not None:
            from eventgpt_tpu_torch.train.resilience import Heartbeat

            healthy = not Heartbeat.is_stale(hb.path, self.heartbeat_stale_s)
        rep.state = "ok" if healthy else "degraded"

    def _collect(self) -> None:
        """Deliver finished requests and fail over those a scheduler fault
        failed (the queued ones that a fault below the breaker kept are
        served by the restarted scheduler)."""
        with self._lock:
            live = [f for f in self._requests.values() if not f.done.is_set()]
        for freq in live:
            rep = self.replicas[freq.replica]
            got = rep.engine.try_result(freq.rid)
            if got is None:
                continue
            tokens, status = got
            with self._lock:
                if status == "engine_fault":
                    remaining = (freq.deadline - time.perf_counter()
                                 if freq.deadline is not None else None)
                    self._failover_locked(freq, remaining)
                    continue
                freq.stats = dict(rep.engine.batcher.request_stats.get(freq.rid, {}))
                self._finish_locked(freq, tokens, status)
