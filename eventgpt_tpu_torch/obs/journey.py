"""Per-request flight recorder + tail-latency attribution.

The port of ``eventgpt_tpu/obs/journey.py``. One bounded, append-only
EVENT TIMELINE per request, and from each finished timeline:

  * a **phase decomposition** -- ``queue_s / defer_s / preempt_s /
    admission_s / decode_s / host_gap_s / failover_redo_s / handoff_s``
    -- that partitions the request's end-to-end latency exactly (the
    checkpoints are clamped into a monotone chain, so the phases sum to
    ``t_done - t_submit`` by construction);
  * a **dominant miss cause** (the CLOSED ``MISS_CAUSES`` enum, a metric
    label) exported per finish as
    ``egpt_serve_slo_miss_cause_total{slo_class,cause}``.

Event kinds are a CLOSED enum too (``EVENT_KINDS``): recording an
unknown kind raises. Segment boundaries are recorded per HARVEST (count
+ committed tokens), never per decode step, and a per-timeline cap
merges overflow into the last same-kind event.

Identity: timelines key on ``(owner, rid)`` -- request ids are
per-batcher, and a fleet runs several batchers in one process.
``register_owner()`` hands out process-unique owner ids, armed or not.

Disarmed (the default) every probe is one module-global ``is None``
check. Recording reads host clocks and host ints only, never a device
tensor, so chains are byte-identical armed or disarmed. Retention: live
timelines plus a ring of the last ``keep`` finished requests
(``--journey_keep``), read by ``GET /requests`` / ``GET /request?rid=N``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

# The CLOSED set of event kinds (bounded by construction; equal to the
# JAX package's tuple):
#   submit          request entered the admission queue
#   queue           request LEFT the queue (queue wait ends here)
#   prefix          prefix-cache decision (hit + matched length, or miss)
#   mem_guard_defer the headroom guard deferred this request's boundary
#   kv_block_defer  the paged pool's used-token gate deferred it (the
#                   queue head's block reservation did not fit the free
#                   list) — counts into defer_s like the
#                   byte-headroom deferral
#   lane_join       admission became a piggyback prefill lane
#   lane_finish     the lane covered its prompt (activation follows)
#   admit           row activated into the shared cache
#                   (path = full | wave | suffix | suffix_wave | chunk | lane)
#   segment         one harvest committed tokens to this row
#                   (count + tokens per BOUNDARY, never per step)
#   spec_depth      the adaptive speculation controller SWITCHED this
#                   row's dispatch-boundary window (emitted on
#                   change only, to every live row — same-kind merge
#                   keeps it bounded)
#   shed            the fleet router refused the request (policy shed)
#   route           the fleet router placed the request on a replica
#   repin           failover moved the session's affinity pin
#   failover        the request re-routed to a survivor (re-decode)
#   worker_lost     the request's worker PROCESS died hard (SIGKILL /
#                   crash / unreachable) — the redo failover follows
#   respawn         the coordinator spawned a replacement process into
#                   the lost worker's slot while this request was live
#   preempt         an active row was evicted to admit higher-value
#                   work (mode = spill | drop) — the request
#                   re-queues and the preempt->resume interval is
#                   carved out as ``preempt_s``
#   spill           the victim's KV run was gathered to the host
#                   SpillStore (bytes + blocks recorded)
#   restore         a spilled run was scattered back into the arena on
#                   re-admission (ends the preempt interval; the drop
#                   path's interval ends at its re-dequeue instead)
#   kv_handoff      the paged prefill->decode handoff: one
#                   event per stage — ``gathered`` (prefill worker
#                   pulled the block run to host), ``shipped``
#                   (coordinator moved it to a decode worker over RPC),
#                   ``spliced`` (decode worker scattered it into its
#                   arena) — with bytes + block count
#   nan_quarantine / deadline / cancel   forced-finish markers
#   exported        the replica drained it for re-admission elsewhere
#   finish          terminal bookkeeping (status + slo_met)
EVENT_KINDS = (
    "submit", "queue", "prefix", "mem_guard_defer", "kv_block_defer",
    "lane_join", "lane_finish", "admit", "segment", "spec_depth", "shed",
    "route",
    "repin", "failover", "worker_lost", "respawn", "preempt", "spill",
    "restore", "kv_handoff", "nan_quarantine",
    "deadline", "cancel", "exported", "finish",
)

# The CLOSED dominant-miss-cause enum. It is the ``cause`` label of
# ``egpt_serve_slo_miss_cause_total`` — obs/metrics.py METRIC_LABELS
# mirrors this tuple; keep the two literals identical. Phase causes map 1:1 onto the
# decomposition keys (``<cause>_s``); ``nan_quarantine`` and ``shed``
# are the two non-time causes (a poisoned row / a router refusal have
# no meaningful time story); ``other`` absorbs degenerate timelines
# (e2e ~ 0).
MISS_CAUSES = (
    "queue", "defer", "preempt", "admission", "decode", "host_gap",
    "failover_redo", "handoff", "nan_quarantine", "shed", "other",
)

# Decomposition keys in checkpoint order (the partition of
# [t_submit, t_done]; see ``_phases``). ``preempt_s`` is carved out of
# the queue/defer side: a preempted request's wait-to-resume interval
# lands in queue_s/defer_s under the checkpoint clamps (its re-dequeue
# overwrites ``t_dequeue``), so the carve re-attributes it without
# breaking the exact-sum invariant.
PHASE_KEYS = ("queue_s", "defer_s", "preempt_s", "admission_s", "decode_s",
              "host_gap_s", "failover_redo_s", "handoff_s")


def _phases(t_submit: float, t_defer: Optional[float],
            t_dequeue: Optional[float], t_admit: Optional[float],
            t_last_commit: Optional[float], t_done: float,
            preempt_acc: float = 0.0,
            ) -> Dict[str, float]:
    """Partition ``[t_submit, t_done]`` into the phase decomposition.

    Checkpoints are clamped into a monotone chain; a missing checkpoint
    collapses its phase to zero by inheriting the NEXT known boundary
    (a request that expired in the queue spends everything in
    queue/defer; one that never committed spends its post-admission
    time in decode). The phases therefore sum to ``t_done - t_submit``
    EXACTLY — the invariant the property test pins.

      queue_s      submit -> first mem-guard deferral (or dequeue)
      defer_s      first deferral -> dequeue (0 when never deferred)
      admission_s  dequeue -> row activation (encode + prefill + lane
                   prefill + scatter — a prefix miss shows up here)
      decode_s     activation -> last committed token
      host_gap_s   last committed token -> terminal bookkeeping (the
                   finish-side host tail: harvest->finish delay,
                   deadline slack after the final commit)
      preempt_s    accumulated preempt -> resume wait.
                   A preempted request's wait lands inside
                   queue_s/defer_s under the clamps (its re-dequeue
                   overwrote ``t_dequeue``), so this carves
                   ``min(preempt_acc, defer_s + queue_s)`` back out —
                   defer_s first, then queue_s — keeping the exact-sum
                   partition.
      failover_redo_s  0 at this layer; the fleet's stitched view adds
                   the abandoned assignments' wall time here.
      handoff_s    0 at this layer; the fleet's stitched view charges
                   the prefill->decode KV move (gather + RPC ship +
                   splice wait) here from coordinator-measured
                   durations.
    """
    td = t_done
    tq = t_dequeue if t_dequeue is not None else td
    tq = min(max(tq, t_submit), td)
    ta = t_admit if t_admit is not None else td
    ta = min(max(ta, tq), td)
    tc = t_last_commit if t_last_commit is not None else td
    tc = min(max(tc, ta), td)
    tdef = t_defer if t_defer is not None else tq
    tdef = min(max(tdef, t_submit), tq)
    queue_s = tdef - t_submit
    defer_s = tq - tdef
    host_gap_s = td - tc
    # Carve the preempt wait out of the phases that absorbed it under
    # the clamps: defer_s/queue_s when the request resumed (its
    # re-dequeue overwrote t_dequeue), host_gap_s when it died while
    # still preempted (t_dequeue stayed at the first dequeue, so the
    # wait sits past the last commit). Order: defer, queue, host_gap.
    preempt_s = min(max(float(preempt_acc), 0.0),
                    queue_s + defer_s + host_gap_s)
    rem = preempt_s
    carve = min(rem, defer_s)
    defer_s -= carve
    rem -= carve
    carve = min(rem, queue_s)
    queue_s -= carve
    rem -= carve
    host_gap_s -= rem
    return {
        "queue_s": queue_s,
        "defer_s": defer_s,
        "preempt_s": preempt_s,
        "admission_s": ta - tq,
        "decode_s": tc - ta,
        "host_gap_s": host_gap_s,
        "failover_redo_s": 0.0,
        "handoff_s": 0.0,
    }


def dominant_cause(status: str, phases: Optional[Dict[str, float]]) -> str:
    """The closed-enum dominant miss cause of one finished request:
    non-time terminal statuses first (a poisoned row / a router shed
    have no time story), else the largest decomposition phase (ties
    break in checkpoint order — the earlier phase wins, since later
    time is often a consequence of it), else ``other``."""
    if status == "nan_quarantined":
        return "nan_quarantine"
    if status == "shed":
        return "shed"
    if not phases:
        return "other"
    best_key, best = None, 0.0
    for key in PHASE_KEYS:
        v = float(phases.get(key, 0.0))
        if v > best:
            best_key, best = key, v
    if best_key is None:
        return "other"
    return best_key[: -len("_s")]  # "queue_s" -> "queue", ...


class JourneyRecorder:
    """Bounded, thread-safe store of per-request event timelines.

    One lock guards everything (scheduler threads, HTTP handler
    threads and the fleet supervisor all record/read); every operation
    is a few dict writes, so the armed cost per event is comparable to
    a metric observation. Host values only -- timestamps are
    ``time.perf_counter`` floats and fields are host ints/strings.
    """

    # Lock-discipline contract: live + finished maps and the drop counters only
    # mutate/read under the recorder's own lock.
    _GUARDED_BY = {
        "_live": "_lock",
        "_done": "_lock",
        "_dropped_live": "_lock",
        "_duplicate_finishes": "_lock",
    }

    def __init__(self, keep: int = 512, max_events: int = 128,
                 live_cap: int = 4096):
        self.keep = max(int(keep), 1)
        self.max_events = max(int(max_events), 8)
        self.live_cap = max(int(live_cap), self.keep)
        self._lock = threading.Lock()
        self._live: "OrderedDict[Tuple[int, int], dict]" = OrderedDict()
        self._done: "OrderedDict[Tuple[int, int], dict]" = OrderedDict()
        self._dropped_live = 0        # live timelines evicted at cap
        self._duplicate_finishes = 0  # double-finish bugs (audit test: 0)

    # -- recording --------------------------------------------------------

    def _new_rec(self, owner: int, rid: int, t: float) -> dict:
        return {
            "owner": int(owner), "rid": int(rid),
            "t_submit": float(t),
            "events": [{"t": float(t), "kind": "submit"}],
            "t_defer": None, "t_dequeue": None, "t_admit": None,
            "t_last_commit": None,
            "t_preempt": None, "preempt_acc": 0.0,
            "tokens": 0, "segments": 0, "merged": 0,
            "finished": False,
        }

    def begin(self, owner: int, rid: int, t: Optional[float] = None,
              **fields) -> None:
        t = time.perf_counter() if t is None else float(t)
        rec = self._new_rec(owner, rid, t)
        if fields:
            rec["events"][0].update(fields)
            rec.update({k: v for k, v in fields.items()
                        if k in ("prompt_len", "budget", "slo_class")})
        with self._lock:
            self._live[(owner, rid)] = rec
            while len(self._live) > self.live_cap:
                self._live.popitem(last=False)
                self._dropped_live += 1

    def event(self, owner: int, rid: int, kind: str,
              t: Optional[float] = None, **fields) -> None:
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown journey event kind {kind!r}: one of "
                f"{EVENT_KINDS} (the enum is closed)")
        t = time.perf_counter() if t is None else float(t)
        with self._lock:
            rec = self._live.get((owner, rid))
            if rec is None:
                # Armed mid-flight (or an evicted live timeline): start
                # a stub so the tail of the request is still explained.
                rec = self._new_rec(owner, rid, t)
                self._live[(owner, rid)] = rec
            ev = {"t": t, "kind": kind}
            if fields:
                ev.update(fields)
            if len(rec["events"]) >= self.max_events:
                last = rec["events"][-1]
                if last["kind"] == kind:
                    # Merge into the trailing same-kind event (defer
                    # streaks, long decodes): timeline stays bounded,
                    # the checkpoint bookkeeping below stays exact.
                    last["t"] = t
                    last["n"] = int(last.get("n", 1)) + 1
                    if kind == "segment" and "tokens" in fields:
                        last["tokens"] = (int(last.get("tokens", 0))
                                          + int(fields["tokens"]))
                else:
                    rec["merged"] += 1
            else:
                rec["events"].append(ev)
            # Checkpoints for the phase decomposition (kept in the
            # header so truncation can never skew the phases).
            if kind == "queue":
                rec["t_dequeue"] = t
                if rec["t_preempt"] is not None:
                    # A preempted request's re-dequeue ends its wait
                    # (the drop path re-prefills from here; the spill
                    # path's ``restore`` usually lands first).
                    rec["preempt_acc"] += t - rec["t_preempt"]
                    rec["t_preempt"] = None
            elif kind == "preempt":
                rec["t_preempt"] = t
            elif kind == "restore":
                if rec["t_preempt"] is not None:
                    rec["preempt_acc"] += t - rec["t_preempt"]
                    rec["t_preempt"] = None
            elif kind == "admit":
                rec["t_admit"] = t
            elif kind == "segment":
                rec["t_last_commit"] = t
                rec["segments"] += 1
                rec["tokens"] += int(fields.get("tokens", 0))
            elif (kind in ("mem_guard_defer", "kv_block_defer")
                    and rec["t_defer"] is None):
                rec["t_defer"] = t

    def finish(self, owner: int, rid: int, status: str,
               t_submit: Optional[float] = None,
               t_done: Optional[float] = None,
               slo_class: Optional[str] = None,
               slo_met: Optional[bool] = None,
               phases: Optional[Dict[str, float]] = None,
               **fields) -> dict:
        """Terminal bookkeeping: append the ``finish`` event, compute
        the phase decomposition + dominant cause, and move the timeline
        into the finished ring. Returns the finished record (the caller
        exports ``cause`` to the miss-cause metric). ``phases``
        overrides the computed decomposition — the fleet's stitcher
        passes the final assignment's phases plus ``failover_redo_s``
        (pass matching ``t_submit``/``t_done`` so the sum invariant
        holds)."""
        t_done = time.perf_counter() if t_done is None else float(t_done)
        with self._lock:
            rec = self._live.pop((owner, rid), None)
            if rec is None:
                rec = self._new_rec(
                    owner, rid,
                    t_done if t_submit is None else float(t_submit))
            elif t_submit is not None:
                # The caller's submit stamp is authoritative (it is the
                # same float the latency metrics use), so the phase sum
                # equals the reported latency exactly.
                rec["t_submit"] = float(t_submit)
            rec["t_done"] = t_done
            rec["status"] = str(status)
            if slo_class is not None:
                rec["slo_class"] = slo_class
            rec["slo_met"] = slo_met
            rec["e2e_s"] = t_done - rec["t_submit"]
            preempt_acc = float(rec.get("preempt_acc", 0.0))
            if rec.get("t_preempt") is not None:
                # Finished while still preempted (deadline / cancel in
                # the re-queue): the open interval ends at t_done.
                preempt_acc += max(t_done - rec["t_preempt"], 0.0)
                rec["t_preempt"] = None
                rec["preempt_acc"] = preempt_acc
            rec["phases"] = (dict(phases) if phases is not None
                             else _phases(
                                 rec["t_submit"], rec["t_defer"],
                                 rec["t_dequeue"], rec["t_admit"],
                                 rec["t_last_commit"], t_done,
                                 preempt_acc))
            rec["cause"] = dominant_cause(rec["status"], rec["phases"])
            ev = {"t": t_done, "kind": "finish", "status": rec["status"]}
            if slo_met is not None:
                ev["slo_met"] = bool(slo_met)
            if fields:
                ev.update(fields)
            rec["events"].append(ev)
            rec["finished"] = True
            if (owner, rid) in self._done:
                # A second finish for the same request is a terminal-
                # path bug; count it loudly (the audit test pins 0)
                # instead of silently replacing the first record.
                self._duplicate_finishes += 1
            self._done[(owner, rid)] = rec
            while len(self._done) > self.keep:
                self._done.popitem(last=False)
            return rec

    # -- export -----------------------------------------------------------

    def _export_locked(self, rec: dict) -> dict:
        """JSON-shaped copy: event times relative to submit (absolute
        perf_counter floats mean nothing to a client)."""
        t0 = rec["t_submit"]
        out = {
            "rid": rec["rid"], "owner": rec["owner"],
            "finished": rec["finished"],
            "tokens": rec["tokens"], "segments": rec["segments"],
            "events": [
                {**{k: v for k, v in ev.items() if k != "t"},
                 "t_s": round(ev["t"] - t0, 6)}
                for ev in rec["events"]
            ],
        }
        for k in ("prompt_len", "budget", "slo_class", "status",
                  "cause", "merged"):
            if rec.get(k) not in (None, 0):
                out[k] = rec[k]
        if rec.get("slo_met") is not None:
            # Explicit None-check: ``False == 0`` would drop a missed
            # request's verdict from the export (the one field the
            # miss-cause accounting keys on).
            out["slo_met"] = rec["slo_met"]
        if rec["finished"]:
            out["e2e_s"] = rec["e2e_s"]
            out["phases"] = dict(rec["phases"])
            out["t_submit"] = rec["t_submit"]
            out["t_done"] = rec["t_done"]
        return out

    def get(self, owner: int, rid: int) -> Optional[dict]:
        """One timeline (finished preferred, live fallback), export
        shape; None when unknown."""
        with self._lock:
            rec = self._done.get((owner, rid)) \
                or self._live.get((owner, rid))
            return self._export_locked(rec) if rec is not None else None

    def raw(self, owner: int, rid: int) -> Optional[dict]:
        """The internal record (absolute timestamps) — the fleet's
        stitcher and tests read checkpoints from here."""
        with self._lock:
            rec = self._done.get((owner, rid)) \
                or self._live.get((owner, rid))
            return dict(rec) if rec is not None else None

    def index(self, owner: Optional[int] = None, n: int = 64) -> List[dict]:
        """Recent finished requests, newest first: the ``GET /requests``
        payload — rid / status / slo / cause, one line per request."""
        with self._lock:
            recs = [r for r in reversed(self._done.values())
                    if owner is None or r["owner"] == owner]
            out = []
            for rec in recs[: max(int(n), 1)]:
                out.append({
                    "rid": rec["rid"], "owner": rec["owner"],
                    "status": rec.get("status"),
                    "slo_class": rec.get("slo_class"),
                    "slo_met": rec.get("slo_met"),
                    "cause": rec.get("cause"),
                    "e2e_s": round(rec.get("e2e_s", 0.0), 6),
                    "tokens": rec["tokens"],
                })
            return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "keep": self.keep,
                "live": len(self._live),
                "finished": len(self._done),
                "dropped_live": self._dropped_live,
                "duplicate_finishes": self._duplicate_finishes,
            }


# -- module-global arming (the trace.py discipline) ------------------------

_recorder: Optional[JourneyRecorder] = None

# Owner ids are process-unique and independent of arming, so a batcher
# registered while disarmed records correctly the moment the recorder
# arms (same pattern as the memory ledger's owner namespaces).
_owner_lock = threading.Lock()
_next_owner = 0


def register_owner(label: str = "") -> int:
    global _next_owner
    with _owner_lock:
        owner = _next_owner
        _next_owner += 1
        return owner


def configure(keep: int = 512) -> Optional[JourneyRecorder]:
    """Arm the flight recorder keeping the last ``keep`` finished
    request timelines; ``keep <= 0`` disarms."""
    global _recorder
    if keep <= 0:
        _recorder = None
        return None
    _recorder = JourneyRecorder(keep)
    return _recorder


def disable() -> None:
    global _recorder
    _recorder = None


def active() -> Optional[JourneyRecorder]:
    return _recorder


def enabled() -> bool:
    return _recorder is not None


# -- armed-checked probes (one module-global load + None check when
#    disarmed; no clock read, no allocation) -------------------------------

def begin(owner: int, rid: int, t: Optional[float] = None, **fields) -> None:
    r = _recorder
    if r is not None:
        r.begin(owner, rid, t=t, **fields)


def event(owner: int, rid: int, kind: str, t: Optional[float] = None,
          **fields) -> None:
    r = _recorder
    if r is not None:
        r.event(owner, rid, kind, t=t, **fields)


def finish(owner: int, rid: int, status: str,
           t_submit: Optional[float] = None,
           t_done: Optional[float] = None,
           slo_class: Optional[str] = None,
           slo_met: Optional[bool] = None,
           phases: Optional[Dict[str, float]] = None,
           **fields) -> Optional[dict]:
    r = _recorder
    if r is None:
        return None
    return r.finish(owner, rid, status, t_submit=t_submit, t_done=t_done,
                    slo_class=slo_class, slo_met=slo_met, phases=phases,
                    **fields)


def get(owner: int, rid: int) -> Optional[dict]:
    r = _recorder
    return None if r is None else r.get(owner, rid)


def raw(owner: int, rid: int) -> Optional[dict]:
    r = _recorder
    return None if r is None else r.raw(owner, rid)


def index(owner: Optional[int] = None, n: int = 64) -> List[dict]:
    r = _recorder
    return [] if r is None else r.index(owner, n)
