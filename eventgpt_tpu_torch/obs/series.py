"""Bounded in-process time-series store + SLO burn-rate alerting.

The port of ``eventgpt_tpu/obs/series.py``: a thread-safe store that
samples the metrics registry on a fixed cadence (``--series_interval_s``)
into a ring of the last ``--series_keep`` samples, derives control
signals (counter -> windowed rate, histogram -> windowed quantiles from
bucket deltas, gauge -> last/min/max, an EWMA arrival rate over
``note_submit()``), and evaluates a CLOSED rule enum (``ALERT_RULES``)
each sample with hysteresis and multi-window (fast/slow) burn rates:

  * ``slo_burn``      windowed SLO attainment under the goodput target
                      in BOTH the fast and slow windows;
  * ``queue_trend``   queue depth high AND confirmed as load (rising vs
                      the slow window, or the arrival EWMA above
                      ``queue_arrival_min``);
  * ``cause_shift``   the fast window's dominant SLO-miss cause differs
                      from the slow window's;
  * ``breaker_flap``  the breaker changed state >= N times in the slow
                      window;
  * ``mem_shrink``    ledger headroom below the floor AND shrinking
                      (only with a configured capacity).

Transitions export as ``egpt_alert_active{rule}`` /
``egpt_alert_transitions_total{rule}``, append to a bounded alert log and
emit trace instants (cat ``alert``). Disarmed (the default) every probe
is one module-global ``is None`` check. Sampling reads host clocks and
the registry's host floats only, so chains are byte-identical armed or
disarmed. Exports give ages relative to the store's own now.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from eventgpt_tpu_torch.obs import metrics as obs_metrics
from eventgpt_tpu_torch.obs import trace as obs_trace

# The CLOSED alert-rule enum. It is the ``rule`` label of
# ``egpt_alert_active`` / ``egpt_alert_transitions_total`` —
# obs/metrics.py METRIC_LABELS mirrors this tuple; keep the literals
# identical.
ALERT_RULES = (
    "slo_burn", "queue_trend", "cause_shift", "breaker_flap",
    "mem_shrink",
)


def _window_quantile(bounds: Tuple[float, ...], c0: List[float],
                     c1: List[float], q: float) -> float:
    """Quantile upper bound over the WINDOW [t0, t1]: the histogram
    samples are cumulative per-bucket counts, so the window's
    distribution is their elementwise delta (log2 buckets -> factor-2
    resolution, same semantics as Histogram.quantile)."""
    delta = [max(b - a, 0.0) for a, b in zip(c0, c1)]
    total = sum(delta)
    if total <= 0:
        return 0.0
    need = q * total
    cum = 0.0
    for i, v in enumerate(delta):
        cum += v
        if cum >= need - 1e-9:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


def _counter_labeled_sum(values: Dict[tuple, float],
                         key: str, want: str) -> float:
    """Sum a labeled-counter snapshot over entries carrying
    ``(key, want)`` in their label tuple."""
    return sum(v for k, v in values.items() if (key, want) in k)


def _cause_totals(values: Dict[tuple, float]) -> Dict[str, float]:
    """Per-cause cumulative miss counts, summed across SLO classes."""
    out: Dict[str, float] = {}
    for k, v in values.items():
        for lk, lv in k:
            if lk == "cause":
                out[lv] = out.get(lv, 0.0) + v
    return out


class SeriesStore:
    """Bounded, thread-safe ring of registry samples + the alert
    evaluator. One lock guards everything (the sampler thread, HTTP
    handler threads and the ``note_submit`` probe on the scheduler
    path all touch it); a sample is a few dozen host floats, so the
    armed cost per tick is comparable to one ``/stats`` render.
    Host values only.
    """

    # Lock-discipline contract: the ring,
    # the submit counter, the alert state machine and the alert log
    # only mutate/read under the store's own lock.
    _GUARDED_BY = {
        "_ring": "_lock",
        "_submits": "_lock",
        "_n_samples": "_lock",
        "_alerts": "_lock",
        "_alert_log": "_lock",
        "_sampler_errors": "_lock",
    }

    def __init__(self, interval_s: float = 1.0, keep: int = 512, *,
                 slo_target: float = 0.9,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 slo_min_finished: int = 1,
                 queue_min: float = 8.0,
                 queue_ratio: float = 1.5,
                 queue_arrival_min: float = 0.0,
                 cause_min_misses: int = 4,
                 flap_min: int = 3,
                 mem_capacity_bytes: Optional[int] = None,
                 mem_headroom_frac: float = 0.1,
                 arm_samples: int = 2,
                 clear_samples: int = 3,
                 ewma_tau_s: Optional[float] = None,
                 log_keep: int = 256,
                 clock=time.perf_counter):
        self.interval_s = max(float(interval_s), 1e-3)
        self.keep = max(int(keep), 2)
        # Multi-window burn rates: the fast window reacts, the slow
        # window confirms (SRE workbook). Defaults scale with the
        # cadence so one flag tunes both.
        self.fast_window_s = (float(fast_window_s) if fast_window_s
                              else 5.0 * self.interval_s)
        self.slow_window_s = (float(slow_window_s) if slow_window_s
                              else 20.0 * self.interval_s)
        self.slo_target = min(max(float(slo_target), 0.0), 1.0 - 1e-9)
        # Traffic floor for the burn-rate rule: a single missed request
        # among a handful of finishes reads as a 50% burn in a short
        # window — real burn-rate alerts gate on request volume so
        # one-off noise cannot page (SRE workbook, "low-traffic
        # services").
        self.slo_min_finished = max(int(slo_min_finished), 1)
        self.queue_min = float(queue_min)
        self.queue_ratio = float(queue_ratio)
        # > 0 swaps queue_trend's confirmation signal from "rising vs
        # the slow window" to "arrival EWMA above this floor". The
        # trend test cannot confirm sustained saturation early in a
        # ring (slow ~= fast when history is short) and a lone deep
        # burst passes it trivially (slow ~= 0); arrival pressure
        # orders those two correctly.
        self.queue_arrival_min = float(queue_arrival_min)
        self.cause_min_misses = max(int(cause_min_misses), 1)
        self.flap_min = max(int(flap_min), 1)
        self.mem_capacity_bytes = (int(mem_capacity_bytes)
                                   if mem_capacity_bytes else None)
        self.mem_headroom_frac = float(mem_headroom_frac)
        # Hysteresis: N consecutive breaching samples to fire, M
        # consecutive clear samples to stand down — boundary noise
        # between the fire and clear thresholds moves neither counter
        # far enough to flap.
        self.arm_samples = max(int(arm_samples), 1)
        self.clear_samples = max(int(clear_samples), 1)
        self.ewma_tau_s = (float(ewma_tau_s) if ewma_tau_s
                           else self.fast_window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=self.keep)
        self._submits = 0
        self._n_samples = 0
        self._sampler_errors = 0
        self._alerts: Dict[str, dict] = {
            rule: {"active": False, "breach": 0, "ok": 0,
                   "transitions": 0, "fired": 0, "since": None,
                   "last_change": None, "value": 0.0}
            for rule in ALERT_RULES
        }
        self._alert_log: "deque[dict]" = deque(maxlen=max(int(log_keep), 8))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- recording --------------------------------------------------------

    def note_submit(self, n: int = 1) -> None:
        """One arrival observed (the EWMA estimator's input). Called
        from the scheduler submit path — a lock round-trip plus an int
        add, comparable to a metric observation."""
        with self._lock:
            self._submits += n

    def _read_registry(self) -> dict:
        """One registry read (each metric takes its OWN lock; the
        store's lock is not held here). Host floats only."""
        m = obs_metrics
        slo = m.SERVE_SLO_REQUESTS.labeled()
        return {
            "queue_depth": max(m.SERVE_QUEUE_DEPTH.value(),
                               m.FLEET_QUEUE_DEPTH.value()),
            "active_rows": m.SERVE_ACTIVE_ROWS.value(),
            "breaker_open": m.SERVE_BREAKER_OPEN.value(),
            "goodput_ratio": m.SERVE_SLO_GOODPUT.value(),
            "slo_finished": sum(slo.values()),
            "slo_met": _counter_labeled_sum(slo, "met", "true"),
            "requests_total": m.SERVE_REQUESTS.total(),
            "tokens_total": m.SERVE_TOKENS.total(),
            "mem_total_bytes": m.MEM_TOTAL.value(),
            "miss_causes": _cause_totals(m.SERVE_SLO_MISS_CAUSE.labeled()),
            "ttft_cum": m.SERVE_TTFT.agg_counts(),
            "latency_cum": m.SERVE_LATENCY.agg_counts(),
        }

    def sample_once(self, now: Optional[float] = None) -> dict:
        """Take one sample and evaluate every alert rule against it.
        ``now`` overrides the clock (the determinism tests drive a
        synthetic timeline through here; the sampler thread passes
        nothing). Returns the recorded sample."""
        now = self._clock() if now is None else float(now)
        raw = self._read_registry()
        with self._lock:
            prev = self._ring[-1] if self._ring else None
            ewma = 0.0
            if prev is not None and now > prev["t"]:
                dt = now - prev["t"]
                inst = (self._submits - prev["submits_total"]) / dt
                alpha = 1.0 - math.exp(-dt / self.ewma_tau_s)
                ewma = alpha * inst + (1.0 - alpha) * prev["arrival_rate_ewma"]
            sample = dict(raw)
            sample["t"] = now
            sample["submits_total"] = self._submits
            sample["arrival_rate_ewma"] = ewma
            self._ring.append(sample)
            self._n_samples += 1
            events = self._evaluate_locked(now)
        # Export OUTSIDE the store lock: the metric objects take their
        # own locks, and the tracer likewise.
        for rule, state, value in events:
            firing = state == "firing"
            obs_metrics.ALERT_ACTIVE.set(1.0 if firing else 0.0, rule=rule)
            obs_metrics.ALERT_TRANSITIONS.inc(rule=rule)
            obs_trace.instant("alert_firing" if firing else "alert_cleared",
                             cat="alert", rule=rule, value=value)
        return sample

    # -- derivations ------------------------------------------------------

    def _window_locked(self, now: float, span_s: float) -> List[dict]:
        # Scan from the newest end: cost is O(window), not O(ring) —
        # the evaluator runs this every sample against short windows
        # while the ring holds hours.
        lo = now - span_s - 1e-9
        out: List[dict] = []
        for s in reversed(self._ring):
            if s["t"] < lo:
                break
            out.append(s)
        out.reverse()
        return out

    @staticmethod
    def _attainment(win: List[dict]) -> Optional[float]:
        """Windowed SLO attainment from the cumulative met/finished
        deltas; None when the window saw no SLO-classed finish."""
        if len(win) < 2:
            return None
        fin = win[-1]["slo_finished"] - win[0]["slo_finished"]
        met = win[-1]["slo_met"] - win[0]["slo_met"]
        if fin <= 0:
            return None
        return max(min(met / fin, 1.0), 0.0)

    @staticmethod
    def _mean(win: List[dict], key: str) -> Optional[float]:
        if not win:
            return None
        return sum(s[key] for s in win) / len(win)

    @staticmethod
    def _cause_deltas(win: List[dict]) -> Dict[str, float]:
        if len(win) < 2:
            return {}
        first, last = win[0]["miss_causes"], win[-1]["miss_causes"]
        return {c: last[c] - first.get(c, 0.0)
                for c in last if last[c] - first.get(c, 0.0) > 0}

    @staticmethod
    def _dominant(deltas: Dict[str, float]) -> Optional[str]:
        best, best_v = None, 0.0
        for c, v in sorted(deltas.items()):
            if v > best_v:
                best, best_v = c, v
        return best

    @staticmethod
    def _flips(win: List[dict], key: str) -> int:
        return sum(1 for a, b in zip(win, win[1:]) if a[key] != b[key])

    def _evaluate_locked(self, now: float) -> List[Tuple[str, str, float]]:
        """Evaluate every rule against the current ring; advance the
        hysteresis state machines; return the transitions to export."""
        fast = self._window_locked(now, self.fast_window_s)
        slow = self._window_locked(now, self.slow_window_s)
        last = self._ring[-1]
        verdicts: Dict[str, Tuple[bool, bool, float, str]] = {}

        # slo_burn: burn rate = (1 - attainment) / (1 - target); both
        # windows must burn >= 1 to fire (multi-window), attainment
        # back above target + half the margin in the fast window to
        # clear (hysteresis gap).
        att_f, att_s = self._attainment(fast), self._attainment(slow)
        fin_f = (fast[-1]["slo_finished"] - fast[0]["slo_finished"]
                 if len(fast) >= 2 else 0)
        clear_target = self.slo_target + 0.5 * (1.0 - self.slo_target)
        breach = (att_f is not None and att_s is not None
                  and fin_f >= self.slo_min_finished
                  and att_f < self.slo_target and att_s < self.slo_target)
        cleared = att_f is None or att_f >= clear_target
        verdicts["slo_burn"] = (breach, cleared,
                                att_f if att_f is not None else 1.0, "")

        # queue_trend: fast-window mean depth above the floor AND
        # confirmed as load rather than noise — rising vs the slow
        # window, or (when queue_arrival_min is armed) the arrival
        # EWMA above its floor. Clears when the depth halves or the
        # trend inverts.
        qf = self._mean(fast, "queue_depth") or 0.0
        qs = self._mean(slow, "queue_depth") or 0.0
        if self.queue_arrival_min > 0:
            confirmed = last["arrival_rate_ewma"] >= self.queue_arrival_min
        else:
            confirmed = qf >= self.queue_ratio * qs if qs > 1e-9 else qf > 0
        breach = qf >= self.queue_min and confirmed
        cleared = qf < 0.5 * self.queue_min or (qs > 1e-9 and qf < qs)
        verdicts["queue_trend"] = (breach, cleared, qf, "")

        # cause_shift: the fast window's dominant miss cause diverged
        # from the slow window's, with enough misses to mean anything.
        df, ds = self._cause_deltas(fast), self._cause_deltas(slow)
        dom_f, dom_s = self._dominant(df), self._dominant(ds)
        n_f = sum(df.values())
        breach = (dom_f is not None and dom_s is not None
                  and dom_f != dom_s and n_f >= self.cause_min_misses)
        cleared = dom_f is None or dom_f == dom_s
        detail = (f"{dom_s}->{dom_f}"
                  if breach and dom_s is not None else "")
        verdicts["cause_shift"] = (breach, cleared, n_f, detail)

        # breaker_flap: state changes inside the slow window.
        flips = self._flips(slow, "breaker_open")
        verdicts["breaker_flap"] = (flips >= self.flap_min, flips == 0,
                                    float(flips), "")

        # mem_shrink: headroom under the floor AND the resident total
        # still growing; needs a configured capacity to judge against.
        if self.mem_capacity_bytes:
            cap = float(self.mem_capacity_bytes)
            headroom = 1.0 - last["mem_total_bytes"] / cap
            mf = self._mean(fast, "mem_total_bytes") or 0.0
            ms = self._mean(slow, "mem_total_bytes") or 0.0
            breach = headroom < self.mem_headroom_frac and mf >= ms
            cleared = headroom >= 1.5 * self.mem_headroom_frac
            verdicts["mem_shrink"] = (breach, cleared, headroom, "")
        else:
            verdicts["mem_shrink"] = (False, True, 1.0, "")

        events: List[Tuple[str, str, float]] = []
        for rule in ALERT_RULES:
            breach, cleared, value, detail = verdicts[rule]
            st = self._alerts[rule]
            st["value"] = value
            if st["active"]:
                st["ok"] = st["ok"] + 1 if cleared else 0
                if st["ok"] >= self.clear_samples:
                    st.update(active=False, ok=0, breach=0,
                              last_change=now)
                    st["transitions"] += 1
                    self._log_locked(now, rule, "cleared", value, detail)
                    events.append((rule, "cleared", value))
            else:
                st["breach"] = st["breach"] + 1 if breach else 0
                if st["breach"] >= self.arm_samples:
                    st.update(active=True, breach=0, ok=0, since=now,
                              last_change=now)
                    st["transitions"] += 1
                    st["fired"] += 1
                    self._log_locked(now, rule, "firing", value, detail)
                    events.append((rule, "firing", value))
        return events

    def _log_locked(self, now: float, rule: str, state: str,
                    value: float, detail: str) -> None:
        ev = {"t": now, "rule": rule, "state": state,
              "value": round(float(value), 6)}
        if detail:
            ev["detail"] = detail
        self._alert_log.append(ev)

    # -- export -----------------------------------------------------------

    _POINT_KEYS = ("queue_depth", "active_rows", "breaker_open",
                   "goodput_ratio", "arrival_rate_ewma",
                   "mem_total_bytes", "requests_total", "tokens_total",
                   "submits_total")

    def snapshot(self, window_s: Optional[float] = None,
                 n: Optional[int] = None,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """The ``GET /series`` payload: the newest ``n`` points with
        ages relative to NOW (duration-aligned — absolute perf_counter
        floats mean nothing across processes) plus windowed
        derivations over ``window_s`` (default: the whole ring)."""
        now = self._clock() if now is None else float(now)
        n = 128 if n is None else max(int(n), 1)
        with self._lock:
            pts = list(self._ring)[-n:]
            span = (window_s if window_s is not None
                    else (now - self._ring[0]["t"] if self._ring else 0.0))
            win = self._window_locked(now, max(float(span), 0.0))
            samples, dropped = self._n_samples, \
                max(self._n_samples - self.keep, 0)
        points = [
            {"age_s": round(now - s["t"], 6),
             **{k: round(float(s[k]), 6) for k in self._POINT_KEYS}}
            for s in pts
        ]
        derived: Dict[str, Any] = {"window_s": round(float(span), 6)}
        if len(win) >= 2:
            dt = win[-1]["t"] - win[0]["t"]
            if dt > 0:
                derived["request_rate_per_s"] = round(
                    (win[-1]["requests_total"] - win[0]["requests_total"])
                    / dt, 6)
                derived["token_rate_per_s"] = round(
                    (win[-1]["tokens_total"] - win[0]["tokens_total"])
                    / dt, 6)
                derived["submit_rate_per_s"] = round(
                    (win[-1]["submits_total"] - win[0]["submits_total"])
                    / dt, 6)
            for key in ("queue_depth", "goodput_ratio", "mem_total_bytes"):
                vals = [s[key] for s in win]
                derived[f"{key}_last"] = round(vals[-1], 6)
                derived[f"{key}_min"] = round(min(vals), 6)
                derived[f"{key}_max"] = round(max(vals), 6)
            derived["breaker_flips"] = self._flips(win, "breaker_open")
            att = self._attainment(win)
            if att is not None:
                derived["attainment_windowed"] = round(att, 6)
            for name, metric in (("ttft", obs_metrics.SERVE_TTFT),
                                 ("latency", obs_metrics.SERVE_LATENCY)):
                c0, c1 = win[0][f"{name}_cum"], win[-1][f"{name}_cum"]
                for q, tag in ((0.5, "p50"), (0.99, "p99")):
                    derived[f"{name}_{tag}_s"] = _window_quantile(
                        metric.bounds, c0, c1, q)
            deltas = self._cause_deltas(win)
            derived["miss_cause_deltas"] = {
                c: round(v, 6) for c, v in sorted(deltas.items())}
            dom = self._dominant(deltas)
            if dom is not None:
                derived["dominant_miss_cause"] = dom
        if win:
            derived["arrival_rate_ewma"] = round(
                win[-1]["arrival_rate_ewma"], 6)
        return {
            "interval_s": self.interval_s,
            "keep": self.keep,
            "samples": samples,
            "dropped": dropped,
            "points": points,
            "derived": derived,
        }

    def alerts_snapshot(self, now: Optional[float] = None,
                        n: int = 64) -> Dict[str, Any]:
        """The ``GET /alerts`` payload: per-rule state + the bounded
        transition log, ages duration-aligned like the series."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            rules = {}
            for rule in ALERT_RULES:
                st = self._alerts[rule]
                rules[rule] = {
                    "active": st["active"],
                    "transitions": st["transitions"],
                    "fired": st["fired"],
                    "value": round(float(st["value"]), 6),
                }
                if st["active"] and st["since"] is not None:
                    rules[rule]["since_age_s"] = round(now - st["since"], 6)
                if st["last_change"] is not None:
                    rules[rule]["last_change_age_s"] = round(
                        now - st["last_change"], 6)
            log = [
                {**{k: v for k, v in ev.items() if k != "t"},
                 "age_s": round(now - ev["t"], 6)}
                for ev in list(self._alert_log)[-max(int(n), 1):]
            ]
        return {
            "rules": rules,
            "active": [r for r in ALERT_RULES if rules[r]["active"]],
            "log": log,
        }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "keep": self.keep,
                "samples": self._n_samples,
                "submits": self._submits,
                "sampler_errors": self._sampler_errors,
            }

    # -- sampler thread ---------------------------------------------------

    def start(self) -> None:
        """Start the cadence sampler (idempotent). Daemon thread: one
        registry read per interval, no device work."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="series-sampler", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                # The sampler must never die silently mid-serve; the
                # error count is exported via stats() instead.
                with self._lock:
                    self._sampler_errors += 1

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None


# -- module-global arming (the trace.py discipline) ------------------------

_store: Optional[SeriesStore] = None


def configure(interval_s: float = 1.0, keep: int = 512,
              autostart: bool = True, **kwargs) -> Optional[SeriesStore]:
    """Arm the time-series store sampling every ``interval_s`` seconds
    into a ring of ``keep`` samples; ``interval_s <= 0`` or
    ``keep <= 0`` disarms. ``autostart`` launches the cadence thread
    (tests drive ``sample_once`` explicitly instead)."""
    global _store
    if _store is not None:
        _store.stop()
    if interval_s <= 0 or keep <= 0:
        _store = None
        return None
    _store = SeriesStore(interval_s=interval_s, keep=keep, **kwargs)
    # All rules visibly healthy from the start (the gauge renders only
    # observed label sets).
    for rule in ALERT_RULES:
        obs_metrics.ALERT_ACTIVE.set(0.0, rule=rule)
    if autostart:
        _store.start()
    return _store


def disable() -> None:
    global _store
    if _store is not None:
        _store.stop()
    _store = None


def active() -> Optional[SeriesStore]:
    return _store


def enabled() -> bool:
    return _store is not None


# -- armed-checked probes (one module-global load + None check when
#    disarmed; no clock read, no allocation) -------------------------------

def note_submit(n: int = 1) -> None:
    s = _store
    if s is not None:
        s.note_submit(n)


def sample_now() -> Optional[dict]:
    s = _store
    return None if s is None else s.sample_once()


def snapshot(window_s: Optional[float] = None,
             n: Optional[int] = None) -> Dict[str, Any]:
    s = _store
    return {"enabled": False} if s is None else \
        {"enabled": True, **s.snapshot(window_s=window_s, n=n)}


def alerts() -> Dict[str, Any]:
    s = _store
    return {"enabled": False} if s is None else \
        {"enabled": True, **s.alerts_snapshot()}


def alert_stats(n: int = 8) -> Dict[str, Any]:
    """The compact ``/stats`` ``"alerts"`` block: active rules + the
    last few transitions (the full log rides ``GET /alerts``)."""
    s = _store
    if s is None:
        return {"enabled": False, "active": []}
    snap = s.alerts_snapshot(n=n)
    return {
        "enabled": True,
        "active": snap["active"],
        "transitions": {r: st["transitions"]
                        for r, st in snap["rules"].items()},
        "last": snap["log"],
    }
