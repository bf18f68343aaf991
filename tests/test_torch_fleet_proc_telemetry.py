"""The process fleet's telemetry and streaming (``eventgpt_tpu_torch/fleet_proc.py``)
against the JAX package's ``ProcFleet``, over stub workers: each scenario
runs on the JAX coordinator over the JAX stub and on the port's over the
port's stub, side by side, with each coordinator's recorder, registry and
series store armed (each stub worker arms a store of its own).

- Deliver-at-finish streaming: a streamed request gets its whole chain in
  one list, then the end sentinel; one streamed request survives the
  SIGKILL of its worker (redone on the survivor) and gets the same.
- Journeys: the moved request's stitched journey carries ``worker_lost``,
  the ``redo`` failover, the repin and the respawn; a prefill/decode split's
  carries the shipped ``kv_handoff`` and both legs, with ``handoff_s``.
- The ``egpt_procfleet_*`` samples (timing-free ones), the series keys of
  the coordinator, of each worker and of the aggregate, the alert rules of
  each store, the shapes of ``memory_stats`` and ``stats``.
Equal field for field between the packages, times aside. Every wait is
bounded, and every fleet shuts down (its workers with it) in a
``finally``.
"""

import threading
import time

import numpy as np
import pytest

from eventgpt_tpu import faults as jfaults
from eventgpt_tpu import fleet_proc as jfp
from eventgpt_tpu.obs import journey as jjourney
from eventgpt_tpu.obs import metrics as jmetrics
from eventgpt_tpu.obs import series as jseries
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch import fleet_proc as tfp
from eventgpt_tpu_torch.obs import journey as tjourney
from eventgpt_tpu_torch.obs import metrics as tmetrics
from eventgpt_tpu_torch.obs import series as tseries

EVENT = -200
WAIT_S = 60.0
PKGS = {"jax": (jfp, jjourney, jmetrics, jseries),
        "torch": (tfp, tjourney, tmetrics, tseries)}
TIMED = {"t_s", "e2e_s", "t_submit", "t_done", "owner", "cause"}
# Samples whose values follow the clock (or the transport's luck).
TIMED_SAMPLES = ("egpt_procfleet_handoff_seconds_bucket", "egpt_procfleet_handoff_seconds_sum",
                 "egpt_procfleet_rpc_retries_total")


@pytest.fixture(autouse=True)
def armed():
    prev = {p: m[2].REGISTRY.enabled for p, m in PKGS.items()}
    for faults in (jfaults, tfaults):
        faults.disable()
    for _, journey, metrics, series in PKGS.values():
        metrics.configure(True)
        metrics.REGISTRY.reset()
        journey.configure(64)
        series.configure(interval_s=0.02, keep=256)
    yield
    for name, (_, journey, metrics, series) in PKGS.items():
        journey.disable()
        series.disable()
        metrics.REGISTRY.reset()
        metrics.configure(prev[name])


def _pv(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, 3, 4, 4)).astype(np.float32)


def _chain(ids, budget):
    s = sum(ids)
    return [(s + k) % 251 for k in range(budget)]


def _wait(cond, what, bound_s=WAIT_S):
    deadline = time.monotonic() + bound_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {bound_s} s waiting for {what}")
        time.sleep(0.01)


def _both(script):
    """``script(fleet_proc, journey, metrics, series)`` for each package, in
    two threads at once; {package: its result}."""
    out, errs = {}, {}

    def run(name):
        try:
            out[name] = script(*PKGS[name])
        except BaseException as e:  # re-raised below, in the test's thread
            errs[name] = e

    threads = [threading.Thread(target=run, args=(name,), daemon=True) for name in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * WAIT_S)
    for name, e in errs.items():
        raise AssertionError(f"the {name} scenario failed: {e!r}") from e
    assert set(out) == set(PKGS), f"a scenario did not end: {sorted(out)}"
    return out


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: (sorted(v) if k == "phases" and isinstance(v, dict) else _untimed(v))
                for k, v in obj.items() if k not in TIMED}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _samples(metrics):
    return sorted(line for line in metrics.REGISTRY.render_prometheus().splitlines()
                  if line.startswith("egpt_procfleet_") and not line.startswith(TIMED_SAMPLES))


def _drain(q):
    out = [q.get(timeout=WAIT_S)]
    while out[-1] is not None and not isinstance(out[-1], dict):
        out.append(q.get(timeout=WAIT_S))
    return out


def test_streams_journeys_metrics_series_alerts_and_memory_equal_jax():
    """A colocated pair: a streamed and a plain request, then a long
    streamed request whose worker is SIGKILLed mid-decode (the supervisor
    redoes it on the survivor and respawns the slot)."""
    ids_a, ids_b, ids_long = [1, 2, EVENT, 4], [1, 2, EVENT, 6], [1, 3, EVENT, 8]

    def script(fp, journey, metrics, series):
        fleet = fp.ProcFleet(fp.stub_worker_cmd(0.002), 2, spawn_timeout_s=WAIT_S,
                             probe_interval_s=0.02, respawn_backoff_s=0.05)
        try:
            fa = fleet.submit_ids(ids_a, _pv(1), 5, stream=True)
            fb = fleet.submit_ids(ids_b, _pv(2), 5)
            out = {"stream": _drain(fleet.stream_queue(fa)),
                   "plain": fleet.result(fb, timeout=WAIT_S)}
            fl = fleet.submit_ids(ids_long, _pv(3), 300, stream=True)
            victim = fleet.worker_of(fl)
            time.sleep(0.1)  # mid-decode (300 tokens at 2 ms)
            fleet.kill_worker(victim)
            out["long"] = _drain(fleet.stream_queue(fl))
            _wait(lambda: fleet.n_respawns == 1 and all(s.routable for s in fleet.slots),
                  "the respawn")
            _wait(lambda: all((fleet.journey(f) or {}).get("finished") for f in (fa, fb, fl)),
                  "the journeys to finish")
            js = {n: fleet.journey(f) for n, f in (("stream", fa), ("plain", fb), ("moved", fl))}
            for n, j in js.items():
                assert sum(j["phases"].values()) == pytest.approx(j["e2e_s"], abs=1e-6), n
            out["journeys"] = _untimed(js)
            out["moved_to"] = (victim, fleet.worker_of(fl))
            time.sleep(0.1)  # a few sampler ticks in every store
            srs = fleet.series(n=4)
            out["series"] = (sorted(srs), sorted(srs["coordinator"]), sorted(srs["aggregate"]),
                             [sorted(w) for w in srs["workers"]])
            al = fleet.alerts()
            out["alerts"] = (sorted(al), al["active"],
                             [(sorted(w), sorted(w["rules"])) for w in al["workers"]])
            out["memory"] = fleet.memory_stats()
            st = fleet.stats()
            out["stats"] = (sorted(st), sorted(st["fleet"]), sorted(st["fleet"]["per_worker"][0]),
                            st["memory"], sorted(st["alerts"]))
            out["samples"] = _samples(metrics)
            out["counters"] = (fleet.n_failovers, fleet.n_deaths, fleet.n_respawns)
            return out
        finally:
            fleet.shutdown()

    got = _both(script)
    for key in got["jax"]:
        assert got["torch"][key] == got["jax"][key], key
    out = got["torch"]
    assert out["stream"] == [_chain(ids_a, 5), None] and out["plain"] == _chain(ids_b, 5)
    assert out["long"] == [_chain(ids_long, 300), None]
    moved = out["journeys"]["moved"]
    assert [e["kind"] for e in moved["events"]] == ["submit", "route", "worker_lost",
                                                     "failover", "repin", "respawn", "finish"]
    assert [e.get("path") for e in moved["events"] if e["kind"] == "failover"] == ["redo"]
    assert [a["worker"] for a in moved["assignments"]] == list(out["moved_to"])
    assert out["counters"] == (1, 1, 1)
    assert 'egpt_procfleet_failovers_total{path="redo"} 1' in out["samples"]
    assert "egpt_procfleet_worker_deaths_total 1" in out["samples"]
    assert "egpt_procfleet_respawns_total 1" in out["samples"]
    assert out["memory"] == {"proc_fleet": True,
                             "workers": [{"worker": i, "state": "ok", "stub": True}
                                         for i in range(2)]}


def test_a_split_journey_carries_the_handoff_and_both_legs_as_jax():
    ids = [1, 2, EVENT, 7]

    def script(fp, journey, metrics, series):
        fleet = fp.ProcFleet(fp.stub_worker_cmd(0.002), 2, roles="1:1", spawn_timeout_s=WAIT_S,
                             probe_interval_s=0.02)
        try:
            fr = fleet.submit_ids(ids, _pv(1), 6, stream=True)
            out = {"stream": _drain(fleet.stream_queue(fr)), "worker": fleet.worker_of(fr)}
            _wait(lambda: (fleet.journey(fr) or {}).get("finished"), "the journey to finish")
            j = fleet.journey(fr)
            assert sum(j["phases"].values()) == pytest.approx(j["e2e_s"], abs=1e-6)
            out["handoff_s"] = j["phases"]["handoff_s"] > 0.0
            out["journey"] = _untimed(j)
            out["samples"] = _samples(metrics)
            return out
        finally:
            fleet.shutdown()

    got = _both(script)
    assert got["torch"] == got["jax"]
    out = got["torch"]
    assert out["stream"] == [_chain(ids, 6), None] and out["worker"] == 1 and out["handoff_s"]
    ev = [e for e in out["journey"]["events"] if e["kind"] == "kv_handoff"]
    assert [(e["stage"], e["from_worker"], e["to_worker"], e["bytes"]) for e in ev] == [
        ("shipped", 0, 1, 4 * len(ids))]
    assert [a["worker"] for a in out["journey"]["assignments"]] == [0, 1]
    assert 'egpt_procfleet_handoff_total{stage="shipped"} 1' in out["samples"]
    assert f"egpt_procfleet_handoff_bytes_total {4 * len(ids)}" in out["samples"]
