"""The port's fleet tier (``eventgpt_tpu_torch/fleet.py``) against the JAX
package's (``tests/test_fleet.py``'s scenarios), f32 on the CPU, two
replicas over one tiny tree.

- ``retry_after_s`` equals the JAX function on a grid, and ``cli/serve``
  re-exports it; ``affinity_key`` hashes to the JAX key for the same ids
  and pixels, from a numpy array or a host tensor.
- Routing: a session (same head, same stream) pins to one replica, whose
  prefix cache takes the hits; every chain equals a single engine's and the
  JAX fleet's.
- Shedding: with the replicas' loops parked (so that queue depths are
  deterministic), the shed decisions and ``Retry-After`` hints of a request
  sequence equal the JAX fleet's, by queue depth and by windowed goodput;
  only ``batch`` is ever shed.
- A kill re-pins the session to the survivor; the revived replica rejoins.
- The fleets' telemetry (journeys, series, alerts, memory) answers, a
  streamed request reads its replica's queue, and the telemetry routes
  answer 200 at the CLI's telemetry defaults.
- Telemetry in lockstep: one scripted scenario on each package's fleet,
  its recorder, registry and series store armed (the store on an injected
  clock): with the loops parked, two plain requests and a streamed one are
  routed, the queued depth fires ``queue_trend``, a batch request is shed
  and replica 0 is killed; the loops resume, the moved request finishes on
  the survivor, the replica restarts. Equal field for field, times aside:
  the stitched journeys (the moved one with its failover and both
  assignments; the streamed one ``engine_fault``; the shed one ``shed``),
  the stream's fault sentinel, the ``egpt_fleet_*`` samples (equal to the
  fleet's own counters), the series keys, the alerts, and the shapes of
  ``memory_stats`` and ``stats``.
Multi-thread legs wait on states, each with a bound.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import faults as jfaults
from eventgpt_tpu import fleet as jfleet
from eventgpt_tpu import serve as jserve
from eventgpt_tpu import workload as jwork
from eventgpt_tpu.cli import serve as jcli
from eventgpt_tpu.data.tokenizer import load_tokenizer as jtok
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.obs import journey as jjourney
from eventgpt_tpu.obs import metrics as jmetrics
from eventgpt_tpu.obs import series as jseries
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch import fleet as tfleet
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer as ttok
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.obs import journey as tjourney
from eventgpt_tpu_torch.obs import metrics as tmetrics
from eventgpt_tpu_torch.obs import series as tseries
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.disable()
    tfaults.disable()
    yield
    jfaults.disable()
    tfaults.disable()


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _pv(seed=0):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


def _ids(suffix=()):
    return [1, 7, 7, -200, 9, 10, 11] + list(suffix)


def _batcher(trees, pkg, **kw):
    args = {"max_batch": 1, "chunk": 2, "max_len": 256, "eos_token_id": None, **kw}
    if pkg == "torch":
        return ContinuousBatcher(trees[1], TCFG, device="cpu", **args)
    return jserve.ContinuousBatcher(trees[0], JCFG, **args)


def _fleet(trees, pkg, n=2, probe_interval_s=0.01, park=False, batcher_kw=None, **kw):
    """A fleet of ``n`` engines; ``park`` stops each engine's loop before
    the fleet exists, so that nothing is admitted until ``_unpark``."""
    cli, tok, fl = (tcli, ttok("byte"), tfleet) if pkg == "torch" else (jcli, jtok("byte"),
                                                                         jfleet)
    engines = [cli.ServingEngine(_batcher(trees, pkg, **(batcher_kw or {})), tok)
               for _ in range(n)]
    if park:
        for eng in engines:
            eng._stop = True
            eng._wake.set()
            eng._thread.join(timeout=10)
    return fl.Fleet(engines, tok, probe_interval_s=probe_interval_s, **kw)


def _unpark(fleet):
    for rep in fleet.replicas:
        eng = rep.engine
        eng._stop = False
        eng._thread = threading.Thread(target=eng._loop, daemon=True)
        eng._thread.start()


def _slo(pkg, **kw):
    return (twork if pkg == "torch" else jwork).SLO(**kw)


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.005)


@pytest.mark.parametrize("cls", ["interactive", "batch", "other"])
def test_retry_after_equals_jax(cls):
    for g in (0.0, 0.3, 0.5, 0.99, 1.0, 1.7, -1.0):
        for depth, cap in ((0, 0), (3, 10), (100, 10), (5, 0)):
            assert tfleet.retry_after_s(cls, g, depth, cap) == jfleet.retry_after_s(
                cls, g, depth, cap)
    assert tcli.retry_after_s is tfleet.retry_after_s
    assert tfleet.retry_after_s("batch", 0.0) == pytest.approx(16.0)
    assert tfleet.retry_after_s("batch", 0.3, queue_depth=100, max_queue=10) <= 60.0


def test_affinity_key_equals_jax():
    for ids, seed in ((_ids(), 1), (_ids((55, 56)), 1), (_ids(), 2), ([1, 2, 3], 4)):
        pv = _pv(seed)
        want = jfleet.affinity_key(ids, pv)
        assert tfleet.affinity_key(ids, pv) == want
        assert tfleet.affinity_key(ids, torch.from_numpy(pv)) == want
        assert tfleet.affinity_key(ids, pv.astype(np.float64)) == want  # f32 content
    a = tfleet.affinity_key(_ids(), _pv(1))
    assert a == tfleet.affinity_key(_ids((55, 56)), _pv(1))  # a later turn, same head
    assert a != tfleet.affinity_key(_ids(), _pv(2))  # another stream


def test_session_pins_to_one_replica_that_takes_the_hits(trees):
    fleet = _fleet(trees, "torch")
    try:
        frids = []
        for turn in range(3):
            f = fleet.submit_ids(_ids(tuple(range(30, 30 + turn))), _pv(7), 4)
            fleet.result(f, timeout=120)
            frids.append(f)
        homes = {fleet.replica_of(f) for f in frids}
        assert len(homes) == 1, f"the session moved: {homes}"
        home = homes.pop()
        pinned = fleet.replicas[home].engine.batcher.prefix_cache_stats()
        idle = fleet.replicas[1 - home].engine.batcher.prefix_cache_stats()
        assert pinned["hits"] >= 1
        assert idle["hits"] == 0 and idle["misses"] == 0
        view = fleet.batcher.prefix_cache_stats()
        assert view["hits"] == pinned["hits"] and len(view["replicas"]) == 2
        assert fleet.stats()["fleet"]["pins"] == 1
        f = fleet.submit_ids(_ids(), _pv(8), 4)  # another stream: no pin yet
        assert len(fleet.result(f, timeout=120)) == 4
    finally:
        fleet.shutdown()


def test_fleet_chains_equal_a_single_engine_and_the_jax_fleet(trees):
    reqs = [(_ids((40 + i,)), _pv(100 + i), 6) for i in range(4)]
    ref = _batcher(trees, "torch", max_batch=2)
    ref_rids = [ref.submit(*r) for r in reqs]
    done = ref.run_until_drained()
    want = [done[r] for r in ref_rids]
    out = {}
    for pkg in ("jax", "torch"):
        fleet = _fleet(trees, pkg)
        try:
            frids = [fleet.submit_ids(*r) for r in reqs]
            out[pkg] = [fleet.result(f, timeout=120) for f in frids]
            assert {fleet.replica_of(f) for f in frids} == {0, 1}
        finally:
            fleet.shutdown()
    assert out["torch"] == out["jax"] == want


def _shed_sequence(trees, pkg, fleet_kw, seq):
    """Submit ``seq`` ((class or None, seed) pairs) to a parked fleet: the
    outcome of each, "ok" or the shed's (class, Retry-After), then unpark
    and drain. Returns (outcomes, n_shed)."""
    fleet = _fleet(trees, pkg, park=True, **fleet_kw)
    outcomes, frids = [], []
    shed_err = tfleet.FleetShedError if pkg == "torch" else jfleet.FleetShedError
    try:
        for cls, seed in seq:
            slo = None if cls is None else _slo(pkg, name=cls, latency_s=3600.0)
            try:
                frids.append(fleet.submit_ids(_ids((seed,)), _pv(seed), 4, slo=slo))
                outcomes.append("ok")
            except shed_err as e:
                outcomes.append((e.slo_class, e.retry_after_s, "shed" in str(e)))
        _unpark(fleet)
        for f in frids:
            assert len(fleet.result(f, timeout=120)) == 4
        return outcomes, dict(fleet.n_shed)
    finally:
        fleet.shutdown()


SEQ = [("batch", 1), (None, 2), ("batch", 3), ("interactive", 4), ("batch", 5),
       ("batch", 6), ("interactive", 7), (None, 8), ("batch", 9)]


@pytest.mark.parametrize("depth", [2, 4])
def test_queue_depth_shedding_equals_jax(trees, depth):
    kw = dict(shed_queue_depth=depth, shed_goodput_ratio=0.0)
    t = _shed_sequence(trees, "torch", kw, SEQ)
    assert t == _shed_sequence(trees, "jax", kw, SEQ)
    outcomes, n_shed = t
    shed = [o for o in outcomes if o != "ok"]
    assert shed and all(o[0] == "batch" and o[2] for o in shed)
    assert n_shed == {"batch": len(shed)}
    # Only batch was ever refused: every interactive and unclassed request ran.
    assert all(o == "ok" for (cls, _), o in zip(SEQ, outcomes) if cls != "batch")


def test_goodput_shedding_equals_jax(trees):
    """Two interactive requests miss an impossible TTFT, so the windowed
    goodput is 0 with 2 finishes: batch is then shed with the hint at
    goodput 0, and interactive still runs."""
    out = {}
    for pkg in ("jax", "torch"):
        fleet = _fleet(trees, pkg, shed_goodput_ratio=0.5, shed_min_window=2)
        try:
            for seed in (1, 2):
                f = fleet.submit_ids(_ids((seed,)), _pv(seed), 3,
                                     slo=_slo(pkg, name="interactive", ttft_s=1e-9))
                fleet.result(f, timeout=120)
            err = tfleet.FleetShedError if pkg == "torch" else jfleet.FleetShedError
            with pytest.raises(err) as e:
                fleet.submit_ids(_ids((3,)), _pv(3), 3, slo=_slo(pkg, name="batch",
                                                                 latency_s=60.0))
            f = fleet.submit_ids(_ids((4,)), _pv(4), 3,
                                 slo=_slo(pkg, name="interactive", ttft_s=1e-9))
            out[pkg] = (e.value.slo_class, e.value.retry_after_s, fleet.result(f, timeout=120),
                        fleet.slo_stats()["classes"]["interactive"], fleet.goodput_ratio())
        finally:
            fleet.shutdown()
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == ("batch", tfleet.retry_after_s("batch", 0.0, 0, 1))


def test_failover_repins_the_session_to_the_survivor(trees):
    fleet = _fleet(trees, "torch")
    try:
        f0 = fleet.submit_ids(_ids(), _pv(9), 4)
        fleet.result(f0, timeout=120)
        home = fleet.replica_of(f0)
        tfaults.configure("serve.step:delay=0.02")  # a window for the kill
        f1 = fleet.submit_ids(_ids((70,)), _pv(9), 16)
        _wait(lambda: any(r is not None for r in fleet.replicas[home].engine.batcher.rows),
              "the session's second turn to decode")
        assert fleet.kill_replica(home) == 1
        assert fleet.kill_replica(home) == 0  # already dead
        assert len(fleet.result(f1, timeout=120)) == 16
        survivor = fleet.replica_of(f1)
        assert survivor != home and fleet.n_failovers == 1
        f2 = fleet.submit_ids(_ids((70, 71)), _pv(9), 4)
        fleet.result(f2, timeout=120)
        assert fleet.replica_of(f2) == survivor  # the pin followed the failover
        fleet.restart_replica(home)
        assert fleet.replicas[home].routable and not fleet.breaker_open()
        st = fleet.fleet_stats()
        assert st["kills"] == 1 and st["failovers"] == 1 and st["routable"] == 2
        assert st["per_replica"][home]["kills"] == 1
        fleet.reset_stats()
        assert fleet.fleet_stats()["kills"] == 0
    finally:
        fleet.shutdown()


def test_the_telemetry_parts_wait_for_their_item(trees):
    """The parts that waited for their items answer now: the telemetry
    surfaces (recorder disarmed: no journeys) and a streamed request's
    queue, whose last list is the plain request's chain."""
    fleet = _fleet(trees, "torch", n=1)
    try:
        assert fleet.journey(0) is None and fleet.journeys() == []
        assert [r["replica"] for r in fleet.series()["per_replica"]] == [0]
        assert "enabled" in fleet.alerts()
        mem = fleet.memory_stats()
        assert {"reconcile", "replicas", "components"} <= set(mem)
        assert [r["replica"] for r in mem["replicas"]] == [0]
        assert {"metrics", "memory", "alerts"} <= set(fleet.stats())
        plain = fleet.result(fleet.submit_ids(_ids((5,)), _pv(5), 4), timeout=WAIT_S)
        q = fleet.stream_queue(fleet.submit_ids(_ids((5,)), _pv(5), 4, stream=True))
        got = []
        while (item := q.get(timeout=WAIT_S)) is not None:
            got.append(item)
        assert got[-1] == plain and all(got[i] == got[-1][:len(got[i])] for i in range(len(got)))
    finally:
        fleet.shutdown()
    with pytest.raises(ValueError, match="at least one"):
        tfleet.Fleet([])


def test_the_fleet_telemetry_routes_answer_501_at_the_defaults(trees):
    """Behind the HTTP handler, at the CLI's telemetry defaults, a fleet's
    journey, series, alert and memory routes answer 200 (they answered 501
    until the fleets' telemetry was ported): the request's stitched
    journey with its assignment, the fleet's series and memory with each
    replica's part; the process-wide routes (metrics, trace) answer as for
    one engine."""
    import http.client
    import json
    from http.server import ThreadingHTTPServer

    args = tcli.build_parser().parse_args(["--device", "cpu", "--fleet", "2"])
    tcli.arm_telemetry(args)
    fleet = _fleet(trees, "torch", n=1)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tcli.make_handler(fleet, TCFG))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        frid = fleet.submit_ids(_ids((6,)), _pv(6), 3)
        fleet.result(frid, timeout=WAIT_S)
        bodies = {}
        for path in (f"/request?rid={frid}", "/requests", "/series", "/alerts", "/memory"):
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            conn.request("GET", path)
            res = conn.getresponse()
            assert res.status == 200, path
            bodies[path.split("?")[0]] = json.loads(res.read())
        j = bodies["/request"]
        assert j["finished"] and j["status"] == "ok"
        assert [(a["replica"], a["journey"]["status"]) for a in j["assignments"]] == [(0, "ok")]
        assert sum(j["phases"].values()) == pytest.approx(j["e2e_s"], abs=1e-9)
        assert [r["rid"] for r in bodies["/requests"]["requests"]] == [frid]
        assert [r["replica"] for r in bodies["/series"]["per_replica"]] == [0]
        assert "rules" in bodies["/alerts"]
        assert [r["replica"] for r in bodies["/memory"]["replicas"]] == [0]
        for path in ("/metrics", "/trace"):
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            conn.request("GET", path)
            res = conn.getresponse()
            res.read()
            assert res.status == 200, path
    finally:
        httpd.shutdown()
        httpd.server_close()
        fleet.shutdown()
        args.no_telemetry = True
        tcli.arm_telemetry(args)
        tmetrics.configure(True)


# (journey, metrics, series) of each package.
OBS = {"jax": (jjourney, jmetrics, jseries), "torch": (tjourney, tmetrics, tseries)}
# Journey fields that hold times (or the recorder's owner numbering).
TIMED = {"t_s", "e2e_s", "t_submit", "t_done", "owner", "cause", "since_age_s",
         "last_change_age_s", "age_s"}


@pytest.fixture
def armed():
    """Each package's registry zeroed and counting, its recorder armed;
    both disarmed again after the test."""
    prev = {p: m[1].REGISTRY.enabled for p, m in OBS.items()}
    for journey, metrics, series in OBS.values():
        metrics.configure(True)
        metrics.REGISTRY.reset()
        journey.configure(64)
    yield
    for name, (journey, metrics, series) in OBS.items():
        journey.disable()
        series.disable()
        metrics.REGISTRY.reset()
        metrics.configure(prev[name])


def _untimed(obj):
    """``obj`` without its times: journey and alert dicts compare on the
    rest; phase dicts on their keys."""
    if isinstance(obj, dict):
        return {k: (sorted(v) if k == "phases" and isinstance(v, dict) else _untimed(v))
                for k, v in obj.items() if k not in TIMED}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _fleet_samples(metrics):
    return sorted(line for line in metrics.REGISTRY.render_prometheus().splitlines()
                  if line.startswith("egpt_fleet_"))


def _scenario(trees, pkg):
    journey, metrics, series = OBS[pkg]
    fl, work = (tfleet, twork) if pkg == "torch" else (jfleet, jwork)
    clock = [100.0]
    store = series.configure(interval_s=1.0, keep=64, autostart=False, queue_min=2.0,
                             queue_ratio=1.0, arm_samples=1, clear_samples=1,
                             clock=lambda: clock[0])

    def tick():
        clock[0] += 1.0
        store.sample_once()

    fleet = _fleet(trees, pkg, park=True)  # nothing is admitted until the kill is done
    out = {}
    try:
        f0 = fleet.submit_ids(_ids((40,)), _pv(40), 4)
        tick()
        f1 = fleet.submit_ids(_ids((41,)), _pv(41), 4)
        tick()
        fs = fleet.submit_ids(_ids((42,)), _pv(42), 4, stream=True)
        tick()
        out["replicas"] = [fleet.replica_of(f) for f in (f0, f1, fs)]
        fleet._overloaded = lambda: (True, "forced by the test")
        with pytest.raises(fl.FleetShedError):
            fleet.submit_ids(_ids((43,)), _pv(43), 4, slo=work.SLO("batch", latency_s=30.0))
        del fleet._overloaded
        out["moved"] = fleet.kill_replica(0)
        out["stream"] = fleet.stream_queue(fs).get(timeout=WAIT_S)
        _unpark(fleet)
        out["chains"] = [list(map(int, fleet.result(f, timeout=WAIT_S))) for f in (f0, f1)]
        out["status"] = [fleet.status(f) for f in (f0, f1, fs)]
        _wait(lambda: all((fleet.journey(f) or {}).get("finished") for f in (f0, f1, fs)),
              "the fleet journeys to finish")
        fleet.restart_replica(0)
        _wait(lambda: metrics.FLEET_QUEUE_DEPTH.value() == 0 and fleet.queue_depth() == 0,
              "the supervisor to export the drained queue")
        for _ in range(3):
            tick()
        journeys = {name: fleet.journey(f) for name, f in (("moved", f0), ("plain", f1),
                                                            ("stream", fs))}
        for name, j in journeys.items():
            assert sum(j["phases"].values()) == pytest.approx(j["e2e_s"], abs=1e-9), name
        out["journeys"] = _untimed(journeys)
        out["index"] = sorted(_untimed(fleet.journeys()), key=lambda r: r["rid"])
        out["samples"] = _fleet_samples(metrics)
        out["counters"] = {"routed": metrics.FLEET_ROUTED.total(),
                           "failovers": metrics.FLEET_FAILOVERS.total(),
                           "own": (fleet.n_requests + fleet.n_failovers, fleet.n_failovers)}
        srs = fleet.series(n=8)
        out["series"] = (sorted(srs), sorted(srs["derived"]), srs["per_replica"])
        out["alerts"] = _untimed(fleet.alerts())
        mem = fleet.memory_stats()
        out["memory"] = (sorted(mem), sorted(mem["reconcile"]),
                         [(r["replica"], sorted(r["components"])) for r in mem["replicas"]])
        st = fleet.stats()
        out["stats"] = (sorted(st), sorted(st["fleet"]), sorted(st["fleet"]["per_replica"][0]),
                        sorted(st["memory"]), sorted(st["alerts"]))
        return out
    finally:
        fleet.shutdown()
        series.disable()


def test_fleet_journeys_metrics_series_alerts_and_memory_equal_jax(trees, armed):
    got = {pkg: _scenario(trees, pkg) for pkg in OBS}
    for key in got["jax"]:
        assert got["torch"][key] == got["jax"][key], key
    out = got["torch"]
    assert out["replicas"] == [0, 1, 0] and out["moved"] == 1
    assert out["stream"] == {"fault": "replica 0 killed"}
    assert out["status"] == ["ok", "ok", "engine_fault"]
    moved = out["journeys"]["moved"]
    assert [e["kind"] for e in moved["events"]] == ["submit", "route", "failover", "repin",
                                                     "finish"]
    assert [(a["replica"], a["journey"]["status"]) for a in moved["assignments"]] == [
        (0, "exported"), (1, "ok")]
    assert "failover_redo_s" in moved["phases"]
    assert out["journeys"]["stream"]["status"] == "engine_fault"
    assert [r["status"] for r in out["index"]].count("shed") == 1
    assert out["counters"]["routed"] == out["counters"]["own"][0] == 4
    assert out["counters"]["failovers"] == out["counters"]["own"][1] == 1
    assert 'egpt_fleet_shed_total{slo_class="batch"} 1' in out["samples"]
    assert "egpt_fleet_replica_deaths_total 1" in out["samples"]
    assert "queue_trend" in [e["rule"] for e in out["alerts"]["log"]]
