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
- The fleets' telemetry (journeys, series, alerts, memory) is refused by
  name, and its HTTP routes answer 501 at the CLI's telemetry defaults.
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
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch import fleet as tfleet
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer as ttok
from eventgpt_tpu_torch.models.convert import params_from_jax
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
    fleet = _fleet(trees, "torch", n=1)
    try:
        for call in (lambda: fleet.journey(0), fleet.journeys, fleet.series, fleet.alerts,
                     fleet.memory_stats, lambda: fleet.stream_queue(0)):
            with pytest.raises(NotImplementedError, match="not ported"):
                call()
        assert not {"metrics", "memory", "alerts"} & set(fleet.stats())
    finally:
        fleet.shutdown()
    with pytest.raises(ValueError, match="at least one"):
        tfleet.Fleet([])


def test_the_fleet_telemetry_routes_answer_501_at_the_defaults(trees):
    """Behind the HTTP handler, at the CLI's telemetry defaults, a fleet's
    journey, series, alert and memory routes answer 501 naming the item;
    the process-wide routes (metrics, trace) answer as for one engine."""
    import http.client
    import json
    from http.server import ThreadingHTTPServer

    args = tcli.build_parser().parse_args(["--device", "cpu", "--fleet", "2"])
    tcli.arm_telemetry(args)
    fleet = _fleet(trees, "torch", n=1)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tcli.make_handler(fleet, TCFG))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        for path in ("/request?rid=0", "/requests", "/series", "/alerts", "/memory"):
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
            conn.request("GET", path)
            res = conn.getresponse()
            assert res.status == 501, path
            assert "item 6b" in json.loads(res.read())["error"], path
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
        from eventgpt_tpu_torch.obs import metrics as tmetrics

        tmetrics.configure(True)
