"""The port's fleet under injected faults (``tests/test_fleet_chaos.py``'s
scenarios), f32 on the CPU, two replicas over one tiny tree, with the JAX
batcher's chains as the oracle.

- ``fleet.route``: a trip costs locality, not service (least queue).
- ``fleet.probe``: a tripped probe takes the replica out of the pool until
  a clean probe; the other replica serves meanwhile.
- ``fleet.replica_kill``: the busiest replica dies with rows mid-decode; its
  queued and in-flight requests drain through ``export_requests`` and finish
  on the survivor with the JAX chains; the survivor's pool is clean; the
  auto-restart (``replica_restart_s``) returns the replica and a new
  session is served. Paged and dense.
- A scheduler fault on a replica (``serve.dispatch``) fails its in-flight
  request over to the other replica, with the JAX chain.
- Over HTTP, through ``cli/serve``: a policy shed is a 429 with the
  ``FleetShedError``'s hint, interactive traffic is served, ``GET /fleet``
  and ``GET /health`` read the fleet; ``build_engine --fleet 2`` builds the
  replicas with one heartbeat directory each, and ``--faults`` arms a plan.
Multi-thread legs wait on states, each with a bound.
"""

import base64
import http.client
import json
import threading
import time
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import faults as jfaults
from eventgpt_tpu import serve as jserve
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer
from eventgpt_tpu_torch.fleet import Fleet
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.serve import ContinuousBatcher
from eventgpt_tpu_torch.train.resilience import Heartbeat

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


def _kw(**kw):
    return {"max_batch": 1, "chunk": 2, "max_len": 256, "eos_token_id": None, **kw}


def _fleet(trees, n=2, probe_interval_s=0.01, batcher_kw=None, **kw):
    tok = load_tokenizer("byte")
    engines = [tcli.ServingEngine(ContinuousBatcher(trees[1], TCFG, device="cpu",
                                                    **_kw(**(batcher_kw or {}))), tok)
               for _ in range(n)]
    return Fleet(engines, tok, probe_interval_s=probe_interval_s, **kw)


def _jax_chains(trees, reqs, **kw):
    srv = jserve.ContinuousBatcher(trees[0], JCFG, **_kw(max_batch=2, **kw))
    rids = [srv.submit(*r) for r in reqs]
    done = srv.run_until_drained()
    return [done[r] for r in rids]


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.002)


def test_route_fault_degrades_to_least_queue(trees):
    fleet = _fleet(trees)
    try:
        f0 = fleet.submit_ids(_ids(), _pv(5), 4)
        fleet.result(f0, timeout=120)  # the session's pin
        tfaults.configure("fleet.route:n=1")
        f1 = fleet.submit_ids(_ids((33,)), _pv(5), 4)
        assert len(fleet.result(f1, timeout=120)) == 4
        assert fleet.n_route_faults == 1 and tfaults.stats()["fleet.route"]["fires"] == 1
        f2 = fleet.submit_ids(_ids((34,)), _pv(5), 4)  # the table is intact
        fleet.result(f2, timeout=120)
        assert fleet.replica_of(f2) == fleet.replica_of(f1)
    finally:
        fleet.shutdown()


def test_probe_fault_takes_a_replica_out_until_a_clean_probe(trees):
    fleet = _fleet(trees)
    try:
        tfaults.configure("fleet.probe:n=1")
        _wait(lambda: any(r.probe_faults >= 1 for r in fleet.replicas), "the probe fault")
        f = fleet.submit_ids(_ids(), _pv(6), 4)  # the other replica serves
        assert len(fleet.result(f, timeout=120)) == 4
        _wait(lambda: all(r.state == "ok" for r in fleet.replicas), "the clean probe")
        assert sum(r.probe_faults for r in fleet.replicas) == 1
    finally:
        fleet.shutdown()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_replica_kill_drains_reroutes_and_recovers(trees, layout):
    reqs = [(_ids((80 + i,)), _pv(400 + i), 20) for i in range(4)]
    want = _jax_chains(trees, reqs, kv_layout=layout)
    fleet = _fleet(trees, replica_restart_s=0.5, batcher_kw={"kv_layout": layout})
    try:
        tfaults.configure("serve.step:delay=0.01")  # a window for the kill
        frids = [fleet.submit_ids(*r) for r in reqs]
        _wait(lambda: any(any(r is not None for r in rep.engine.batcher.rows)
                          for rep in fleet.replicas), "a replica to decode")
        tfaults.configure("serve.step:delay=0.01;fleet.replica_kill:n=1")
        _wait(lambda: fleet.n_kills == 1, "the scripted kill")
        dead = next(r for r in fleet.replicas if r.kills == 1)
        out = [fleet.result(f, timeout=120) for f in frids]
        assert out == want
        moved = [f for f in frids if fleet._requests[f].failovers >= 1]
        assert moved and fleet.n_failovers == len(moved)
        assert all(fleet.replica_of(f) != dead.idx for f in moved)
        assert tfaults.stats()["fleet.replica_kill"]["fires"] == 1
        _wait(lambda: all(r.state == "ok" for r in fleet.replicas), "the auto-restart")
        for rep in fleet.replicas:
            b = rep.engine.batcher
            assert not b.queue and all(r is None for r in b.rows)
            if layout == "paged":
                st = b.pool_stats()
                assert st["free_blocks"] == st["usable_blocks"] - \
                    b.prefix_cache_stats().get("blocks_held", 0)
        tfaults.disable()
        f = fleet.submit_ids(_ids((99,)), _pv(500), 4)
        assert fleet.result(f, timeout=120) == _jax_chains(
            trees, [(_ids((99,)), _pv(500), 4)], kv_layout=layout)[0]
    finally:
        fleet.shutdown()


def test_a_scheduler_fault_fails_over_to_the_other_replica(trees):
    reqs = [(_ids((60,)), _pv(60), 12)]
    want = _jax_chains(trees, reqs)
    fleet = _fleet(trees)
    try:
        tfaults.configure("serve.dispatch:n=2")
        f = fleet.submit_ids(*reqs[0])
        assert fleet.result(f, timeout=120) == want[0]
        assert fleet._requests[f].failovers == 1 and fleet.n_failovers == 1
        assert fleet.n_faults == 1 and not fleet.breaker_open()
        assert fleet.status(f) == "ok" and fleet.batcher.request_stats.get(f)
    finally:
        fleet.shutdown()


def _serve(engine):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tcli.make_handler(engine, TCFG))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _request(port, method, path, obj=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if obj is None else json.dumps(obj))
    res = conn.getresponse()
    return res.status, dict(res.getheaders()), json.loads(res.read())


@pytest.fixture(scope="module")
def b64(tmp_path_factory):
    path = tmp_path_factory.mktemp("fleet") / "ev.npy"
    np.save(path, synthetic_event_stream(2, n_events=4000))
    return base64.b64encode(path.read_bytes()).decode()


def test_http_shed_429_and_fleet_routes(trees, b64):
    fleet = _fleet(trees)
    httpd, port = _serve(fleet)
    try:
        fleet._overloaded = lambda: (True, "forced by test")
        code, headers, body = _request(port, "POST", "/v1/generate",
                                       {"query": "shed me", "event_b64": b64,
                                        "slo_class": "batch"})
        assert code == 429 and "shed" in body["error"] and body["slo_class"] == "batch"
        ra = tcli.retry_after_s("batch", 1.0, 0, 1)
        assert body["retry_after_s"] == round(ra, 3) and headers["Retry-After"] == "4"
        code, _, body = _request(port, "POST", "/v1/generate",
                                 {"query": "keep me", "event_b64": b64,
                                  "slo_class": "interactive", "max_new_tokens": 4})
        assert code == 200 and body["status"] == "ok" and body["tokens"] == 4
        assert body["slo_class"] == "interactive" and "slo_met" in body
        code, _, fl = _request(port, "GET", "/fleet")
        assert code == 200 and fl["replicas"] == 2 and fl["shed"] == {"batch": 1}
        assert fl["policy"]["probe_interval_s"] == 0.01
        code, _, h = _request(port, "GET", "/health")
        assert code == 200 and h["status"] == "ok" and h["restarts"] == 0
        code, _, st = _request(port, "GET", "/stats")
        assert st["fleet"]["routable"] == 2 and st["requests"] == 1
        for rep in fleet.replicas:  # every breaker open: the probes pull both
            rep.engine._t_fault = time.monotonic()
            rep.engine._consec_faults = rep.engine.breaker_threshold
        _wait(lambda: fleet.breaker_open(), "both replicas to leave the pool")
        code, headers, body = _request(port, "GET", "/health")
        assert code == 503 and body["status"] == "degraded" and int(headers["Retry-After"]) >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        fleet.shutdown()


def test_cli_builds_a_fleet_with_a_heartbeat_each(tmp_path, b64):
    args = tcli.build_parser().parse_args([
        "--model_path", "tiny-random", "--dtype", "float32", "--device", "cpu",
        "--max_batch", "1", "--chunk", "2", "--max_len", "256", "--fleet", "2",
        "--heartbeat_dir", str(tmp_path), "--fleet_probe_interval_s", "0.01",
        "--fleet_restart_s", "0.5", "--breaker_threshold", "2", "--faults", "serve.admit:n=1",
        "--port", "0"])
    httpd, fleet = tcli.build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        assert isinstance(fleet, Fleet) and len(fleet.replicas) == 2
        assert fleet.replica_restart_s == 0.5
        assert all(r.engine.breaker_threshold == 2 for r in fleet.replicas)
        assert tfaults.enabled()
        code, _, body = _request(port, "POST", "/v1/generate",
                                 {"query": "q", "event_b64": b64, "max_new_tokens": 3})
        # The admission fault fires before the queue is touched: the request
        # stays queued and the restarted scheduler serves it where it is.
        assert code == 200 and body["tokens"] == 3
        assert tfaults.stats()["serve.admit"]["fires"] == 1
        assert fleet.n_faults == 1 and fleet.n_failovers == 0
        _wait(lambda: fleet.n_restarts == 1, "the restart")
        for i in range(2):
            _wait(lambda: Heartbeat.read(str(tmp_path / f"replica{i}")) is not None,
                  f"replica {i}'s heartbeat")
        assert _request(port, "GET", "/fleet")[2]["replicas"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        fleet.shutdown()
