"""The port's ``ServingEngine`` under injected faults, against the JAX
engine (``tests/test_serve_chaos.py``'s scenarios), f32 on the CPU.

Each scenario runs on both packages' engines over the same tiny weights,
each package's fault registry armed with the same spec:
- a scheduler fault (``serve.step``, ``serve.loop``, ``serve.dispatch`` with
  a segment in flight, ``serve.prefix_copy`` on a prefix hit) fails the
  in-flight request with the fault, restarts the scheduler on a fresh
  thread, and the next requests' chains equal the JAX engine's;
- a streak of ``breaker_threshold`` faults opens the breaker: the queued
  requests fail too, ``/health`` is a 503 ``degraded`` with the remaining
  cooldown as ``Retry-After``, a POST is a 503 with it, ``submit`` raises;
  after the cooldown a clean request closes it;
- the heartbeat file is the trainer's (the JAX ``Heartbeat`` reads the
  port's);
- ``kill`` drains (a request the drain finishes is delivered, not
  exported), refuses submits and handoff imports until ``revive``.
Multi-thread legs wait on states, each with a bound.
"""

import base64
import http.client
import json
import math
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
from eventgpt_tpu.cli import serve as jcli
from eventgpt_tpu.data.tokenizer import load_tokenizer as jtok
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.train.resilience import Heartbeat as JHeartbeat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer as ttok
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.serve import ContinuousBatcher
from eventgpt_tpu_torch.train.resilience import Heartbeat

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
WAIT_S = 60.0  # the bound of every wait on a state


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


def _engine(trees, pkg, **kw):
    bkw = {"max_batch": 1, "chunk": 2, "max_len": 256, "eos_token_id": None}
    bkw.update({k: kw.pop(k) for k in ("max_queue", "max_len", "max_batch") if k in kw})
    if pkg == "torch":
        srv = ContinuousBatcher(trees[1], TCFG, device="cpu", **bkw)
        return tcli.ServingEngine(srv, ttok("byte"), **kw)
    srv = jserve.ContinuousBatcher(trees[0], JCFG, **bkw)
    return jcli.ServingEngine(srv, jtok("byte"), **kw)


def _arm(spec):
    jfaults.configure(spec)
    tfaults.configure(spec)


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.01)


def _both(trees, spec, scenario, **kw):
    """``scenario(engine)`` on each package's engine under ``spec``; the two
    results, which the caller compares."""
    out = {}
    for pkg in ("jax", "torch"):
        _arm(spec)
        eng = _engine(trees, pkg, **kw)
        try:
            out[pkg] = scenario(eng)
        finally:
            eng.shutdown()
    return out["jax"], out["torch"]


def test_transient_step_fault_restarts_and_recovers_as_jax(trees):
    def scenario(eng):
        rid = eng.submit("What is happening?", _pv(), 8)
        with pytest.raises(RuntimeError, match="InjectedFault"):
            eng.result(rid, timeout=120)
        assert eng.n_faults == 1 and not eng.breaker_open()
        rid2 = eng.submit("Again?", _pv(), 6)
        toks = eng.result(rid2, timeout=120)
        assert eng.n_restarts >= 1 and eng.fault is None  # a clean step closed it
        return toks

    j, t = _both(trees, "serve.step:n=2", scenario, breaker_threshold=3,
                 breaker_cooldown_s=0.5)
    assert t == j and len(t) == 6


def test_loop_fault_site_restarts_the_scheduler(trees):
    _arm("serve.loop:n=2")
    eng = _engine(trees, "torch", breaker_threshold=3, breaker_cooldown_s=0.5)
    try:
        _wait(lambda: eng.n_faults >= 1, "the loop fault")  # idle passes reach it
        _wait(lambda: eng.n_restarts >= 1, "the restart")
        rid = eng.submit("still alive?", _pv(), 4)
        assert len(eng.result(rid, timeout=120)) == 4
        assert tfaults.stats()["serve.loop"]["fires"] == 1
    finally:
        eng.shutdown()


def _serve(engine):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tcli.make_handler(engine, TCFG))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _request(port, method, path, obj=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if obj is None else json.dumps(obj))
    res = conn.getresponse()
    return res.status, dict(res.getheaders()), json.loads(res.read())


def _event_b64(tmp_path):
    path = tmp_path / "ev.npy"
    np.save(path, synthetic_event_stream(1, n_events=4000))
    return base64.b64encode(path.read_bytes()).decode()


@pytest.mark.parametrize("spec", ["serve.step:every=1,times=2",
                                  "serve.dispatch:every=1,times=2"])
def test_breaker_trips_degrades_health_then_half_open_closes(trees, tmp_path, spec):
    _arm(spec)
    eng = _engine(trees, "torch", breaker_threshold=2, breaker_cooldown_s=1.5)
    httpd, port = _serve(eng)
    try:
        # Two requests: each fault fails the in-flight one; the second keeps
        # the restarted scheduler dispatching into the second fault.
        rids = [eng.submit("trip?", _pv(), 6), eng.submit("trip too?", _pv(1), 6)]
        for rid in rids:
            with pytest.raises(RuntimeError, match="down|InjectedFault"):
                eng.result(rid, timeout=120)
        assert eng.breaker_open() and eng.n_faults == 2
        code, headers, body = _request(port, "GET", "/health")
        assert code == 503 and body["status"] == "degraded"
        assert "InjectedFault" in body["error"] and body["faults"] == 2
        assert 1 <= int(headers["Retry-After"]) <= math.ceil(1.5)
        assert 1.0 <= body["retry_after_s"] <= 1.5
        code, headers, body = _request(port, "POST", "/v1/generate",
                                       {"query": "refused?", "event_b64": _event_b64(tmp_path)})
        assert code == 503 and "down" in body["error"] and int(headers["Retry-After"]) >= 1
        with pytest.raises(RuntimeError, match="down"):
            eng.submit("refused?", _pv(), 4)
        assert eng.stats()["status"] == "degraded"
        _wait(lambda: not eng.breaker_open(), "the half-open breaker")
        rid = eng.submit("recovered?", _pv(), 5)  # the plan is spent
        assert len(eng.result(rid, timeout=120)) == 5
        code, _, body = _request(port, "GET", "/health")
        assert code == 200 and body["status"] == "ok" and body["restarts"] >= 1
        assert eng.stats()["faults"] == 2 and eng.fault is None
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.shutdown()


def test_a_tripping_fault_fails_the_queue_too(trees):
    """The fault that opens the breaker fails the queued requests with the
    in-flight ones (below the threshold they stay queued and survive)."""
    _arm("serve.dispatch:every=1,times=1")
    eng = _engine(trees, "torch", breaker_threshold=1, breaker_cooldown_s=0.5, start=False)
    rids = [eng.submit(f"q{i}?", _pv(i), 6) for i in range(3)]
    eng.start()
    try:
        for rid in rids:
            with pytest.raises(RuntimeError, match="down|InjectedFault"):
                eng.result(rid, timeout=120)
        assert [eng.status(r) for r in rids] == ["engine_fault"] * 3
        assert not eng.batcher.queue and all(r is None for r in eng.batcher.rows)
        _wait(lambda: not eng.breaker_open(), "the half-open breaker")
        rid = eng.submit("after?", _pv(), 4)
        assert len(eng.result(rid, timeout=120)) == 4
    finally:
        eng.shutdown()


def test_dispatch_fault_mid_pipeline_drains_and_recovers_as_jax(trees):
    # chunk 2, budget 8: step 1 dispatches segment 1; step 2 dispatches
    # segment 2, then harvests 1; step 3's dispatch (call 3) faults with
    # segment 2 in flight.
    def scenario(eng):
        rid = eng.submit("What is happening?", _pv(), 8)
        with pytest.raises(RuntimeError, match="InjectedFault"):
            eng.result(rid, timeout=120)
        assert eng.batcher._inflight is None and eng.batcher._dev_carry is None
        assert eng.n_faults == 1 and not eng.breaker_open()
        rid2 = eng.submit("Again?", _pv(3), 6)
        rid3 = eng.submit("Again?", _pv(3), 6)
        out = [eng.result(rid2, timeout=120), eng.result(rid3, timeout=120)]
        assert eng.n_restarts >= 1
        return out, (jfaults if isinstance(eng, jcli.ServingEngine) else tfaults).stats()

    (j, jst), (t, tst) = _both(trees, "serve.dispatch:n=3", scenario, breaker_threshold=3,
                               breaker_cooldown_s=0.5)
    assert t == j and t[0] == t[1] and len(t[0]) == 6
    assert tst["serve.dispatch"]["fires"] == 1 and tst["serve.dispatch"]["calls"] >= 3


def test_prefix_copy_fault_keeps_the_entry_exact_as_jax(trees):
    from eventgpt_tpu_torch.constants import DEFAULT_EV_START_TOKEN
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt

    head = prepare_event_prompt("What is happening?", "eventgpt_v1").split(
        DEFAULT_EV_START_TOKEN)[0]
    clean = _engine(trees, "torch")
    try:
        assert clean.set_prefix(head) > 0
        want = clean.result(clean.submit("What is happening?", _pv(), 6), timeout=120)
    finally:
        clean.shutdown()

    def scenario(eng):
        assert eng.set_prefix(head) > 0
        doomed = eng.submit("What is happening?", _pv(), 6)
        with pytest.raises(RuntimeError, match="InjectedFault"):
            eng.result(doomed, timeout=120)
        assert eng.batcher._inflight is None and eng.n_faults == 1
        entries = eng.batcher._prefix_cache.entries()
        assert len(entries) == 1 and entries[0].pins == 0  # the sweep drained its pin
        toks = eng.result(eng.submit("What is happening?", _pv(), 6), timeout=120)
        assert eng.batcher._prefix_cache.hits >= 1 and eng.n_restarts >= 1
        return toks

    j, t = _both(trees, "serve.prefix_copy:n=1", scenario, breaker_threshold=3,
                 breaker_cooldown_s=0.5)
    assert t == j == want
    assert tfaults.stats()["serve.prefix_copy"]["fires"] == 1


def test_serving_heartbeat_is_the_trainers(trees, tmp_path):
    eng = _engine(trees, "torch", heartbeat_dir=str(tmp_path), heartbeat_interval_s=0.05)
    try:
        eng.result(eng.submit("alive?", _pv(), 6), timeout=120)
        _wait(lambda: (Heartbeat.read(str(tmp_path)) or {}).get("step", 0) >= 1,
              "a beat after a step")
        rec = Heartbeat.read(str(tmp_path))
        assert rec["status"] == "ok" and rec["faults"] == 0 and rec["restarts"] == 0
        assert set(rec) >= {"step", "time", "active", "queued"}
        # The JAX package's reader takes the port's file, and its staleness rule.
        assert JHeartbeat.read(str(tmp_path)) == rec
        assert not JHeartbeat.is_stale(str(tmp_path), timeout_s=600)
        assert not Heartbeat.is_stale(str(tmp_path), timeout_s=600)
    finally:
        eng.shutdown()


def test_kill_delivers_a_request_the_drain_finishes_as_jax(trees):
    """The kill lands with the request's only segment in flight: the export
    drains it, which finishes the request; it is delivered, not exported."""
    def scenario(eng):
        eng._stop = True
        eng._wake.set()
        eng._thread.join(timeout=10)  # park the loop: the test steps
        rid = eng.submit_ids([1, 7, 7, -200, 9, 80], _pv(400), 2)
        eng.batcher.step()  # admit + dispatch; nothing harvested yet
        assert any(r is not None for r in eng.batcher.rows) and not eng.batcher.finished
        assert eng.kill() == []
        assert not eng.batcher.finished and not eng.alive
        got = eng.try_result(rid)
        assert eng.try_result(rid) is None  # consumed
        with pytest.raises(RuntimeError, match="down"):
            eng.submit_ids([1, -200, 5], _pv(), 2)
        eng.revive()
        assert eng.alive and not eng.breaker_open()
        return got

    j, t = _both(trees, "", scenario)
    assert t == j and t[1] == "ok" and len(t[0]) == 2


def test_kill_exports_the_rest_and_import_is_gated(trees):
    eng = _engine(trees, "torch", max_batch=1, start=False)
    try:
        rids = [eng.submit_ids([1, -200, 5 + i], _pv(i), 8) for i in range(3)]
        eng.batcher.step()
        recs = eng.kill()
        assert [r["rid"] for r in recs] == rids
        assert all(rid not in eng._done for rid in rids)  # the fleet owns them now
        assert eng.try_result(rids[0]) is None and eng.try_status(rids[0]) is None
        with pytest.raises(RuntimeError, match="down"):
            eng.import_handoff([1, -200, 5], 4, {})
        assert eng.collect_handoffs() == []  # a colocated engine's outbox is empty
        snap = eng.snapshot()
        assert snap["active_rows"] == 0 and snap["queued"] == 0
        eng.revive()
        eng.start()
        rid = eng.submit_ids(recs[1]["input_ids"], recs[1]["pixel_values"], 8)
        assert len(eng.result(rid, timeout=120)) == 8
        assert eng.try_status(rid) == "ok"
    finally:
        eng.shutdown()
