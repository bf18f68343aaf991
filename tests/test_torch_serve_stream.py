"""The engine's fair lock hand-off and streamed responses in the port's HTTP
front end (``cli/serve``), against the JAX package's, f32 on the CPU over
one tiny tree.

- The hand-off: with ``serve.step:delay`` arming a slow step while one long
  request decodes, six submits from other threads each return within two
  steps, counted and timed (the scheduler takes the lock again at once, so
  without the hand-off they waited through several steps of the request).
  Every chain of that traffic is the JAX engine's.
- Streaming: the JAX server and the port's get the same requests, and their
  NDJSON bodies are equal event for event (``delta``/``restart`` and the
  ``done`` record); the deltas concatenate to the plain request's answer;
  a streamed request leaves no engine state behind; a tokenizer whose
  decode is not prefix-stable gives the same ``restart`` events; an engine
  fault mid-stream ends both bodies with the same ``error`` record.
Every wait is bounded, and every server shuts down in a ``finally``.
"""

import base64
import http.client
import json
import tempfile
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
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer as ttok
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
WAIT_S = 60.0
STEP_DELAY_S = 0.2
N_SUBMITS = 6
PKGS = {"jax": (jcli, jtok, jfaults), "torch": (tcli, ttok, tfaults)}


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


def _batcher(trees, pkg, **kw):
    args = {"max_batch": 1, "chunk": 2, "max_len": 256, "eos_token_id": None, **kw}
    if pkg == "torch":
        return ContinuousBatcher(trees[1], TCFG, device="cpu", **args)
    return jserve.ContinuousBatcher(trees[0], JCFG, **args)


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


def _ids(suffix=()):
    return [1, 7, 7, -200, 9, 10, 11] + list(suffix)


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.005)


def test_submits_return_within_two_step_delays_while_a_request_decodes(trees):
    """A long request decodes through steps slowed by ``serve.step:delay``;
    six submits posted from other threads at once each return within two
    steps: at most two steps end while it waits, and it waits less than the
    two longest steps take (each at least the delay, more when the machine
    is loaded). The long request's committed tokens and the six chains
    equal the JAX engine's on the same traffic."""
    short = [(_ids((20 + i,)), _pv(20 + i), 4) for i in range(N_SUBMITS)]
    long_req = (_ids((1,)), _pv(1), 60)
    engine = tcli.ServingEngine(_batcher(trees, "torch"), ttok("byte"))
    steps = []  # each step's seconds, appended as it ends
    step = engine.batcher.step

    def timed_step():
        t0 = time.perf_counter()
        step()
        steps.append(time.perf_counter() - t0)

    engine.batcher.step = timed_step
    try:
        long_rid = engine.submit_ids(*long_req)
        _wait(lambda: engine.batcher.rows[0] is not None, "the long request to decode")
        tfaults.configure(f"serve.step:delay={STEP_DELAY_S}")
        time.sleep(STEP_DELAY_S / 2)  # a slowed step is under way
        took, ended, rids = {}, {}, {}

        def go(i):
            t0, n0 = time.perf_counter(), len(steps)
            rids[i] = engine.submit_ids(*short[i])
            took[i], ended[i] = time.perf_counter() - t0, len(steps) - n0

        threads = [threading.Thread(target=go, args=(i,)) for i in range(N_SUBMITS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert sorted(took) == list(range(N_SUBMITS))
        assert max(ended.values()) <= 2, (ended, took, steps)
        assert max(took.values()) < sum(sorted(steps)[-2:]), (took, steps)
        assert engine.batcher.rows[0] is not None and engine.batcher.rows[0].rid == long_rid
        tfaults.disable()
        assert engine.cancel(long_rid)
        got_long = engine.result(long_rid, timeout=WAIT_S)
        got = [engine.result(rids[i], timeout=WAIT_S) for i in range(N_SUBMITS)]
    finally:
        engine.shutdown()
    ref = jcli.ServingEngine(_batcher(trees, "jax"), jtok("byte"))
    try:
        want_long = ref.result(ref.submit_ids(*long_req), timeout=WAIT_S)
        want = [ref.result(ref.submit_ids(*r), timeout=WAIT_S) for r in short]
    finally:
        ref.shutdown()
    assert [list(map(int, c)) for c in got] == [list(map(int, c)) for c in want]
    assert 0 < len(got_long) < len(want_long)
    assert list(map(int, got_long)) == list(map(int, want_long))[:len(got_long)]


def test_the_hand_off_under_a_short_switch_interval_loses_no_waiter(trees):
    """More submitting threads than cores, with the interpreter switching
    threads every 10 us: every submit gets a distinct rid and its answer,
    every announced acquisition is counted once, and no announcement is
    left over (a lost update of the counter would strand the loop's wait or
    a caller)."""
    import os
    import sys

    n_threads, per_thread = 2 * (os.cpu_count() or 4), 2
    engine = tcli.ServingEngine(_batcher(trees, "torch"), ttok("byte"))
    interval = sys.getswitchinterval()
    rids, errs = [], []

    def go(i):
        try:
            for k in range(per_thread):
                rids.append(engine.submit_ids(_ids((i, k)), _pv(0), 1))
        except Exception as e:  # re-raised below, in the test's thread
            errs.append(e)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=go, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not errs and not any(t.is_alive() for t in threads)
        got = [engine.result(r, timeout=WAIT_S) for r in rids]
    finally:
        sys.setswitchinterval(interval)
        engine.shutdown()
    n = n_threads * per_thread
    assert len(set(rids)) == n and all(len(g) == 1 for g in got)
    # Each submit and each result announced itself once.
    assert engine._lock_waits["n"] == 2 * n and engine._waiting == 0


class _RewritingTokenizer:
    """A tokenizer whose decode is not prefix-stable: past 6 tokens it
    upper-cases the text (as sentencepiece re-merges earlier text)."""

    def __init__(self, base):
        self._base = base
        self.eos_token_id = getattr(base, "eos_token_id", None)

    def __getattr__(self, name):
        return getattr(self._base, name)

    def __call__(self, *a, **kw):
        return self._base(*a, **kw)

    def batch_decode(self, seqs, **kw):
        out = self._base.batch_decode(seqs, **kw)
        return [t.upper() if len(seqs[0]) > 6 else t for t in out]


def _servers(trees, rewrite=False):
    """{package: (port, engine, httpd)} of one tiny server each."""
    out = {}
    for pkg, (cli, tok, _) in PKGS.items():
        tokenizer = _RewritingTokenizer(tok("byte")) if rewrite else tok("byte")
        engine = cli.ServingEngine(_batcher(trees, pkg), tokenizer)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), cli.make_handler(
            engine, JCFG if pkg == "jax" else TCFG, default_budget=8))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        out[pkg] = (httpd.server_address[1], engine, httpd)
    return out


def _stop(servers):
    for _, engine, httpd in servers.values():
        httpd.shutdown()
        engine.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def b64():
    with tempfile.NamedTemporaryFile(suffix=".npy") as f:
        np.save(f, synthetic_event_stream(5, n_events=20_000))
        f.flush()
        with open(f.name, "rb") as g:
            return base64.b64encode(g.read()).decode()


@pytest.fixture(scope="module")
def servers(trees):
    s = _servers(trees)
    yield s
    _stop(s)


def _post(port, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    conn.request("POST", "/v1/generate", body=json.dumps(obj))
    res = conn.getresponse()
    body = res.read()
    if res.getheader("Content-Type") == "application/x-ndjson":
        return res.status, [json.loads(line) for line in body.splitlines()]
    return res.status, json.loads(body)


def _both(servers, obj):
    return {pkg: _post(port, obj) for pkg, (port, _, _) in servers.items()}


def _apply(events):
    """The text a client builds from the deltas and restarts."""
    text = ""
    for ev in events:
        if "delta" in ev:
            text += ev["delta"]
        elif "restart" in ev:
            text = ev["restart"]
    return text


def test_stream_concatenates_to_nonstream_answer(servers, b64):
    req = {"query": "What moves?", "event_b64": b64, "max_new_tokens": 8}
    plain = _both(servers, req)
    streamed = _both(servers, {**req, "stream": True})
    assert streamed["torch"] == streamed["jax"]
    code, events = streamed["torch"]
    assert code == 200 and plain["torch"][0] == 200
    assert plain["torch"][1]["answer"] == plain["jax"][1]["answer"]
    final = events[-1]
    assert final["done"] and final["status"] == "ok" and all(not e.get("done")
                                                             for e in events[:-1])
    assert _apply(events).strip() == final["answer"] == plain["torch"][1]["answer"]


def test_streaming_state_is_released(servers, b64):
    """After a plain and a streamed request finish, no engine map holds
    either (a streamed request never calls ``result``)."""
    req = {"query": "x?", "event_b64": b64, "max_new_tokens": 4}
    _both(servers, req)
    got = _both(servers, {**req, "stream": True})
    assert got["torch"] == got["jax"]
    for _, engine, _ in servers.values():
        assert engine._streams == {} and engine._sent == {}
        assert engine._answers == {} and engine._done == {}


def test_stream_restart_event_on_detokenizer_rewrite(trees, b64):
    servers = _servers(trees, rewrite=True)
    try:
        got = _both(servers, {"query": "What moves?", "event_b64": b64, "max_new_tokens": 8,
                              "stream": True})
    finally:
        _stop(servers)
    assert got["torch"] == got["jax"]
    events = got["torch"][1]
    assert any("restart" in e for e in events)
    assert _apply(events).strip() == events[-1]["answer"]
    assert events[-1]["answer"] == events[-1]["answer"].upper()


def test_engine_fault_mid_stream_ends_the_body_with_error(servers, b64):
    """The third step raises: the streamed request's rows are failed, its
    queue gets the fault sentinel, and each body ends with a ``done``
    record carrying the error; the restarted scheduler serves on."""
    for _, (_, _, faults) in PKGS.items():
        faults.configure("serve.step:n=3")
    req = {"query": "What moves?", "event_b64": b64, "max_new_tokens": 16}
    got = _both(servers, {**req, "stream": True})
    for _, (_, _, faults) in PKGS.items():
        faults.disable()
    assert got["torch"] == got["jax"]
    code, events = got["torch"]
    assert code == 200 and events[-1]["done"] and "InjectedFault" in events[-1]["error"]
    assert "status" not in events[-1]
    after = _both(servers, {**req, "max_new_tokens": 4})
    assert after["torch"][0] == after["jax"][0] == 200
    assert after["torch"][1]["answer"] == after["jax"][1]["answer"]
