"""The PyTorch port's continuous-batching server and its HTTP front end,
against the JAX package.

Greedy chains at f32 must equal the JAX ``ContinuousBatcher``'s token for
token (run with the prefix cache, lanes and pipelining off, which the port
does not have; the JAX package holds its chains the same with them on),
for the dense and the paged layout, each with the f32 and the int8 cache.
Requests are tests/test_paged_blocks.py::_reqs: three through two rows.
"""

import base64
import http.client
import io
import json
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.serve import ContinuousBatcher as JaxBatcher
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer
from eventgpt_tpu_torch.cli import serve as cli_serve
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.serve import ContinuousBatcher, QueueFullError

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
CASES = [("dense", False), ("dense", True), ("paged", False), ("paged", True)]
CASE_IDS = ["dense-f32", "dense-int8", "paged-f32", "paged-int8"]


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


def _reqs():
    return [([1, 5, -200, 9, 9], _pv(0), 8),
            ([1, -200, 7, 7, 8, 14], _pv(1), 7),
            ([3, -200, 11], _pv(2), 9)]


@pytest.fixture(scope="module")
def setup():
    """The JAX chains of every case, and the JAX block tables after the
    first admission wave (one step), computed once."""
    jp = jax.tree_util.tree_map(np.asarray, jchat.init_eventchat_params(JCFG,
                                                                        jax.random.PRNGKey(5)))
    tp = params_from_jax(jp, TCFG, torch.float32, "cpu")
    want = {}
    for layout, quant in CASES:
        srv = JaxBatcher(jp, JCFG, max_batch=2, max_len=256, chunk=4, eos_token_id=None,
                         kv_quant=quant, kv_layout=layout, prefix_cache=False, pipeline=False,
                         prefill_budget=0)
        rids = [srv.submit(ids, pv, b) for ids, pv, b in _reqs()]
        srv.step()
        bt = np.asarray(srv.cache["bt"]) if layout == "paged" else None
        out = srv.run_until_drained()
        want[layout, quant] = ([out[r] for r in rids], bt)
    return tp, want


def _serve(tp, reqs, **kw):
    srv = ContinuousBatcher(tp, TCFG, max_batch=2, max_len=256, chunk=4, eos_token_id=None,
                            device="cpu", **kw)
    rids = [srv.submit(ids, pv, b) for ids, pv, b in reqs]
    return srv, rids


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_server_chains_equal_the_jax_server(setup, layout, quant):
    tp, want = setup
    srv, rids = _serve(tp, _reqs(), kv_layout=layout, kv_quant=quant)
    srv.step()
    if layout == "paged":
        np.testing.assert_array_equal(srv.cache["bt"].numpy(), want[layout, quant][1])
    out = srv.run_until_drained()
    chains = [out[r] for r in rids]
    assert chains == want[layout, quant][0]
    assert [len(c) for c in chains] == [b for _, _, b in _reqs()]
    if layout == "paged":
        st = srv.pool_stats()
        assert st["free_blocks"] == st["usable_blocks"] and st["allocs"] == st["frees"] > 0
        assert int(srv.cache["bt"].abs().sum()) == 0  # every table back at scratch


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_equals_dense_and_oneshot_generate(setup, quant):
    tp, _ = setup
    chains = {}
    for layout in ("dense", "paged"):
        srv, rids = _serve(tp, _reqs(), kv_layout=layout, kv_quant=quant)
        out = srv.run_until_drained()
        chains[layout] = [out[r] for r in rids]
    assert chains["paged"] == chains["dense"]
    ids, pv, budget = _reqs()[0]
    oneshot = tchat.generate(tp, TCFG, [ids], pv[None], max_new_tokens=budget, temperature=0.0,
                             eos_token_id=None, kv_quant=quant, device="cpu")[0]
    assert chains["paged"][0] == oneshot


def test_eos_stops_a_row_early_and_the_row_is_reused(setup):
    """tests/test_serve.py::test_eos_stops_row_early through one row: the
    first request stops at an EOS taken from its own chain, and the second
    decodes in the row it freed."""
    tp, _ = setup
    (ids0, pv0, _), (ids1, pv1, _) = _reqs()[:2]

    def oneshot(ids, pv, eos):
        return tchat.generate(tp, TCFG, [ids], pv[None], max_new_tokens=12, temperature=0.0,
                              eos_token_id=eos, device="cpu")[0]

    eos = oneshot(ids0, pv0, None)[5]
    srv = ContinuousBatcher(tp, TCFG, max_batch=1, max_len=256, chunk=5, eos_token_id=eos,
                            kv_layout="paged", device="cpu")
    rids = [srv.submit(ids0, pv0, 12), srv.submit(ids1, pv1, 12)]
    out = srv.run_until_drained()
    assert out[rids[0]] == oneshot(ids0, pv0, eos) and len(out[rids[0]]) < 12
    assert out[rids[1]] == oneshot(ids1, pv1, eos)
    assert srv.finish_status[rids[0]] == "ok"


def test_small_pool_defers_admission_and_frees_every_block(setup):
    """A pool of 4 blocks holds one reservation at a time: admission waits
    for blocks (tests/test_paged_blocks.py::
    test_paged_pool_pressure_defers_then_completes), the chains stay."""
    tp, want = setup
    srv, rids = _serve(tp, _reqs(), kv_layout="paged", kv_pool_blocks=4)
    out = srv.run_until_drained()
    assert [out[r] for r in rids] == want["dense", False][0]
    assert srv.block_deferrals > 0
    assert srv._pool.free_blocks() == srv._pool.usable


def test_submit_refuses_what_cannot_fit(setup):
    tp, _ = setup
    srv = ContinuousBatcher(tp, TCFG, max_batch=2, max_len=256, chunk=4, kv_layout="paged",
                            kv_pool_blocks=4, max_queue=1, device="cpu")
    for ids in ([1, 5, 9], [1, -200, 5, -200]):
        with pytest.raises(ValueError, match="exactly one"):
            srv.submit(ids, _pv(0), 4)
    with pytest.raises(ValueError, match="exceeds server max_len"):
        srv.submit([1, -200, 5], _pv(0), 4096)
    # Fits max_len (111 + 100 + 1 <= 256) but needs 4 blocks of a
    # 3-block pool: refused now, never queued to wait forever.
    with pytest.raises(ValueError, match="KV blocks"):
        srv.submit([1, -200] + [7] * 100, _pv(0), 100)
    srv.submit([1, -200, 5], _pv(0), 4)
    with pytest.raises(QueueFullError):
        srv.submit([1, -200, 5], _pv(0), 4)
    assert ContinuousBatcher(tp, TCFG, max_batch=1, max_len=200, device="cpu").max_len == 256


def test_cancel_and_deadline_keep_the_other_chains(setup):
    """tests/test_serve.py::test_deadline_and_cancel_preserve_batch_exactness:
    a deadline and a cancel free rows mid-flight with the tokens they
    committed, and the other rows' chains do not change."""
    import time

    tp, want = setup
    reqs = _reqs()
    srv = ContinuousBatcher(tp, TCFG, max_batch=2, max_len=256, chunk=4, eos_token_id=None,
                            kv_layout="paged", device="cpu")
    doomed = srv.submit(*reqs[0], deadline_s=60.0)
    cancelled, late = srv.submit(*reqs[1]), srv.submit(*reqs[2])
    srv.step()  # both rows admitted, one 4-token segment
    next(r for r in srv.rows if r is not None and r.rid == doomed).deadline = \
        time.perf_counter() - 1.0
    assert srv.cancel(cancelled)
    queued_cancel = srv.submit(*reqs[2])
    assert srv.cancel(queued_cancel) and not srv.cancel(queued_cancel)
    out = srv.run_until_drained()
    full = want["paged", False][0]
    assert srv.finish_status[doomed] == "deadline_exceeded"
    assert srv.finish_status[cancelled] == "cancelled"
    assert out[doomed] == full[0][:len(out[doomed])] and 0 < len(out[doomed]) < 8
    assert out[cancelled] == full[1][:len(out[cancelled])] and len(out[cancelled]) == 4
    assert out[late] == full[2]
    assert out[queued_cancel] == []
    assert srv._pool.free_blocks() == srv._pool.usable


@pytest.mark.parametrize("kw", [
    dict(speculative=2), dict(prefix_cache=True), dict(pipeline=True),
    dict(prefill_budget=8), dict(prefill_chunk=64), dict(preempt=True),
], ids=lambda kw: next(iter(kw)))
def test_unported_server_features_raise(setup, kw):
    tp, _ = setup
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousBatcher(tp, TCFG, device="cpu", **kw)


def test_engine_fault_fails_the_rows_and_serves_on(setup):
    """A scheduler fault fails the in-flight requests (their blocks return
    to the pool) and the engine serves the next request."""
    tp, want = setup
    batcher = ContinuousBatcher(tp, TCFG, max_batch=2, max_len=256, chunk=4, eos_token_id=None,
                                kv_layout="paged", device="cpu")
    engine = cli_serve.ServingEngine(batcher, tokenizer=None, start=False)
    real = batcher._dispatch_segment
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real()

    batcher._dispatch_segment = flaky
    try:
        ids, pv, budget = _reqs()[0]
        first = engine.submit_ids(ids, pv, budget)
        engine.start()
        with pytest.raises(RuntimeError, match="injected"):
            engine.result(first, timeout=60)
        assert engine.status(first) == "engine_fault" and engine.stats()["faults"] == 1
        second = engine.submit_ids(ids, pv, budget)
        assert engine.result(second, timeout=60) == want["paged", False][0][0]
        assert batcher._pool.free_blocks() == batcher._pool.usable
    finally:
        engine.shutdown()


# -- the HTTP front end ------------------------------------------------------

FLAGS = ["--model_path", "tiny-random", "--device", "cpu", "--dtype", "float32",
         "--kv_layout", "paged", "--kv_cache", "int8", "--max_batch", "2", "--chunk", "4"]


@pytest.fixture(scope="module")
def server():
    args = cli_serve.build_parser().parse_args(FLAGS + ["--port", "0", "--max_body_mb", "1"])
    httpd, engine = cli_serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1], engine
    httpd.shutdown()
    engine.shutdown()
    httpd.server_close()


def _post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=json.dumps(obj))
    res = conn.getresponse()
    return res.status, json.loads(res.read())


def test_http_generate_answers_as_the_infer_cli(server, tmp_path):
    port, engine = server
    stream = synthetic_event_stream(7, n_events=20_000)
    buf = io.BytesIO()
    np.save(buf, stream)
    query = "What is happening?"
    code, obj = _post(port, "/v1/generate", {
        "query": query, "max_new_tokens": 6,
        "event_b64": base64.b64encode(buf.getvalue()).decode()})
    assert code == 200 and obj["status"] == "ok" and obj["tokens"] == 6
    path = str(tmp_path / "events.npy")
    np.save(path, stream)
    want = infer.main(["--model_path", "tiny-random", "--device", "cpu", "--dtype", "float32",
                       "--kv_cache", "int8", "--temperature", "0", "--max_new_tokens", "6",
                       "--event_frame", path, "--query", query])
    assert obj["answer"] == want
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/health")
    res = conn.getresponse()
    assert res.status == 200 and json.loads(res.read())["status"] == "ok"
    conn.request("GET", "/stats")
    stats = json.loads(conn.getresponse().read())
    assert stats["kv_layout"] == "paged" and stats["kv_quant"] is True
    assert stats["kv_blocks"]["free_blocks"] == stats["kv_blocks"]["usable_blocks"]


def test_http_refuses_bad_requests(server):
    port, _ = server
    assert _post(port, "/v1/generate", {"max_new_tokens": 4})[0] == 400     # no query
    assert _post(port, "/v1/generate", {"query": "q"})[0] == 400           # no stream
    assert _post(port, "/v1/generate", {"query": "q", "event_path": "x.npy"})[0] == 400
    assert _post(port, "/v1/generate", {"query": "q", "stream": True,
                                        "event_b64": ""})[0] == 400
    assert _post(port, "/nope", {})[0] == 404
    assert _post(port, "/cancel", {"rid": 12345}) == (200, {"rid": 12345, "cancelled": False})
    # A body over --max_body_mb is refused before it is read, and so is
    # a request with no Content-Length.
    for head, code in ((b"Content-Length: 4194304\r\n", b"413"), (b"", b"400")):
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n" + head + b"\r\n")
            assert s.recv(64).startswith(b"HTTP/1.1 " + code)


@pytest.mark.parametrize("extra", [["--speculative", "2"], ["--prefill_budget", "-1"],
                                   ["--mesh_model", "2"], ["--warmup"]],
                         ids=lambda x: x[0])
def test_cli_refuses_unported_flags(extra):
    args = cli_serve.build_parser().parse_args(FLAGS + ["--port", "0"] + extra)
    with pytest.raises(NotImplementedError, match="not ported"):
        cli_serve.build_engine(args)


def test_cli_accepts_the_off_switches_it_already_has():
    args = cli_serve.build_parser().parse_args(
        FLAGS + ["--no_prefix_cache", "--no_pipeline", "--no_telemetry"])
    cli_serve._refuse_unported(args)


def test_cli_wants_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    args = cli_serve.build_parser().parse_args(["--model_path", "tiny-random"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.build_engine(args)
