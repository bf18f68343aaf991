"""The port's speculative server (fixed-K suffix lookup) against the JAX
package (tests/test_serve.py's speculative cases, tests/test_mixed_segments.py
and tests/test_prefix_cache.py's speculative ones).

For every configuration the port's chains must equal the JAX
``ContinuousBatcher(speculative=...)``'s and one-shot ``generate``, token
for token at f32, and the two servers, stepped together, must hold the
same ``ids_buf``, host ``base_pos``, lookup ``history`` and speculation
counters after every step (the same drafts, so the same acceptance). The
traffic: two requests admitted together, one finishing fast, then two
late arrivals into the freed row, which repeat the first's text head and
stream (prefix hits, suffix admission or suffix lanes). Sampled chains
match between the pipelined and the synchronous scheduler at one seed.
The ``cli/serve`` flags answer as the JAX CLI does on one checkpoint.
"""

import base64
import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve as jserve
from eventgpt_tpu.cli import infer as jinfer
from eventgpt_tpu.models import convert as jconv
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import serve as cli_serve
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import medusa as tmedusa
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
FIRST = [([1, 5, -200, 9, 9], 0, 10), ([1, -200, 7, 7], 1, 4)]
LATE = [([1, 5, -200, 3], 0, 8), ([3, -200, 11], 2, 7)]


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _oneshot(tp, ids, pv, budget, eos=None, quant=False):
    return tchat.generate(tp, TCFG, [ids], pv[None], max_new_tokens=budget, temperature=0.0,
                          eos_token_id=eos, kv_quant=quant, device="cpu")[0]


def _pair(trees, **kw):
    kw = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None, **kw}
    return (ContinuousBatcher(trees[1], TCFG, device="cpu", **kw),
            jserve.ContinuousBatcher(trees[0], JCFG, **kw))


_COUNTERS = ("spec_iterations", "spec_tokens", "spec_dispatches", "spec_depth_sum",
             "spec_masked_rows")


def assert_same_state(port, jax_srv, where):
    """ids_buf, base_pos, history and the speculation counters equal."""
    np.testing.assert_array_equal(port.ids_buf.numpy(), np.asarray(jax_srv.ids_buf),
                                  err_msg=where)
    np.testing.assert_array_equal(port.base_pos, jax_srv.base_pos, err_msg=where)
    np.testing.assert_array_equal(port._history, jax_srv._history, err_msg=where)
    for name in _COUNTERS:
        assert getattr(port, name) == getattr(jax_srv, name), (where, name)
    assert list(port.spec_depth_trace) == list(jax_srv.spec_depth_trace), where


def run_lockstep(port, jax_srv, first=FIRST, late=LATE, late_after: int = 2):
    """Submit ``first``, step both servers ``late_after`` times, submit
    ``late``, then step both to the drain, holding their state equal
    after every step. Returns the chains in request order."""
    rids = [(port.submit(i, _pv(s), b), jax_srv.submit(i, _pv(s), b)) for i, s, b in first]
    steps = 0
    while port.queue or any(r is not None for r in port.rows):
        port.step()
        jax_srv.step()
        steps += 1
        assert_same_state(port, jax_srv, f"step {steps}")
        if steps == late_after:
            rids += [(port.submit(i, _pv(s), b), jax_srv.submit(i, _pv(s), b))
                     for i, s, b in late]
    assert not (jax_srv.queue or any(r is not None for r in jax_srv.rows))
    port._drain()
    jax_srv._drain()
    assert_same_state(port, jax_srv, "drained")
    got = [port.finished[r] for r, _ in rids]
    want = [jax_srv.finished[r] for _, r in rids]
    assert got == want
    return got


# name -> batcher flags. Chunked prefill engages only without lanes;
# the lanes cases admit the late requests as suffix lanes (prefix hits).
_CONFIGS = {
    "dense_w4": dict(speculative=4),
    "dense_w2_sync": dict(speculative=2, pipeline=False),
    "dense_int8": dict(speculative=4, kv_quant=True),
    "paged_w4": dict(speculative=4, kv_layout="paged"),
    "paged_int8_sync": dict(speculative=4, kv_layout="paged", kv_quant=True, pipeline=False),
    "lanes_dense": dict(speculative=4, prefill_budget=8, prefill_lane_chunk=4),
    "lanes_paged_int8": dict(speculative=4, kv_layout="paged", kv_quant=True,
                             prefill_budget=8, prefill_lane_chunk=4),
    "lanes_sync_no_cache": dict(speculative=2, pipeline=False, prefix_cache=False,
                                prefill_budget=8, prefill_lane_chunk=4),
    "chunked_prefill_no_cache": dict(speculative=4, prefill_chunk=8, prefix_cache=False),
    "chunked_prefill_paged_int8": dict(speculative=4, prefill_chunk=8, kv_layout="paged",
                                       kv_quant=True, prefix_cache=False),
    "no_prefix_cache_paged": dict(speculative=4, kv_layout="paged", prefix_cache=False),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_spec_server_equals_jax_and_oneshot(trees, name):
    kw = _CONFIGS[name]
    port, jax_srv = _pair(trees, **kw)
    got = run_lockstep(port, jax_srv)
    quant = kw.get("kv_quant", False)
    for chain, (ids, s, budget) in zip(got, FIRST + LATE):
        assert chain == _oneshot(trees[1], ids, _pv(s), budget, quant=quant), name
    assert port.spec_iterations > 0 and port.first_chunk == 0
    if kw.get("prefill_budget"):
        assert port.mixed_segments > 0 and port.mixed_zero_harvests == 0
        if kw.get("prefix_cache", True):
            assert port.lanes_started["suffix"] > 0
    if kw.get("prefill_chunk"):
        assert port.dispatches.get("chunk", 0) > 0
    if kw.get("prefix_cache", True) and not kw.get("prefill_budget"):
        assert port.dispatches.get("suffix", 0) + port.dispatches.get("suffix_wave", 0) > 0
    if kw.get("kv_layout") == "paged":
        port.reset_prefix_cache()
        assert port._pool.free_blocks() == port._pool.usable


def test_eos_and_row_reuse(trees):
    """tests/test_serve.py::test_speculative_server_eos_and_reuse: EOS
    inside a verify window finishes the row there; the queued twin reuses
    the row and commits the same chain."""
    jp, tp = trees
    ids, pv = [1, 5, -200, 9, 9], _pv(0)
    full = _oneshot(tp, ids, pv, 12)
    eos = full[4]
    want = _oneshot(tp, ids, pv, 12, eos=eos)
    for pipeline in (True, False):
        port, jax_srv = _pair(trees, max_batch=1, eos_token_id=eos, speculative=4,
                              pipeline=pipeline)
        got = run_lockstep(port, jax_srv, first=[(ids, 0, 12), (ids, 0, 12)], late=[])
        assert got == [want, want] and len(want) < 12


def test_zero_budget_returns_zero_tokens(trees):
    _, tp = trees
    ids, pv = [1, 5, -200, 9], _pv(0)
    srv = ContinuousBatcher(tp, TCFG, max_batch=1, max_len=256, chunk=4, eos_token_id=None,
                            speculative=4, device="cpu")
    rid = srv.submit(ids, pv, 0)
    follow = srv.submit(ids, pv, 3)  # the row must recycle cleanly after
    out = srv.run_until_drained()
    assert out[rid] == [] and srv.finish_status[rid] == "ok"
    assert out[follow] == _oneshot(tp, ids, pv, 3)


def test_ramp_is_dropped_under_speculation(trees):
    _, tp = trees
    ids, pv, budget = [1, 5, -200, 9, 9], _pv(3), 10
    for kw in (dict(speculative=4), dict(spec_buckets="0,2")):
        srv = ContinuousBatcher(tp, TCFG, max_batch=2, max_len=256, chunk=8, eos_token_id=None,
                                first_chunk=4, device="cpu", **kw)
        assert srv.first_chunk == 0
        rid = srv.submit(ids, pv, budget)
        assert srv.run_until_drained()[rid] == _oneshot(tp, ids, pv, budget)


def test_zeros_model_repetitive_chain(trees):
    """tests/test_serve.py::test_speculative_server_acceptance_on_repetitive_chain:
    a constant chain drafts perfectly, and the tokens per iteration are
    the JAX server's."""
    jp = jax.tree_util.tree_map(np.zeros_like, trees[0])
    tp = params_from_jax(jp, TCFG, torch.float32, "cpu")
    port, jax_srv = _pair((jp, tp), max_batch=1, chunk=16, speculative=4)
    got = run_lockstep(port, jax_srv, first=[([1, 5, -200, 9], 0, 16)], late=[])
    assert got == [[0] * 16]
    assert port.spec_tokens_per_iteration() == jax_srv.spec_tokens_per_iteration() > 2.0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_submit_refuses_what_jax_refuses(trees, layout):
    """The ``1 + spec_max`` slack: a verify window writes past the last
    commit, so the request must leave it inside max_len (and inside the
    pool's blocks)."""
    ids = [1, 5, -200, 9]  # 3 text tokens + 10 event tokens = 13 positions
    for kw in (dict(speculative=4), dict(spec_buckets="0,2,8")):
        port, jax_srv = _pair(trees, kv_layout=layout, max_len=128, **kw)
        for budget in range(96, 120):
            outcome = []
            for srv in (port, jax_srv):
                try:
                    srv.submit(ids, _pv(0), budget)
                    outcome.append("ok")
                except ValueError:
                    outcome.append("refused")
            assert outcome[0] == outcome[1], (kw, budget)
        slack = 1 + port.spec_max
        assert port.queue[-1].max_new_tokens == 128 - 13 - slack


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_pipelined_equals_synchronous(trees, layout):
    """One admission wave: the two schedulers run the same iterations (one
    stop rule) while rows are live and so draw the same numbers. Sampled
    chains and the live-iteration count match at one seed, the requested
    lengths hold, and another seed draws another chain."""
    _, tp = trees
    reqs = [(ids, _pv(s), b) for ids, s, b in FIRST + LATE]
    runs = []
    for pipeline, seed in ((True, 3), (False, 3), (True, 4)):
        srv = ContinuousBatcher(tp, TCFG, max_batch=4, max_len=256, chunk=4, eos_token_id=None,
                                speculative=4, kv_layout=layout, pipeline=pipeline,
                                temperature=0.8, top_p=0.9, seed=seed, device="cpu")
        rids = [srv.submit(*r) for r in reqs]
        out = srv.run_until_drained()
        runs.append(([out[r] for r in rids], srv.spec_iterations))
    assert runs[0] == runs[1]
    assert [len(c) for c in runs[0][0]] == [b for _, _, b in reqs]
    assert runs[0][0] != runs[2][0]


# -- cli/serve ---------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, trees):
    """The tiny tree as a checkpoint both packages load, a stream, and a
    3-head Medusa stack."""
    root = tmp_path_factory.mktemp("spec_ckpt")
    d = str(root / "ckpt")
    jconv.write_hf_checkpoint(trees[0], JCFG, d, num_shards=1)
    ev = str(root / "events.npy")
    np.save(ev, synthetic_event_stream(11, n_events=20_000))
    heads = str(root / "heads.npz")
    d_model = TCFG.llama.hidden_size
    tmedusa.save_medusa(heads, {"w": torch.randn((3, d_model, d_model),
                                                 generator=torch.Generator().manual_seed(2))
                                * 0.5})
    return d, ev, heads


_CLI_CASES = {
    "lookup": ["--speculative", "4"],
    "adaptive": ["--spec_buckets", "0,2,4"],
    "medusa": ["--speculative", "4", "--draft_head", "HEADS"],
}


@pytest.mark.parametrize("case", sorted(_CLI_CASES))
def test_cli_serve_answers_as_the_jax_cli(checkpoint, case, capsys):
    d, ev, heads = checkpoint
    query = "What is happening?"
    want = jinfer.main(["--model_path", d, "--tokenizer_path", "byte", "--event_frame", ev,
                        "--query", query, "--temperature", "0", "--max_new_tokens", "8",
                        "--dtype", "float32"])
    flags = [heads if f == "HEADS" else f for f in _CLI_CASES[case]]
    args = cli_serve.build_parser().parse_args(
        ["--model_path", d, "--tokenizer_path", "byte", "--device", "cpu", "--dtype", "float32",
         "--max_batch", "2", "--chunk", "4", "--max_len", "256", "--port", "0", "--warmup",
         *flags])
    httpd, engine = cli_serve.build_server(args)
    printed = capsys.readouterr().out
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.save(buf, np.load(ev))
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request("POST", "/v1/generate", body=json.dumps({
            "query": query, "max_new_tokens": 8,
            "event_b64": base64.b64encode(buf.getvalue()).decode()}))
        res = conn.getresponse()
        obj = json.loads(res.read())
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
    finally:
        httpd.shutdown()
        engine.shutdown()
        httpd.server_close()
    assert res.status == 200 and obj["status"] == "ok"
    assert want and obj["answer"] == want
    b = engine.batcher
    assert stats["speculative"] == b.speculative == 4
    assert stats["spec"]["dispatches"] > 0 and stats["spec"] == json.loads(
        json.dumps(b.spec_stats()))
    assert ("adaptive" in stats["spec"]) == (case == "adaptive")
    assert (b.draft_head is not None) == (case == "medusa")
    # --warmup printed its count before the server listened: one prefill
    # and admission per bucket (128, 256), the encoder, a segment per
    # window and a mixed segment per window (lanes are on by default).
    n_windows = 3 if case == "adaptive" else 1
    assert f"[serve] warmup: {1 + 2 * 2 + 2 * n_windows} functions in " in printed
