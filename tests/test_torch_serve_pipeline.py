"""The port's pipelined scheduler, TTFT ramp and chunked prefill against
the JAX package (tests/test_serve.py's pipeline cases, without the
speculative ones).

For every configuration, on the dense and the paged layout, the port's
pipelined chains must equal its synchronous chains, the JAX batcher's
under the same flags and one-shot ``generate``, token for token at f32.
Sampled chains match between the pipelined and the synchronous
scheduler at one seed (they run the same segments, so they draw the same
numbers). Forced finishes that land while a segment is in flight, EOS
inside a ramp segment, the grain check of ``prefill_chunk`` and the
prefix cache's precedence over chunked prefill follow the JAX cases.
"""

import time

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve as jserve
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import serve as cli_serve
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
LAYOUTS = ["dense", "paged"]
REQS = [([1, 5, -200, 9, 9], 0, 10), ([1, -200, 7, 7, 8, 14], 1, 7), ([3, -200, 11], 2, 12)]


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


def _reqs():
    return [(ids, _pv(s), b) for ids, s, b in REQS]


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _oneshot(tp, ids, pv, budget, eos=None, quant=False):
    return tchat.generate(tp, TCFG, [ids], pv[None], max_new_tokens=budget, temperature=0.0,
                          eos_token_id=eos, kv_quant=quant, device="cpu")[0]


def _port(tp, **kw):
    kw = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None, **kw}
    return ContinuousBatcher(tp, TCFG, device="cpu", **kw)


def _chains(srv, reqs):
    rids = [srv.submit(ids, pv, b) for ids, pv, b in reqs]
    out = srv.run_until_drained()
    return [out[r] for r in rids]


_CONFIGS = {
    "greedy": dict(),
    "int8_kv": dict(kv_quant=True),
    "ttft_ramp": dict(first_chunk=2),
    "chunked_prefill": dict(prefill_chunk=8),
}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_pipelined_equals_synchronous_jax_and_oneshot(trees, name, layout):
    jp, tp = trees
    kw = dict(_CONFIGS[name], kv_layout=layout)
    piped_srv = _port(tp, **kw)
    piped = _chains(piped_srv, _reqs())
    synced = _chains(_port(tp, pipeline=False, **kw), _reqs())
    jax_srv = jserve.ContinuousBatcher(jp, JCFG, max_batch=2, max_len=256, chunk=4,
                                       eos_token_id=None, **kw)
    assert piped == synced == _chains(jax_srv, _reqs()), name
    for got, (ids, pv, budget) in zip(piped, _reqs()):
        assert got == _oneshot(tp, ids, pv, budget, quant=kw.get("kv_quant", False)), name
    assert piped_srv.pipeline and piped_srv.seg_count > 0
    if layout == "paged":
        piped_srv.reset_prefix_cache()
        assert piped_srv._pool.free_blocks() == piped_srv._pool.usable


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sampled_pipelined_equals_synchronous(trees, layout):
    """One admission wave, then rows finishing at different steps: the two
    schedulers run the same segments of the same lengths and stop at the
    same steps, so a sampled chain draws the same numbers either way."""
    _, tp = trees
    runs = []
    for pipeline in (True, False):
        srv = _port(tp, max_batch=4, kv_layout=layout, pipeline=pipeline, temperature=0.8,
                    top_p=0.9, seed=3)
        runs.append((_chains(srv, _reqs()), srv.decode_steps_run))
    assert runs[0][0] == runs[1][0]
    assert [len(c) for c in runs[0][0]] == [b for _, _, b in REQS]
    assert runs[0][0] != _chains(_port(tp, max_batch=4, kv_layout=layout, temperature=0.8,
                                       top_p=0.9, seed=4), _reqs())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_deadline_and_cancel_while_a_segment_is_in_flight(trees, layout):
    """tests/test_serve.py:601: the forced finishes drain the pipeline
    first; the doomed row keeps an exact one-shot prefix, the cancelled
    active row the tokens its segments committed, the others their full
    chains."""
    _, tp = trees
    srv = _port(tp, max_batch=3, chunk=3, kv_layout=layout)
    doomed = srv.submit([1, 5, -200, 9], _pv(0), 12, deadline_s=60.0)
    keeper = srv.submit([1, -200, 7, 7], _pv(1), 9)
    active_cancel = srv.submit([2, 6, -200, 11], _pv(3), 9)
    srv.step()
    assert srv._inflight is not None  # the first segment has not been fetched
    next(r for r in srv.rows if r is not None and r.rid == doomed).deadline = \
        time.perf_counter() - 1.0
    assert srv.cancel(active_cancel)  # drains, then frees the row
    assert srv._inflight is None
    late = srv.submit([3, -200, 11, 4], _pv(2), 6)
    queued_cancel = srv.submit([3, -200, 11], _pv(3), 6)
    assert srv.cancel(queued_cancel)
    out = srv.run_until_drained()
    assert srv.finish_status[doomed] == "deadline_exceeded"
    assert srv.finish_status[active_cancel] == "cancelled"
    want = _oneshot(tp, [1, 5, -200, 9], _pv(0), 12)
    assert out[doomed] == want[:len(out[doomed])] and 0 < len(out[doomed]) < 12
    assert out[active_cancel] == _oneshot(tp, [2, 6, -200, 11], _pv(3), 9)[:3]
    assert out[keeper] == _oneshot(tp, [1, -200, 7, 7], _pv(1), 9)
    assert out[late] == _oneshot(tp, [3, -200, 11, 4], _pv(2), 6)
    assert out[queued_cancel] == []


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ramp_with_eos_inside_the_ramp_segment(trees, layout):
    """tests/test_serve.py:499: EOS inside the short ramp segment freezes
    the row there; the row recycles for the next request."""
    jp, tp = trees
    ids, pv = [1, 5, -200, 9, 9], _pv(0)
    eos = _oneshot(tp, ids, pv, 12)[1]
    want = _oneshot(tp, ids, pv, 12, eos=eos)
    assert len(want) < 4
    srv = _port(tp, max_batch=1, chunk=8, eos_token_id=eos, first_chunk=3, kv_layout=layout)
    assert srv.first_chunk == 3
    rid, follow = srv.submit(ids, pv, 12), srv.submit(ids, pv, 12)
    out = srv.run_until_drained()
    assert out[rid] == want and out[follow] == want
    jsrv = jserve.ContinuousBatcher(jp, JCFG, max_batch=1, max_len=256, chunk=8,
                                    eos_token_id=eos, first_chunk=3, kv_layout=layout)
    assert _chains(jsrv, [(ids, pv, 12)] * 2) == [want, want]


def test_off_grain_prefill_chunk_raises(trees):
    with pytest.raises(ValueError, match="divide the prompt bucket grain"):
        _port(trees[1], max_batch=1, prefill_chunk=48)
    assert _port(trees[1], chunk=4, first_chunk=9).first_chunk == 4  # clamped to chunk


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefix_takes_precedence_over_chunked_prefill(trees, layout):
    """tests/test_serve.py:427: matching requests admit suffix-only, the
    others through the chunked machinery once rows decode."""
    jp, tp = trees
    system = [1, 5, 7, 7, 8]
    reqs = [(system + [-200, 9, 9], _pv(0), 8), ([2, 6, -200, 11], _pv(1), 8),
            (system + [-200, 3], _pv(2), 6)]
    srv = _port(tp, prefill_chunk=8, kv_layout=layout)
    srv.set_prefix(system)
    chains = _chains(srv, reqs)
    for got, (ids, pv, b) in zip(chains, reqs):
        assert got == _oneshot(tp, ids, pv, b)
    assert srv.dispatches.get("suffix", 0) + srv.dispatches.get("suffix_wave", 0) >= 1
    jsrv = jserve.ContinuousBatcher(jp, JCFG, max_batch=2, max_len=256, chunk=4,
                                    eos_token_id=None, prefill_chunk=8, kv_layout=layout)
    jsrv.set_prefix(system)
    assert _chains(jsrv, reqs) == chains


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chunked_prefill_decode_progresses_across_admission(trees, layout):
    """tests/test_serve.py:208: while a two-chunk admission is in flight the
    active row commits a segment per step."""
    _, tp = trees
    srv = _port(tp, chunk=2, prefill_chunk=8, prefix_cache=False, kv_layout=layout)
    a = srv.submit([1, 5, -200, 9], _pv(0), 12)
    srv.step()
    req_a = next(r for r in srv.rows if r is not None and r.rid == a)
    b = srv.submit([1, 5, 6, 7, -200, 9], _pv(1), 4)
    srv.step()  # drains A's segment, then B's first chunk and A's next segment
    assert srv._pending is not None and srv._pending.req.rid == b
    before = len(req_a.tokens)
    srv.step()  # B's second chunk and another segment of A
    assert len(req_a.tokens) == before + 2
    out = srv.run_until_drained()
    assert srv.dispatches["chunk"] == 2
    assert out[a] == _oneshot(tp, [1, 5, -200, 9], _pv(0), 12)
    assert out[b] == _oneshot(tp, [1, 5, 6, 7, -200, 9], _pv(1), 4)


def test_pipelined_eos_row_recycling_and_carry_uploads(trees):
    """tests/test_serve.py:583, and the carry rule: the frozen/budget state
    goes up to the device only after the host changed rows."""
    _, tp = trees
    ids, pv = [1, 5, -200, 9, 9], _pv(0)
    eos = _oneshot(tp, ids, pv, 12)[4]
    want = _oneshot(tp, ids, pv, 12, eos=eos)
    srv = _port(tp, max_batch=1, chunk=5, eos_token_id=eos)
    a, b = srv.submit(ids, pv, 12), srv.submit(ids, pv, 12)
    out = srv.run_until_drained()
    assert out[a] == want and out[b] == want and len(want) < 12
    assert srv._inflight is None
    one = _port(tp, max_batch=2, chunk=2)
    one.submit(ids, pv, 12)
    one.run_until_drained()
    assert one.seg_count >= 6 and one.carry_uploads == 1  # the admission only
    assert one.decode_steps == 12 and one.decode_steps_run <= 12 + 1


def test_overlap_counters(trees):
    """The host's harvest of segment N runs while segment N + 1 is queued:
    the pipelined run counts host time between fetches; the synchronous
    run fetches right after each dispatch."""
    _, tp = trees
    for pipeline in (True, False):
        srv = _port(tp, chunk=8, pipeline=pipeline)
        _chains(srv, _reqs())
        assert srv.seg_count >= 2 and srv.host_gap_s > 0 and srv.device_segment_s >= 0
        assert 0.0 <= srv.overlap_ratio() <= 1.0


def test_engine_fault_aborts_the_pipeline(trees):
    """A fault in the harvest of a pipelined segment fails the rows, drops
    the in-flight segment and the carry, and the engine serves on."""
    _, tp = trees
    batcher = _port(tp, kv_layout="paged")
    engine = cli_serve.ServingEngine(batcher, tokenizer=None, start=False)
    real = batcher._harvest_segment
    calls = []

    def flaky(rec):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected")
        return real(rec)

    batcher._harvest_segment = flaky
    try:
        ids, pv, budget = _reqs()[0]
        first = engine.submit_ids(ids, pv, budget)
        engine.start()
        with pytest.raises(RuntimeError, match="injected"):
            engine.result(first, timeout=60)
        assert engine.status(first) == "engine_fault" and engine.stats()["faults"] == 1
        second = engine.submit_ids(ids, pv, budget)
        assert engine.result(second, timeout=60) == _oneshot(tp, ids, pv, budget)
        with engine._lock:
            batcher.reset_prefix_cache()
            assert batcher._pool.free_blocks() == batcher._pool.usable
    finally:
        engine.shutdown()
