"""No decode step and no verify at a boundary whose rows are all frozen:
the port's server against the JAX ``ContinuousBatcher``, f32 on the CPU.

The JAX segments loop while ``live.any()``, so a segment whose rows are
all frozen runs zero iterations, and so does the decode half of a mixed
segment that only advances piggyback lanes. The port reads its stop flag
one launched step late, so its one step past the last live one is the
only step it may run with no live row: ``idle_steps`` / ``idle_verifies``
count those, on the device.

The traffic makes lane-only boundaries: row A finishes fast, a long late
request joins as a lane in A's row while row B decodes, then B finishes
while the lane still fills. Stepped in lockstep with the JAX server:
- chains, the host mirror, budgets, segment and lane counters (and, when
  speculative, ``ids_buf``, ``base_pos``, history, the speculation
  counters and the bucket trace) are equal after every step;
- at every boundary where the host mirror shows all rows frozen, the port
  runs no step; synchronously, wherever the JAX loop ran zero iterations
  the port's idle count does not move;
- each transition to all-frozen adds at most one idle step or verify;
- a server with no rows at all dispatches nothing.
A skipped step makes the generator draws the step would have made, so
sampled chains of the pipelined scheduler, which may still launch that
step, equal the synchronous one's on one admission wave (a later
admission lands a segment later when pipelined, in both packages). A
segment that runs all its steps leaves its last flag unread until the
next dispatch asks whether its carry is all frozen.
"""

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve as jserve
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch import serve as serve_mod
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
FIRST = [([1, 5, -200, 9, 9], 0, 3), ([1, -200, 7, 7], 1, 16)]
# 41 text positions and the event block: a lane of many 4-token advances.
LATE = [([1] + list(range(20, 60)) + [-200], 2, 5)]


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _kw(**kw):
    return {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None,
            "prefill_budget": 4, "prefill_lane_chunk": 4, **kw}


def _oneshot(tp, ids, pv, budget, quant=False):
    return tchat.generate(tp, TCFG, [ids], pv[None], max_new_tokens=budget, temperature=0.0,
                          eos_token_id=None, kv_quant=quant, device="cpu")[0]


def _assert_same_state(port, jsrv, where):
    np.testing.assert_array_equal(port.frozen, np.asarray(jsrv.frozen), err_msg=where)
    np.testing.assert_array_equal(port.n_rem, np.asarray(jsrv.n_rem), err_msg=where)
    for name in ("seg_count", "mixed_prefill_tokens", "mixed_boundaries",
                 "mixed_zero_harvests"):
        assert getattr(port, name) == getattr(jsrv, name), (where, name)
    assert port.finished == jsrv.finished, where
    assert len(port._lanes) == len(jsrv._lanes), where
    if port.speculative:
        np.testing.assert_array_equal(port.ids_buf.numpy(), np.asarray(jsrv.ids_buf),
                                      err_msg=where)
        np.testing.assert_array_equal(port.base_pos, jsrv.base_pos, err_msg=where)
        np.testing.assert_array_equal(port._history, jsrv._history, err_msg=where)
        for name in ("spec_iterations", "spec_tokens", "spec_dispatches", "spec_depth_sum",
                     "spec_masked_rows"):
            assert getattr(port, name) == getattr(jsrv, name), (where, name)
        assert list(port.spec_depth_trace) == list(jsrv.spec_depth_trace), where


def _idle(srv):
    return srv.idle_verifies if srv.speculative else srv.idle_steps


def _live_count(srv):
    """What the JAX loop's live iterations move: the verify count, or the
    tokens committed (each decode iteration commits one)."""
    if srv.speculative:
        return srv.spec_iterations
    return (sum(len(c) for c in srv.finished.values())
            + sum(len(r.tokens) for r in srv.rows if r is not None))


def run_lockstep(trees, **kw):
    port = ContinuousBatcher(trees[1], TCFG, device="cpu", **_kw(**kw))
    jsrv = jserve.ContinuousBatcher(trees[0], JCFG, **_kw(**kw))
    rids = [(port.submit(i, _pv(s), b), jsrv.submit(i, _pv(s), b)) for i, s, b in FIRST]
    steps = lane_only = transitions = 0
    was_all_frozen = True
    while port.queue or any(r is not None for r in port.rows):
        # A lane-only boundary: every row frozen, lanes still filling.
        boundary_all_frozen = (bool(port.frozen.all()) and bool(port._lanes) and not port.queue
                               and all(x.filled < x.prompt_len for x in port._lanes))
        run_before, idle_before = port.decode_steps_run, _idle(port)
        seg_before, live_before = jsrv.seg_count, _live_count(jsrv)
        port.step()
        jsrv.step()
        steps += 1
        where = f"step {steps}"
        _assert_same_state(port, jsrv, where)
        if boundary_all_frozen:
            lane_only += 1
            assert port.decode_steps_run == run_before, where
        if not port.pipeline and jsrv.seg_count == seg_before + 1 \
                and _live_count(jsrv) == live_before:
            # A synchronous segment in which the JAX loop ran no iteration.
            assert port.decode_steps_run == run_before, where
            assert _idle(port) == idle_before, where
        all_frozen = bool(port.frozen.all())
        transitions += all_frozen and not was_all_frozen
        was_all_frozen = all_frozen
        if steps == 1:
            rids += [(port.submit(i, _pv(s), b), jsrv.submit(i, _pv(s), b))
                     for i, s, b in LATE]
    port._drain()
    jsrv._drain()
    _assert_same_state(port, jsrv, "drained")
    assert lane_only >= 3, lane_only
    assert 0 < transitions and _idle(port) <= transitions, (_idle(port), transitions)
    assert port.lanes_started["full"] == 1 and port.mixed_zero_harvests == 0
    return [port.finished[r] for r, _ in rids], port


_CONFIGS = {
    "dense_pipelined": dict(),
    "paged_sync": dict(kv_layout="paged", pipeline=False),
    "paged_int8_pipelined": dict(kv_layout="paged", kv_quant=True),
    "spec_dense_sync": dict(speculative=4, chunk=8, pipeline=False),
    "spec_paged_pipelined": dict(speculative=4, chunk=8, kv_layout="paged"),
    "spec_adaptive_dense_pipelined": dict(spec_buckets="0,2,4", chunk=8),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_lane_only_boundaries_run_no_step(trees, name):
    kw = _CONFIGS[name]
    chains, port = run_lockstep(trees, prefix_cache=False, **kw)
    for chain, (ids, s, budget) in zip(chains, FIRST + LATE):
        assert chain == _oneshot(trees[1], ids, _pv(s), budget, kw.get("kv_quant", False))


def test_no_rows_dispatch_nothing(trees):
    """An idle server, and one stepped past its drain, runs no segment."""
    for kw in (dict(), dict(speculative=4, chunk=8)):
        port = ContinuousBatcher(trees[1], TCFG, device="cpu", **_kw(**kw))
        jsrv = jserve.ContinuousBatcher(trees[0], JCFG, **_kw(**kw))
        for _ in range(3):
            port.step()
            jsrv.step()
        assert port.seg_count == jsrv.seg_count == 0
        rid = port.submit(FIRST[0][0], _pv(0), 3)
        jsrv.submit(FIRST[0][0], _pv(0), 3)
        out = port.run_until_drained()
        want = jsrv.run_until_drained()
        seg = port.seg_count
        for _ in range(3):
            port.step()
            jsrv.step()
        assert port.seg_count == jsrv.seg_count == seg
        assert out[rid] == want[rid]
        assert port.decode_steps_run <= seg * port.chunk and _idle(port) <= 1


def _all_frozen_segment(trees, spec: bool, run: bool, seed: int = 3):
    """One segment of a sampled server whose rows are all frozen: the
    generator's state after it and the segment's outputs."""
    _, tp = trees
    srv = ContinuousBatcher(tp, TCFG, device="cpu", temperature=0.8, top_p=0.9, seed=seed,
                            **_kw(**(dict(speculative=4, chunk=8) if spec else {})))
    frozen = torch.ones((2,), dtype=torch.bool)
    n_rem = torch.zeros((2,), dtype=torch.int32)
    if spec:
        out = serve_mod._spec_segment(
            tp, TCFG, srv.cache, srv.generator, srv.ids_buf, n_rem.clone(), frozen, n_rem, 2, 4,
            0, 0.8, 0.9, drafts=srv.spec_drafts, run=run)
        steps, lived = out[10], int(out[2])
        outs = out[:2] + out[3:10]
    else:
        out = serve_mod._decode_segment(tp, TCFG, srv.logits, srv.cache, srv.generator, frozen,
                                        n_rem, 4, 0, 0.8, 0.9, run=run)
        steps, lived = out[8], int(out[7])
        outs = out[:7]
    assert out[-1]() is True and lived == 0  # the host knows the carry is all frozen
    return srv.generator.get_state(), steps, [o.clone() for o in outs]


@pytest.mark.parametrize("spec", [False, True], ids=["decode", "spec"])
def test_skipped_segment_draws_what_its_step_draws(trees, spec):
    """On an all-frozen carry the stop rule runs one step (or verify) that
    commits nothing; ``run=False`` runs none. Both leave the generator in
    the same state and give the same outputs, so a scheduler that skips
    the step samples on as one that still launches it."""
    state_run, steps_run, outs_run = _all_frozen_segment(trees, spec, run=True)
    state_skip, steps_skip, outs_skip = _all_frozen_segment(trees, spec, run=False)
    fresh, _, _ = _all_frozen_segment(trees, spec, run=False, seed=4)
    assert (steps_run, steps_skip) == (1, 0)
    assert torch.equal(state_run, state_skip) and not torch.equal(state_run, fresh)
    for a, b in zip(outs_run, outs_skip):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("spec", [False, True], ids=["decode", "spec"])
def test_full_segment_reads_its_last_flag_only_when_asked(trees, spec, monkeypatch):
    """A segment that runs all its steps with a live row reads the flags of
    steps 0 .. n - 2 to go on, and its ``all_frozen`` reads flag n - 1 only
    when called (the next dispatch), so the segment's end adds no wait."""
    _, tp = trees
    reads = []
    real = serve_mod._flag_read
    monkeypatch.setattr(serve_mod, "_flag_read", lambda f, i: reads.append(i) or real(f, i))
    srv = ContinuousBatcher(tp, TCFG, device="cpu", seed=3,
                            **_kw(**(dict(speculative=4, chunk=8) if spec else {})))
    frozen = torch.zeros((2,), dtype=torch.bool)
    n_rem = torch.full((2,), 64, dtype=torch.int32)
    if spec:
        out = serve_mod._spec_segment(
            tp, TCFG, srv.cache, srv.generator, srv.ids_buf, torch.ones((2,), dtype=torch.int32),
            frozen, n_rem, 2, 4, -1, drafts=srv.spec_drafts)
        n, steps = 2, out[10]
    else:
        out = serve_mod._decode_segment(tp, TCFG, srv.logits, srv.cache, srv.generator, frozen,
                                        n_rem, 4, -1)
        n, steps = 4, out[8]
    assert steps == n and reads == list(range(n - 1))
    assert out[-1]() is False and reads == list(range(n))


@pytest.mark.parametrize("kw", [dict(), dict(speculative=4, chunk=8)],
                         ids=["decode", "spec"])
def test_sampled_pipelined_equals_synchronous(trees, kw):
    """One admission wave, rows finishing at different steps: the sampled
    chains of the two schedulers are equal, and the one transition to all
    frozen runs at most one idle step (or verify) in either."""
    _, tp = trees
    reqs = FIRST + LATE
    runs = []
    for pipeline, seed in ((True, 3), (False, 3), (True, 4)):
        srv = ContinuousBatcher(tp, TCFG, device="cpu", pipeline=pipeline, temperature=0.8,
                                top_p=0.9, seed=seed, **_kw(**{**kw, "max_batch": 3}))
        rids = [srv.submit(i, _pv(s), b) for i, s, b in reqs]
        out = srv.run_until_drained()
        assert _idle(srv) <= 1
        runs.append([out[r] for r in rids])
    assert runs[0] == runs[1]
    assert [len(c) for c in runs[0]] == [b for _, _, b in reqs]
    assert runs[0] != runs[2]
