"""The port's piggyback prefill lanes (mixed prefill + decode segments)
against the JAX package (tests/test_mixed_segments.py, without the
speculative, fault-injection and sharded cases).

The traffic that exercises lanes: request A decodes for the whole window,
B finishes fast, then C (a session-0 repeat: a prefix hit, so a SUFFIX
lane seeded from the entry) and D (a fresh head: a FULL lane) arrive
while A decodes. For every configuration, on the dense and the paged
layout, the port's mixed chains must equal the JAX batcher's under the
same flags, the port's exclusive-admission chains (``prefill_budget=0``)
and one-shot ``generate``; the lanes must have run, and no boundary that
advanced a lane beside live rows may leave those rows without a token.
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
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
LAYOUTS = ["dense", "paged"]


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _oneshot(tp, ids, pv, budget, quant=False):
    return tchat.generate(tp, TCFG, [ids], pv[None], max_new_tokens=budget, temperature=0.0,
                          eos_token_id=None, kv_quant=quant, device="cpu")[0]


def _batcher(trees, jax_side, **kw):
    kw = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None,
          "prefill_lane_chunk": 4, **kw}
    if jax_side:
        return jserve.ContinuousBatcher(trees[0], JCFG, **kw)
    return ContinuousBatcher(trees[1], TCFG, device="cpu", **kw)


def _run(trees, budget, jax_side=False, **kw):
    srv = _batcher(trees, jax_side, prefill_budget=budget, **kw)
    reqs = [([1, 5, -200, 9, 9], _pv(0), 30), ([1, -200, 7, 7], _pv(1), 5)]
    rids = [srv.submit(i, p, b) for i, p, b in reqs]
    srv.step()
    srv.step()
    late = [([1, 5, -200, 3], _pv(0), 8),    # a hit: a suffix lane
            ([2, 6, -200, 11], _pv(3), 7)]   # a miss: a full lane
    rids += [srv.submit(i, p, b) for i, p, b in late]
    out = srv.run_until_drained()
    return [out[r] for r in rids], reqs + late, srv


_CONFIGS = {
    "greedy": dict(),
    "int8_kv": dict(kv_quant=True),
    "ttft_ramp": dict(first_chunk=2),
    "sync": dict(pipeline=False),
}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_mixed_equals_jax_exclusive_and_oneshot(trees, name, layout):
    kw = dict(_CONFIGS[name], kv_layout=layout)
    mixed, reqs, srv = _run(trees, 16, **kw)
    jax_mixed, _, jsrv = _run(trees, 16, jax_side=True, **kw)
    exclusive, _, _ = _run(trees, 0, **kw)
    assert mixed == jax_mixed == exclusive, name
    for got, (ids, pv, budget) in zip(mixed, reqs):
        assert got == _oneshot(trees[1], ids, pv, budget, kw.get("kv_quant", False)), name
    assert srv.mixed_prefill_tokens == jsrv.mixed_prefill_tokens > 0, name
    assert srv.lanes_started == {"full": 1, "suffix": 1}, name
    assert srv.mixed_zero_harvests == 0, name
    assert srv._prefix_cache.hits == jsrv._prefix_cache.hits >= 1
    if layout == "paged":
        assert srv._pool.stats()["cow_copies"] == jsrv._pool.stats()["cow_copies"]
        srv.reset_prefix_cache()
        assert srv._pool.free_blocks() == srv._pool.usable


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mixed_stall_free_property(trees, layout):
    """At every boundary where a lane advanced beside live decode rows,
    those rows committed tokens; the lane fleet is capped at
    prefill_budget // chunk_p, bounded by the batch."""
    _, _, srv = _run(trees, 16, kv_layout=layout)
    assert srv.mixed_boundaries > 0 and srv.mixed_zero_harvests == 0
    assert srv._lane_cap == 2  # min(16 // 4, max_batch=2)
    assert not srv._lanes and len(srv._lane_free) == srv._lane_cap


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mixed_budget_caps_concurrent_lanes(trees, layout):
    """More admissions than the budget allows lanes: the excess stays
    queued and admits at later boundaries, never more than one lane at
    once here; the chains equal the JAX batcher's and one-shot."""
    chains = {}
    for jax_side in (False, True):
        srv = _batcher(trees, jax_side, max_batch=4, prefill_budget=4, kv_layout=layout)
        a = srv.submit([1, 5, -200, 9, 9], _pv(0), 30)
        srv.step()
        srv.step()
        late = [srv.submit([1, 5, -200, i], _pv(0), 6) for i in (3, 4, 12)]
        max_lanes = 0
        while srv.queue or any(r is not None for r in srv.rows):
            srv.step()
            max_lanes = max(max_lanes, len(srv._lanes))
        srv._drain()
        out, srv.finished = srv.finished, {}
        assert max_lanes == 1
        chains[jax_side] = [out[a]] + [out[r] for r in late]
    assert chains[False] == chains[True]
    assert chains[False][0] == _oneshot(trees[1], [1, 5, -200, 9, 9], _pv(0), 30)
    for got, i in zip(chains[False][1:], (3, 4, 12)):
        assert got == _oneshot(trees[1], [1, 5, -200, i], _pv(0), 6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mixed_lane_deadline_and_cancel(trees, layout):
    """Forced finishes hit lanes mid-prefill: the lane drops, its row frees,
    the request finishes with the forced status and no tokens, and the
    decoding row's chain does not change."""
    srv = _batcher(trees, False, max_batch=3, prefill_budget=32, kv_layout=layout)
    a = srv.submit([1, 5, -200, 9, 9], _pv(0), 40)
    srv.step()
    srv.step()
    doomed = srv.submit([1, -200, 7, 7], _pv(1), 8, deadline_s=60.0)
    cancel_me = srv.submit([2, 6, -200, 11], _pv(2), 8)
    srv.step()  # the lanes join and advance once
    assert {lane.req.rid for lane in srv._lanes} == {doomed, cancel_me}
    next(lane for lane in srv._lanes if lane.req.rid == doomed).req.deadline = \
        time.perf_counter() - 1.0
    assert srv.cancel(cancel_me)
    out = srv.run_until_drained()
    assert srv.finish_status[doomed] == "deadline_exceeded"
    assert srv.finish_status[cancel_me] == "cancelled"
    assert out[doomed] == [] and out[cancel_me] == []
    assert out[a] == _oneshot(trees[1], [1, 5, -200, 9, 9], _pv(0), 40)
    assert not srv._lanes and len(srv._lane_free) == srv._lane_cap
    if layout == "paged":
        srv.reset_prefix_cache()
        assert srv._pool.free_blocks() == srv._pool.usable


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mixed_chained_admissions(trees, layout):
    """tests/test_mixed_segments.py's chained-admission case, with the
    TTFT ramp (the port has no warmup): a lane admission into a recycled
    row stays exact."""
    srv = _batcher(trees, False, prefill_budget=16, first_chunk=2, kv_layout=layout)
    a = srv.submit([1, 5, -200, 9, 9], _pv(0), 20)
    srv.step()
    srv.step()
    b = srv.submit([1, 5, -200, 3], _pv(0), 8)
    out = srv.run_until_drained()
    assert srv.lanes_started["suffix"] == 1
    assert out[a] == _oneshot(trees[1], [1, 5, -200, 9, 9], _pv(0), 20)
    assert out[b] == _oneshot(trees[1], [1, 5, -200, 3], _pv(0), 8)
