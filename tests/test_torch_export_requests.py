"""``export_requests`` (the drain seam) and the per-request inter-token
gap (``request_stats[rid]["itl_s"]``): the port's batcher against the JAX
one, f32 on the CPU.

Stepped in lockstep until requests sit in every place a request can be
(rows, lanes, a chunked admission, the queue, the spill store), then both
export:
- the records (rid order, ids, budget, the SLO, the remaining deadline)
  are equal;
- the pool's and the prefix cache's stats after the export are equal, the
  spill store is empty, and every block table points at scratch;
- the exported requests, resubmitted, decode the JAX chains.
The stats of finished requests carry ``itl_s`` beside ``ttft_s`` and
``latency_s`` in both packages, with the same meaning: the mean gap
between the first and the last harvest that committed tokens.
"""

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve as jserve
from eventgpt_tpu import workload as jwork
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
FIRST = [([1, 5, -200, 9, 9], 0, 30), ([1, -200, 7, 7], 1, 3)]
LATE = [([1, 5, -200, 9, 9, 4], 0, 8), ([1] + list(range(20, 40)) + [-200], 2, 6),
        ([3, -200, 11], 3, 5)]
CONFIGS = {"paged_lanes": {"kv_layout": "paged", "prefill_budget": 4},
           "paged_chunked": {"kv_layout": "paged", "prefill_chunk": 4},
           "dense_sync": {"pipeline": False}}
# Deadlines and SLO targets far beyond any run, so that a slow machine
# changes no status and no score between the packages.
LONG_S = 3600.0


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _pair(trees, **kw):
    args = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None, **kw}
    return (ContinuousBatcher(trees[1], TCFG, device="cpu", **args),
            jserve.ContinuousBatcher(trees[0], JCFG, **args))


def _submit_both(port, jsrv, reqs, i0=0):
    for n, (ids, s, b) in enumerate(reqs):
        cls = "batch" if (i0 + n) % 2 else "interactive"
        deadline = LONG_S if (i0 + n) % 3 == 0 else None
        rid = port.submit(ids, _pv(s), b, deadline_s=deadline,
                          slo=twork.SLO(name=cls, latency_s=LONG_S))
        assert jsrv.submit(ids, _pv(s), b, deadline_s=deadline,
                           slo=jwork.SLO(name=cls, latency_s=LONG_S)) == rid


def _assert_same_export(t_out, j_out):
    assert [r["rid"] for r in t_out] == [r["rid"] for r in j_out]
    for t, j in zip(t_out, j_out):
        assert t["input_ids"] == j["input_ids"] and t["max_new_tokens"] == j["max_new_tokens"]
        assert (t["slo"].name, t["slo"].latency_s) == (j["slo"].name, j["slo"].latency_s)
        assert (t["deadline_s"] is None) == (j["deadline_s"] is None)
        if t["deadline_s"] is not None:
            assert 0 < t["deadline_s"] <= LONG_S
        np.testing.assert_array_equal(t["pixel_values"], j["pixel_values"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_export_requests_matches_jax(trees, name):
    port, jsrv = _pair(trees, **CONFIGS[name])
    _submit_both(port, jsrv, FIRST)
    for _ in range(2):
        port.step()
        jsrv.step()
    _submit_both(port, jsrv, LATE, i0=len(FIRST))
    port.step()
    jsrv.step()
    assert port.finished == jsrv.finished
    t_out, j_out = port.export_requests(), jsrv.export_requests()
    _assert_same_export(t_out, j_out)
    assert len(t_out) >= 3
    assert not port.queue and all(r is None for r in port.rows) and not port._lanes
    assert port._pending is None and port._n_deadlines == 0 == jsrv._n_deadlines
    keys = ("n_entries", "bytes", "hits", "misses", "evictions", "insertions")
    t_pc, j_pc = port.prefix_cache_stats(), jsrv.prefix_cache_stats()
    assert {k: t_pc[k] for k in keys} == {k: j_pc[k] for k in keys}
    if port._paged:
        assert port.pool_stats() == {**jsrv._pool.stats(), "deferrals": jsrv.block_deferrals,
                                     "preemptions": jsrv.preemptions}
        assert int(port.cache["bt"].abs().sum()) == 0
        st = port._pool.stats()
        assert st["free_blocks"] == st["usable_blocks"] - \
            port.prefix_cache_stats()["blocks_held"]
    # A survivor re-decodes the exported requests from their prompts.
    for srv, recs in ((port, t_out), (jsrv, j_out)):
        for r in recs:
            srv.submit(r["input_ids"], r["pixel_values"], r["max_new_tokens"],
                       deadline_s=r["deadline_s"], slo=r["slo"])
    assert port.run_until_drained() == jsrv.run_until_drained()


def test_export_drops_a_spilled_request_as_jax(trees):
    port, jsrv = _pair(trees, kv_layout="paged", kv_pool_blocks=4, preempt=True,
                       spill_capacity_mb=64)
    port._recompute_flops_per_s = jsrv._recompute_flops_per_s = 1.0
    for srv, w in ((port, twork), (jsrv, jwork)):
        srv.submit([1, 5, -200, 9, 9], _pv(0), 40, slo=w.SLO(name="batch", latency_s=LONG_S))
    for _ in range(6):
        port.step()
        jsrv.step()
    for srv, w in ((port, twork), (jsrv, jwork)):
        srv.submit([3, -200, 11, 4], _pv(1), 12, slo=w.SLO(name="interactive", ttft_s=LONG_S))
    for _ in range(20):
        port.step()
        jsrv.step()
        if port._pool.stats()["spilled_runs"]:
            break
    assert port._pool.stats()["spilled_runs"] == 1 == jsrv._pool.stats()["spilled_runs"]
    _assert_same_export(port.export_requests(), jsrv.export_requests())
    assert port._pool.stats() == jsrv._pool.stats()
    assert port._spill_store.stats() == jsrv._spill_store.stats()
    assert port._spill_store.stats()["records"] == 0
    assert port._pool.stats()["spilled_runs"] == 0


@pytest.mark.parametrize("kw", [{}, {"speculative": 4}], ids=["plain", "speculative"])
def test_request_stats_carry_itl_as_jax(trees, monkeypatch, kw):
    """On a clock that reads the step count, both packages stamp the same
    harvests, so ``ttft_s``, ``itl_s``, ``latency_s`` and ``slo_met`` are
    equal exactly; ``itl_s`` is 0 for a request whose tokens all landed
    in one harvest."""
    import time

    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    port, jsrv = _pair(trees, kv_layout="paged", **kw)
    _submit_both(port, jsrv, FIRST + LATE)
    while port.queue or any(r is not None for r in port.rows):
        clock[0] += 1.0
        port.step()
        jsrv.step()
    port._drain()
    jsrv._drain()
    monkeypatch.undo()
    assert port.finished == jsrv.finished
    assert port.request_stats == jsrv.request_stats
    spread = 0
    for rid, toks in port.finished.items():
        st = port.request_stats[rid]
        assert {"ttft_s", "latency_s", "itl_s", "slo_met"} <= st.keys()
        if len(toks) <= 1:
            assert st["itl_s"] == 0.0
        spread += st["itl_s"] > 0.0
        assert st["ttft_s"] + st["itl_s"] * (len(toks) - 1) <= st["latency_s"]
    assert spread >= 2
    assert port.slo_stats() == jsrv.slo_stats()
