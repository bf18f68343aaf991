"""Prefill/decode roles and the in-process KV handoff: the port's
``ContinuousBatcher`` against the JAX one, f32 on the CPU.

A prefill-role batcher admits only: each activated row's block run is
gathered into its outbox (``pop_handoffs``) and the row torn down. A
decode-role batcher splices the record through the paged admission
scatter (``import_handoff``) instead of prefilling. For the plain, int8-KV,
speculative and mixed-lane configurations:
- the handed-off chain equals the JAX batcher's handed-off chain and the
  port's colocated one-shot, token for token;
- the outbox record equals the JAX one (shipped and total blocks, bytes,
  base position, tokens, int8 payloads bit-equal, f32 planes within 1e-5:
  the two forwards round f32 sums differently), and both pools are clean
  after the drain;
- a JAX prefill worker's record (numpy planes) spliced into the port's
  decode batcher gives the JAX chain, and the port's record, converted to
  numpy, spliced into the JAX decode batcher gives the port's.
Also: a splice beside local traffic, splices under an in-flight segment
with lanes armed (the port drains first; the JAX batcher does not, F3), role
validation, the prefill role's refusals, the oversized-import refusal and the
whole-life stats.
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
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
IDS = [1, 5, -200, 9, 9]
BUDGET = 24
F32_ATOL = 1e-5
CONFIGS = {"plain": {}, "int8_kv": {"kv_quant": True}, "speculative": {"speculative": 4},
           "mixed_lane": {"prefill_budget": 2, "prefill_chunk": 4}}
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


def _kw(**kw):
    return {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None,
            "kv_layout": "paged", "kv_pool_blocks": 12, **kw}


def _port(trees, **kw):
    return ContinuousBatcher(trees[1], TCFG, device="cpu", **_kw(**kw))


def _jax(trees, **kw):
    return jserve.ContinuousBatcher(trees[0], JCFG, **_kw(**kw))


def _gather_one(pre, ids, pv, budget, **submit_kw):
    rid = pre.submit(ids, pv, budget, **submit_kw)
    for _ in range(400):
        if pre.handoff_ready:
            break
        pre.step()
    else:
        pytest.fail("the prefill role never gathered the row into its outbox")
    out = pre.pop_handoffs()
    assert len(out) == 1 and out[0]["rid"] == rid
    return out[0]


def _splice_and_drain(dec, out, rec=None):
    rid = dec.import_handoff(out["input_ids"], out["max_new_tokens"],
                             out["rec"] if rec is None else rec, tokens=out["tokens"],
                             prompt_len=out["prompt_len"], deadline_s=out["deadline_s"],
                             slo=out["slo"])
    return dec.run_until_drained()[rid]


def _numpy_record(rec):
    """A port record with numpy planes (the form the JAX batcher splices)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return x.numpy() if isinstance(x, torch.Tensor) else x
    return conv(rec)


def _assert_pool_clean(srv):
    st = srv._pool.stats()
    assert st["free_blocks"] + st["used_blocks"] == st["usable_blocks"]
    assert st["spilled_runs"] == 0


def _assert_same_record(t, j):
    for key in ("n_blocks", "n_total", "nbytes_kv", "base_pos"):
        assert t[key] == j[key], key
    assert int(t["length"]) == int(j["length"])
    for key in ("k", "v"):
        tp, jp = _numpy_record(t[key]), j[key]
        if isinstance(jp, dict):
            np.testing.assert_array_equal(tp["q"], np.asarray(jp["q"]))
            np.testing.assert_allclose(tp["s"], np.asarray(jp["s"]), rtol=0, atol=F32_ATOL)
        else:
            np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(t["logits"].numpy(), np.asarray(j["logits"]), rtol=0,
                               atol=F32_ATOL)
    if "ids" in j:
        np.testing.assert_array_equal(t["ids"].numpy(), np.asarray(j["ids"]))


@pytest.fixture(scope="module")
def jax_runs(trees):
    """Per configuration, the JAX prefill worker's outbox record and its
    handed-off chain (kept for the cross-package splices)."""
    runs = {}
    for name, kw in CONFIGS.items():
        out = _gather_one(_jax(trees, role="prefill", **kw), IDS, _pv(3), BUDGET)
        chain = _splice_and_drain(_jax(trees, role="decode", **kw), out)
        runs[name] = (out, chain)
    return runs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_handoff_chain_and_record_match_jax(trees, jax_runs, name):
    kw = CONFIGS[name]
    j_out, j_chain = jax_runs[name]
    srv = _port(trees, **kw)
    rid = srv.submit(IDS, _pv(3), BUDGET)
    ref = srv.run_until_drained()[rid]
    assert len(ref) == BUDGET
    pre, dec = _port(trees, role="prefill", **kw), _port(trees, role="decode", **kw)
    out = _gather_one(pre, IDS, _pv(3), BUDGET)
    assert all(r is None for r in pre.rows) and pre.handoffs_gathered == 1
    assert pre.handoffs_gathered_bytes == out["rec"]["nbytes_kv"] > 0
    _assert_pool_clean(pre)
    for key in ("tokens", "prompt_len", "max_new_tokens", "input_ids"):
        assert out[key] == j_out[key], key
    assert (out["ttft_s"] is None) == (j_out["ttft_s"] is None)
    _assert_same_record(out["rec"], j_out["rec"])
    chain = _splice_and_drain(dec, out)
    assert chain == j_chain == ref
    assert dec.handoffs_spliced == 1 and dec.handoffs_spliced_bytes == out["rec"]["nbytes_kv"]
    _assert_pool_clean(dec)
    assert dec._pool.stats()["free_blocks"] == dec._pool.usable - \
        dec.prefix_cache_stats().get("blocks_held", 0)


@pytest.mark.parametrize("name", ["plain", "int8_kv", "speculative"])
def test_cross_package_splices(trees, jax_runs, name):
    """JAX record -> port decode batcher gives the JAX chain; the port's
    record as numpy -> JAX decode batcher gives the port's chain."""
    kw = CONFIGS[name]
    j_out, j_chain = jax_runs[name]
    rec = {k: (v if k not in ("k", "v", "logits", "ids", "drafts", "length")
               else jax.tree_util.tree_map(np.asarray, v)) for k, v in j_out["rec"].items()}
    assert _splice_and_drain(_port(trees, role="decode", **kw), j_out, rec) == j_chain
    out = _gather_one(_port(trees, role="prefill", **kw), IDS, _pv(3), BUDGET)
    t_chain = _splice_and_drain(_port(trees, role="decode", **kw), out)
    assert _splice_and_drain(_jax(trees, role="decode", **kw), out,
                             _numpy_record(out["rec"])) == t_chain == j_chain


def test_handoff_interleaves_with_local_traffic(trees):
    ids_b = [3, -200, 11, 4]
    ref = _port(trees)
    ra, rb = ref.submit(IDS, _pv(0), BUDGET), ref.submit(ids_b, _pv(1), 12)
    want = ref.run_until_drained()
    pre, dec = _port(trees, role="prefill"), _port(trees, role="decode")
    out = _gather_one(pre, IDS, _pv(0), BUDGET)
    rid_b = dec.submit(ids_b, _pv(1), 12)
    rid_a = dec.import_handoff(out["input_ids"], out["max_new_tokens"], out["rec"],
                               tokens=out["tokens"], prompt_len=out["prompt_len"])
    got = dec.run_until_drained()
    assert got[rid_a] == want[ra] and got[rid_b] == want[rb]
    _assert_pool_clean(dec)


def test_role_validation(trees):
    with pytest.raises(ValueError, match="role must be"):
        _port(trees, role="draft")
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        _port(trees, role="prefill", kv_layout="dense")
    assert _port(trees, role="prefill", prefill_budget=8).prefill_budget == 0


def test_prefill_role_rejects_import_and_never_decodes(trees):
    pre = _port(trees, role="prefill")
    with pytest.raises(ValueError, match="prefill-role"):
        pre.import_handoff(IDS, 4, {"n_blocks": 1})
    out = _gather_one(pre, IDS, _pv(5), BUDGET)
    assert len(out["tokens"]) < BUDGET
    assert all(r is None for r in pre.rows) and pre.finished == {}
    assert pre.seg_count == 0


def test_import_refuses_an_oversized_reservation_and_unknown_slo(trees):
    dec = _port(trees, role="decode", kv_pool_blocks=4)
    with pytest.raises(ValueError, match="does not fit"):
        dec.import_handoff(IDS, 200, {"n_blocks": 1}, prompt_len=250)
    with pytest.raises(ValueError, match="unknown SLO class"):
        dec.import_handoff(IDS, 4, {"n_blocks": 1}, slo=twork.SLO(name="platinum", ttft_s=1.0))
    assert not dec.queue


def test_import_rebases_stats_and_keeps_deadline_and_slo(trees):
    """The decode side scores the request's whole life: ``t_submit`` moves
    back by the prefill leg and the wire gap, a shipped commit-time TTFT
    pins ``t_first``, and the remaining deadline and the SLO carry over."""
    pre, dec = _port(trees, role="prefill"), _port(trees, role="decode")
    out = _gather_one(pre, IDS, _pv(6), 8, deadline_s=LONG_S,
                      slo=twork.SLO(name="batch", latency_s=LONG_S))
    assert 0 < out["deadline_s"] < LONG_S and out["slo"].name == "batch"
    assert out["elapsed_s"] > 0.0 and out["ttft_s"] is None
    time.sleep(0.05)
    elapsed = out["elapsed_s"] + 0.05
    rid = dec.import_handoff(out["input_ids"], out["max_new_tokens"], out["rec"],
                             tokens=out["tokens"], prompt_len=out["prompt_len"],
                             deadline_s=out["deadline_s"], slo=out["slo"], elapsed_s=elapsed,
                             ttft_s=out["ttft_s"])
    req = next(r for r in dec.queue if r.rid == rid)
    assert req.deadline is not None and req.slo.name == "batch"
    dec.run_until_drained()
    st = dec.request_stats[rid]
    assert st["ttft_s"] > elapsed and st["latency_s"] >= st["ttft_s"] > 0
    assert st["slo_met"] == 1.0 and dec.slo_stats()["classes"]["batch"]["finished"] == 1
    out2 = _gather_one(pre, [1, 5, -200, 9, 2], _pv(7), 8)
    rid2 = dec.import_handoff(out2["input_ids"], out2["max_new_tokens"], out2["rec"],
                              tokens=out2["tokens"], prompt_len=out2["prompt_len"],
                              elapsed_s=out2["elapsed_s"], ttft_s=0.011)
    dec.run_until_drained()
    assert dec.request_stats[rid2]["ttft_s"] == pytest.approx(0.011, abs=1e-6)
    _assert_pool_clean(dec)


def test_a_splice_under_an_in_flight_segment_drains_first(trees):
    """The decode role imports records one at a time while its rows decode,
    pipelined with lanes armed (``prefill_budget``), as a decode worker of a
    process fleet does: each splice must drain the in-flight segment first,
    and every chain equals the colocated one. The JAX batcher does not drain
    there, and a record spliced into a row freed under that segment decodes
    two stale tokens first (ROADMAP Queue 3, F3)."""
    kw = {"chunk": 2, "prefill_budget": 2, "eos_token_id": 2}
    reqs = [([1, 7, 7, -200, 9, 10, 11, 80 + i], _pv(400 + i), 12) for i in range(4)]
    ref = _port(trees, **kw)
    rids = [ref.submit(*r) for r in reqs]
    done = ref.run_until_drained()
    want = [done[r] for r in rids]
    jref = _jax(trees, **kw)
    rids = [jref.submit(*r) for r in reqs]
    done = jref.run_until_drained()
    assert [done[r] for r in rids] == want

    def interleaved(make):
        pre, dec = make(trees, role="prefill", **kw), make(trees, role="decode", **kw)
        got = []
        for r in reqs:
            out = _gather_one(pre, *r)
            got.append(dec.import_handoff(out["input_ids"], out["max_new_tokens"], out["rec"],
                                          tokens=out["tokens"], prompt_len=out["prompt_len"]))
            dec.step()
        done = dec.run_until_drained()
        _assert_pool_clean(dec)
        return [done[r] for r in got]

    assert interleaved(_port) == want
    jax_chains = interleaved(_jax)
    assert jax_chains[:2] == want[:2] and jax_chains != want
