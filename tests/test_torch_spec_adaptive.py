"""The port's adaptive speculation, Medusa heads in the server and
``warmup`` against the JAX package (tests/test_spec_adaptive.py,
tests/test_serve.py's warmup cases).

  * ``serve_spec``: the port's own copy gives the JAX controller's
    decisions (``select_window``, ``depths``, ``stats``) on the same
    ``observe`` sequences, and ``parse_spec_buckets`` the same buckets.
  * The adaptive server (``spec_buckets="0,2,4"``): chains equal to the JAX
    server's and one-shot ``generate`` on JAX's matrix, and the trace of
    chosen windows equal to the JAX server's on the same traffic. That the
    controller leaves the top bucket is not asserted: on this traffic the
    JAX server's own trace stays at 4 in two of the matrix's cases.
  * Medusa heads, fixed and adaptive, with the drafts of every row that
    goes on decoding equal to the JAX server's after every step.
  * ``warmup``: refused once anything is queued or admitted, the JAX
    count of warmed functions, and the same chains (greedy and sampled)
    as a server that was not warmed.
"""

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve as jserve
from eventgpt_tpu import serve_spec as jspec
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import serve_spec as tspec
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
# tests/test_spec_adaptive.py's traffic: two rows decode, one finishes
# fast, two late arrivals join mid-flight.
REQS = [([1, 5, -200, 9, 9], 0, 14), ([1, -200, 7, 7], 1, 5)]
LATE = [([1, 5, -200, 3], 0, 8), ([2, 6, -200, 11], 3, 7)]


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


@pytest.fixture(scope="module")
def heads():
    """A 3-head Medusa stack (tests/test_spec_adaptive.py's scale) for both
    packages."""
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (3, JCFG.llama.hidden_size,
                                                             JCFG.llama.hidden_size))) * 0.01
    return {"w": jax.numpy.asarray(w)}, {"w": torch.from_numpy(np.asarray(w, np.float32))}


def _oneshot(tp, ids, pv, budget, quant=False):
    return tchat.generate(tp, TCFG, [ids], pv[None], max_new_tokens=budget, temperature=0.0,
                          eos_token_id=None, kv_quant=quant, device="cpu")[0]


def _pair(trees, jax_kw=None, **kw):
    kw = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None, **kw}
    return (ContinuousBatcher(trees[1], TCFG, device="cpu", **kw),
            jserve.ContinuousBatcher(trees[0], JCFG, **{**kw, **(jax_kw or {})}))


def _same_state(port, jax_srv, where):
    np.testing.assert_array_equal(port.ids_buf.numpy(), np.asarray(jax_srv.ids_buf),
                                  err_msg=where)
    np.testing.assert_array_equal(port.base_pos, jax_srv.base_pos, err_msg=where)
    np.testing.assert_array_equal(port._history, jax_srv._history, err_msg=where)
    if port.draft_head is not None:
        # The drafts every row that goes on decoding will consume (the
        # device carry's unfrozen rows). A finished row's drafts are dead
        # until its next admission reseeds them: the port's one verify past
        # the last live one (its stop rule) rewrites them, JAX's loop ends.
        frozen = port._dev_carry[0].numpy() if port._dev_carry is not None else port.frozen
        np.testing.assert_array_equal(port.spec_drafts.numpy()[~frozen],
                                      np.asarray(jax_srv.spec_drafts)[~frozen], err_msg=where)
    for name in ("spec_iterations", "spec_tokens", "spec_dispatches", "spec_depth_sum",
                 "spec_masked_rows"):
        assert getattr(port, name) == getattr(jax_srv, name), (where, name)
    assert list(port.spec_depth_trace) == list(jax_srv.spec_depth_trace), where


def _run_pair(port, jax_srv):
    """The staged traffic through both servers stepped together (state
    equal after every step); the chains in request order."""
    rids = [(port.submit(i, _pv(s), b), jax_srv.submit(i, _pv(s), b)) for i, s, b in REQS]
    steps = 0
    while port.queue or any(r is not None for r in port.rows):
        port.step()
        jax_srv.step()
        steps += 1
        _same_state(port, jax_srv, f"step {steps}")
        if steps == 2:
            rids += [(port.submit(i, _pv(s), b), jax_srv.submit(i, _pv(s), b))
                     for i, s, b in LATE]
    port._drain()
    jax_srv._drain()
    _same_state(port, jax_srv, "drained")
    got = [port.finished[r] for r, _ in rids]
    assert got == [jax_srv.finished[r] for _, r in rids]
    return got


# -- the controller ----------------------------------------------------------

@pytest.mark.parametrize("spec", ["", None, "0", "4", "0,2,4", " 8, 2,,4 ,1", "3,3,0", "-1",
                                  "x"])
def test_parse_spec_buckets_matches_jax(spec):
    def parse(mod):
        try:
            return mod.parse_spec_buckets(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert parse(tspec) == parse(jspec)


_CTL = {
    "defaults": dict(windows=(1, 2, 4), default_window=4),
    "costly_drafts": dict(windows=(1, 2, 4, 8), default_window=2, draft_cost=0.4,
                          hysteresis=0.0, row_window=2),
    "budgeted": dict(windows=(1, 3, 5), default_window=5, ema_alpha=0.7, draft_budget=6,
                     head_min_yield=0.3),
}


@pytest.mark.parametrize("name", sorted(_CTL))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_decisions_match_jax(name, seed):
    """The same recorded observe sequence (per-row acceptance of a random
    traffic whose rows come and go) through both controllers: every
    window, depth vector and snapshot equal."""
    rng = np.random.default_rng(seed)
    kw = _CTL[name]
    ours, theirs = tspec.SpecController(**kw), jspec.SpecController(**kw)
    rids = [None, 1, 2, 3]
    next_rid = 4
    window = max(kw["windows"])
    for _ in range(60):
        live = sum(r is not None for r in rids)
        mixed = bool(rng.integers(2))
        window = ours.select_window(live_rows=live, mixed=mixed)
        assert window == theirs.select_window(live_rows=live, mixed=mixed)
        assert ours.depths(rids, window) == theirs.depths(rids, window)
        per_row = []
        for rid in rids:
            if rid is None:
                continue
            off = int(rng.integers(0, 2 * window))
            per_row.append((rid, int(rng.integers(0, off + 1)), off))
        pos_off = [int(x) for x in rng.integers(0, 5, size=window - 1)]
        pos_acc = [int(rng.integers(0, o + 1)) for o in pos_off]
        ours.observe(per_row, pos_acc, pos_off)
        theirs.observe(per_row, pos_acc, pos_off)
        slot = int(rng.integers(len(rids)))
        if rng.random() < 0.3 and rids[slot] is not None:
            ours.forget(rids[slot])
            theirs.forget(rids[slot])
            rids[slot] = None
        elif rids[slot] is None:
            rids[slot] = next_rid
            next_rid += 1
        assert ours.stats() == theirs.stats()
    for d in range(6):
        for a in (0.0, 0.3, 0.99, 1.0):
            assert tspec.expected_commits(a, d) == jspec.expected_commits(a, d)


# -- the adaptive server -----------------------------------------------------

MATRIX = {
    "plain": {},
    "int8_kv": dict(kv_quant=True),
    "paged": dict(kv_layout="paged"),
    "mixed_lanes": dict(prefill_budget=8, prefill_lane_chunk=4),
    "pipeline_off": dict(pipeline=False),
}


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_adaptive_equals_jax_fixed_and_oneshot(trees, name):
    kw = MATRIX[name]
    port, jax_srv = _pair(trees, spec_buckets="0,2,4", **kw)
    got = _run_pair(port, jax_srv)
    fixed = ContinuousBatcher(trees[1], TCFG, max_batch=2, max_len=256, chunk=4,
                              eos_token_id=None, speculative=4, device="cpu", **kw)
    rids = [fixed.submit(i, _pv(s), b) for i, s, b in REQS]
    fixed.step()
    fixed.step()
    rids += [fixed.submit(i, _pv(s), b) for i, s, b in LATE]
    out = fixed.run_until_drained()
    assert got == [out[r] for r in rids], name
    for chain, (ids, s, budget) in zip(got, REQS + LATE):
        assert chain == _oneshot(trees[1], ids, _pv(s), budget, kw.get("kv_quant", False)), name
    trace = list(port.spec_depth_trace)
    assert trace == list(jax_srv.spec_depth_trace) and set(trace) <= set(port.spec_windows)
    assert port.spec_stats() == jax_srv.spec_stats()


@pytest.mark.parametrize("buckets", [None, "0,2,4"])
def test_medusa_draft_head_equals_jax(trees, heads, buckets):
    jh, th = heads
    kw = dict(speculative=4) if buckets is None else dict(spec_buckets=buckets)
    port, jax_srv = _pair(trees, jax_kw={"draft_head": jh}, draft_head=th, **kw)
    got = _run_pair(port, jax_srv)
    for chain, (ids, s, budget) in zip(got, REQS + LATE):
        assert chain == _oneshot(trees[1], ids, _pv(s), budget)
    assert port.spec_max == 4 and port.spec_drafts.shape == (2, 3)


def test_medusa_lanes_and_chunked_prefill(trees, heads):
    """The lane finish and the chunked admission hand their last hidden to
    the draft seeding (tests/test_mixed_segments.py's Medusa case)."""
    jh, th = heads
    for kw in (dict(prefill_budget=8, prefill_lane_chunk=4, kv_layout="paged"),
               dict(prefill_chunk=8, prefix_cache=False)):
        port, jax_srv = _pair(trees, jax_kw={"draft_head": jh}, draft_head=th, speculative=4,
                              **kw)
        got = _run_pair(port, jax_srv)
        for chain, (ids, s, budget) in zip(got, REQS + LATE):
            assert chain == _oneshot(trees[1], ids, _pv(s), budget)


def test_draft_head_validation(trees, heads):
    _, th = heads
    with pytest.raises(ValueError, match="requires speculative"):
        ContinuousBatcher(trees[1], TCFG, draft_head=th, device="cpu")
    with pytest.raises(ValueError, match="needs 7"):
        ContinuousBatcher(trees[1], TCFG, draft_head=th, spec_buckets="0,8", device="cpu")


# -- warmup ------------------------------------------------------------------

_WARM = {
    "fixed": dict(speculative=4),
    "adaptive_lanes_chunked_ramp": dict(spec_buckets="0,2,4", prefill_chunk=8,
                                        prefill_budget=8, first_chunk=2),
    "plain_paged_ramp_lanes": dict(first_chunk=2, kv_layout="paged", prefill_budget=8),
}


@pytest.mark.parametrize("name", sorted(_WARM))
def test_warmup_count_matches_jax_and_chains_hold(trees, name):
    kw = _WARM[name]
    port, jax_srv = _pair(trees, **kw)
    assert port.warmup(prompt_lens=[14]) == jax_srv.warmup(prompt_lens=[14])
    cold = ContinuousBatcher(trees[1], TCFG, max_batch=2, max_len=256, chunk=4,
                             eos_token_id=None, device="cpu", **kw)
    chains = []
    for srv in (port, cold):
        rids = [srv.submit(i, _pv(s), b) for i, s, b in REQS + LATE]
        out = srv.run_until_drained()
        chains.append([out[r] for r in rids])
    assert chains[0] == chains[1]
    for chain, (ids, s, budget) in zip(chains[0], REQS + LATE):
        assert chain == _oneshot(trees[1], ids, _pv(s), budget)


def test_warmup_counts_prefix_entry_shapes_as_jax(trees):
    port, jax_srv = _pair(trees, speculative=4, kv_layout="paged")
    for srv in (port, jax_srv):
        srv.set_prefix([1, 5, 7])
        srv.set_prefix([1, 5, -200, 7], pixel_values=_pv(4))
    assert port.warmup(prompt_lens=[14, 200]) == jax_srv.warmup(prompt_lens=[14, 200])


def test_warmup_keeps_sampled_chains_and_refuses_a_busy_server(trees):
    _, tp = trees
    chains = []
    for warm in (True, False):
        srv = ContinuousBatcher(tp, TCFG, max_batch=2, max_len=256, chunk=4, eos_token_id=None,
                                spec_buckets="0,2,4", temperature=0.8, top_p=0.9, seed=5,
                                device="cpu")
        if warm:
            assert srv.warmup() > 0
        rids = [srv.submit(i, _pv(s), b) for i, s, b in REQS]
        out = srv.run_until_drained()
        chains.append([out[r] for r in rids])
    assert chains[0] == chains[1]
    srv.submit(*REQS[0][:1], _pv(0), 4)
    with pytest.raises(RuntimeError, match="before any request"):
        srv.warmup()
    srv.step()
    with pytest.raises(RuntimeError, match="before any request"):
        srv.warmup()
