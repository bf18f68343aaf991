"""Speculative decoding in the PyTorch port against the JAX package, at f32
on the CPU.

The contracts of ``eventgpt_tpu/models/eventchat._spec_loop_jit``: at
temperature 0 the speculative chain is exactly the plain greedy chain; above
it, drafts pass through rejection sampling. The port's ``decode_kstep``,
suffix-lookup drafts, acceptance count and chains are held against the JAX
package's on the same weights and inputs (made from numpy seeds).

Tolerances, stated where they are used:
- ``decode_kstep`` logits against the JAX package's: f32 sums of the same
  terms in another order, atol 1e-4 on logits of order 1 (the bar of
  tests/test_torch_models.py); against K sequential port ``decode_step``s
  the same arithmetic on other GEMM shapes, 1e-5 (the JAX package's own
  bar, tests/test_speculative.py);
- drafts, accepted counts and token chains: exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.models import llama as jllama
from eventgpt_tpu.ops import quant as jquant
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX, SPEC_LOOKUP_MAX
from eventgpt_tpu_torch.data.tokenizer import split_at_event
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models.convert import (kv_cache_from_jax, llama_params_from_jax,
                                               params_from_jax)
from eventgpt_tpu_torch.ops import quant as tquant
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

JCFG = jcfg.EventChatConfig.tiny(vocab_size=128)
TCFG = tcfg.EventChatConfig.tiny(vocab_size=128)
CPU = torch.device("cpu")
# A LLaMA whose widths pass K4's gate (tests/test_torch_quant.py), so that
# --quant int4 runs K4's plain version, as the card runs K4.
_ALIGNED = dict(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=2,
                num_heads=4, num_kv_heads=2, max_seq_len=256)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jp = _np_tree(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, TCFG, torch.float32, CPU)
    rng = np.random.default_rng(0)
    size = JCFG.vision.image_size
    pixels = rng.standard_normal((2, JCFG.num_event_frames, 3, size, size)).astype(np.float32)
    # Row 1 repeats a bigram, so the lookup has something to draft.
    ids = [rng.integers(3, 128, 4).tolist() + [EVENT_TOKEN_INDEX] + rng.integers(3, 128, 3).tolist(),
           [5, 9, 7, 5, 9] + [EVENT_TOKEN_INDEX] + [5, 9, 7, 5, 9, 7]]
    return jp, tp, ids, pixels


def _kstep_inputs(seed, b=2, t=9, k=4, d=64):
    rng = np.random.default_rng(seed)
    embeds = (rng.standard_normal((b, t, d)) * 0.5).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [t - 3]])
    window = (rng.standard_normal((b, k, d)) * 0.5).astype(np.float32)
    return embeds, mask, window


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_decode_kstep_matches_jax(setup, cache):
    jp, tp, _, _ = setup
    jl, tl = jp["llama"], tp["llama"]
    embeds, mask, window = _kstep_inputs(1)
    b, t = mask.shape
    dtype = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
             "int8": (jnp.float32, torch.float32)}[cache]
    quant = cache == "int8"
    j_cache = jllama.init_kv_cache(JCFG.llama, b, 16, dtype=dtype[0], quant=quant)
    _, j_cache = jllama.prefill(jl, JCFG.llama, jnp.asarray(embeds), jnp.asarray(mask), j_cache)
    j_logits, j_hidden, j_cache = jllama.decode_kstep(jl, JCFG.llama, jnp.asarray(window),
                                                      j_cache, return_hidden=True)
    t_cache = tllama.init_kv_cache(TCFG.llama, b, 16, dtype=dtype[1], quant=quant)
    tllama.prefill(tl, TCFG.llama, torch.from_numpy(embeds), torch.from_numpy(mask), t_cache)
    t_logits, t_hidden, t_cache = tllama.decode_kstep(tl, TCFG.llama, torch.from_numpy(window),
                                                      t_cache, return_hidden=True)
    assert t_logits.dtype == torch.float32 and t_logits.shape == (b, 4, 128)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(j_hidden), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_cache["length"].numpy(), np.asarray(j_cache["length"]))


def test_decode_kstep_equals_sequential_steps(setup):
    """One K-token window == K decode_steps fed one token at a time."""
    _, tp, _, _ = setup
    tl = tp["llama"]
    embeds, mask, window = _kstep_inputs(2)
    b, t = mask.shape
    caches = []
    for _ in range(2):
        c = tllama.init_kv_cache(TCFG.llama, b, 16, dtype=torch.float32)
        tllama.prefill(tl, TCFG.llama, torch.from_numpy(embeds), torch.from_numpy(mask), c)
        caches.append(c)
    seq = []
    for i in range(window.shape[1]):
        lg, _ = tllama.decode_step(tl, TCFG.llama, torch.from_numpy(window[:, i:i + 1]), caches[0])
        seq.append(lg)
    win, _ = tllama.decode_kstep(tl, TCFG.llama, torch.from_numpy(window), caches[1])
    torch.testing.assert_close(win, torch.stack(seq, dim=1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(caches[1]["k"], caches[0]["k"], atol=1e-6, rtol=1e-5)
    assert caches[1]["length"].tolist() == caches[0]["length"].tolist() == [t + 4, t + 1]


def _paged_from_dense(cache, bs, bt):
    """A dense numpy cache (L, B, S, ...) planes scattered into a paged
    arena of ``bt.max() + 1`` blocks of ``bs`` slots through table ``bt``."""
    def arena(x):
        x = np.asarray(x)
        out = np.zeros((x.shape[0], int(bt.max()) + 1, bs) + x.shape[3:], x.dtype)
        for r in range(bt.shape[0]):
            for j, blk in enumerate(bt[r]):
                out[:, blk] = x[:, r, j * bs:(j + 1) * bs]
        return out

    def plane(p):
        return {k: arena(v) for k, v in p.items()} if isinstance(p, dict) else arena(p)

    return {"k": plane(cache["k"]), "v": plane(cache["v"]), "bt": bt.astype(np.int32),
            "length": np.asarray(cache["length"])}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_decode_kstep_paged_matches_jax_and_dense(setup, quant):
    """Through a block table (the paged layout the server's speculation
    will verify on), the window's logits are the JAX package's and the
    dense cache's, and its K slots land in the rows' own blocks."""
    jp, tp, _, _ = setup
    jl = jp["llama"]
    embeds, mask, window = _kstep_inputs(4)
    b = mask.shape[0]
    dense = jllama.init_kv_cache(JCFG.llama, b, 16, dtype=jnp.float32, quant=quant)
    _, dense = jllama.prefill(jl, JCFG.llama, jnp.asarray(embeds), jnp.asarray(mask), dense)
    bt = np.random.default_rng(0).permutation(np.arange(1, 9)).reshape(b, 4)
    paged = _paged_from_dense(jax.tree_util.tree_map(np.asarray, dense), 4, bt)
    j_dense, _ = jllama.decode_kstep(jl, JCFG.llama, jnp.asarray(window), dense)
    j_paged, _ = jllama.decode_kstep(jl, JCFG.llama, jnp.asarray(window),
                                     jax.tree_util.tree_map(jnp.asarray, paged))
    t_cache = kv_cache_from_jax(paged, CPU)
    t_paged, t_cache = tllama.decode_kstep(tp["llama"], TCFG.llama, torch.from_numpy(window),
                                           t_cache)
    np.testing.assert_allclose(t_paged.numpy(), np.asarray(j_paged), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_paged.numpy(), np.asarray(j_dense), atol=1e-4, rtol=1e-4)
    # Row 1 (length 6) wrote slots 6..9: slots 2, 3 of its block 1, 0, 1 of block 2.
    k_plane = t_cache["k"]["q"] if quant else t_cache["k"]
    assert k_plane[:, bt[1, 2], :2].abs().sum() > 0
    assert t_cache["length"].tolist() == [13, 10]


def test_prefill_return_hidden_matches_jax(setup):
    jp, tp, _, _ = setup
    embeds, mask, _ = _kstep_inputs(3)
    b = mask.shape[0]
    j_logits, j_hidden, _ = jllama.prefill(
        jp["llama"], JCFG.llama, jnp.asarray(embeds), jnp.asarray(mask),
        jllama.init_kv_cache(JCFG.llama, b, 16, dtype=jnp.float32), last_only=True,
        return_hidden=True)
    t_logits, t_hidden, _ = tllama.prefill(
        tp["llama"], TCFG.llama, torch.from_numpy(embeds), torch.from_numpy(mask),
        tllama.init_kv_cache(TCFG.llama, b, 16, dtype=torch.float32), last_only=True,
        return_hidden=True)
    assert t_hidden.shape == (b, 64)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(j_hidden), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)


# ---- suffix-lookup drafts -----------------------------------------------------


def _drafts_both(ids, pos, window, vocab=50, history=None):
    """(port drafts, JAX drafts) for the same buffers, as lists."""
    j_params = {"llama": {"lm_head": jnp.zeros((8, vocab))}}  # JAX (D, V)
    t_params = {"llama": {"lm_head": torch.zeros((vocab, 8))}}  # port (V, D)
    jd = jchat._suffix_vote_drafts(
        j_params, jnp.asarray(ids), jnp.asarray(pos, jnp.int32), window,
        history=None if history is None else jnp.asarray(history))
    td = tchat._suffix_vote_drafts(
        t_params, torch.from_numpy(np.asarray(ids, np.int32)),
        torch.as_tensor(pos, dtype=torch.int64), window,
        history=None if history is None else torch.from_numpy(np.asarray(history, np.int32)))
    assert td.dtype == torch.int32
    return td.tolist(), np.asarray(jd).tolist()


@pytest.mark.parametrize("seed", range(6))
def test_suffix_vote_drafts_equal_jax_on_random_buffers(seed):
    """Seeded buffers over a small alphabet (many deep matches), fillers
    (-1) in blocks and at random, positions at the buffer's edges, windows
    1 to 6 and an optional history buffer: the drafts are JAX's exactly."""
    rng = np.random.default_rng(seed)
    b, s, vocab = 3, 40, 6 + seed
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    ids[rng.random((b, s)) < 0.1] = -1
    ids[0, 5:12] = -1  # an event block
    pos = np.array([s, rng.integers(2, s), 1 + seed % 3])
    for i, p in enumerate(pos):
        ids[i, p:] = -1  # nothing written past pos
    history = rng.integers(-1, vocab, (24,)).astype(np.int32) if seed % 2 else None
    for window in range(1, 7):
        got, want = _drafts_both(ids, pos, window, vocab, history)
        assert got == want, (window, got, want)
        assert len(got[0]) == window - 1


def test_suffix_vote_drafts_majority_beats_latest():
    row = [1, 9, 3, 1, 9, 3, 1, 9, 4, 1, 9]
    ids = np.full((1, 32), -1, np.int32)
    ids[0, :len(row)] = row
    got, want = _drafts_both(ids, [len(row)], 2)
    assert got == want == [[3]]


def test_suffix_vote_drafts_requery_follows_history():
    ids = np.full((1, 16), -1, np.int32)
    ids[0, :2] = [7, 8]
    hist = np.full((24,), -1, np.int32)
    hist[:6] = [1, 7, 8, 9, 10, 11]
    got, want = _drafts_both(ids, [2], 4, history=hist)
    assert got == want == [[9, 10, 11]]


def test_suffix_vote_drafts_no_match_repeats_newest():
    ids = np.full((1, 16), -1, np.int32)
    ids[0, :3] = [3, 4, 5]
    got, want = _drafts_both(ids, [3], 3)
    assert got == want == [[5, 5]]


def test_suffix_vote_drafts_deep_match_and_depth_cap():
    """A suffix deeper than SPEC_LOOKUP_MAX still drafts its continuation
    (the depth saturates), and ties between continuations go to the
    smallest id."""
    pattern = list(range(10, 10 + SPEC_LOOKUP_MAX + 3))
    row = pattern + [40] + pattern[:-1]
    ids = np.full((1, 64), -1, np.int32)
    ids[0, :len(row)] = row
    got, want = _drafts_both(ids, [len(row)], 4)
    assert got == want == [[pattern[-1], 40, pattern[0]]]
    tie = [2, 7, 2, 5, 2]  # after 2: 7 and 5 once each -> 5
    ids = np.full((1, 16), -1, np.int32)
    ids[0, :len(tie)] = tie
    got, want = _drafts_both(ids, [len(tie)], 2)
    assert got == want == [[5]]


def test_spliced_text_ids_match_jax():
    ids = [1, 2, EVENT_TOKEN_INDEX, 3, 4, 5, EVENT_TOKEN_INDEX, 6]
    segs = split_at_event(ids)
    for limit in (100, 9, 3):
        got = tchat._spliced_text_ids(segs, 4, limit)
        want = jchat._spliced_text_ids([np.asarray(s) for s in segs], 4, limit)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert tchat._spliced_text_ids(segs, 2, 100).tolist() == [1, 2, -1, -1, 3, 4, 5, -1, -1, 6]


def test_spec_draft_verify_with_history_and_depth_matches_jax(setup):
    """One draft-and-verify step with the server's history buffer and a
    per-row depth cap (row 0 drafts nothing, row 1 at most 2): the commit
    window, counts and EOS location are JAX's, and ``length`` is set back."""
    jp, tp, _, _ = setup
    rng = np.random.default_rng(5)
    b, t, s_ids, window = 2, 6, 24, 4
    prompt = rng.integers(3, 128, (b, t)).astype(np.int32)
    mask = np.ones((b, t), bool)
    mask[1, 4:] = False
    lens = mask.sum(1)
    ids = np.full((b, s_ids), -1, np.int32)
    for r in range(b):
        ids[r, :lens[r]] = prompt[r, :lens[r]]
        ids[r, lens[r]] = prompt[r, 1]  # the first generated token
    hist = np.concatenate([prompt[1, :3], [7, 9, 11], prompt[0, 1:3], [5]]).astype(np.int32)
    pos = lens + 1
    depth = np.array([0, 2], np.int32)
    eos = 9
    embeds = np.asarray(jllama.embed_tokens(jp["llama"], jnp.asarray(prompt)))
    j_cache = jllama.init_kv_cache(JCFG.llama, b, s_ids, dtype=jnp.float32)
    _, j_cache = jllama.prefill(jp["llama"], JCFG.llama, jnp.asarray(embeds), jnp.asarray(mask),
                                j_cache)
    t_cache = tllama.init_kv_cache(TCFG.llama, b, s_ids, dtype=torch.float32)
    tllama.prefill(tp["llama"], TCFG.llama, torch.from_numpy(embeds), torch.from_numpy(mask),
                   t_cache)
    want = jchat._spec_draft_verify(
        jp, JCFG, jnp.asarray(ids), jnp.asarray(pos, jnp.int32), j_cache, jax.random.PRNGKey(0),
        window, 0.0, 1.0, eos, history=jnp.asarray(hist), depth=jnp.asarray(depth))
    got = tchat._spec_draft_verify(
        tp, TCFG, torch.from_numpy(ids), torch.from_numpy(pos), t_cache, None, window, 0.0, 1.0,
        eos, history=torch.from_numpy(hist), depth=torch.from_numpy(depth))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].tolist()[0] == 1 and got[4] is None
    assert t_cache["length"].tolist() == lens.tolist()


# ---- greedy chains --------------------------------------------------------------


def _both(jp, tp, ids, pixels, jc=JCFG, tc=TCFG, **kw):
    want = jchat.generate(jp, jc, ids, pixels, **kw)
    got = tchat.generate(tp, tc, ids, pixels, device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("window", [1, 2, 4])
def test_spec_greedy_equals_jax_and_plain(setup, window):
    jp, tp, ids, pixels = setup
    kw = dict(max_new_tokens=12, temperature=0.0, eos_token_id=None)
    plain = tchat.generate(tp, TCFG, ids, pixels, device="cpu", **kw)
    stats = {}
    got, want = _both(jp, tp, ids, pixels, speculative=window, **kw)
    assert got == want == plain
    assert all(len(r) == 12 for r in got)
    timings = {}
    tchat.generate(tp, TCFG, ids, pixels, device="cpu", speculative=window, spec_stats=stats,
                   timings=timings, **kw)
    assert stats["tokens"] == 24
    assert timings["decode_steps"] == stats["iterations"] <= 12


def test_spec_greedy_with_eos(setup):
    """An EOS from row 0's own chain stops it early; row 1 runs on."""
    jp, tp, ids, pixels = setup
    full = tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=12, temperature=0.0,
                          eos_token_id=None, device="cpu")
    eos = full[0][5]
    kw = dict(max_new_tokens=12, temperature=0.0, eos_token_id=eos)
    plain = tchat.generate(tp, TCFG, ids, pixels, device="cpu", **kw)
    assert len(plain[0]) <= 5
    for window in (2, 4):
        got, want = _both(jp, tp, ids, pixels, speculative=window, **kw)
        assert got == want == plain


@pytest.mark.parametrize("window", [2, 4])
def test_spec_greedy_int8_kv(setup, window):
    jp, tp, ids, pixels = setup
    kw = dict(max_new_tokens=10, temperature=0.0, eos_token_id=None, kv_quant=True)
    plain = tchat.generate(tp, TCFG, ids, pixels, device="cpu", **kw)
    got, want = _both(jp, tp, ids, pixels, speculative=window, **kw)
    assert got == want == plain


def test_spec_greedy_int4_and_int8_kv():
    """--quant int4 --kv_cache int8 at K4's widths (K4's plain version on
    the CPU, the JAX kernel in interpret mode)."""
    jc = dataclasses.replace(JCFG, llama=jcfg.LlamaConfig(**_ALIGNED),
                             projector=dataclasses.replace(JCFG.projector, output_dim=256))
    tc = dataclasses.replace(TCFG, llama=tcfg.LlamaConfig(**_ALIGNED),
                             projector=dataclasses.replace(TCFG.projector, output_dim=256))
    jp = _np_tree(jchat.init_eventchat_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, tc, torch.float32, CPU)
    jp["llama"] = jquant.quantize_llama_params(jp["llama"], host=True, bits=4)
    tp["llama"] = llama_params_from_jax(jp["llama"], tc.llama, torch.float32, CPU)
    assert tquant.is_quantized4(tp["llama"]["lm_head"])
    rng = np.random.default_rng(1)
    size = jc.vision.image_size
    pixels = rng.standard_normal((2, jc.num_event_frames, 3, size, size)).astype(np.float32)
    ids = [[3, 4, EVENT_TOKEN_INDEX, 5, 3, 4], rng.integers(3, 128, 6).tolist()
           + [EVENT_TOKEN_INDEX] + [9, 9]]
    kw = dict(max_new_tokens=8, temperature=0.0, eos_token_id=None, kv_quant=True)
    plain = tchat.generate(tp, tc, ids, pixels, device="cpu", **kw)
    got, want = _both(jp, tp, ids, pixels, jc, tc, speculative=4, **kw)
    assert got == want == plain


def test_spec_acceptance_on_repetitive_chain():
    """Zero weights: a constant greedy chain that the lookup drafts in full,
    so the iterations drop to ~budget / window, as in the JAX package."""
    zp = _np_tree(jax.tree_util.tree_map(
        jnp.zeros_like, jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0))))
    tp = params_from_jax(zp, TCFG, torch.float32, CPU)
    pixels = np.zeros((1, JCFG.num_event_frames, 3, 28, 28), np.float32)
    stats = {}
    out = tchat.generate(tp, TCFG, [[1, 5, EVENT_TOKEN_INDEX, 9]], pixels, max_new_tokens=16,
                         temperature=0.0, eos_token_id=None, speculative=4, spec_stats=stats,
                         device="cpu")[0]
    assert out == [0] * 16
    assert stats["iterations"] <= 6 and stats["tokens"] == 16


def test_spec_validation(setup):
    _, tp, ids, pixels = setup
    with pytest.raises(ValueError, match="num_beams"):
        tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=2, num_beams=2, speculative=2,
                       device="cpu")


# ---- sampled speculation ---------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_spec_commit_sampled_accepts_like_jax(seed):
    """The accepted count depends on (p, drafts, u) only: equal to JAX's
    for the same arrays, fillers and windows 1 to 5 included; the
    correction lies in the support of the distribution it is drawn from."""
    rng = np.random.default_rng(seed)
    b, v = 64, 12
    for w in range(1, 6):
        p = rng.dirichlet(np.full(v, 0.3), size=(b, w)).astype(np.float32)
        # Drafts mostly at each position's mode, so acceptance runs deep.
        drafts = np.where(rng.random((b, w - 1)) < 0.7, p[:, :-1].argmax(-1),
                          rng.integers(-1, v, (b, w - 1))).astype(np.int32)
        u = rng.random((b, w - 1)).astype(np.float32)
        ja, _ = jchat._spec_commit_sampled(jnp.asarray(p), jnp.asarray(drafts), jnp.asarray(u),
                                           jax.random.PRNGKey(seed))
        ta, tc = tchat._spec_commit_sampled(torch.from_numpy(p), torch.from_numpy(drafts),
                                            torch.from_numpy(u),
                                            torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        p_at = p[np.arange(b), ta.numpy()]
        assert (p_at[np.arange(b), tc.numpy()] > 0).all()


def test_spec_commit_sampled_oracle():
    """The JAX package's hand-made cases (tests/test_speculative.py)."""
    v = 8
    g = torch.Generator().manual_seed(0)
    onehot = lambda t: np.eye(v, dtype=np.float32)[t]  # noqa: E731

    def run(rows, drafts, u):
        p = torch.from_numpy(np.asarray(rows, np.float32)[None])
        a, c = tchat._spec_commit_sampled(p, torch.tensor([drafts], dtype=torch.int32),
                                          torch.tensor([u]), g)
        return int(a[0]), int(c[0])

    assert run([onehot(3), onehot(5), onehot(6), onehot(2)], [3, 5, 6], [0.9] * 3) == (3, 2)
    p0 = 0.5 * onehot(1) + 0.5 * onehot(4)
    p0[4] = 0.0
    assert run([p0, onehot(0), onehot(0), onehot(0)], [4, 0, 0], [0.0] * 3) == (0, 1)
    assert run([onehot(1)] * 4, [-1, -1, -1], [0.0] * 3) == (0, 1)
    p1 = 0.6 * onehot(2) + 0.4 * onehot(7)
    assert run([onehot(5), p1, onehot(0), onehot(0)], [5, 7, 0], [0.5] * 3) == (1, 2)


def test_spec_commit_sampled_is_unbiased():
    """The first committed token of a window is distributed as p0 whatever
    the point-mass draft: 20k vectorized windows against the marginal, the
    JAX package's bar (L1 < 0.05)."""
    v, w, n = 8, 3, 20000
    rng = np.random.default_rng(0)
    p0 = rng.dirichlet(np.ones(v)).astype(np.float32)
    p1 = rng.dirichlet(np.ones(v)).astype(np.float32)
    p = torch.from_numpy(np.broadcast_to(np.stack([p0, p1, p1]), (n, w, v)).copy())
    g = torch.Generator().manual_seed(1)
    for draft_tok in (int(np.argmax(p0)), int(np.argmin(p0))):
        drafts = torch.full((n, w - 1), draft_tok, dtype=torch.int32)
        u = torch.rand((n, w - 1), generator=g)
        a, corrected = tchat._spec_commit_sampled(p, drafts, u, g)
        first = np.where(a.numpy() >= 1, draft_tok, corrected.numpy())
        l1 = np.abs(np.bincount(first, minlength=v) / n - p0).sum()
        assert l1 < 0.05, f"draft {draft_tok}: L1 {l1:.3f}"


def test_spec_sampled_budget_eos_and_seed(setup):
    """Sampled speculation: the first token is the plain sampled one (the
    same generator draw), a seed repeats its chain, the budget is filled
    without an EOS, an EOS taken from the chain stops it, and every id is
    in the vocab."""
    _, tp, ids, pixels = setup
    kw = dict(max_new_tokens=10, temperature=0.7, top_p=0.9, seed=3, device="cpu")
    out = tchat.generate(tp, TCFG, ids, pixels, eos_token_id=None, speculative=4, **kw)
    assert out == tchat.generate(tp, TCFG, ids, pixels, eos_token_id=None, speculative=4, **kw)
    plain = tchat.generate(tp, TCFG, ids, pixels, eos_token_id=None, **kw)
    assert [r[0] for r in out] == [r[0] for r in plain]
    assert all(len(r) == 10 and all(0 <= t < 128 for t in r) for r in out)
    eos = out[0][4]
    stopped = tchat.generate(tp, TCFG, ids, pixels, eos_token_id=eos, speculative=4, **kw)
    assert stopped[0] == out[0][:out[0].index(eos)]


# ---- the CLI -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def event_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spec_cli") / "events.npy")
    np.save(path, synthetic_event_stream(8, n_events=20_000))
    return path


def test_cli_speculative_prints_the_greedy_answer(event_path):
    common = ["--model_path", "tiny-random", "--event_frame", event_path, "--query", "What?",
              "--temperature", "0", "--max_new_tokens", "8", "--dtype", "float32",
              "--device", "cpu"]
    plain = infer.main(common)
    assert infer.main(common + ["--speculative", "4"]) == plain
