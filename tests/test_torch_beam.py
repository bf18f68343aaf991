"""Beam search in the PyTorch port against the JAX package, at f32 on the CPU.

``eventchat._beam_loop`` against ``eventgpt_tpu``'s ``_beam_loop_jit`` on
the same prefilled cache (weights carried by ``params_from_jax``, inputs
from numpy seeds): the best beam's tokens and lengths are equal exactly,
with a dense f32 or an int8 cache, with the regather bounded below
(``gather_start``), and where candidates tie exactly, which ``lax.top_k``
breaks toward the lower index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.models import llama as jllama
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX, SEQ_BUCKET
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

JCFG = jcfg.EventChatConfig.tiny(vocab_size=128)
TCFG = tcfg.EventChatConfig.tiny(vocab_size=128)
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    jp = _np_tree(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, TCFG, torch.float32, CPU)


def _beams(jp, tp, embeds, lens, k, max_new, eos, quant=False, gather_start=0):
    """(port (tokens, lengths), JAX (tokens, lengths)) from the same prompt
    embeddings, each package prefilling its own cache."""
    b, t = embeds.shape[:2]
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    max_len = t + max_new + 8
    jc = jllama.init_kv_cache(JCFG.llama, b, max_len, dtype=jnp.float32, quant=quant)
    j_last, jc = jllama.prefill(jp["llama"], JCFG.llama, jnp.asarray(embeds), jnp.asarray(mask),
                                jc, last_only=True)
    j_tok, j_len = jchat._beam_loop_jit(jp, JCFG, j_last, jc, k, max_new, eos,
                                        gather_start=gather_start)
    tc = tllama.init_kv_cache(TCFG.llama, b, max_len, dtype=torch.float32, quant=quant)
    t_last, tc = tllama.prefill(tp["llama"], TCFG.llama, torch.from_numpy(embeds),
                                torch.from_numpy(mask), tc, last_only=True)
    t_tok, t_len, t_norm, steps = tchat._beam_loop(tp, TCFG, t_last, tc, k, max_new, eos,
                                                   gather_start=gather_start)
    assert 1 <= steps <= max_new and torch.isfinite(t_norm).all()
    return (t_tok.numpy(), t_len.numpy()), (np.asarray(j_tok), np.asarray(j_len))


def _embeds(tp, seed, b, t):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(3, 128, (b, t)))
    return tllama.embed_tokens(tp["llama"], ids).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("k,max_new", [(2, 6), (3, 8)])
def test_beam_loop_equals_jax(trees, k, max_new, quant):
    jp, tp = trees
    embeds = _embeds(tp, k, 2, 7)
    (t_tok, t_len), (j_tok, j_len) = _beams(jp, tp, embeds, [7, 4], k, max_new, eos=-1,
                                            quant=quant)
    np.testing.assert_array_equal(t_tok, j_tok)
    np.testing.assert_array_equal(t_len, j_len)


def test_beam_loop_with_eos_and_gather_start_equals_jax(trees):
    """Prompts past one SEQ_BUCKET regather only the tail [64, S); an EOS
    taken from the unconstrained best beam ends beams early."""
    jp, tp = trees
    t = SEQ_BUCKET + 6
    embeds = _embeds(tp, 9, 2, t)
    lens = [t, SEQ_BUCKET + 2]
    (free, _), _ = _beams(jp, tp, embeds, lens, 3, 8, eos=-1)
    eos = int(free[0, 2])
    for gather_start in (0, SEQ_BUCKET):
        (t_tok, t_len), (j_tok, j_len) = _beams(jp, tp, embeds, lens, 3, 8, eos=eos,
                                                gather_start=gather_start)
        np.testing.assert_array_equal(t_len, j_len)
        for row in range(2):  # tokens past a row's length are free in both
            np.testing.assert_array_equal(t_tok[row, :t_len[row]], j_tok[row, :j_len[row]])
    assert t_len[0] <= 3


def test_top_k_breaks_ties_like_lax():
    """Exact ties everywhere: the same k indices in the same order as
    ``lax.top_k``, the lower index first."""
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 3, (5, 40)).astype(np.float32)
    x[0] = 1.0  # one row all tied
    for k in (1, 3, 7):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tchat._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_beam_forced_tie_equals_jax():
    """Zero weights: every logit ties, so every candidate of every step
    ties; the beams are chosen by index order, as in the JAX package."""
    zp = _np_tree(jax.tree_util.tree_map(
        jnp.zeros_like, jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0))))
    tp = params_from_jax(zp, TCFG, torch.float32, CPU)
    embeds = _embeds(tp, 3, 2, 5)
    (t_tok, t_len), (j_tok, j_len) = _beams(zp, tp, embeds, [5, 3], 3, 5, eos=-1)
    np.testing.assert_array_equal(t_tok, j_tok)
    np.testing.assert_array_equal(t_len, j_len)
    assert t_tok[0].tolist() == [0] * 5


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    size = JCFG.vision.image_size
    pixels = rng.standard_normal((2, JCFG.num_event_frames, 3, size, size)).astype(np.float32)
    ids = [rng.integers(3, 128, 4).tolist() + [EVENT_TOKEN_INDEX] + rng.integers(3, 128, 3).tolist(),
           rng.integers(3, 128, 9).tolist() + [EVENT_TOKEN_INDEX] + rng.integers(3, 128, 6).tolist()]
    return ids, pixels


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8kv"])
def test_beam_generate_equals_jax(trees, prompts, kv_quant):
    """Through ``generate``: batch 2 with right padding; an EOS drops the
    beam's trailing EOS from the answer, as the JAX package does."""
    jp, tp = trees
    ids, pixels = prompts
    kw = dict(max_new_tokens=6, eos_token_id=None, num_beams=3, kv_quant=kv_quant)
    want = jchat.generate(jp, JCFG, ids, pixels, **kw)
    timings = {}
    got = tchat.generate(tp, TCFG, ids, pixels, device="cpu", timings=timings, **kw)
    assert got == want and all(len(r) == 6 for r in got)
    assert timings["decode_steps"] == 6
    kw["eos_token_id"] = want[1][2]
    want = jchat.generate(jp, JCFG, ids, pixels, **kw)
    got = tchat.generate(tp, TCFG, ids, pixels, device="cpu", **kw)
    assert got == want
    assert all(kw["eos_token_id"] not in r for r in got)


def test_beam1_equals_greedy(trees, prompts):
    _, tp = trees
    ids, pixels = prompts
    kw = dict(max_new_tokens=6, temperature=0.0, eos_token_id=2, device="cpu")
    assert (tchat.generate(tp, TCFG, ids, pixels, num_beams=1, **kw)
            == tchat.generate(tp, TCFG, ids, pixels, **kw))


def test_beam_validation(trees, prompts):
    _, tp = trees
    ids, pixels = prompts
    with pytest.raises(ValueError, match="num_beams"):
        tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=2, num_beams=0, device="cpu")


def test_cli_num_beams_runs(tmp_path):
    path = str(tmp_path / "events.npy")
    np.save(path, synthetic_event_stream(9, n_events=20_000))
    common = ["--model_path", "tiny-random", "--event_frame", path, "--query", "What?",
              "--max_new_tokens", "5", "--dtype", "float32", "--device", "cpu"]
    out = infer.main(common + ["--num_beams", "3"])
    assert isinstance(out, str)
    assert infer.main(common + ["--num_beams", "3", "--temperature", "0.9"]) == out
    with pytest.raises(ValueError, match="num_beams"):
        infer.main(common + ["--num_beams", "0"])
