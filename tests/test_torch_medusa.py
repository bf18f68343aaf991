"""Medusa draft heads in the PyTorch port against the JAX package, at f32
on the CPU.

Verification makes any draft exact, so random (untrained) heads must keep
the greedy chain token for token; head stacks are carried from the JAX
package by ``medusa_from_jax`` (drawn there with ``jax.random``, as
tests/test_medusa.py draws them). Head products and logits are f32 sums of
the same terms in another order: atol 1e-4 on logits of order 1 (the bar
of tests/test_torch_models.py); chains and npz arrays are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.models import medusa as jmedusa
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import medusa as tmedusa
from eventgpt_tpu_torch.models.convert import medusa_from_jax, params_from_jax
from eventgpt_tpu_torch.ops.quant import matmul_f32_out
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

JCFG = jcfg.EventChatConfig.tiny(vocab_size=128)
TCFG = tcfg.EventChatConfig.tiny(vocab_size=128)
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_heads(k, seed=3, scale=0.5):
    """The JAX package's test heads: normal (k, D, D) times ``scale``."""
    d = JCFG.llama.hidden_size
    return {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (k, d, d)) * scale)}


@pytest.fixture(scope="module")
def setup():
    jp = _np_tree(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    tp = params_from_jax(jp, TCFG, torch.float32, CPU)
    rng = np.random.default_rng(0)
    size = JCFG.vision.image_size
    pixels = rng.normal(size=(2, JCFG.num_event_frames, 3, size, size)).astype(np.float32)
    ids = [[1, 5, EVENT_TOKEN_INDEX, 9, 9], [3, EVENT_TOKEN_INDEX, 11, 4, 7]]
    return jp, tp, ids, pixels


def test_zero_heads_give_the_base_logits(setup):
    _, tp, _, _ = setup
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32))
    heads = tmedusa.init_medusa_params(TCFG.llama, 4, device="cpu")
    assert tmedusa.num_draft_heads(heads) == 4
    got = tmedusa.medusa_logits(tp["llama"], heads, x)
    base = matmul_f32_out(x, tp["llama"]["lm_head"])
    assert got.shape == (3, 4, 128)
    torch.testing.assert_close(got, base[:, None, :].expand_as(got), rtol=1e-5, atol=0)


def test_head_logits_and_drafts_match_jax(setup):
    jp, tp, _, _ = setup
    jh = _random_heads(3)
    th = medusa_from_jax(jh, torch.float32, CPU)
    x = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)
    for k in (None, 1, 3):
        want = jmedusa.medusa_logits(jp["llama"], jh, jnp.asarray(x), k)
        got = tmedusa.medusa_logits(tp["llama"], th, torch.from_numpy(x), k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    want = jmedusa.medusa_drafts(jp["llama"], jh, jnp.asarray(x), 2)
    got = tmedusa.medusa_drafts(tp["llama"], th, torch.from_numpy(x), 2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [2, 4])
def test_random_heads_keep_the_greedy_chain(setup, window):
    jp, tp, ids, pixels = setup
    jh = _random_heads(window - 1)
    kw = dict(max_new_tokens=8, temperature=0.0)
    plain = tchat.generate(tp, TCFG, ids, pixels, device="cpu", **kw)
    want = jchat.generate(jp, JCFG, ids, pixels, speculative=window, draft_head=jh, **kw)
    stats = {}
    got = tchat.generate(tp, TCFG, ids, pixels, device="cpu", speculative=window,
                         draft_head=medusa_from_jax(jh, torch.float32, CPU), spec_stats=stats,
                         **kw)
    assert got == want == plain
    assert 1 <= stats["iterations"] <= 8


def test_random_heads_exact_with_eos_and_int8_kv(setup):
    jp, tp, ids, pixels = setup
    full = tchat.generate(tp, TCFG, ids[:1], pixels[:1], max_new_tokens=12, temperature=0.0,
                          device="cpu")
    eos = full[0][4]
    kw = dict(max_new_tokens=12, temperature=0.0, eos_token_id=eos, kv_quant=True)
    plain = tchat.generate(tp, TCFG, ids[:1], pixels[:1], device="cpu", **kw)
    jh = _random_heads(2)
    want = jchat.generate(jp, JCFG, ids[:1], pixels[:1], speculative=3, draft_head=jh, **kw)
    got = tchat.generate(tp, TCFG, ids[:1], pixels[:1], device="cpu", speculative=3,
                         draft_head=medusa_from_jax(jh, torch.float32, CPU), **kw)
    assert got == want == plain
    assert len(got[0]) <= 4


def test_zero_heads_accept_a_constant_chain_in_full():
    zp = _np_tree(jax.tree_util.tree_map(
        jnp.zeros_like, jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0))))
    tp = params_from_jax(zp, TCFG, torch.float32, CPU)
    pixels = np.zeros((1, JCFG.num_event_frames, 3, 28, 28), np.float32)
    stats = {}
    out = tchat.generate(tp, TCFG, [[1, 5, EVENT_TOKEN_INDEX, 9]], pixels, max_new_tokens=16,
                         temperature=0.0, eos_token_id=None, speculative=4,
                         draft_head=tmedusa.init_medusa_params(TCFG.llama, 3, device="cpu"),
                         spec_stats=stats, device="cpu")[0]
    assert out == [0] * 16
    assert stats["iterations"] <= 6


def test_too_few_heads_raise(setup):
    _, tp, ids, pixels = setup
    heads = medusa_from_jax(_random_heads(2), torch.float32, CPU)
    with pytest.raises(ValueError, match="heads"):
        tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=4, speculative=4, draft_head=heads,
                       device="cpu")


def test_npz_round_trips_between_the_packages(tmp_path):
    jh = _random_heads(3, seed=7)
    jax_file = str(tmp_path / "jax_heads.npz")
    jmedusa.save_medusa(jax_file, jh)
    loaded = tmedusa.load_medusa(jax_file, device="cpu")
    np.testing.assert_array_equal(loaded["w"].numpy(), jh["w"])
    assert loaded["w"].dtype == torch.float32
    port_file = str(tmp_path / "port_heads.npz")
    tmedusa.save_medusa(port_file, medusa_from_jax(jh, torch.float32, CPU))
    np.testing.assert_array_equal(np.asarray(jmedusa.load_medusa(port_file)["w"]), jh["w"])
    bf16 = tmedusa.load_medusa(jax_file, dtype=torch.bfloat16, device="cpu")
    assert bf16["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16["w"].float().numpy(),
                                  torch.tensor(jh["w"]).bfloat16().float().numpy())


def test_cli_draft_head_prints_the_greedy_answer(tmp_path):
    path = str(tmp_path / "events.npy")
    np.save(path, synthetic_event_stream(10, n_events=20_000))
    heads = str(tmp_path / "heads.npz")
    g = torch.Generator().manual_seed(0)
    tmedusa.save_medusa(heads, {"w": torch.randn(3, 64, 64, generator=g) * 0.5})
    common = ["--model_path", "tiny-random", "--event_frame", path, "--query", "What?",
              "--temperature", "0", "--max_new_tokens", "8", "--dtype", "float32",
              "--device", "cpu"]
    plain = infer.main(common)
    assert infer.main(common + ["--speculative", "4", "--draft_head", heads]) == plain
    with pytest.raises(ValueError, match="heads"):
        infer.main(common + ["--speculative", "5", "--draft_head", heads])
