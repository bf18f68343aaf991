"""Model modules of the PyTorch port against the JAX package, at f32 on the CPU.

The JAX package's random parameters pass through ``params_from_jax``; the
same numpy inputs go through both. Both sides compute in f32 (JAX at
``highest`` matmul precision, pinned by conftest), so they differ only in
the order of f32 sums: atol 1e-4 on activations of order 1, the bar the
JAX package holds against HF (tests/test_eventchat.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.data.tokenizer import split_at_event as j_split
from eventgpt_tpu.models import clip as jclip
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.models import llama as jllama
from eventgpt_tpu.models import projector as jproj
from eventgpt_tpu.ops.pooling import spatio_temporal_pool as j_pool
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX
from eventgpt_tpu_torch.data.tokenizer import split_at_event
from eventgpt_tpu_torch.models import clip as tclip
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models import projector as tproj
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops.pooling import spatio_temporal_pool

ATOL = 1e-4
JCFG = jcfg.EventChatConfig.tiny(vocab_size=128)
TCFG = tcfg.EventChatConfig.tiny(vocab_size=128)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    jp = _np_tree(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=1e-4)


def _pixels(rng, n):
    size = JCFG.vision.image_size
    return rng.standard_normal((n, 3, size, size)).astype(np.float32)


def test_clip_encode(params):
    jp, tp = params
    px = _pixels(np.random.default_rng(0), 3)
    _close(tclip.clip_encode(tp["clip"], TCFG.vision, torch.from_numpy(px)),
           jclip.clip_encode(jp["clip"], JCFG.vision, jnp.asarray(px)))


def test_projector_adaptor_and_pool(params):
    jp, tp = params
    feats = np.random.default_rng(1).standard_normal((5, 7, 32)).astype(np.float32)
    j = jproj.apply_adaptor(jp["projector"], jproj.apply_projector(jp["projector"], jnp.asarray(feats)))
    t = tproj.apply_adaptor(tp["projector"], tproj.apply_projector(tp["projector"], torch.from_numpy(feats)))
    _close(t, j)
    for n_tt in (None, 3, 8):
        _close(spatio_temporal_pool(t, n_tt), j_pool(j, n_tt))


def test_encode_events_batch(params):
    jp, tp = params
    px = _pixels(np.random.default_rng(2), 2 * JCFG.num_event_frames).reshape(
        (2, JCFG.num_event_frames) + (3, JCFG.vision.image_size, JCFG.vision.image_size))
    t = tchat.encode_events_batch(tp, TCFG, torch.from_numpy(px))
    assert t.shape == (2, TCFG.num_event_tokens, TCFG.llama.hidden_size)
    _close(t, jchat.encode_events_batch(jp, JCFG, jnp.asarray(px)))


def test_splice_embeddings_and_pad(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 128, 7).tolist() + [EVENT_TOKEN_INDEX] + rng.integers(3, 128, 5).tolist()
    evt = rng.standard_normal((TCFG.num_event_tokens, TCFG.llama.hidden_size)).astype(np.float32)
    t = tchat.splice_embeddings(tp, TCFG, split_at_event(ids), torch.from_numpy(evt))
    j = jchat.splice_embeddings(jp, JCFG, j_split(ids), jnp.asarray(evt))
    assert t.shape == (7 + TCFG.num_event_tokens + 5, TCFG.llama.hidden_size)
    _close(t, j, atol=0)
    # Text overflow truncates like the reference ...
    limit = 7 + TCFG.num_event_tokens + 2
    _close(tchat.splice_embeddings(tp, TCFG, split_at_event(ids), torch.from_numpy(evt), limit),
           jchat.splice_embeddings(jp, JCFG, j_split(ids), jnp.asarray(evt), limit), atol=0)
    # ... and a cut inside the event block raises.
    with pytest.raises(ValueError, match="inside an event block"):
        tchat.splice_embeddings(tp, TCFG, split_at_event(ids), torch.from_numpy(evt), 12)
    padded, mask, lens = tchat._pad_batch([t, t[:9]])
    j_padded, j_mask, j_lens = jchat._pad_batch([j, j[:9]])
    _close(padded, j_padded, atol=0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(lens, j_lens)


# A head_dim-128 LM, the only head dim the flash kernel takes.
J_LM = jcfg.LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=256, num_layers=2,
                        num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
T_LM = tcfg.LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=256, num_layers=2,
                        num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)


@pytest.fixture(scope="module")
def lm_params():
    from eventgpt_tpu_torch.models.convert import llama_params_from_jax

    jp = _np_tree(jllama.init_llama_params(J_LM, jax.random.PRNGKey(1)))
    return jp, llama_params_from_jax(jp, T_LM, torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_llama_prefill_and_decode(lm_params, attn_impl):
    jp, tp = lm_params
    jc = dataclasses.replace(J_LM, attn_impl=attn_impl)
    tc = dataclasses.replace(T_LM, attn_impl=attn_impl)
    rng = np.random.default_rng(4)
    b, t, max_len = 2, 130, 192  # unaligned T, right padding on row 1
    embeds = (rng.standard_normal((b, t, 256)) * 0.5).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [100]])

    j_cache = jllama.init_kv_cache(jc, b, max_len, dtype=jnp.float32)
    j_logits, j_cache = jllama.prefill(jp, jc, jnp.asarray(embeds), jnp.asarray(mask), j_cache)
    t_cache = tllama.init_kv_cache(tc, b, max_len, dtype=torch.float32)
    t_logits, t_cache = tllama.prefill(tp, tc, torch.from_numpy(embeds), torch.from_numpy(mask), t_cache)
    # Real positions only: padded rows differ by construction between the
    # dense mask and flash's zeroed padded queries.
    np.testing.assert_allclose(t_logits.numpy()[mask], np.asarray(j_logits)[mask], atol=5e-4, rtol=1e-3)
    _close(t_cache["k"][:, :, :t], j_cache["k"][:, :, :t])
    np.testing.assert_array_equal(t_cache["length"].numpy(), np.asarray(j_cache["length"]))

    tl_last, _ = tllama.prefill(tp, tc, torch.from_numpy(embeds), torch.from_numpy(mask),
                                tllama.init_kv_cache(tc, b, max_len, dtype=torch.float32),
                                last_only=True)
    _close(tl_last, np.asarray(j_logits)[np.arange(b), mask.sum(1) - 1], atol=5e-4)

    tok = rng.standard_normal((b, 1, 256)).astype(np.float32)
    j_step, j_cache = jllama.decode_step(jp, jc, jnp.asarray(tok), j_cache)
    t_step, t_cache = tllama.decode_step(tp, tc, torch.from_numpy(tok), t_cache)
    assert t_step.dtype == torch.float32
    _close(t_step, j_step, atol=5e-4)
    np.testing.assert_array_equal(t_cache["length"].numpy(), np.asarray(j_cache["length"]))


def test_rms_norm_and_rope_keep_dtype():
    x = torch.randn(2, 3, 4, 128, dtype=torch.bfloat16)
    cos, sin = tllama.rope_tables(T_LM, torch.arange(3)[None].expand(2, 3))
    assert cos.dtype == torch.float32
    assert tllama.apply_rope(x, cos, sin).dtype == torch.bfloat16
    assert tllama.rms_norm(x, torch.ones(128, dtype=torch.bfloat16), 1e-5).dtype == torch.bfloat16
