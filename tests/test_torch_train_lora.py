"""LoRA for training in the port: init, apply-form, merge and dropout.

- ``init_lora_params``: the JAX package's stacked shapes, A within its
  Kaiming-uniform bound, B zero, so the adapted model is the base model.
- ``apply_lora`` (composite leaves through ``ops/quant.matmul``) gives the
  logits ``merge_lora`` gives, within 1e-5, and at dropout 0 the logits of
  the JAX package's ``apply_lora`` on the same factors, within 1e-4 (the
  bar of tests/test_torch_models.py for activations of order 1).
- Dropout follows the rules of tests/test_lora_dropout.py: the base branch
  is never dropped, a mask is fixed by its (seed, step) key and changes
  with the step, no key means no mask state, and the recompute of a
  checkpointed layer draws its forward's masks (the gradients equal those
  of the same step without checkpointing). JAX's threefry masks are not
  reproduced, so there is no equality with the JAX package under dropout.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import llama as jllama
from eventgpt_tpu.train import lora as jlora
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models.convert import llama_params_from_jax, lora_from_jax
from eventgpt_tpu_torch.ops import quant
from eventgpt_tpu_torch.train import lora as tlora

JCFG = jcfg.LlamaConfig.tiny(vocab_size=96)
TCFG = dataclasses.replace(tcfg.LlamaConfig.tiny(vocab_size=96), remat=False)


@pytest.fixture(scope="module")
def base():
    jp = jax.tree_util.tree_map(np.asarray, jllama.init_llama_params(JCFG, jax.random.PRNGKey(0)))
    return jp, llama_params_from_jax(jp, TCFG, torch.float32, "cpu")


def _lora(seed, r=4, b_scale=0.05, targets=tlora.DEFAULT_TARGETS):
    gen = torch.Generator().manual_seed(seed)
    lp = tlora.init_lora_params(TCFG, tlora.LoraConfig(r=r, targets=targets), gen)
    g = torch.Generator().manual_seed(seed + 1)
    for group in lp.values():
        for ab in group.values():
            ab["b"] = b_scale * torch.randn(ab["b"].shape, generator=g)
    return lp


def _embeds(seed, b=2, t=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, TCFG.hidden_size)).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[1, 9:] = False
    return x, mask


def test_init_shapes_and_base_equality(base):
    _, tp = base
    lcfg = tlora.LoraConfig(r=4)
    lp = tlora.init_lora_params(TCFG, lcfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda: jlora.init_lora_params(JCFG, jlora.LoraConfig(r=4),
                                                            jax.random.PRNGKey(0)))
    for group, names in jshapes.items():
        for name, ab in names.items():
            for k in ("a", "b"):
                assert tuple(lp[group][name][k].shape) == ab[k].shape, (group, name, k)
            d_in = lp[group][name]["a"].shape[1]
            assert lp[group][name]["a"].abs().max() <= 1.0 / np.sqrt(d_in)
            assert not lp[group][name]["b"].any()
    x, mask = _embeds(1)
    xt, mt = torch.tensor(x), torch.tensor(mask)
    want = tllama.forward(tp, TCFG, xt, mt)
    got = tllama.forward(tlora.apply_lora(tp, lp, lcfg), TCFG, xt, mt)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="dropout"):
        tlora.LoraConfig(dropout=1.0)
    with pytest.raises(ValueError, match="dropout"):
        tlora.LoraConfig(dropout=-0.1)


@pytest.mark.parametrize("targets", [tlora.DEFAULT_TARGETS, ("q", "v")])
def test_apply_equals_merge_and_jax(base, targets):
    jp, tp = base
    lcfg = tlora.LoraConfig(r=4, alpha=8.0, targets=targets)
    lp = _lora(3, targets=targets)
    x, mask = _embeds(2)
    xt, mt = torch.tensor(x), torch.tensor(mask)
    applied = tllama.forward(tlora.apply_lora(tp, lp, lcfg), TCFG, xt, mt)
    merged = tllama.forward(tlora.merge_lora(tp, lp, lcfg), TCFG, xt, mt)
    np.testing.assert_allclose(applied.numpy(), merged.numpy(), atol=1e-5, rtol=0)
    jl = jax.tree_util.tree_map(lambda t: t.numpy(), lp)
    jeff = jlora.apply_lora(jp, jl, jlora.LoraConfig(r=4, alpha=8.0, targets=targets))
    want = jllama.forward(jeff, JCFG, x, mask)
    np.testing.assert_allclose(applied.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # The stacked tree converts as it is.
    back = lora_from_jax(jl, torch.float32, "cpu")
    assert all(torch.equal(back[g][n][k], lp[g][n][k])
               for g in lp for n in lp[g] for k in ("a", "b"))


def _q_leaf(tp, lp, lcfg, key):
    return tlora.apply_lora(tp, lp, lcfg, dropout_key=key)["layers"][0]["q_proj"]


def test_base_branch_never_dropped(base):
    _, tp = base
    lcfg = tlora.LoraConfig(r=4, dropout=0.9)
    zero = _lora(4, b_scale=0.0)
    for ab in zero["attn"].values():
        ab["a"] = torch.zeros_like(ab["a"])
    x = torch.randn(3, TCFG.hidden_size, generator=torch.Generator().manual_seed(2))
    leaf = _q_leaf(tp, zero, lcfg, (0, 7))
    assert "seed" in leaf
    assert torch.equal(quant.matmul(x, leaf), F.linear(x, tp["layers"][0]["q_proj"]))


def test_dropout_masks_fixed_per_key_and_vary_per_step(base):
    _, tp = base
    lcfg = tlora.LoraConfig(r=4, dropout=0.5)
    lp = _lora(5)
    x = torch.randn(3, TCFG.hidden_size, generator=torch.Generator().manual_seed(2))

    def q_out(key):
        return quant.matmul(x, _q_leaf(tp, lp, lcfg, key))

    clean = quant.matmul(x, _q_leaf(tp, lp, lcfg, None))
    a, b, c = q_out((0, 7)), q_out((0, 7)), q_out((0, 8))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, clean)
    assert "seed" not in _q_leaf(tp, lp, lcfg, None)
    # Each layer and target draws its own mask.
    seeds = {tlora.dropout_seed(0, 7, t, i) for t in range(7) for i in range(2)}
    assert len(seeds) == 14


def test_recompute_draws_the_forward_masks(base):
    _, tp = base
    lp = _lora(6)
    x, mask = _embeds(3)
    lcfg = tlora.LoraConfig(r=4, dropout=0.3)

    def grads(remat):
        cfg = dataclasses.replace(TCFG, remat=remat)
        leaves = [lp["attn"]["q"]["a"], lp["mlp"]["down"]["b"]]
        for t in leaves:
            t.requires_grad_(True)
        eff = tlora.apply_lora(tp, lp, lcfg, dropout_key=(0, 3))
        out = tllama.forward(eff, cfg, torch.tensor(x), torch.tensor(mask))
        return out, torch.autograd.grad(out.square().mean(), leaves)

    out_plain, g_plain = grads(False)
    out_remat, g_remat = grads(True)
    assert torch.equal(out_plain, out_remat)
    for a, b in zip(g_plain, g_remat):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, rtol=0)
