"""The dot-saving remat policies of the port's ``llama.forward`` against full
remat and against the JAX policies, f32 on the CPU.

- A stage-2 LoRA step (dense attention, and the flash path's plain version)
  under ``dots_saveable`` and ``dots_with_no_batch_dims_saveable`` gives
  full remat's loss, gradient norm and updated trainables bit for bit.
- The policies act: the backward pass dispatches fewer matmuls under them
  (``dots_saveable`` recomputes none of the layer's products,
  ``dots_with_no_batch_dims_saveable`` only the batched attention ones).
- Each policy's loss and gradient norm are within 1e-5 of the JAX step's
  under the same policy (the bar of ``tests/test_torch_train_steps.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import convert as jconv
from eventgpt_tpu.train import data as jdata
from eventgpt_tpu.train import optim as joptim
from eventgpt_tpu.train import steps as jsteps
from eventgpt_tpu.train.lora import LoraConfig as JLoraConfig
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.models import convert as tconv
from eventgpt_tpu_torch.train import optim as toptim
from eventgpt_tpu_torch.train import steps as tsteps
from eventgpt_tpu_torch.train.lora import LoraConfig

ATOL = 1e-5
POLICIES = ("full", "dots_saveable", "dots_with_no_batch_dims_saveable")
_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default}


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in _MATMULS
        return func(*args, **(kwargs or {}))


def _cfgs(policy, attn):
    jc = jcfg.EventChatConfig.tiny(vocab_size=264)
    jc = dataclasses.replace(jc, llama=dataclasses.replace(jc.llama, remat_policy=policy,
                                                           attn_impl=attn))
    return jc, tcfg.event_chat_config_from_dict(jcfg.to_dict(jc))


def _batch(jc, seed, b=2, seq=48):
    rng = np.random.default_rng(seed)
    size = jc.vision.image_size
    pix = rng.standard_normal((b, jc.num_event_frames, 3, size, size)).astype(np.float32)
    batch = jdata.synthetic_multimodal_batch(jc, b, seq, event_offset=5, pixel_values=pix,
                                             mask_event_labels=True)
    batch["token_ids"] = rng.integers(3, jc.llama.vocab_size, (b, seq)).astype(np.int32)
    batch["labels"] = np.where(batch["event_pos"], -100, batch["token_ids"]).astype(np.int32)
    batch["attn_mask"][1, seq - 7:] = False  # a padded row
    batch["labels"][1, seq - 7:] = -100
    return batch


@pytest.fixture(scope="module")
def jparams(tmp_path_factory):
    """One tiny tree in the JAX package's layout, drawn by the port and read
    back through a checkpoint (cheaper than the JAX initializer)."""
    jc, tc = _cfgs("full", "dense")
    d = str(tmp_path_factory.mktemp("remat") / "ckpt")
    tconv.write_hf_checkpoint(tconv.init_eventchat_params(
        tc, torch.Generator().manual_seed(1), torch.float32, "cpu"), tc, d)
    return jconv.eventchat_params_from_hf(jconv.load_state_dict(d), jc)


def _jax_trainable(jp, jc):
    """The JAX stage-2 split, with non-zero LoRA B so the adapters shape the
    loss from the first step."""
    jtr, jfz = jsteps.split_stage2(jp, jc, JLoraConfig(r=4, alpha=8.0), jax.random.PRNGKey(2))
    rng = np.random.default_rng(4)
    jtr = jax.tree_util.tree_map(np.asarray, jtr)
    jtr["lora"] = jax.tree_util.tree_map(
        lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32), jtr["lora"])
    return jtr, jfz


def _port_step(jp, policy, attn, batch, count=False):
    jc, tc = _cfgs(policy, attn)
    jtr, _ = _jax_trainable(jp, jc)
    tp = tconv.params_from_jax(jp, tc, torch.float32, "cpu")
    lcfg = LoraConfig(r=4, alpha=8.0)
    _, fz = tsteps.split_stage2(tp, tc, lcfg, torch.Generator().manual_seed(0))
    tr = {"projector": tconv.projector_params_from_jax(jtr["projector"], torch.float32, "cpu"),
          "lora": tconv.lora_from_jax(jtr["lora"], torch.float32, "cpu")}
    assert sorted(tr) == sorted(jtr)
    opt = toptim.make_optimizer(toptim.linear_warmup_cosine(2e-3, 4, 1, 1e-4, 0.0))
    state = tsteps.init_train_state(tr, fz, opt)
    step = tsteps.make_train_step(tc, opt, tsteps.make_stage2_combine(lcfg))
    counter = _CountMatmuls()
    if count:
        with counter:
            state, m = step(state, tsteps.batch_to_device(batch, "cpu"))
    else:
        state, m = step(state, tsteps.batch_to_device(batch, "cpu"))
    return m, state.trainable, counter.n


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_dot_policies_equal_full_remat_bit_for_bit(jparams, attn):
    jc, _ = _cfgs("full", attn)
    batch = _batch(jc, 11)
    runs = {p: _port_step(jparams, p, attn, batch, count=True) for p in POLICIES}
    m_full, tr_full, _ = runs["full"]
    for policy in POLICIES[1:]:
        m, tr, _ = runs[policy]
        assert torch.equal(m["loss"], m_full["loss"]), policy
        assert torch.equal(m["grad_norm"], m_full["grad_norm"]), policy
        for (path, a), (_, b) in zip(toptim.tree_leaves(tr), toptim.tree_leaves(tr_full)):
            assert torch.equal(a, b), (policy, path)
    n = {p: r[2] for p, r in runs.items()}
    assert n["dots_saveable"] < n["full"], n
    if attn == "dense":  # the batched attention products: recomputed by one policy only
        assert n["dots_saveable"] < n["dots_with_no_batch_dims_saveable"] < n["full"], n


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_each_policy_matches_the_jax_policy(jparams, policy):
    jc, _ = _cfgs(policy, "dense")
    batch = _batch(jc, 12)
    m, _, _ = _port_step(jparams, policy, "dense", batch)
    jtr, jfz = _jax_trainable(jparams, jc)
    opt = joptim.make_optimizer(joptim.linear_warmup_cosine(2e-3, 4, 1, 1e-4, 0.0))
    jstate = jsteps.init_train_state(jax.tree_util.tree_map(jnp.asarray, jtr),
                                     jax.tree_util.tree_map(jnp.asarray, jfz), opt)
    jstep = jsteps.make_train_step(jc, opt, jsteps.make_stage2_combine(JLoraConfig(r=4, alpha=8.0)),
                                   donate=False)
    _, jm = jstep(jstate, jsteps.batch_to_device(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= ATOL
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= ATOL
