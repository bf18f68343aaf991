"""Medusa-head training in the port against the JAX package, f32 on the CPU.

- ``medusa_loss`` and its per-head values within 1e-5 of the JAX
  ``medusa_loss``, with IGNORE_INDEX labels, a head whose targets are all
  ignored and a head with no position in range (both 0.0, not NaN); its
  gradient within 1e-5 of ``jax.grad``'s.
- Two head steps from the zero stack, ``optax.adamw(lr)`` against the
  port's ``make_adamw(lr)``: loss, per-head loss, grad norm and the updated
  stack within 1e-5 of ``make_medusa_train_step``'s.
- At width (d = 1024, vocab 32000, one layer), four head steps of
  ``optax.adamw(1e-3)``, the JAX scripts' LR, against the port's: the
  losses agree per step within 1e-5 and fall alike.
- The port's counterpart of tests/test_medusa.py::
  test_medusa_training_learns_fixed_continuation.
- ``scripts/train_medusa`` end to end on the CPU (``--quant none`` and
  ``int8``): the npz loads through the JAX ``load_medusa`` to the stack the
  port holds, and the loaded heads keep the greedy chain; ``--quant int4``
  raises before anything loads.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.models import medusa as jmedusa
from eventgpt_tpu.train import data as jdata
from eventgpt_tpu.train import medusa as jtrain
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import medusa as tmedusa
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.scripts import train_medusa
from eventgpt_tpu_torch.train import medusa as ttrain
from eventgpt_tpu_torch.train.optim import AdamW
from eventgpt_tpu_torch.train.steps import batch_to_device

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
ATOL = 1e-5
IGNORE = -100


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _heads(k, seed=3, scale=0.1):
    d = JCFG.llama.hidden_size
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (k, d, d)) * scale,
                      np.float32)


def _loss_inputs(t=6, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((2, t, JCFG.llama.hidden_size)).astype(np.float32)
    labels = rng.integers(0, JCFG.llama.vocab_size, (2, t)).astype(np.int32)
    labels[0, :2] = IGNORE
    labels[1, 3] = IGNORE
    return hidden, labels


@pytest.mark.parametrize("case", ["masked", "all_ignored_head", "head_out_of_range"])
def test_medusa_loss_and_gradient_match_jax(trees, case):
    jp, tp = trees
    k, t = 3, 6
    hidden, labels = _loss_inputs(t)
    if case == "all_ignored_head":
        labels[:, 4:] = IGNORE       # head 2 (offset 4) sees only ignored targets
    if case == "head_out_of_range":
        k, t = 4, 4                  # heads 2 and 3 (offsets 4, 5) have no position
        hidden, labels = hidden[:, :t], labels[:, :t]
    w = _heads(k)

    def jloss(wj):
        return jmedusa.medusa_loss(jp["llama"], {"w": wj}, jnp.asarray(hidden),
                                   jnp.asarray(labels), ignore_index=IGNORE)

    (j_sum, j_per), j_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w))
    tw = torch.from_numpy(w.copy()).requires_grad_(True)
    t_sum, t_per = tmedusa.medusa_loss(tp["llama"], {"w": tw}, torch.from_numpy(hidden),
                                       torch.from_numpy(labels), ignore_index=IGNORE)
    (t_grad,) = torch.autograd.grad(t_sum, [tw])
    t_sum, t_per = t_sum.detach(), t_per.detach()
    assert t_per.shape == (k,) and t_per.dtype == torch.float32
    assert torch.isfinite(t_per).all()
    np.testing.assert_allclose(t_per.numpy(), np.asarray(j_per), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(t_sum), float(j_sum), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), atol=ATOL, rtol=0)
    if case == "all_ignored_head":
        assert float(t_per[2]) == 0.0
    if case == "head_out_of_range":
        assert float(t_per[2]) == float(t_per[3]) == 0.0
        assert not torch.any(t_grad[2:] != 0)


def _batch(seed=1, b=2, seq=48):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    pix = rng.standard_normal((b, JCFG.num_event_frames, 3, size, size)).astype(np.float32)
    batch = jdata.synthetic_multimodal_batch(JCFG, b, seq, event_offset=5, pixel_values=pix,
                                             mask_event_labels=True)
    batch["token_ids"] = rng.integers(3, JCFG.llama.vocab_size, (b, seq)).astype(np.int32)
    batch["labels"] = np.where(batch["event_pos"], IGNORE, batch["token_ids"]).astype(np.int32)
    batch["attn_mask"][1, seq - 7:] = False
    batch["labels"][1, seq - 7:] = IGNORE
    return batch


def test_head_steps_match_jax_adamw(trees):
    jp, tp = trees
    lr = 1e-2
    batches = [_batch(1), _batch(2)]
    opt = optax.adamw(lr)
    jstate = jtrain.init_medusa_state(JCFG, jp, 3, opt)
    jstep = jtrain.make_medusa_train_step(JCFG, opt, donate=False)
    topt = ttrain.make_adamw(lr)
    tstate = ttrain.init_medusa_state(TCFG, tp, 3, topt)
    assert tstate.trainable["w"].shape == (3, 64, 64) and not tstate.trainable["w"].any()
    tstep = ttrain.make_medusa_train_step(TCFG, topt)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch_to_device(batch, "cpu"))
        where = f"step {i + 1}"
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=ATOL, rtol=0,
                                   err_msg=where)
        np.testing.assert_allclose(tm["per_head_loss"].numpy(), np.asarray(jm["per_head_loss"]),
                                   atol=ATOL, rtol=0, err_msg=where)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), atol=ATOL,
                                   rtol=1e-5, err_msg=where)
        np.testing.assert_allclose(tstate.trainable["w"].numpy(),
                                   np.asarray(jstate.trainable["w"]), atol=ATOL, rtol=0,
                                   err_msg=where)
    assert tstate.step == int(jstate.step) == 2
    assert tstate.trainable["w"].any() and not tstate.trainable["w"].requires_grad


def _wide(c, d=1024, vocab=32000):
    llama = dataclasses.replace(c.llama, hidden_size=d, intermediate_size=2 * d, num_layers=1,
                                num_heads=d // 64, num_kv_heads=d // 64, vocab_size=vocab)
    return dataclasses.replace(c, llama=llama,
                               projector=dataclasses.replace(c.projector, output_dim=d))


def test_head_steps_at_width_match_jax_adamw():
    """The head step at d = 1024 over the 7B's vocabulary, at the JAX
    scripts' LR: the per-step losses and grad norms of the two packages
    agree, and fall alike. Adam's first update is lr * g / (|g| + 1e-8),
    so entries whose gradient is ~1e-8 take a step set by the last bits of
    the sum (2.8e-4 of the stack's norm after the first step): the stacks
    are held within 1e-3 of it, by their relative Frobenius difference."""
    jc, tc = _wide(JCFG), _wide(TCFG)
    jp = jax.tree_util.tree_map(np.asarray, jchat.init_eventchat_params(jc, jax.random.PRNGKey(5)))
    tp = params_from_jax(jp, tc, torch.float32, "cpu")
    lr = 1e-3
    opt = optax.adamw(lr)
    jstate = jtrain.init_medusa_state(jc, jp, 3, opt)
    jstep = jtrain.make_medusa_train_step(jc, opt, donate=False)
    topt = ttrain.make_adamw(lr)
    tstate = ttrain.init_medusa_state(tc, tp, 3, topt)
    tstep = ttrain.make_medusa_train_step(tc, topt)
    per_head = []
    for i in range(4):
        batch = _batch(1 + i % 2)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch_to_device(batch, "cpu"))
        where = f"step {i + 1}"
        np.testing.assert_allclose(tm["per_head_loss"].numpy(), np.asarray(jm["per_head_loss"]),
                                   atol=ATOL, rtol=0, err_msg=where)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), atol=ATOL,
                                   rtol=1e-5, err_msg=where)
        jw = np.asarray(jstate.trainable["w"])
        rel = np.linalg.norm(tstate.trainable["w"].numpy() - jw) / np.linalg.norm(jw)
        assert rel <= 1e-3, (where, rel)
        per_head.append((tm["per_head_loss"].numpy(), np.asarray(jm["per_head_loss"])))
    print("per-head loss, port | JAX, first and last step:", per_head[0], per_head[-1])
    for pkg in (0, 1):
        assert (per_head[-1][pkg] < per_head[0][pkg]).all(), per_head


def test_medusa_training_learns_fixed_continuation(trees):
    """A few steps on a repetitive target drop the head loss well below the
    identity start; only the head stack moves (``optax.adam(3e-3)``: no
    decay, no clipping)."""
    _, tp = trees
    opt = AdamW(lambda count: 3e-3, weight_decay=0.0, grad_clip=None)
    state = ttrain.init_medusa_state(TCFG, tp, num_heads=3, optimizer=opt)
    step = ttrain.make_medusa_train_step(TCFG, opt)
    rng = np.random.default_rng(0)
    size = JCFG.vision.image_size
    pv = rng.normal(size=(2, JCFG.num_event_frames, 3, size, size)).astype(np.float32)
    host = jdata.synthetic_multimodal_batch(JCFG, 2, 48, pixel_values=pv)
    lab = np.asarray(host["labels"]).copy()
    pattern = np.resize([7, 9, 11, 13], lab.shape[1])
    host["labels"] = np.where(lab >= 0, pattern[None, :], lab).astype(np.int32)
    batch = batch_to_device(host, "cpu")
    frozen_before = {name: t.clone() for name, t in (("lm_head", tp["llama"]["lm_head"]),
                                                     ("embed", tp["llama"]["embed_tokens"]))}
    state, m0 = step(state, batch)
    first = float(m0["loss"])
    for _ in range(24):
        state, m = step(state, batch)
    last = float(m["loss"])
    assert np.isfinite(first) and np.isfinite(last)
    assert last < 0.5 * first, (first, last)
    assert m["per_head_loss"].shape == (3,)
    assert torch.equal(frozen_before["lm_head"], tp["llama"]["lm_head"])
    assert torch.equal(frozen_before["embed"], tp["llama"]["embed_tokens"])
    assert not any(t.requires_grad for t in (tp["llama"]["lm_head"], state.trainable["w"]))


def _toy_dataset(tmp_path):
    np.save(tmp_path / "ev.npy", synthetic_event_stream(3, n_events=5000))
    qa = tmp_path / "qa.json"
    qa.write_text(json.dumps([
        {"id": i, "event": "ev.npy",
         "conversations": [{"from": "human", "value": "<event>\nDescribe the scene."},
                           {"from": "gpt", "value": "The scene depicts a person holding a fish."}]}
        for i in range(4)]))
    return str(qa)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_train_medusa_cli_end_to_end(tmp_path, trees, quant, capsys):
    qa = _toy_dataset(tmp_path)
    out = str(tmp_path / "medusa.npz")
    last = train_medusa.main([
        "--model_path", "tiny-random", "--data_path", qa, "--event_folder", str(tmp_path),
        "--num_heads", "3", "--max_steps", "6", "--batch_size", "2", "--logging_steps", "3",
        "--quant", quant, "--out", out, "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines] == [3, 6] and lines[-1] == last
    assert sorted(last) == ["grad_norm", "loss", "per_head", "s_per_step", "step"]
    assert np.isfinite(last["loss"]) and len(last["per_head"]) == 3
    loaded = jmedusa.load_medusa(out)
    back = tmedusa.load_medusa(out, device="cpu")
    assert loaded["w"].shape == (3, 64, 64) and np.asarray(loaded["w"]).any()
    np.testing.assert_array_equal(np.asarray(loaded["w"]), back["w"].numpy())
    # Any heads keep the chain: the loaded stack drafts for the tiny tree.
    _, tp = trees
    rng = np.random.default_rng(0)
    size = JCFG.vision.image_size
    pv = rng.normal(size=(1, JCFG.num_event_frames, 3, size, size)).astype(np.float32)
    ids = [[1, 5, -200, 9]]
    plain = tchat.generate(tp, TCFG, ids, pv, max_new_tokens=6, temperature=0.0, device="cpu")
    got = tchat.generate(tp, TCFG, ids, pv, max_new_tokens=6, temperature=0.0, speculative=4,
                         draft_head=back, device="cpu")
    assert got == plain


def test_train_medusa_refuses_int4(tmp_path):
    with pytest.raises(NotImplementedError, match="no gradient"):
        train_medusa.main(["--data_path", str(tmp_path / "missing.json"), "--quant", "int4",
                           "--device", "cpu"])
