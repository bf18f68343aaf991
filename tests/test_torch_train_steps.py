"""Training data and steps of the port against the JAX package, f32 on the CPU.

- ``preprocess_v1``/``preprocess_plain`` and ``collate_fixed_layout``: the
  same ids, labels and arrays as the JAX package's, exactly.
- ``multimodal_embeds`` within 1e-6 of the event block's largest value
  (text rows exactly), and ``lm_loss`` within 1e-6.
- A stage-1 step (projector + the Q-Former + the new embedding rows) and a
  stage-2 step (LoRA + projector, dropout 0, dense and flash attention),
  two steps each from the same state and batches, one case with gradient
  accumulation 2: loss, grad_norm and every updated trainable within 1e-5
  of the JAX ``make_train_step``'s.
- Remat on equals remat off, and a remat policy that saves dots equals
  full remat; a config whose remat fields came from a JAX ``config.json``
  round-trips.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.data.tokenizer import load_tokenizer as j_load_tokenizer
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.train import data as jdata
from eventgpt_tpu.train import optim as joptim
from eventgpt_tpu.train import steps as jsteps
from eventgpt_tpu.train.lora import LoraConfig as JLoraConfig
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer as t_load_tokenizer
from eventgpt_tpu_torch.models import convert as tconv
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.train import data as tdata
from eventgpt_tpu_torch.train import optim as toptim
from eventgpt_tpu_torch.train import steps as tsteps
from eventgpt_tpu_torch.train.lora import LoraConfig
from eventgpt_tpu_torch.train.trainer import tree_map

ATOL = 1e-5
LOSS_ATOL = 1e-6


def _cfgs(qformer=False, start_end=False, vocab=264):
    jc = jcfg.EventChatConfig.tiny(vocab_size=vocab)
    if qformer:
        jc = dataclasses.replace(jc, use_event_qformer=True,
                                 qformer=jcfg.QFormerConfig(num_queries=6, num_layers=1,
                                                            num_heads=4, hidden_size=64))
    jc = dataclasses.replace(jc, mm_use_im_start_end=start_end)
    return jc, tcfg.event_chat_config_from_dict(jcfg.to_dict(jc))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conversations(i):
    return [{"from": "human", "value": f"Describe the scene {i}.\n<event>"},
            {"from": "gpt", "value": f"Cars {i} move left."},
            {"from": "human", "value": "And then?"},
            {"from": "gpt", "value": "They stop."}]


@pytest.mark.parametrize("start_end", [False, True])
def test_preprocess_and_collate_match_jax(tmp_path, start_end):
    jc, tc = _cfgs(start_end=start_end)
    jt, tt = j_load_tokenizer("byte"), t_load_tokenizer("byte")
    if start_end:
        for tok in (jt, tt):
            tok.add_tokens(["<ev_start>", "<ev_end>"], special_tokens=True)
    for i in range(3):
        conv = _conversations(i)
        assert tdata.preprocess_v1(conv, tt, tc) == jdata.preprocess_v1(conv, jt, jc)
        pair = [conv[0], conv[1]]
        assert tdata.preprocess_plain(pair, tt, tc) == jdata.preprocess_plain(pair, jt, jc)
    entries = []
    for i in range(3):
        np.save(tmp_path / f"ev{i}.npy", synthetic_event_stream(100 + i, n_events=3000))
        entries.append({"id": i, "event": f"ev{i}.npy", "conversations": _conversations(i)})
    entries.append({"id": 3, "conversations": [{"from": "human", "value": "Hi <event>"},
                                               {"from": "gpt", "value": "Hello."}]})
    path = tmp_path / "qa.json"
    path.write_text(json.dumps(entries))
    jds = jdata.EventChatDataset(str(path), jt, jc, event_folder=str(tmp_path))
    tds = tdata.EventChatDataset(str(path), tt, tc, event_folder=str(tmp_path))
    assert tds.modality_lengths() == jds.modality_lengths()
    jb = list(jdata.batch_iterator(jds, 2, jc, seed=3, max_len=200))
    tb = list(tdata.batch_iterator(tds, 2, tc, seed=3, max_len=200))
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            assert b[k].dtype == a[k].dtype, k


def test_image_entries_are_not_ported(tmp_path, monkeypatch):
    """Image entries are ported (``tests/test_torch_raster_stream.py`` holds
    their pixels to JAX's); without Pillow, as on the card machine, an
    image entry raises an error that names Pillow."""
    import sys

    _, tc = _cfgs()
    path = tmp_path / "qa.json"
    path.write_text(json.dumps([{"image": "x.png", "conversations": _conversations(0)}]))
    ds = tdata.EventChatDataset(str(path), t_load_tokenizer("byte"), tc)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        ds[0]


def _batch(jc, seed, b=2, seq=48):
    rng = np.random.default_rng(seed)
    size = jc.vision.image_size
    pix = rng.standard_normal((b, jc.num_event_frames, 3, size, size)).astype(np.float32)
    batch = jdata.synthetic_multimodal_batch(jc, b, seq, event_offset=5, pixel_values=pix,
                                             mask_event_labels=True)
    batch["token_ids"] = rng.integers(3, jc.llama.vocab_size, (b, seq)).astype(np.int32)
    batch["labels"] = np.where(batch["event_pos"], -100, batch["token_ids"]).astype(np.int32)
    batch["attn_mask"][1, seq - 7:] = False
    batch["labels"][1, seq - 7:] = -100
    return batch


@pytest.mark.parametrize("qformer", [False, True])
def test_multimodal_embeds_and_lm_loss_match_jax(qformer):
    jc, tc = _cfgs(qformer=qformer)
    jp = _np(jchat.init_eventchat_params(jc, jax.random.PRNGKey(0)))
    tp = tconv.params_from_jax(jp, tc, torch.float32, "cpu")
    batch = _batch(jc, 1)
    want = np.asarray(jsteps.multimodal_embeds(jp, jc, jsteps.batch_to_device(batch)))
    got = tsteps.multimodal_embeds(tp, tc, tsteps.batch_to_device(batch, "cpu")).numpy()
    # Text rows are gathered table rows: exact. Event rows pass CLIP, the
    # projector and (gated) the Q-Former, whose tokens reach |x| ~ 3: there
    # the bar is 1e-6 of the block's largest value (a few f32 ulps of it).
    ev = batch["event_pos"]
    np.testing.assert_array_equal(got[~ev], want[~ev])
    bar = LOSS_ATOL * max(1.0, float(np.abs(want[ev]).max()))
    np.testing.assert_allclose(got[ev], want[ev], atol=bar, rtol=0)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 48, 264)).astype(np.float32) * 3
    jl, jn = jsteps.lm_loss(jnp.asarray(logits), jnp.asarray(batch["labels"]))
    tl, tn = tsteps.lm_loss(torch.tensor(logits), torch.tensor(batch["labels"]))
    assert int(tn) == int(jn)
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL


def _trainable_to_port(tree, tc):
    out = {}
    for k, v in tree.items():
        if k == "projector":
            out[k] = tconv.projector_params_from_jax(v, torch.float32, "cpu")
        elif k == "qformer":
            out[k] = tconv.qformer_params_from_jax(v, torch.float32, "cpu")
        elif k == "lora":
            out[k] = tconv.lora_from_jax(v, torch.float32, "cpu")
        else:
            out[k] = torch.tensor(np.asarray(v))
    return out


def _assert_trees_close(got, want, atol=ATOL):
    gl, wl = toptim.tree_leaves(got), toptim.tree_leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=atol, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("case", ["stage1_embed_new_qformer", "stage1_accum2",
                                  "stage2_dense", "stage2_flash"])
def test_train_step_matches_jax(case):
    stage2 = case.startswith("stage2")
    accum = 2 if case == "stage1_accum2" else 1
    jc, tc = _cfgs(qformer=case == "stage1_embed_new_qformer")
    if case == "stage2_flash":
        jc = dataclasses.replace(jc, llama=dataclasses.replace(jc.llama, attn_impl="flash"))
        tc = dataclasses.replace(tc, llama=dataclasses.replace(tc.llama, attn_impl="flash"))
    jp = _np(jchat.init_eventchat_params(jc, jax.random.PRNGKey(1)))
    tp = tconv.params_from_jax(jp, tc, torch.float32, "cpu")
    kw = dict(weight_decay=0.01, projector_lr=5e-4 if stage2 else None, accum_steps=accum)
    jopt = joptim.make_optimizer(joptim.linear_warmup_cosine(2e-3, 4, 1, 1e-4, 0.0), **kw)
    topt = toptim.make_optimizer(toptim.linear_warmup_cosine(2e-3, 4, 1, 1e-4, 0.0), **kw)
    if stage2:
        lcfg = LoraConfig(r=4, alpha=8.0)
        jtr, jfz = jsteps.split_stage2(jp, jc, JLoraConfig(r=4, alpha=8.0),
                                       jax.random.PRNGKey(2))
        # Non-zero B so the adapters shape the loss from the first step.
        rng = np.random.default_rng(4)
        jtr["lora"] = jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
            jtr["lora"])
        jcomb = jsteps.make_stage2_combine(JLoraConfig(r=4, alpha=8.0))
        _, tfz = tsteps.split_stage2(tp, tc, lcfg, torch.Generator().manual_seed(0))
        ttr = _trainable_to_port(_np(jtr), tc)
        tcomb = tsteps.make_stage2_combine(lcfg)
    else:
        n_new = 2 if case == "stage1_embed_new_qformer" else 0
        jtr, jfz = jsteps.split_stage1(jp, trainable_embed_rows=n_new)
        jcomb = jsteps.stage1_combine
        ttr, tfz = tsteps.split_stage1(tp, trainable_embed_rows=n_new)
        ttr = tree_map(lambda x: x.detach().clone(), ttr)
        tcomb = tsteps.stage1_combine
    jstate = jsteps.init_train_state(jax.tree_util.tree_map(jnp.asarray, jtr),
                                     jax.tree_util.tree_map(jnp.asarray, jfz), jopt)
    jstep = jsteps.make_train_step(jc, jopt, jcomb, donate=False)
    tstate = tsteps.init_train_state(ttr, tfz, topt)
    tstep = tsteps.make_train_step(tc, topt, tcomb)
    for i in range(2 * accum):
        batch = _batch(jc, 10 + i)
        jstate, jm = jstep(jstate, jsteps.batch_to_device(batch))
        tstate, tm = tstep(tstate, tsteps.batch_to_device(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= ATOL, i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= ATOL, i
    assert tstate.step == int(jstate.step) == 2 * accum
    _assert_trees_close(tstate.trainable, _trainable_to_port(_np(jstate.trainable), tc))
    # Every trainable leaf moved.
    start = _trainable_to_port(_np(jtr), tc)
    for (path, a), (_, b) in zip(toptim.tree_leaves(tstate.trainable),
                                 toptim.tree_leaves(start)):
        assert not torch.equal(a.detach(), b), path


def test_remat_on_equals_off_and_dot_policies_raise():
    jc, tc = _cfgs()
    tp = tconv.params_from_jax(_np(jchat.init_eventchat_params(jc, jax.random.PRNGKey(3))),
                               tc, torch.float32, "cpu")
    batch = tsteps.batch_to_device(_batch(jc, 5), "cpu")
    results = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, llama=dataclasses.replace(tc.llama, remat=remat))
        opt = toptim.make_optimizer(toptim.linear_warmup_cosine(1e-3, 4))
        tr, fz = tsteps.split_stage2(tp, cfg, LoraConfig(r=4), torch.Generator().manual_seed(0))
        tr = tree_map(lambda x: x.detach().clone(), tr)
        state = tsteps.init_train_state(tr, fz, opt)
        step = tsteps.make_train_step(cfg, opt, tsteps.make_stage2_combine(LoraConfig(r=4)))
        state, m = step(state, batch)
        state, m = step(state, batch)
        results.append((m, state.trainable))
    (m_on, tr_on), (m_off, tr_off) = results
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert torch.equal(m_on["grad_norm"], m_off["grad_norm"])
    _assert_trees_close(tr_on, tr_off, atol=0)
    # The dot-saving policies are ported: a stage-1 step under each equals
    # full remat's bit for bit (``tests/test_torch_remat.py`` holds them to
    # the JAX policies); an unknown policy name still raises.
    got = []
    for policy in ("full", "dots_saveable"):
        cfg = dataclasses.replace(tc, llama=dataclasses.replace(tc.llama, remat_policy=policy))
        step = tsteps.make_train_step(cfg, opt, tsteps.stage1_combine)
        tr, fz = tsteps.split_stage1(tp)
        got.append(step(tsteps.init_train_state(tree_map(lambda x: x.detach().clone(), tr),
                                                fz, opt), batch)[1])
    assert torch.equal(got[0]["loss"], got[1]["loss"])
    assert torch.equal(got[0]["grad_norm"], got[1]["grad_norm"])
    with pytest.raises(ValueError, match="remat_policy"):
        tcfg.LlamaConfig(remat_policy="dots")


@pytest.mark.parametrize("remat,policy", [(True, "full"), (False, "nothing_saveable"),
                                          (True, "dots_saveable")])
def test_remat_fields_round_trip_with_jax(tmp_path, remat, policy):
    jc = dataclasses.replace(jcfg.EventChatConfig.tiny(), llama=dataclasses.replace(
        jcfg.EventChatConfig.tiny().llama, remat=remat, remat_policy=policy))
    jcfg.save_config(jc, str(tmp_path / "jax.json"))
    tc = tcfg.load_config(str(tmp_path / "jax.json"))
    assert (tc.llama.remat, tc.llama.remat_policy) == (remat, policy)
    tcfg.save_config(tc, str(tmp_path / "port.json"))
    assert jcfg.load_config(str(tmp_path / "port.json")) == jc
    assert tcfg.load_config(str(tmp_path / "port.json")) == tc
