"""The training mesh: sharded train steps against the JAX package, f32 on the CPU.

One spawned world of 4 ranks over gloo (``torch_mesh_ranks.run_world``)
runs every case of this file; a mesh of 2 ranks runs on both halves of the
world at once (``parallel/mesh.make_mesh``'s blocks), and the halves must
agree. From one JAX tiny tree and one seeded set of batches (T = 48, two
rows, one right-padded), each case takes two optimizer steps:

- stage 1 (projector + the 2 new embedding rows) and stage 2 (LoRA with
  non-zero ``b`` + projector, dropout 0) at (data 2), (fsdp 2), (model 2),
  (context 2, ring), (context 2, ulysses) and (context 2, model 2,
  ulysses): the loss and the gradient norm of each step within 1e-5
  relative of the JAX single-device ``make_train_step``'s, and every
  trainable after the two steps within 1e-5 of the leaf's largest value;
- gradient accumulation 2 at (fsdp 2) and LoRA dropout 0.1 at (context 2,
  model 2, ulysses), against the port's one-device steps (the same bars;
  dropout masks are the port's own draws, so JAX is no oracle there). Under
  dropout a trainable element may instead be within 1% of its own move
  from the start: AdamW divides each element's gradient by its own scale,
  so an element whose gradient nearly cancels carries the f32 reordering
  of the sums (measured: one projector element of 4096 at 0.9% of its
  move, 5.7x the leaf bar);
- the layout: at (fsdp 2) every trainable is whole on each rank (kept
  replicated where the JAX specs split it over ``fsdp``: memory only), at
  (model 2) LoRA ``b`` of the column targets and ``a`` of ``o``/``down``
  hold half their features.

Beside them: the trainer's three mesh checks and the data-parallel check
raise the JAX package's ``ValueError`` texts, and a model axis that does
not divide the heads is refused. ``cli/train`` under
``torch.distributed.run`` is in ``tests/test_torch_multiproc.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.train import data as jdata
from eventgpt_tpu.train import optim as joptim
from eventgpt_tpu.train import steps as jsteps
from eventgpt_tpu.train.lora import LoraConfig as JLoraConfig
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.models import convert as tconv
from eventgpt_tpu_torch.train import optim as toptim
from eventgpt_tpu_torch.train import steps as tsteps
from eventgpt_tpu_torch.train.lora import LoraConfig
from torch_mesh_ranks import finish_world, start_world

RTOL = 1e-5
SEQ = 48
MESHES = {"data2": ((2, 1, 1, 1), "dense"), "fsdp2": ((1, 2, 1, 1), "flash"),
          "model2": ((1, 1, 1, 2), "flash"), "ring2": ((1, 1, 2, 1), "ring"),
          "ulysses2": ((1, 1, 2, 1), "ulysses"), "ctx2_model2": ((1, 1, 2, 2), "ulysses")}
CASES = ([{"name": f"{m}_stage{st}", "mesh": shape, "attn": attn, "stage": st}
          for m, (shape, attn) in MESHES.items() for st in (1, 2)]
         + [{"name": "fsdp2_stage2_accum2", "mesh": (1, 2, 1, 1), "attn": "flash", "stage": 2,
             "accum": 2},
            {"name": "ctx2_model2_stage2_dropout", "mesh": (1, 1, 2, 2), "attn": "ulysses",
             "stage": 2, "dropout": 0.1}])
JAX_CASES = [c["name"] for c in CASES if "accum" not in c and "dropout" not in c]


def _cfgs():
    jc = jcfg.EventChatConfig.tiny(vocab_size=264)
    return jc, tcfg.event_chat_config_from_dict(jcfg.to_dict(jc))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(jc, seed, b=2, seq=SEQ):
    rng = np.random.default_rng(seed)
    size = jc.vision.image_size
    pix = rng.standard_normal((b, jc.num_event_frames, 3, size, size)).astype(np.float32)
    batch = jdata.synthetic_multimodal_batch(jc, b, seq, event_offset=5, pixel_values=pix,
                                             mask_event_labels=True)
    batch["token_ids"] = rng.integers(3, jc.llama.vocab_size, (b, seq)).astype(np.int32)
    # The last two ids are the new embedding rows of stage 1.
    batch["token_ids"][:, 2] = jc.llama.vocab_size - 1
    batch["token_ids"][0, 20] = jc.llama.vocab_size - 2
    batch["labels"] = np.where(batch["event_pos"], -100, batch["token_ids"]).astype(np.int32)
    batch["attn_mask"][1, seq - 7:] = False
    batch["labels"][1, seq - 7:] = -100
    return batch


def _to_port(tree):
    out = {}
    for k, v in tree.items():
        if k == "projector":
            out[k] = tconv.projector_params_from_jax(v, torch.float32, "cpu")
        elif k == "lora":
            out[k] = tconv.lora_from_jax(v, torch.float32, "cpu")
        else:
            out[k] = torch.tensor(np.asarray(v))
    return out


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _optimizers(stage, accum=1):
    kw = dict(weight_decay=0.01, projector_lr=5e-4 if stage == 2 else None, accum_steps=accum)
    return (joptim.make_optimizer(joptim.linear_warmup_cosine(2e-3, 4, 1, 1e-4, 0.0), **kw),
            toptim.make_optimizer(toptim.linear_warmup_cosine(2e-3, 4, 1, 1e-4, 0.0), **kw))


def _starts(jc, jp):
    """The JAX trainables of each stage (LoRA ``b`` made non-zero so every
    factor moves from the first step) and their frozen trees."""
    j1, f1 = jsteps.split_stage1(jp, trainable_embed_rows=2)
    j2, f2 = jsteps.split_stage2(jp, jc, JLoraConfig(r=4, alpha=8.0), jax.random.PRNGKey(2))
    rng = np.random.default_rng(4)
    j2["lora"] = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
        j2["lora"])
    return {1: (_np(j1), f1), 2: (_np(j2), f2)}


def _jax_run(jc, starts, stage, batches):
    jtr, jfz = starts[stage]
    jopt, _ = _optimizers(stage)
    comb = jsteps.stage1_combine if stage == 1 else jsteps.make_stage2_combine(
        JLoraConfig(r=4, alpha=8.0))
    state = jsteps.init_train_state(jax.tree_util.tree_map(jnp.asarray, jtr),
                                    jax.tree_util.tree_map(jnp.asarray, jfz), jopt)
    step = jsteps.make_train_step(jc, jopt, comb, donate=False)
    losses, norms = [], []
    for b in batches[:2]:
        state, m = step(state, jsteps.batch_to_device(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "trainable": _tree_np(_to_port(_np(state.trainable)))}


def _port_run(tc, tp, start, stage, batches, accum=1, dropout=0.0):
    _, topt = _optimizers(stage, accum)
    fz = {"clip": tp["clip"], "llama": tp["llama"]}
    tr = {k: v for k, v in _to_port(start).items()}
    comb = tsteps.stage1_combine if stage == 1 else tsteps.make_stage2_combine(
        LoraConfig(r=4, alpha=8.0, dropout=dropout), dropout_seed=7)
    state = tsteps.init_train_state(tr, fz, topt)
    step = tsteps.make_train_step(tc, topt, comb)
    losses, norms = [], []
    for b in batches[:2 * accum]:
        state, m = step(state, tsteps.batch_to_device(b, "cpu"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "trainable": _tree_np(state.trainable)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jc, tc = _cfgs()
    jp = _np(jchat.init_eventchat_params(jc, jax.random.PRNGKey(1)))
    starts = _starts(jc, jp)
    batches = [_batch(jc, 10 + i) for i in range(4)]
    job = {"kind": "train_mesh", "cfg": jcfg.to_dict(jc), "tree": jp, "batches": batches,
           "start": {st: _tree_np(_to_port(starts[st][0])) for st in (1, 2)},
           "cases": CASES, "timeout_s": 120}
    started = start_world(job, 4, tmp_path_factory.mktemp("train_mesh"))
    try:
        tp = tconv.params_from_jax(jp, tc, torch.float32, "cpu")
        refs = {("jax", st): _jax_run(jc, starts, st, batches) for st in (1, 2)}
        refs["port", 2, "accum2"] = _port_run(tc, tp, starts[2][0], 2, batches, accum=2)
        refs["port", 2, "dropout"] = _port_run(tc, tp, starts[2][0], 2, batches, dropout=0.1)
    finally:
        ranks = finish_world(started, 150)
    return ranks, refs, job["start"]


def _close(got, want, what):
    bar = RTOL * max(abs(float(want)), 1e-30)
    assert abs(float(got) - float(want)) <= bar, f"{what}: {got} vs {want} (bar {bar})"


MOVE_RTOL = 1e-2


def _assert_trees(got, want, start=None, path="trainable"):
    """Every leaf within RTOL of its largest value; with ``start`` an element
    may instead be within MOVE_RTOL of its own move from ``start``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees(got[k], want[k], None if start is None else start[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees(g, w, None if start is None else start[i], f"{path}.{i}")
    else:
        bar = RTOL * max(float(np.abs(want).max()), 1e-30)
        err = np.abs(got - want)
        ok = err <= bar
        if start is not None:
            ok |= err <= MOVE_RTOL * np.abs(want - start)
        assert ok.all(), (f"{path}: {int((~ok).sum())} of {ok.size} elements off, "
                          f"largest {float(err.max())} (bar {bar})")


def _ref(refs, case):
    if "accum" in case:
        return refs["port", 2, "accum2"]
    if "dropout" in case:
        return refs["port", 2, "dropout"]
    return refs["jax", case["stage"]]


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_mesh_steps_equal_the_one_device_reference(world, case):
    ranks, refs, starts = world
    c = next(c for c in CASES if c["name"] == case)
    want = _ref(refs, c)
    for r, rank in enumerate(ranks):
        got = rank[case]
        assert len(got["losses"]) == len(want["losses"]), r
        for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
            _close(a, b, f"rank {r} loss {i}")
        for i, (a, b) in enumerate(zip(got["grad_norms"], want["grad_norms"])):
            _close(a, b, f"rank {r} grad_norm {i}")
        _assert_trees(got["trainable"], want["trainable"],
                      start=starts[c["stage"]] if "dropout" in c else None)


def test_accumulation_and_dropout_equal_the_port_and_dropout_moves_the_loss(world):
    """Accumulation's window mean and dropout's masks are the port's: held to
    the port's one-device run above; here dropout must change the loss from
    the dropout-0 run (the masks were drawn), on every rank alike."""
    ranks, refs, _ = world
    d = [r["ctx2_model2_stage2_dropout"]["losses"] for r in ranks]
    assert all(x == d[0] for x in d)
    assert abs(d[0][0] - refs["jax", 2]["losses"][0]) > 1e-4
    assert len(ranks[0]["fsdp2_stage2_accum2"]["losses"]) == 4


def test_layout_replicates_over_fsdp_and_splits_lora_over_model(world):
    ranks, refs, _ = world
    full = [np.shape(x) for x in jax.tree_util.tree_leaves(refs["jax", 2]["trainable"])]
    paths = [p for p, _ in toptim.tree_leaves(refs["jax", 2]["trainable"])]
    assert ranks[0]["fsdp2_stage2"]["local_shapes"] == [tuple(s) for s in full]
    for path, local, whole in zip(paths, ranks[0]["model2_stage2"]["local_shapes"], full):
        halved = path[0] == "lora" and ((path[3] == "b" and path[2] not in ("o", "down"))
                                        or (path[3] == "a" and path[2] in ("o", "down")))
        want = list(whole)
        if halved:
            want[2 if path[3] == "b" else 1] //= 2
        assert list(local) == want, path


# -- the trainer's checks and cli/train ------------------------------------


def _targs(tmp_path, **kw):
    from eventgpt_tpu_torch.train.args import TrainingArguments

    return TrainingArguments(output_dir=str(tmp_path), bf16=False, **kw)


@pytest.mark.parametrize("flags,match", [
    ({"mesh_context": 2}, "requires attn_impl='ring' or 'ulysses'"),
    ({"mesh_context": 2, "attn_impl": "ulysses", "mesh_model": 1},
     "must divide by mesh_context=2"),
    ({"mesh_context": 3, "attn_impl": "ring"}, "must divide the 64-token"),
])
def test_trainer_checks_raise_the_jax_errors(tmp_path, flags, match):
    """The JAX trainer's three checks, on a one-device stand-in of the mesh
    shape (the checks run before any rank is needed)."""
    from eventgpt_tpu_torch.train.trainer import check_mesh_config

    _, tc = _cfgs()
    if flags.get("attn_impl") == "ulysses":
        tc = dataclasses.replace(tc, llama=dataclasses.replace(tc.llama, num_heads=1,
                                                               num_kv_heads=1))
    targs = _targs(tmp_path, **flags)
    shape = {"data": 1, "fsdp": 1, "context": targs.mesh_context, "model": targs.mesh_model}
    cfg = dataclasses.replace(tc, llama=dataclasses.replace(
        tc.llama, attn_impl=targs.attn_impl or tc.llama.attn_impl))
    with pytest.raises(ValueError, match=match):
        check_mesh_config(cfg, shape)


def test_batch_that_does_not_divide_dp_raises_the_jax_error():
    from eventgpt_tpu_torch.config import MeshConfig
    from eventgpt_tpu_torch.parallel.mesh import Mesh

    jc, _ = _cfgs()
    mesh = Mesh(MeshConfig(data=2, fsdp=2), torch.device("cpu"))
    batch = _batch(jc, 0, b=2)
    with pytest.raises(ValueError, match=r"batch size 2 does not divide the data-parallel "
                                         r"extent dp=4"):
        tsteps.batch_to_device(batch, mesh)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        from eventgpt_tpu_torch.parallel.mesh import make_mesh

        make_mesh(MeshConfig(fsdp=2), "cpu")


def test_a_model_axis_that_does_not_divide_the_heads_is_refused():
    """The one JAX training mesh the port leaves unported: serving
    replicates heads that ``model`` does not divide; training them would
    need their partial gradients summed."""
    from eventgpt_tpu_torch.train.trainer import refuse_unported

    _, tc = _cfgs()
    refuse_unported(tc, {"model": 2})
    with pytest.raises(NotImplementedError, match="does not divide the heads"):
        refuse_unported(tc, {"model": 4})
