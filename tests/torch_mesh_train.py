"""Cases of the training mesh's CPU worlds (``torch_mesh_ranks.run_world``).

Three kinds of case (``run_case`` tells them by their keys), each a
function of (job, case, mesh) on every rank of a world over ``gloo``; no
JAX here, the ranks run the port alone:

  * ``collectives`` -- ``Mesh.all_to_all``/``ppermute``/``reduce_scatter``
    and the autograd forms of ``parallel/autograd.py`` on seeded inputs,
    against what each should give, gradients included;
  * ``attention`` -- ring or Ulysses on the rank's blocks of global q/k/v:
    the gathered output and the rank's input gradients at a cotangent;
  * ``train`` -- the tiny EventChat's stage-1 or stage-2 steps on the
    mesh from a JAX tree: losses, gradient norms and the whole trainables.
"""

from __future__ import annotations

import numpy as np


def _block(mesh, spec_axes):
    """(index, parts) of the rank's block for each dim split over
    ``spec_axes`` (one entry of axes a dim)."""
    return [(mesh.index(axes), mesh.parts(axes)) for axes in spec_axes]


def collectives_case(job, case, mesh):
    import torch

    from eventgpt_tpu_torch.parallel import autograd as pgrad

    ax = case["axis"]
    n, c = mesh.shape[ax], mesh.coord[ax]
    g = torch.Generator().manual_seed(100 + mesh.rank)
    x = torch.randn((4, 6, 8), generator=g)
    got = {"coord": c, "n": n, "x": x.numpy()}
    got["all_to_all"] = mesh.all_to_all(x, ax, 2, 1).numpy()
    got["ppermute"] = mesh.ppermute(x, ax, 1).numpy()
    got["ppermute_back"] = mesh.ppermute(x, ax, -1).numpy()
    got["reduce_scatter"] = mesh.reduce_scatter(x, ax, 2).numpy()
    # Gradients: sum(w * f(x)) with a per-rank w; the test holds each to
    # the transpose computed from every rank's x and w.
    w = torch.randn((4, 6 * n, 8 // n), generator=g)
    got["w_a2a"] = w.numpy()
    xr = x.clone().requires_grad_(True)
    (pgrad.all_to_all(xr, mesh, ax, 2, 1) * w).sum().backward()
    got["grad_a2a"] = xr.grad.numpy()
    w2 = torch.randn((4, 6, 8), generator=g)
    got["w2"] = w2.numpy()
    for name, fn in (("ppermute", lambda t: pgrad.ppermute(t, mesh, ax, 1)),
                     ("copy_to", lambda t: pgrad.copy_to(t, mesh, ax)),
                     ("reduce_from", lambda t: pgrad.reduce_from(t, mesh, ax))):
        xr = x.clone().requires_grad_(True)
        (fn(xr) * w2).sum().backward()
        got[f"grad_{name}"] = xr.grad.numpy()
    w3 = torch.randn((4, 6 * n, 8), generator=g)
    got["w3"] = w3.numpy()
    xr = x.clone().requires_grad_(True)
    (pgrad.gather_from(xr, mesh, ax, 1) * w3).sum().backward()
    got["grad_gather_from"] = xr.grad.numpy()
    return got


def attention_case(job, case, mesh):
    import torch

    from eventgpt_tpu_torch.parallel import ring, ulysses
    from eventgpt_tpu_torch.parallel.sharding import local_slice
    from eventgpt_tpu_torch.parallel.sp_common import SP_QKV_SPEC, SP_VALID_SPEC

    arrays = job["attention"][case["inputs"]]
    q, k, v, valid, cot = (torch.from_numpy(arrays[n]) for n in ("q", "k", "v", "valid", "cot"))
    causal = case.get("causal", True)
    if case["impl"] == "ring":
        f = ring.ring_attention_shard_map(mesh, causal=causal)
    else:
        f = ulysses.ulysses_attention_shard_map(mesh, causal=causal,
                                                inner=case.get("inner", "flash"))
    ql, kl, vl = (local_slice(x, SP_QKV_SPEC, mesh).clone().requires_grad_(True)
                  for x in (q, k, v))
    vv = local_slice(valid, SP_VALID_SPEC, mesh)
    out = f(ql, kl, vl, vv, vv)
    (out * local_slice(cot, SP_QKV_SPEC, mesh)).sum().backward()
    full = ring._gather_sp(out.detach(), mesh)
    return {"out": full.numpy(), "dq": ql.grad.numpy(), "dk": kl.grad.numpy(),
            "dv": vl.grad.numpy(),
            "block": _block(mesh, [("data", "fsdp"), ("context",), ("model",)])}


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return tree.detach().cpu().numpy()


def train_case(job, case, mesh):
    """Steps on ``mesh`` from the job's JAX tree and trainable start
    (``trainable`` in the port's layout as numpy), as ``case`` says:
    ``stage``, ``attn``, ``accum``, ``dropout``, ``steps``."""
    import dataclasses

    import torch

    from eventgpt_tpu_torch import config as tcfg
    from eventgpt_tpu_torch.models.convert import params_from_jax
    from eventgpt_tpu_torch.parallel import sharding
    from eventgpt_tpu_torch.train import optim as toptim
    from eventgpt_tpu_torch.train import steps as tsteps
    from eventgpt_tpu_torch.train.lora import LoraConfig

    cfg = tcfg.event_chat_config_from_dict(job["cfg"])
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, attn_impl=case["attn"]))
    params = params_from_jax(job["tree"], cfg, torch.float32, "cpu")
    stage = case["stage"]
    start = job["start"][stage]
    trainable = {k: v for k, v in start.items()}
    if stage == 1:
        frozen = {"clip": params["clip"], "llama": params["llama"]}
        combine = tsteps.stage1_combine
    else:
        lcfg = LoraConfig(r=4, alpha=8.0, dropout=case.get("dropout", 0.0))
        frozen = {"clip": params["clip"], "llama": params["llama"]}
        combine = tsteps.make_stage2_combine(lcfg, dropout_seed=7, mesh=mesh)
    specs = sharding.trainable_param_specs(trainable)
    trainable = sharding.shard_trainable(trainable, specs, mesh)
    frozen = sharding.shard_frozen(frozen, cfg, mesh)
    accum = case.get("accum", 1)
    opt = toptim.make_optimizer(toptim.linear_warmup_cosine(2e-3, 4, 1, 1e-4, 0.0),
                                weight_decay=0.01, projector_lr=5e-4 if stage == 2 else None,
                                accum_steps=accum)
    state = tsteps.init_train_state(trainable, frozen, opt)
    step = tsteps.make_train_step(cfg, opt, combine, mesh=mesh)
    losses, norms = [], []
    for i in range(case.get("steps", 2) * accum):
        state, m = step(state, tsteps.batch_to_device(job["batches"][i], mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = sharding.gather_trainable(state.trainable, specs, mesh)
    return {"losses": losses, "grad_norms": norms, "trainable": _tree_np(full),
            "local_shapes": [tuple(t.shape) for _, t in toptim.tree_leaves(state.trainable)]}


def run_case(job, case, mesh):
    """The case's kind by its keys: ``axis`` (collectives), ``impl``
    (attention), else a training run."""
    if "axis" in case:
        return collectives_case(job, case, mesh)
    if "impl" in case:
        return attention_case(job, case, mesh)
    return train_case(job, case, mesh)
