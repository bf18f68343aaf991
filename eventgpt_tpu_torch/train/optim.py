"""Optimizers and LR schedules, with optax's semantics.

The port of ``eventgpt_tpu/train/optim.py``:

  * ``linear_warmup_cosine`` -- linear warmup from ``warmup_start_lr`` to
    ``init_lr`` over ``warmup_steps``, then cosine decay to ``min_lr``
    (``optax.join_schedules`` of ``linear_schedule`` and
    ``cosine_decay_schedule`` with ``alpha = min_lr / init_lr``);
  * ``step_decay`` -- ``max(init_lr * decay_rate ** epoch, min_lr)``;
  * ``make_optimizer`` -- AdamW over the trainable tree as the JAX package
    chains it: ``clip_by_global_norm`` (scale by ``max_norm / norm`` only
    when ``norm >= max_norm``; ``torch.nn.utils.clip_grad_norm_`` adds 1e-6
    to the norm and is another function), Adam with eps outside the square
    root and bias correction by ``1 - b ** count``, decoupled weight decay
    ``+ wd * param``, then ``- lr(count) *``. ``projector_lr`` gives the
    ``projector`` subtree its own group with a constant LR, its own clip
    norm and its own count (``optax.multi_transform``); ``accum_steps > 1``
    is ``optax.MultiSteps``: the running mean of the micro-batch gradients,
    and an update, with the inner count and so the schedule ticking, once
    per ``accum_steps`` micro-batches.

Schedules are plain functions of the update count evaluated in float32, as
optax evaluates them; a group's first update reads ``schedule(0)``. Master
weights, moments and the accumulator are f32 tensors on the weights'
device; the update is queued on the device and never read back.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]
Schedule = Callable[[int], float]

_F32 = np.float32


def linear_warmup_cosine(init_lr: float, total_steps: int, warmup_steps: int = 0,
                         min_lr: float = 0.0, warmup_start_lr: float = -1.0) -> Schedule:
    """Linear warmup then cosine decay. ``warmup_start_lr < 0`` means start
    at ``init_lr``."""
    start = init_lr if warmup_start_lr < 0 else warmup_start_lr
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = min_lr / max(init_lr, 1e-12)

    def warmup(count: int) -> np.float32:
        # optax.linear_schedule: (init - end) * (1 - clip(c, 0, T) / T) + end.
        frac = _F32(1) - _F32(min(max(count, 0), warmup_steps)) / _F32(warmup_steps)
        return _F32(start - init_lr) * frac + _F32(init_lr)

    def cosine(count: int) -> np.float32:
        c = _F32(min(count, decay_steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        return _F32(init_lr) * ((_F32(1) - _F32(alpha)) * decay + _F32(alpha))

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return float(warmup(count))
        return float(cosine(count - warmup_steps))

    return schedule


def step_decay(init_lr: float, min_lr: float, decay_rate: float,
               steps_per_epoch: int) -> Schedule:
    """Per-epoch exponential step decay floored at min_lr."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return float(max(_F32(init_lr) * _F32(decay_rate) ** _F32(epoch), _F32(min_lr)))

    return schedule


def tree_leaves(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of a tree of dicts and lists, dict keys in
    sorted order: the order every optimizer structure follows."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def global_norm(tensors, mesh=None, split=None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32
    (``optax.global_norm``). On a ``mesh``, ``split[i]`` marks a tensor that
    is this rank's block of a leaf split over ``model``: those sums of
    squares are all-reduced over ``model``; a leaf replicated over an axis
    is counted once."""
    tensors = list(tensors)
    sq = [(t.float() * t.float()).sum() for t in tensors]
    if mesh is None or not split or not any(split) or mesh.shape["model"] == 1:
        return torch.stack(sq).sum().sqrt()
    mine = torch.stack([x for x, s in zip(sq, split) if s]).sum()
    rest = [x for x, s in zip(sq, split) if not s]
    total = mesh.all_reduce(mine, "model")
    if rest:
        total = total + torch.stack(rest).sum()
    return total.sqrt()


class AdamW:
    """AdamW over a tree of f32 tensors with optax's semantics (see the
    module docstring). ``init`` makes the state; ``update`` applies one
    micro-batch's gradients to the parameters in place and returns the
    state. The state holds tensors, ints and floats only, so that
    ``torch.save``/``torch.load(weights_only=True)`` carry it."""

    def __init__(self, schedule: Schedule, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, grad_clip: Optional[float] = 1.0,
                 projector_lr: Optional[float] = None, accum_steps: int = 1):
        self.schedules = {"base": schedule}
        if projector_lr is not None:
            self.schedules["projector"] = lambda count: float(_F32(projector_lr))
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.grad_clip = grad_clip
        self.accum_steps = max(int(accum_steps), 1)
        # On a mesh (the trainer sets both): the norm of the clip counts the
        # model-split leaves' blocks over the mesh (``global_norm``).
        self.mesh = None
        self.model_split: Callable[[Tuple], bool] = lambda path: False

    def _label(self, path: Tuple) -> str:
        return "projector" if "projector" in self.schedules and path[0] == "projector" \
            else "base"

    def init(self, params: Params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        state: Dict[str, Any] = {
            "count": {label: 0 for label in self.schedules},
            "mu": [torch.zeros_like(p, dtype=torch.float32) for _, p in leaves],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for _, p in leaves],
        }
        if self.accum_steps > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(p, dtype=torch.float32) for _, p in leaves]
        return state

    @torch.no_grad()
    def update(self, params: Params, grads: List[Optional[torch.Tensor]],
               state: Dict[str, Any]) -> Dict[str, Any]:
        """One micro-batch: ``grads`` in ``tree_leaves(params)`` order (None
        for a leaf the loss does not reach, read as zeros)."""
        leaves = [p for _, p in tree_leaves(params)]
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for p, g in zip(leaves, grads)]
        if self.accum_steps > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1).
                acc.add_((g - acc) / _F32(n + 1))
            if n < self.accum_steps - 1:
                state["mini_step"] = n + 1
                return state
            grads = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
            state["mini_step"] = 0
        paths = [path for path, _ in tree_leaves(params)]
        labels = [self._label(path) for path in paths]
        for label, schedule in self.schedules.items():
            idx = [i for i, lab in enumerate(labels) if lab == label]
            if not idx:
                continue
            g = [grads[i] for i in idx]
            if self.grad_clip is not None:
                norm = global_norm(g, self.mesh, [self.model_split(paths[i]) for i in idx])
                g = [torch.where(norm < self.grad_clip, x, x / norm * self.grad_clip)
                     for x in g]
            count = state["count"][label]
            lr = schedule(count)
            count += 1
            bc1 = float(_F32(1) - _F32(self.b1) ** _F32(count))
            bc2 = float(_F32(1) - _F32(self.b2) ** _F32(count))
            for i, gi in zip(idx, g):
                mu, nu, p = state["mu"][i], state["nu"][i], leaves[i]
                mu.mul_(self.b1).add_((1 - self.b1) * gi)
                nu.mul_(self.b2).add_((1 - self.b2) * (gi * gi))
                upd = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
                upd = upd + self.weight_decay * p.float()
                p.add_((upd * -lr).to(p.dtype))
            state["count"][label] = count
        return state


def make_optimizer(schedule: Schedule, weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8, grad_clip: Optional[float] = 1.0,
                   projector_lr: Optional[float] = None, accum_steps: int = 1) -> AdamW:
    """AdamW over the trainable tree (``eventgpt_tpu/train/optim.make_optimizer``)."""
    return AdamW(schedule, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                 grad_clip=grad_clip, projector_lr=projector_lr, accum_steps=accum_steps)
