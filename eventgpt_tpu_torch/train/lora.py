"""LoRA adapters over the port's LLaMA: init, apply-form for training, merge.

The port of ``eventgpt_tpu/train/lora.py``. The adapters are a separate
trainable tree whose factors are stacked on the layer axis, as in the JAX
package and in the ``lora.*`` npz its trainer writes::

    {"attn"|"mlp": {name: {"a": (L, d_in, r), "b": (L, r, d_out)}}}

``apply_lora`` gives the tree the forward runs during training: each
adapted weight ``{name}_proj`` of layer i becomes the composite leaf
``{"w": base, "a": (a * alpha / r)[i], "b": b[i]}`` that ``ops/quant.matmul``
evaluates as ``x @ w + (drop(x) @ a) @ b``, so no (K, N) delta is ever
formed and the base weights stay frozen. ``merge_lora`` folds the adapters
into the weights for export: ``W + scaling * (a[i] @ b[i])^T`` in
``nn.Linear``'s (out, in) layout.

Dropout (peft semantics: on the adapter branch's input only) draws its
masks from a ``torch.Generator`` seeded from (seed, step, target index,
layer), carried by the composite leaf. A checkpointed layer's recompute
then draws the mask its forward drew. JAX's threefry bits are not
reproduced, so dropout > 0 is held by its rules, not by equality with the
JAX package; dropout 0 is equal. On a mesh (``apply_lora(mesh=)``) each
mask is drawn for the global input and sliced to the rank's rows,
sequence chunk and (for ``o``/``down``, whose inputs split over
``model``) features, so a sharded run drops what one device drops.

``lora_param_specs`` is the JAX package's layout: ``a`` follows ``fsdp``
on its input rows and ``b`` ``model`` on its output columns, the other way
round for ``o``/``down``. The port's trainer keeps the ``fsdp`` splits
replicated (``parallel/sharding.training_spec``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from eventgpt_tpu_torch.config import LlamaConfig

Params = Dict[str, Any]

# (group, name) -> (d_in, d_out) of the adapted weight, from the config.
_TARGET_SHAPES = {
    ("attn", "q"): lambda c: (c.hidden_size, c.num_heads * c.resolved_head_dim()),
    ("attn", "k"): lambda c: (c.hidden_size, c.num_kv_heads * c.resolved_head_dim()),
    ("attn", "v"): lambda c: (c.hidden_size, c.num_kv_heads * c.resolved_head_dim()),
    ("attn", "o"): lambda c: (c.num_heads * c.resolved_head_dim(), c.hidden_size),
    ("mlp", "gate"): lambda c: (c.hidden_size, c.intermediate_size),
    ("mlp", "up"): lambda c: (c.hidden_size, c.intermediate_size),
    ("mlp", "down"): lambda c: (c.intermediate_size, c.hidden_size),
}

DEFAULT_TARGETS: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")


@dataclass(frozen=True)
class LoraConfig:
    """Defaults follow peft and the reference's TrainingArguments: r=64,
    alpha=16, dropout 0, every attention and MLP weight adapted."""

    r: int = 64
    alpha: float = 16.0
    dropout: float = 0.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    def __post_init__(self):
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"lora dropout must be in [0, 1), got {self.dropout}")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def init_lora_params(cfg: LlamaConfig, lora: LoraConfig, generator: torch.Generator,
                     dtype: torch.dtype = torch.float32, device=None) -> Params:
    """A ~ Kaiming-uniform (bound 1/sqrt(d_in)), B = 0 (peft init): the
    adapted model starts equal to the base model. Drawn from ``generator``
    in ``_TARGET_SHAPES`` order, on the generator's device unless given."""
    device = generator.device if device is None else device
    out: Params = {"attn": {}, "mlp": {}}
    for (group, name), dims in _TARGET_SHAPES.items():
        if name not in lora.targets:
            continue
        d_in, d_out = dims(cfg)
        bound = 1.0 / math.sqrt(d_in)
        a = torch.empty((cfg.num_layers, d_in, lora.r), dtype=dtype, device=device)
        out[group][name] = {
            "a": a.uniform_(-bound, bound, generator=generator),
            "b": torch.zeros((cfg.num_layers, lora.r, d_out), dtype=dtype, device=device),
        }
    return out


def dropout_seed(seed: int, step: int, target: int, layer: int) -> int:
    """The seed of one dropout mask: a function of (seed, step, target
    index, layer) only, so any call at the same four draws the same mask."""
    return int(np.random.SeedSequence([seed, step, target, layer]).generate_state(1)[0])


def lora_param_specs(targets: Tuple[str, ...] = DEFAULT_TARGETS) -> Params:
    """Partition specs of the LoRA tree (``eventgpt_tpu/train/lora.py``'s):
    the rank dim replicated, the feature dims following the base layout
    (``fsdp`` on input rows, ``model`` on output columns; ``o``/``down``
    contract over the ``model``-split dim instead)."""
    from eventgpt_tpu_torch.parallel.sharding import P

    spec_in = {"a": P(None, "fsdp", None), "b": P(None, None, "model")}
    spec_out = {"a": P(None, "model", None), "b": P(None, None, "fsdp")}
    out: Params = {"attn": {}, "mlp": {}}
    for (group, name) in _TARGET_SHAPES:
        if name not in targets:
            continue
        out[group][name] = dict(spec_out if name in ("o", "down") else spec_in)
    return out


def _dropout_shard(name: str, mesh) -> Tuple[Tuple[int, int], ...]:
    """(parts, index) of the adapted product's input (B, T, F) on ``mesh``:
    rows over (data, fsdp), the sequence over ``context``, and the features
    over ``model`` for ``o``/``down``."""
    rows = ("data", "fsdp")
    feat = ("model",) if name in ("o", "down") else ()
    return ((mesh.parts(rows), mesh.index(rows)),
            (mesh.parts(("context",)), mesh.index(("context",))),
            (mesh.parts(feat), mesh.index(feat)))


def apply_lora(base_llama: Params, lora_params: Params, lora: LoraConfig,
               dropout_key: Optional[Tuple[int, int]] = None, mesh=None) -> Params:
    """Frozen base + trainable LoRA -> the LLaMA tree whose adapted weights
    are composite leaves ``{"w": base, "a": (A * scale)[i], "b": B[i]}``.

    Gradients reach ``lora_params`` through the two skinny products; the
    base leaves are shared, not copied. ``dropout_key`` = (seed, step)
    enables ``lora.dropout``: each composite leaf gains ``seed`` (from
    ``dropout_seed``) and ``dr``, and on a ``mesh`` ``dshard``. Without it
    evaluation is deterministic.
    """
    scale = lora.scaling
    use_dropout = lora.dropout > 0.0 and dropout_key is not None
    layers = [dict(layer) for layer in base_llama["layers"]]
    for t_idx, (group, name) in enumerate(sorted(_TARGET_SHAPES)):
        ab = (lora_params.get(group) or {}).get(name)
        if ab is None:
            continue
        a = ab["a"] * scale
        for i, layer in enumerate(layers):
            leaf = {"w": layer[f"{name}_proj"], "a": a[i], "b": ab["b"][i]}
            if use_dropout:
                leaf["seed"] = dropout_seed(dropout_key[0], dropout_key[1], t_idx, i)
                leaf["dr"] = lora.dropout
                if mesh is not None:
                    leaf["dshard"] = _dropout_shard(name, mesh)
            layer[f"{name}_proj"] = leaf
    return {**base_llama, "layers": layers}


def _factor(x, i: int, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x[i].to(device)
    return torch.from_numpy(np.array(x[i])).to(device)


def merge_lora(base_llama: Params, lora_params: Params, lora: LoraConfig) -> Params:
    """A new LLaMA tree with ``W + scaling * (a @ b)^T`` for every adapted
    weight (the delta in the factors' dtype, then cast to the weight's);
    the base tree and its tensors are left as they are. The factors may be
    numpy arrays (a ``lora.*`` npz) or tensors."""
    scale = lora.scaling
    layers = [dict(layer) for layer in base_llama["layers"]]
    for group in ("attn", "mlp"):
        for name, ab in (lora_params.get(group) or {}).items():
            key = f"{name}_proj"
            for i, layer in enumerate(layers):
                w = layer[key]
                a, b = _factor(ab["a"], i, w.device), _factor(ab["b"], i, w.device)
                layer[key] = w + scale * (a @ b).T.to(w.dtype)
    return {**base_llama, "layers": layers}
