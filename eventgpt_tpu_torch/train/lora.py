"""LoRA merge: the JAX trainer's adapters folded into the port's LLaMA.

The port of ``LoraConfig`` and ``merge_lora`` from
``eventgpt_tpu/train/lora.py``, for ``cli/export``. The JAX trainer saves
its adapters as a ``lora.*`` npz whose factors are stacked on the layer
axis: ``{"attn"|"mlp": {name: {"a": (L, d_in, r), "b": (L, r, d_out)}}}``.
Merging adds ``(alpha / r) * a[i] @ b[i]`` to layer i's weight, transposed
to ``nn.Linear``'s (out, in) layout. Training comes with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]

@dataclass(frozen=True)
class LoraConfig:
    """The merge's two numbers, with peft's defaults (r=64, alpha=16). The
    adapters merged are those the npz holds; the training-side fields
    (dropout, targets) come with the trainer."""

    r: int = 64
    alpha: float = 16.0

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def merge_lora(base_llama: Params, lora_params: Params, lora: LoraConfig) -> Params:
    """A new LLaMA tree with ``W + scaling * (a @ b)^T`` for every adapted
    weight (the delta in the factors' dtype, then cast to the weight's);
    the base tree and its tensors are left as they are."""
    scale = lora.scaling
    layers = [dict(layer) for layer in base_llama["layers"]]
    for group in ("attn", "mlp"):
        for name, ab in (lora_params.get(group) or {}).items():
            key = f"{name}_proj"
            for i, layer in enumerate(layers):
                w = layer[key]
                a = torch.from_numpy(np.array(ab["a"][i])).to(w.device)
                b = torch.from_numpy(np.array(ab["b"][i])).to(w.device)
                layer[key] = w + scale * (a @ b).T.to(w.dtype)
    return {**base_llama, "layers": layers}
