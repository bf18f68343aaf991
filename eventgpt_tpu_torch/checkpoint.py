"""Component checkpoints: small module subtrees as one npz file each.

The npz half of ``eventgpt_tpu/checkpoint.py``: the projector, the LoRA
factors and the Q-Former's parts travel as flat npz files whose keys are
the subtree's dotted leaf paths under a prefix such as
``model.visual_projector.`` (the reference's partial-checkpoint key
convention). Leaves load as numpy arrays; callers place them. A torch leaf
is written as numpy, bf16 widened to f32 (numpy has no bf16; the widening
is exact). Full training checkpoints come with the training slice.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("."): _leaf(tree)}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def save_component(path: str, tree: Params, prefix: str = "") -> None:
    """Save a small module subtree as one npz file, ``prefix`` prepended to
    every dotted key."""
    flat = {prefix + k: v for k, v in _flatten(tree).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_component(path: str, strip_prefix: str = "") -> Params:
    """Load an npz component as a tree of numpy arrays, ``strip_prefix``
    removed from every key. A key without the prefix raises: it belongs to
    another artifact."""
    with np.load(path) as data:
        flat = {}
        for k in data.files:
            if strip_prefix and not k.startswith(strip_prefix):
                raise ValueError(
                    f"component file {path} holds key {k!r} without the "
                    f"expected prefix {strip_prefix!r} — wrong artifact?"
                )
            flat[k[len(strip_prefix):] if strip_prefix else k] = data[k]
    return _unflatten(flat)
