"""Checkpoints: the full training state, and components as npz files.

The port of ``eventgpt_tpu/checkpoint.py``.

  * **Full checkpoints** (the trainable tree, the optimizer state and the
    step) are the port's own format: one ``state.pt`` written with
    ``torch.save`` and read with ``torch.load(weights_only=True)``, inside a
    directory that appears whole (written under a temporary name, then
    renamed) with its ``STEP`` file. The JAX package writes orbax, which the
    card machine lacks, so a training run resumes within one package.
  * **Component checkpoints** are the contract between the packages: the
    projector, the LoRA factors, the new embedding rows and the Q-Former's
    parts travel as flat npz files whose keys are the subtree's dotted leaf
    paths under a prefix such as ``model.visual_projector.`` (the
    reference's partial-checkpoint key convention), in the JAX package's
    layouts. Leaves load as numpy arrays; callers place them. A torch leaf
    is written as numpy, bf16 widened to f32 (numpy has no bf16; the
    widening is exact).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"

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


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Write ``tree`` (tensors, ints, floats, dicts and lists) to the
    directory ``path``, replacing what was there, and ``STEP`` beside it
    when ``step`` is given. The directory is written as ``path.tmp-<pid>``
    and renamed, so a run killed mid-save leaves the previous checkpoint or
    none, never half of one; ``find_latest_checkpoint`` skips the
    temporary name."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, STATE_FILE))
    if step is not None:
        with open(os.path.join(tmp, "STEP"), "w") as f:
            f.write(str(int(step)))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None) -> Any:
    """The tree ``save_checkpoint`` wrote, its tensors on ``device`` (as
    saved when None)."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)


def find_latest_checkpoint(output_dir: str) -> Optional[str]:
    """The most recent completed checkpoint under ``output_dir``, or None
    (``--resume_from auto``), with the JAX package's ordering rules.

    The recorded ``STEP`` is the primary key; a ``ckpt_step{N}`` or
    ``ckpt_preempt_step{N}`` directory without one takes N from its name.
    At equal steps a preemption save beats ``ckpt_last``, which beats a
    periodic save (the order they are written in). Directories with no step
    at all (``ckpt_last``/``ckpt_preempt`` of an older run) are ordered by
    mtime among themselves and never beat a recorded step: mtimes are
    fabricated by copies. Only completed names count; the temporary
    directory of a save in progress does not."""
    if not os.path.isdir(output_dir):
        return None

    def mtime(p):
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    def recorded_step(p):
        try:
            with open(os.path.join(p, "STEP")) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    best_step = (-1, -1, None)  # (step, rank at equal steps, path)
    stepless = []
    for name in os.listdir(output_dir):
        path = os.path.join(output_dir, name)
        if not os.path.isdir(path):
            continue
        m = re.fullmatch(r"ckpt_(preempt_)?step(\d+)", name)
        named = re.fullmatch(r"ckpt_(last|preempt)", name)
        if not (m or named):
            continue
        step = recorded_step(path)
        if step is None and m:
            step = int(m.group(2))
        if (m and m.group(1)) or name == "ckpt_preempt":
            rank = 2
        elif name == "ckpt_last":
            rank = 1
        else:
            rank = 0
        if step is not None:
            if (step, rank) > best_step[:2]:
                best_step = (step, rank, path)
        else:
            stepless.append(path)
    if best_step[2] is not None:
        return best_step[2]
    best = None
    for path in stepless:
        if best is None or mtime(path) > mtime(best):
            best = path
    return best
