"""Event Q-Former: learned-query cross-attention aggregator (config-gated).

Port of ``eventgpt_tpu/models/qformer.py``. ``num_queries`` learned query
vectors cross-attend to the projected per-frame event features and replace
the spatio-temporal pool as the LM's event tokens (32 instead of 582 at
7B). Each layer is pre-LN cross-attention with f32 scores and softmax,
then a tanh-GELU MLP, each with a residual.

Parameters (a Python loop walks the layer list; kernels are (in, out), as
the component files store them)::

    {"query_embeddings": (Q, D),
     "attention_layers": [{"ln_q": {"scale", "bias"}, "ln_kv": {...},
                           "attn": {"q", "k", "v", "o"}: (D, D),
                           "ln_mlp": {...},
                           "mlp": {"fc1": (D, M), "fc1_bias": (M,),
                                   "fc2": (M, D), "fc2_bias": (D,)}}, ...]}

The component files keep the reference's partial-checkpoint keys:
``model.query_embedder.weight`` in one npz, and
``model.attention_layers.{i}.<leaf path>`` plus ``qformer_meta.num_heads``
in the other.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from eventgpt_tpu_torch.checkpoint import load_component, save_component
from eventgpt_tpu_torch.config import QFormerConfig
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models.clip import layer_norm

Params = Dict[str, Any]

_LAYER_PREFIX = "model.attention_layers."


def init_qformer_params(qcfg: QFormerConfig, generator: torch.Generator,
                        dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """Random Q-Former weights with the JAX init's scales (queries N(0,
    0.02), kernels N(0, 1/fan_in), norms 1 and 0, biases 0), drawn from
    ``generator`` on ``device``."""
    device = resolve_device(device)
    d, m = qcfg.hidden_size, qcfg.hidden_size * qcfg.mlp_ratio

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(std)

    def ln():
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}

    layers = []
    for _ in range(qcfg.num_layers):
        layers.append({
            "ln_q": ln(), "ln_kv": ln(),
            "attn": {k: normal((d, d), 1.0 / math.sqrt(d)) for k in ("q", "k", "v", "o")},
            "ln_mlp": ln(),
            "mlp": {"fc1": normal((d, m), 1.0 / math.sqrt(d)),
                    "fc1_bias": torch.zeros(m, dtype=dtype, device=device),
                    "fc2": normal((m, d), 1.0 / math.sqrt(m)),
                    "fc2_bias": torch.zeros(d, dtype=dtype, device=device)},
        })
    return {"query_embeddings": normal((qcfg.num_queries, d), 0.02), "attention_layers": layers}


def _layer_norm(x: torch.Tensor, w: Params, eps: float = 1e-5) -> torch.Tensor:
    return layer_norm(x, {"weight": w["scale"], "bias": w["bias"]}, eps)


def qformer_encode(params: Params, qcfg: QFormerConfig, feats: torch.Tensor) -> torch.Tensor:
    """Aggregate event features into ``num_queries`` LM tokens.

    feats: (T, S, D) projected per-frame features (after the projector and
    adaptor) or (N, D) already flattened. Returns (num_queries, D) in
    feats' dtype.
    """
    if feats.ndim == 3:
        feats = feats.reshape(-1, feats.shape[-1])
    h, hd = qcfg.num_heads, qcfg.head_dim
    q = params["query_embeddings"].to(feats.dtype)
    for layer in params["attention_layers"]:
        attn, mlp = layer["attn"], layer["mlp"]
        qn = _layer_norm(q, layer["ln_q"])
        kvn = _layer_norm(feats, layer["ln_kv"])
        qh = (qn @ attn["q"]).reshape(-1, h, hd)      # (Q, H, hd)
        kh = (kvn @ attn["k"]).reshape(-1, h, hd)     # (N, H, hd)
        vh = (kvn @ attn["v"]).reshape(-1, h, hd)
        # bf16 products are exact in f32: f32 operands give the JAX
        # package's f32-accumulated scores.
        scores = torch.einsum("qhd,nhd->hqn", qh.float(), kh.float())
        probs = torch.softmax(scores * (1.0 / math.sqrt(hd)), dim=-1)
        ctx = torch.einsum("hqn,nhd->qhd", probs.to(q.dtype), vh)
        q = q + ctx.reshape(-1, h * hd) @ attn["o"]
        yn = _layer_norm(q, layer["ln_mlp"])
        y = F.gelu(yn @ mlp["fc1"] + mlp["fc1_bias"], approximate="tanh")
        q = q + (y @ mlp["fc2"] + mlp["fc2_bias"])
    return q


# ---------------------------------------------------------------------------
# Component files


def _paths(node: Params, prefix: str = ""):
    """(dotted leaf path, leaf) of one layer dict."""
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _set_path(node: Params, path: str, value) -> None:
    *parents, leaf = path.split(".")
    for p in parents:
        node = node[p]
    node[leaf] = value


def load_qformer_components(qparams: Params, query_embedder_path: Optional[str] = None,
                            attention_layers_path: Optional[str] = None) -> Params:
    """``qparams`` with the leaves of the given component files loaded
    over it, each on its leaf's device and in its dtype. Every configured
    leaf must be present with its configured shape; a key of another
    artifact raises."""
    out = {"query_embeddings": qparams["query_embeddings"],
           "attention_layers": qparams["attention_layers"]}
    if query_embedder_path:
        tree = load_component(query_embedder_path, strip_prefix="model.query_embedder.")
        if isinstance(tree, dict):
            if "weight" not in tree:
                raise ValueError(
                    f"query_embedder component {query_embedder_path} has no "
                    f"'weight' leaf (keys: {sorted(tree)}) — wrong artifact?")
            tree = tree["weight"]
        ref = out["query_embeddings"]
        if tuple(tree.shape) != tuple(ref.shape):
            raise ValueError(f"query_embedder shape {tuple(tree.shape)} != configured "
                             f"{tuple(ref.shape)}")
        out["query_embeddings"] = torch.from_numpy(np.asarray(tree)).to(ref.device, ref.dtype)

    if attention_layers_path:
        num_layers = len(out["attention_layers"])
        per_layer = [dict() for _ in range(num_layers)]
        with np.load(attention_layers_path) as data:
            for key in data.files:
                if key.startswith("qformer_meta."):
                    continue  # artifact metadata (num_heads), not weights
                if not key.startswith(_LAYER_PREFIX):
                    raise ValueError(
                        f"attention_layers component has key {key!r} without "
                        f"expected prefix {_LAYER_PREFIX!r} — wrong artifact?")
                idx_str, leaf_path = key[len(_LAYER_PREFIX):].split(".", 1)
                idx = int(idx_str)
                if idx >= num_layers:
                    raise ValueError(f"layer index {idx} in {key!r} out of range "
                                     f"(configured num_layers={num_layers})")
                per_layer[idx][leaf_path] = data[key]
        layers = []
        for i, layer in enumerate(out["attention_layers"]):
            new = {k: (dict(v) if not isinstance(v, torch.Tensor) else v)
                   for k, v in layer.items()}
            for path, ref in _paths(layer):
                if path not in per_layer[i]:
                    raise ValueError(f"attention_layers component missing "
                                     f"{_LAYER_PREFIX}{i}.{path}")
                got = per_layer[i][path]
                if tuple(got.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"attention_layers.{path}: shape {(num_layers,) + tuple(got.shape)} "
                        f"!= configured {(num_layers,) + tuple(ref.shape)}")
                _set_path(new, path, torch.from_numpy(np.asarray(got)).to(ref.device, ref.dtype))
            layers.append(new)
        out["attention_layers"] = layers
    return out


def save_qformer_components(qparams: Params, query_embedder_path: str,
                            attention_layers_path: str, num_heads: Optional[int] = None) -> None:
    """Write-side counterpart of ``load_qformer_components``: two npz files
    in the reference's key conventions, bf16 widened to f32. ``num_heads``
    is stored as ``qformer_meta.num_heads``: the head split cannot be read
    off the square projections, and another split computes other
    attention."""
    save_component(query_embedder_path, {"weight": qparams["query_embeddings"]},
                   prefix="model.query_embedder.")
    # The layer list flattens to model.attention_layers.{i}.<leaf path>.
    tree = {"model": {"attention_layers": qparams["attention_layers"]}}
    if num_heads is not None:
        tree["qformer_meta"] = {"num_heads": num_heads}
    save_component(attention_layers_path, tree)


def qformer_config_from_artifacts(query_embedder_path: Optional[str] = None,
                                  attention_layers_path: Optional[str] = None) -> QFormerConfig:
    """The QFormerConfig of trained component files: num_queries and the
    width from the query embeddings, num_layers and mlp_ratio from the
    layer file, num_heads from its ``qformer_meta.num_heads``. A file
    without that metadata gets the largest of 8, 4, 2, 1 that divides the
    width, with a loud warning."""
    num_queries, hidden, num_layers, mlp_ratio = 32, 4096, 2, 4
    heads = None
    if query_embedder_path:
        with np.load(query_embedder_path) as data:
            q = data["model.query_embedder.weight"]
        num_queries, hidden = int(q.shape[0]), int(q.shape[1])
    if attention_layers_path:
        idxs = set()
        with np.load(attention_layers_path) as data:
            for key in data.files:
                if key == "qformer_meta.num_heads":
                    heads = int(data[key])
                    continue
                if key.startswith("qformer_meta."):
                    continue
                rest = key[len(_LAYER_PREFIX):]
                idxs.add(int(rest.split(".", 1)[0]))
                if rest.endswith("mlp.fc1"):
                    fc1 = data[key]
                    hidden = int(fc1.shape[0])
                    mlp_ratio = int(fc1.shape[1]) // hidden
        num_layers = max(idxs) + 1
    if heads is None:
        heads = next(h for h in (8, 4, 2, 1) if hidden % h == 0)
        logging.getLogger("eventgpt_tpu_torch.qformer").warning(
            "attention_layers artifact carries no qformer_meta.num_heads; "
            "GUESSING num_heads=%d from hidden=%d — re-export the artifact "
            "with this framework (metadata included) or verify the trained "
            "head count matches", heads, hidden)
    return QFormerConfig(num_queries=num_queries, num_layers=num_layers, num_heads=heads,
                         hidden_size=hidden, mlp_ratio=mlp_ratio)


def find_components(model_path: str, query_embedder: Optional[str] = None,
                    attention_layers: Optional[str] = None):
    """The Q-Former component files to load: the explicit paths, else the
    ``query_embedder.npz`` / ``attention_layers.npz`` that
    ``write_hf_checkpoint`` puts beside a checkpoint, where they exist."""
    found = []
    for given, name in ((query_embedder, "query_embedder.npz"),
                        (attention_layers, "attention_layers.npz")):
        if given is None and os.path.isdir(model_path):
            cand = os.path.join(model_path, name)
            given = cand if os.path.exists(cand) else None
        found.append(given)
    return tuple(found)
