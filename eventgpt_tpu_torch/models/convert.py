"""Parameters of the port: conversion from the JAX package's tree, and a
random init built on the device.

The JAX package keeps each tower's layers stacked on a leading ``L`` axis
with matmul kernels in (in, out) layout under its own key names
(``eventgpt_tpu/models/{llama,clip,projector}.py``). The port keeps a list
of per-layer dicts with ``nn.Linear``'s (out, in) weights under HF-style
names (see each model module's docstring). ``params_from_jax`` maps one to
the other; ``init_eventchat_params`` draws random weights with the JAX
init's scales straight on the device. ``kv_cache_from_jax`` carries a KV
cache over, so that tests can feed both packages the same cache.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from eventgpt_tpu_torch.config import EventChatConfig, LlamaConfig, ProjectorConfig, VisionConfig
from eventgpt_tpu_torch.device import resolve_device

Params = Dict[str, Any]

_CLIP_LINEARS = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "o"}


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)


def _weight(kernel, dtype, device) -> torch.Tensor:
    """(in, out) JAX kernel -> (out, in) torch weight."""
    return _tensor(np.asarray(kernel).T, dtype, device)


def clip_params_from_jax(tree: Params, cfg: VisionConfig, dtype, device) -> Params:
    emb, lay = tree["embeddings"], tree["layers"]

    def ln(p, i=None):
        s, b = (p["scale"], p["bias"]) if i is None else (p["scale"][i], p["bias"][i])
        return {"weight": _tensor(s, dtype, device), "bias": _tensor(b, dtype, device)}

    def lin(p, i):
        return {"weight": _weight(p["kernel"][i], dtype, device),
                "bias": _tensor(p["bias"][i], dtype, device)}

    layers = []
    for i in range(cfg.num_layers):
        layer = {"layer_norm1": ln(lay["ln1"], i), "layer_norm2": ln(lay["ln2"], i),
                 "fc1": lin(lay["mlp"]["fc1"], i), "fc2": lin(lay["mlp"]["fc2"], i)}
        for ours, theirs in _CLIP_LINEARS.items():
            layer[ours] = lin(lay["attn"][theirs], i)
        layers.append(layer)
    return {
        "class_embedding": _tensor(emb["class_embedding"], dtype, device),
        "patch_embedding": _weight(emb["patch_embedding"], dtype, device),
        "position_embedding": _tensor(emb["position_embedding"], dtype, device),
        "pre_layernorm": ln(tree["pre_layernorm"]),
        "layers": layers,
        "post_layernorm": ln(tree["post_layernorm"]),
    }


def projector_params_from_jax(tree: Params, dtype, device) -> Params:
    def lin(p):
        return {"weight": _weight(p["kernel"], dtype, device),
                "bias": _tensor(p["bias"], dtype, device)}

    out: Params = {"mlp": [lin(p) for p in tree["mlp"]]}
    if tree.get("adaptor") is not None:
        out["adaptor"] = lin(tree["adaptor"])
    return out


def _leaf_from_jax(leaf, i: Optional[int], dtype, device):
    """One JAX LLaMA weight leaf (layer ``i`` of a stacked leaf, or the
    whole leaf when ``i`` is None) in the port's form: a dense (in, out)
    kernel becomes an (out, in) weight in ``dtype``; an int8 or int4 leaf
    keeps its payload and f32 scales as they are, with no transpose."""
    if isinstance(leaf, dict):
        return {k: torch.from_numpy(np.array(v if i is None else v[i])).to(device)
                for k, v in leaf.items()}
    return _weight(leaf if i is None else leaf[i], dtype, device)


def llama_params_from_jax(tree: Params, cfg: LlamaConfig, dtype, device) -> Params:
    """Split or fused (``qkv``, ``gate_up``) and dense or quantized JAX
    trees; fused leaves become ``qkv_proj`` / ``gate_up_proj``."""
    lay = tree["layers"]
    attn = {f"{k}_proj": v for k, v in lay["attn"].items()}
    mlp = {f"{k}_proj": v for k, v in lay["mlp"].items()}
    layers = []
    for i in range(cfg.num_layers):
        layer = {
            "input_layernorm": _tensor(lay["input_norm"][i], dtype, device),
            "post_attention_layernorm": _tensor(lay["post_norm"][i], dtype, device),
        }
        for name, leaf in {**attn, **mlp}.items():
            layer[name] = _leaf_from_jax(leaf, i, dtype, device)
        layers.append(layer)
    return {
        "embed_tokens": _tensor(tree["embed_tokens"], dtype, device),
        "layers": layers,
        "norm": _tensor(tree["final_norm"], dtype, device),
        "lm_head": _leaf_from_jax(tree["lm_head"], None, dtype, device),
    }


def params_from_jax(tree: Params, cfg: EventChatConfig, dtype: torch.dtype = torch.float32,
                    device="cuda") -> Params:
    """The JAX package's EventChat parameter tree (numpy or array leaves)
    -> the port's parameters in ``dtype`` on ``device``."""
    device = resolve_device(device)
    return {
        "clip": clip_params_from_jax(tree["clip"], cfg.vision, dtype, device),
        "projector": projector_params_from_jax(tree["projector"], dtype, device),
        "llama": llama_params_from_jax(tree["llama"], cfg.llama, dtype, device),
    }


def kv_cache_from_jax(cache: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A JAX KV cache (numpy or array leaves), dense or paged, in the
    compute dtype or int8 with scales, -> the port's cache on ``device``.
    The two packages share the layout: (L, B, S, KV, hd) per plane dense,
    (L, N, bs, KV, hd) per plane and a (B, n_bpr) table ``bt`` paged, and
    (B,) ``length``; each array is copied as it is (bf16 through f32)."""
    device = resolve_device(device)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                                dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(device)

    return {k: leaf(v) for k, v in cache.items()}


class _Init:
    """Random tensors drawn from one generator on one device, in one dtype."""

    def __init__(self, generator: torch.Generator, dtype, device):
        self.g, self.dtype, self.device = generator, dtype, device

    def normal(self, shape, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.g, dtype=self.dtype, device=self.device)
        return x.mul_(std)

    def dense(self, fan_in: int, shape) -> torch.Tensor:
        return self.normal(shape, 1.0 / math.sqrt(fan_in))

    def uniform(self, shape, bound: float) -> torch.Tensor:
        x = torch.empty(shape, dtype=self.dtype, device=self.device)
        return x.uniform_(-bound, bound, generator=self.g)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


def _init_clip(cfg: VisionConfig, r: _Init) -> Params:
    d, i = cfg.hidden_size, cfg.intermediate_size
    patch_dim = cfg.num_channels * cfg.patch_size ** 2

    def ln():
        return {"weight": r.ones((d,)), "bias": r.zeros((d,))}

    def lin(fan_in, n_out):
        return {"weight": r.dense(fan_in, (n_out, fan_in)), "bias": r.zeros((n_out,))}

    layers = []
    for _ in range(cfg.num_layers):
        layer = {ours: lin(d, d) for ours in _CLIP_LINEARS}
        layer.update(layer_norm1=ln(), layer_norm2=ln(), fc1=lin(d, i), fc2=lin(i, d))
        layers.append(layer)
    return {
        "class_embedding": r.normal((d,), 0.02),
        "patch_embedding": r.dense(patch_dim, (d, patch_dim)),
        "position_embedding": r.normal((cfg.num_tokens, d), 0.02),
        "pre_layernorm": ln(),
        "layers": layers,
        "post_layernorm": ln(),
    }


def _init_projector(cfg: ProjectorConfig, r: _Init) -> Params:
    def lin(fan_in, fan_out):
        # torch nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both.
        bound = 1.0 / math.sqrt(fan_in)
        return {"weight": r.uniform((fan_out, fan_in), bound), "bias": r.uniform((fan_out,), bound)}

    out: Params = {"mlp": [lin(cfg.input_dim, cfg.output_dim)]
                   + [lin(cfg.output_dim, cfg.output_dim) for _ in range(1, cfg.mlp_depth)]}
    if cfg.use_feature_adaptor:
        out["adaptor"] = lin(cfg.output_dim, cfg.output_dim)
    return out


def _init_llama(cfg: LlamaConfig, r: _Init) -> Params:
    d, i = cfg.hidden_size, cfg.intermediate_size
    hd = cfg.resolved_head_dim()
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "input_layernorm": r.ones((d,)),
            "q_proj": r.dense(d, (qd, d)),
            "k_proj": r.dense(d, (kvd, d)),
            "v_proj": r.dense(d, (kvd, d)),
            "o_proj": r.dense(qd, (d, qd)),
            "post_attention_layernorm": r.ones((d,)),
            "gate_proj": r.dense(d, (i, d)),
            "up_proj": r.dense(d, (i, d)),
            "down_proj": r.dense(i, (d, i)),
        })
    return {
        "embed_tokens": r.normal((cfg.vocab_size, d), 0.02),
        "layers": layers,
        "norm": r.ones((d,)),
        "lm_head": r.dense(d, (cfg.vocab_size, d)),
    }


def init_eventchat_params(cfg: EventChatConfig, generator: Optional[torch.Generator] = None,
                          dtype: torch.dtype = torch.bfloat16, device="cuda") -> Params:
    """Random EventChat weights with the JAX init's scales, drawn from
    ``generator`` (default: a fresh one seeded 0) directly on ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    r = _Init(generator, dtype, device)
    return {
        "clip": _init_clip(cfg.vision, r),
        "projector": _init_projector(cfg.projector, r),
        "llama": _init_llama(cfg.llama, r),
    }

