"""CLIP ViT vision encoder in PyTorch.

Port of ``eventgpt_tpu/models/clip.py``: the last encoder layer's hidden
state without post-layernorm (what the projector consumes). The patch
embedding is one flattened matmul in (c, i, j) order, equal to the
stride-equals-kernel convolution and free of cuDNN's TF32 default. Layers
are a list that a Python loop walks. Attention scores and the softmax are
f32 whatever the weight dtype.

Parameters (weights in ``nn.Linear``'s (out, in) layout)::

    {"class_embedding": (D,), "patch_embedding": (D, C*P*P),
     "position_embedding": (N, D), "pre_layernorm": {"weight", "bias"},
     "layers": [{"layer_norm1", "q_proj", "k_proj", "v_proj", "out_proj",
                 "layer_norm2", "fc1", "fc2"}: {"weight", "bias"}, ...],
     "post_layernorm": {"weight", "bias"}}
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from eventgpt_tpu_torch.config import VisionConfig

Params = Dict[str, Any]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """LayerNorm in f32 (population variance), cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * p["weight"].float() + p["bias"].float()).to(x.dtype)


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.linear(x, p["weight"], p["bias"])


def _embed_patches(params: Params, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 1 + N, D) token embeddings with CLS + positions."""
    b = pixel_values.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    # Flatten each patch in (c, i, j) order: the conv kernel's layout.
    x = pixel_values.reshape(b, cfg.num_channels, g, p, g, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, cfg.num_channels * p * p)
    patches = F.linear(x, params["patch_embedding"])
    cls = params["class_embedding"].to(patches.dtype).expand(b, 1, cfg.hidden_size)
    tokens = torch.cat([cls, patches], dim=1)
    return tokens + params["position_embedding"]


def _attention(x: torch.Tensor, layer: Params, cfg: VisionConfig) -> torch.Tensor:
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = _linear(x, layer["q_proj"]).reshape(b, s, h, hd) * (1.0 / math.sqrt(hd))
    k = _linear(x, layer["k_proj"]).reshape(b, s, h, hd)
    v = _linear(x, layer["v_proj"]).reshape(b, s, h, hd)
    # bf16 products are exact in f32: the f32 einsum is the JAX
    # package's preferred_element_type=float32 dot.
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
    return _linear(ctx, layer["out_proj"])


def clip_encode(params: Params, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) pixels -> (B, num_tokens, D) last hidden state (no post-LN)."""
    x = _embed_patches(params, cfg, pixel_values)
    x = layer_norm(x, params["pre_layernorm"], cfg.layer_norm_eps)
    for layer in params["layers"]:
        y = layer_norm(x, layer["layer_norm1"], cfg.layer_norm_eps)
        x = x + _attention(y, layer, cfg)
        y = layer_norm(x, layer["layer_norm2"], cfg.layer_norm_eps)
        y = _linear(quick_gelu(_linear(y, layer["fc1"])), layer["fc2"])
        x = x + y
    return x
