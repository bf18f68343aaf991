"""Parameters of the port: HF checkpoints read and written, conversion
from the JAX package's tree, and a random init built on the device.

The JAX package keeps each tower's layers stacked on a leading ``L`` axis
with matmul kernels in (in, out) layout under its own key names
(``eventgpt_tpu/models/{llama,clip,projector}.py``). The port keeps a list
of per-layer dicts with ``nn.Linear``'s (out, in) weights under HF-style
names (see each model module's docstring). ``params_from_jax`` maps one to
the other; ``init_eventchat_params`` draws random weights with the JAX
init's scales straight on the device. ``kv_cache_from_jax`` carries a KV
cache over, and ``medusa_from_jax`` a Medusa head stack, so that tests can
feed both packages the same arrays.

HF checkpoints keep the reference's layout: the vision tower and projector
live inside the LLM state dict under

  model.visual_tower.visual_tower.vision_model.*   (HF CLIPVisionModel)
  model.visual_projector.{0,2}.{weight,bias}        (nn.Sequential MLP)
  model.feature_adaptor.{weight,bias}
  model.layers.* / model.embed_tokens / model.norm / lm_head  (HF LLaMA)

Since the port's names and layout are HF's, ``*_params_from_hf`` and
``*_params_to_hf`` only rename, except the patch embedding ((D, C, P, P)
conv weight <-> (D, C*P*P) matrix) and a tied ``lm_head``, which gets its
own storage. ``load_state_dict`` reads safetensors shards with the port's
own reader (``models/_safetensors.py``) or ``pytorch_model*.bin`` files,
one file at a time, each tensor straight onto the target device in the
target dtype, so a load holds one tree and no host copy of it.
``write_hf_checkpoint`` writes the same layout back.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from eventgpt_tpu_torch.config import (EventChatConfig, LlamaConfig, ProjectorConfig,
                                       VisionConfig, to_dict)
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import _safetensors
from eventgpt_tpu_torch.models.qformer import init_qformer_params, save_qformer_components

Params = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]

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


def qformer_params_from_jax(tree: Params, dtype, device) -> Params:
    """The JAX Q-Former (leaves stacked on the layer axis) -> the port's
    per-layer list with the same leaf paths and (in, out) kernels."""
    num_layers = np.asarray(tree["attention_layers"]["attn"]["q"]).shape[0]

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return _tensor(np.asarray(node)[i], dtype, device)

    return {"query_embeddings": _tensor(tree["query_embeddings"], dtype, device),
            "attention_layers": [layer(tree["attention_layers"], i) for i in range(num_layers)]}


def params_from_jax(tree: Params, cfg: EventChatConfig, dtype: torch.dtype = torch.float32,
                    device="cuda") -> Params:
    """The JAX package's EventChat parameter tree (numpy or array leaves)
    -> the port's parameters in ``dtype`` on ``device``; a ``qformer``
    subtree comes along."""
    device = resolve_device(device)
    out = {
        "clip": clip_params_from_jax(tree["clip"], cfg.vision, dtype, device),
        "projector": projector_params_from_jax(tree["projector"], dtype, device),
        "llama": llama_params_from_jax(tree["llama"], cfg.llama, dtype, device),
    }
    if "qformer" in tree:
        out["qformer"] = qformer_params_from_jax(tree["qformer"], dtype, device)
    return out


def projector_params_to_jax(params: Params) -> Params:
    """The port's projector -> the JAX package's layout as numpy f32 arrays
    ({"mlp": [{"kernel": (in, out), "bias"}], "adaptor"}): the tree of a
    ``projector_*.npz`` component that both packages read."""
    def lin(p):
        return {"kernel": p["weight"].detach().float().cpu().numpy().T.copy(),
                "bias": p["bias"].detach().float().cpu().numpy()}

    out: Params = {"mlp": [lin(p) for p in params["mlp"]]}
    if params.get("adaptor") is not None:
        out["adaptor"] = lin(params["adaptor"])
    return out


def lora_from_jax(tree: Params, dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """A JAX LoRA tree (or a ``lora.*`` npz loaded by ``load_component``)
    -> the port's, in ``dtype`` on ``device``. Both packages keep the
    factors stacked on the layer axis in the math layout, a (L, d_in, r)
    and b (L, r, d_out), so the arrays are carried as they are."""
    device = resolve_device(device)
    return {group: {name: {k: _tensor(np.asarray(v), dtype, device) for k, v in ab.items()}
                    for name, ab in names.items()}
            for group, names in tree.items()}


def medusa_from_jax(tree: Params, dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """A JAX Medusa head stack ``{"w": (K, D, D)}`` -> the port's, in
    ``dtype`` on ``device``. Both packages keep the (in, out) layout of the
    batched head product, so the array is carried as it is."""
    return {"w": _tensor(np.asarray(tree["w"]), dtype, resolve_device(device))}


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
    ``generator`` (default: a fresh one seeded 0) directly on ``device``;
    a Q-Former too when the config gates it."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    r = _Init(generator, dtype, device)
    params = {
        "clip": _init_clip(cfg.vision, r),
        "projector": _init_projector(cfg.projector, r),
        "llama": _init_llama(cfg.llama, r),
    }
    if cfg.use_event_qformer:
        params["qformer"] = init_qformer_params(cfg.qformer, generator, dtype, device)
    return params



# ---------------------------------------------------------------------------
# HF state dict -> port tree (no copies but the patch view and a tied head)

_CLIP_LAYER_LEAVES = [
    ("layer_norm1", "layer_norm1"), ("layer_norm2", "layer_norm2"),
    ("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
    ("v_proj", "self_attn.v_proj"), ("out_proj", "self_attn.out_proj"),
    ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"),
]
_LLAMA_LAYER_LEAVES = [
    ("input_layernorm", "input_layernorm"), ("q_proj", "self_attn.q_proj"),
    ("k_proj", "self_attn.k_proj"), ("v_proj", "self_attn.v_proj"),
    ("o_proj", "self_attn.o_proj"), ("post_attention_layernorm", "post_attention_layernorm"),
    ("gate_proj", "mlp.gate_proj"), ("up_proj", "mlp.up_proj"), ("down_proj", "mlp.down_proj"),
]


def clip_params_from_hf(sd: StateDict, cfg: VisionConfig, prefix: str = "vision_model.") -> Params:
    g = lambda k: sd[prefix + k]

    def wb(k):
        return {"weight": g(k + ".weight"), "bias": g(k + ".bias")}

    layers = []
    for i in range(cfg.num_layers):
        base = f"encoder.layers.{i}."
        layers.append({ours: wb(base + theirs) for ours, theirs in _CLIP_LAYER_LEAVES})
    return {
        "class_embedding": g("embeddings.class_embedding"),
        # (D, C, P, P) conv weight -> (D, C*P*P), (c, i, j) flatten order.
        "patch_embedding": g("embeddings.patch_embedding.weight").reshape(cfg.hidden_size, -1),
        "position_embedding": g("embeddings.position_embedding.weight"),
        "pre_layernorm": wb("pre_layrnorm"),  # sic: HF spells it "pre_layrnorm"
        "layers": layers,
        "post_layernorm": wb("post_layernorm"),
    }


def llama_params_from_hf(sd: StateDict, cfg: LlamaConfig, prefix: str = "model.") -> Params:
    embed = sd[prefix + "embed_tokens.weight"]
    layers = []
    for i in range(cfg.num_layers):
        layers.append({ours: sd[f"{prefix}layers.{i}.{theirs}.weight"]
                       for ours, theirs in _LLAMA_LAYER_LEAVES})
    # A tied checkpoint has no lm_head: give it its own storage, since
    # resize, fuse and quantize replace leaves in place.
    head = sd["lm_head.weight"] if "lm_head.weight" in sd else embed.clone()
    return {"embed_tokens": embed, "layers": layers, "norm": sd[prefix + "norm.weight"],
            "lm_head": head}


def projector_params_from_hf(sd: StateDict, mlp_depth: int = 2,
                             prefix: str = "model.visual_projector.",
                             adaptor_prefix: Optional[str] = "model.feature_adaptor.") -> Params:
    """Sequential [Linear, GELU, Linear, ...] -> the port's layer list
    (Linear j at index 2j)."""
    out: Params = {"mlp": [{"weight": sd[f"{prefix}{2 * j}.weight"],
                            "bias": sd[f"{prefix}{2 * j}.bias"]} for j in range(mlp_depth)]}
    if adaptor_prefix is not None and adaptor_prefix + "weight" in sd:
        out["adaptor"] = {"weight": sd[adaptor_prefix + "weight"],
                          "bias": sd[adaptor_prefix + "bias"]}
    return out


def eventchat_params_from_hf(sd: StateDict, cfg: EventChatConfig) -> Params:
    """A full EventChat_llama state dict -> the port's {clip, projector,
    llama} tree, sharing the state dict's tensors. Q-Former weights never
    live in the state dict: they load from their component files
    (``models/qformer.load_qformer_components``)."""
    return {
        "clip": clip_params_from_hf(sd, cfg.vision,
                                    prefix="model.visual_tower.visual_tower.vision_model."),
        "projector": projector_params_from_hf(sd, cfg.projector.mlp_depth),
        "llama": llama_params_from_hf(sd, cfg.llama, prefix="model."),
    }


# ---------------------------------------------------------------------------
# port tree -> HF state dict and checkpoint directory


def clip_params_to_hf(params: Params, cfg: VisionConfig, prefix: str = "vision_model.") -> StateDict:
    sd: StateDict = {
        prefix + "embeddings.class_embedding": params["class_embedding"],
        prefix + "embeddings.patch_embedding.weight": params["patch_embedding"].reshape(
            cfg.hidden_size, cfg.num_channels, cfg.patch_size, cfg.patch_size),
        prefix + "embeddings.position_embedding.weight": params["position_embedding"],
    }
    for ours, theirs in (("pre_layernorm", "pre_layrnorm"), ("post_layernorm", "post_layernorm")):
        for leaf in ("weight", "bias"):
            sd[f"{prefix}{theirs}.{leaf}"] = params[ours][leaf]
    for i, layer in enumerate(params["layers"]):
        for ours, theirs in _CLIP_LAYER_LEAVES:
            for leaf in ("weight", "bias"):
                sd[f"{prefix}encoder.layers.{i}.{theirs}.{leaf}"] = layer[ours][leaf]
    return sd


def llama_params_to_hf(params: Params, cfg: LlamaConfig, prefix: str = "model.") -> StateDict:
    """Split, dense weights only: a fused or quantized tree has no HF form."""
    sd: StateDict = {prefix + "embed_tokens.weight": params["embed_tokens"]}
    for i, layer in enumerate(params["layers"]):
        for ours, theirs in _LLAMA_LAYER_LEAVES:
            if not isinstance(layer.get(ours), torch.Tensor):
                raise ValueError(f"llama layer {i}: {ours} is fused or quantized; export the "
                                 f"split dense tree")
            sd[f"{prefix}layers.{i}.{theirs}.weight"] = layer[ours]
    sd[prefix + "norm.weight"] = params["norm"]
    sd["lm_head.weight"] = params["lm_head"]
    return sd


def projector_params_to_hf(params: Params, prefix: str = "model.visual_projector.",
                           adaptor_prefix: str = "model.feature_adaptor.") -> StateDict:
    sd: StateDict = {}
    for j, layer in enumerate(params["mlp"]):
        sd[f"{prefix}{2 * j}.weight"] = layer["weight"]
        sd[f"{prefix}{2 * j}.bias"] = layer["bias"]
    if "adaptor" in params:
        sd[adaptor_prefix + "weight"] = params["adaptor"]["weight"]
        sd[adaptor_prefix + "bias"] = params["adaptor"]["bias"]
    return sd


def eventchat_params_to_hf(params: Params, cfg: EventChatConfig) -> StateDict:
    """The port's {clip, projector, llama} tree -> the reference-layout
    state dict; inverse of ``eventchat_params_from_hf``."""
    sd: StateDict = {}
    sd.update(clip_params_to_hf(params["clip"], cfg.vision,
                                prefix="model.visual_tower.visual_tower.vision_model."))
    sd.update(projector_params_to_hf(params["projector"]))
    sd.update(llama_params_to_hf(params["llama"], cfg.llama, prefix="model."))
    return sd


def hf_config_dict(cfg: EventChatConfig,
                   visual_tower: str = "openai/clip-vit-large-patch14-336",
                   has_adaptor: Optional[bool] = None,
                   include_qformer: Optional[bool] = None) -> dict:
    """EventChatConfig -> the reference's ``config.json`` fields plus the
    extensions that make non-default towers, projectors and Q-Formers
    round-trip (``vision_config``, ``mm_projector_depth``,
    ``qformer_config``). ``has_adaptor`` / ``include_qformer`` override the
    config's gates: a gate must follow the weights written beside it."""
    out = {
        "model_type": "EventChat_llama",
        "architectures": ["EventChatModel"],
        "vocab_size": cfg.llama.vocab_size,
        "hidden_size": cfg.llama.hidden_size,
        "intermediate_size": cfg.llama.intermediate_size,
        "num_hidden_layers": cfg.llama.num_layers,
        "num_attention_heads": cfg.llama.num_heads,
        "num_key_value_heads": cfg.llama.num_kv_heads,
        "rms_norm_eps": cfg.llama.rms_norm_eps,
        "rope_theta": cfg.llama.rope_theta,
        "max_position_embeddings": cfg.llama.max_seq_len,
        "tie_word_embeddings": cfg.llama.tie_word_embeddings,
        "mm_visual_tower": visual_tower,
        "mm_projector_depth": cfg.projector.mlp_depth,
        "spatial_temporal_encoder": cfg.use_spatio_temporal_pool,
        "mm_use_im_start_end": cfg.mm_use_im_start_end,
        "mm_use_im_patch_token": cfg.mm_use_im_patch_token,
        # CLIP's activation, which the HF layout names beside the dims.
        "vision_config": {**to_dict(cfg.vision), "hidden_act": "quick_gelu"},
    }
    if cfg.projector.use_feature_adaptor if has_adaptor is None else has_adaptor:
        out["event_feature_adaptor"] = True
    if cfg.use_event_qformer if include_qformer is None else include_qformer:
        out["use_event_qformer"] = True
        out["qformer_config"] = to_dict(cfg.qformer)
    return out


def save_sharded_safetensors(sd: StateDict, out_dir: str, num_shards: int = 2) -> int:
    """Write ``model-0000i-of-0000N.safetensors`` shards (keys sorted, split
    evenly by count) and ``model.safetensors.index.json``; returns the
    bytes of tensor data written."""
    os.makedirs(out_dir, exist_ok=True)
    keys = sorted(sd)
    per = (len(keys) + num_shards - 1) // num_shards
    total = sum(t.numel() * t.element_size() for t in sd.values())
    index = {"metadata": {"total_size": int(total)}, "weight_map": {}}
    for s in range(num_shards):
        shard_keys = keys[s * per:(s + 1) * per]
        if not shard_keys:
            continue
        name = f"model-{s + 1:05d}-of-{num_shards:05d}.safetensors"
        _safetensors.save_file({k: sd[k] for k in shard_keys}, os.path.join(out_dir, name),
                               metadata={"format": "pt"})
        for k in shard_keys:
            index["weight_map"][k] = name
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=2)
    return total


def write_hf_checkpoint(params: Params, cfg: EventChatConfig, out_dir: str,
                        num_shards: int = 2,
                        visual_tower: str = "openai/clip-vit-large-patch14-336") -> str:
    """The port's tree -> an HF-style checkpoint directory: sharded
    safetensors in the tensors' own dtype, ``config.json``, and the
    Q-Former's component files beside them when the config gates it and
    the tree holds it. Inverse of ``load_state_dict`` +
    ``eventchat_params_from_hf``."""
    save_sharded_safetensors(eventchat_params_to_hf(params, cfg), out_dir, num_shards)
    has_qformer = cfg.use_event_qformer and "qformer" in params
    if has_qformer:
        save_qformer_components(params["qformer"], os.path.join(out_dir, "query_embedder.npz"),
                                os.path.join(out_dir, "attention_layers.npz"),
                                num_heads=cfg.qformer.num_heads)
    cfg_dict = hf_config_dict(cfg, visual_tower,
                              has_adaptor="adaptor" in params.get("projector", {}),
                              include_qformer=has_qformer)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    return out_dir


# ---------------------------------------------------------------------------
# File readers


def _place(t: torch.Tensor, device, dtype) -> torch.Tensor:
    want = dtype if dtype is not None and t.is_floating_point() else t.dtype
    return t.to(device=device, dtype=want, copy=True)


def load_state_dict(model_path: str, device="cuda", dtype: Optional[torch.dtype] = None) -> StateDict:
    """A (possibly sharded) HF checkpoint directory as one state dict on
    ``device``, floating tensors in ``dtype`` when given: every
    ``*.safetensors`` file, else every ``pytorch_model*.bin``. Files load
    one at a time, each tensor straight onto ``device``."""
    device = resolve_device(device)
    entries = sorted(os.listdir(model_path))
    safes = [e for e in entries if e.endswith(".safetensors")]
    bins = [e for e in entries if e.startswith("pytorch_model") and e.endswith(".bin")]
    sd: StateDict = {}
    if safes:
        for shard in safes:
            sd.update(_safetensors.load_file(os.path.join(model_path, shard), device, dtype))
    elif bins:
        for shard in bins:
            raw = torch.load(os.path.join(model_path, shard), map_location="cpu",
                             weights_only=True, mmap=True)
            for k in list(raw):
                sd[k] = _place(raw.pop(k), device, dtype)
            del raw
    else:
        raise FileNotFoundError(f"no safetensors/bin checkpoint found under {model_path}")
    return sd


def load_partial_module(path: str, strip_prefix: str, device="cuda",
                        dtype: Optional[torch.dtype] = None) -> StateDict:
    """A reference-style partial checkpoint (a raw ``torch.save`` dict, such
    as the projector or adaptor alone) with ``strip_prefix`` removed from
    the keys that carry it."""
    device = resolve_device(device)
    raw = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return {(k[len(strip_prefix):] if k.startswith(strip_prefix) else k): _place(v, device, dtype)
            for k, v in raw.items()}
