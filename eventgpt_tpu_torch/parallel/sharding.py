"""Partition spec trees of every parameter tree of the port.

Port of ``eventgpt_tpu/parallel/sharding.py``. The layout rules are the
JAX package's (Megatron-style tensor parallelism composed with FSDP):

  * contraction (input feature) dims shard over ``fsdp``, gathered at use
    (ZeRO-3);
  * head / column dims shard over ``model``: q/k/v and the MLP's gate/up
    shard their output columns, o/down their input rows, so each layer
    needs one sum over ``model`` on its output;
  * small leaves (norms, biases, the projector) replicate over ``model``.

GSPMD inserts those collectives in the JAX program; the port's model code
calls them itself (``models/llama.py`` with ``mesh=``): an all-reduce over
``model`` after ``o_proj`` and ``down_proj``, an all-gather over ``fsdp``
of each weight at use, a masked vocab-parallel embedding lookup summed over
``model``, and an all-gather over ``model`` of the lm_head's logits.

Two things differ from the JAX trees. The port's dense weights are
``nn.Linear``'s (out, in), so a dense leaf's spec is the JAX spec
transposed; a quantized leaf keeps the JAX (K, N) layout and its one spec
is read transposed (``parallel/serving._shard_tree``). And the port has no
stacked layer axis: its layers are a list of dicts, so the JAX specs'
leading ``None`` goes and the layer specs are a list too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

Specs = Dict[str, Any]
Axis = Union[None, str, Tuple[str, ...]]

BATCH_AXES = ("data", "fsdp")


class P(tuple):
    """A leaf's partition spec: one entry a dimension of the port's layout,
    an axis name, a tuple of axis names or None (replicated)."""

    def __new__(cls, *parts: Axis):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def batch_spec(ndim: int, seq_axis: Optional[int] = None) -> P:
    """Activations: batch over (data, fsdp); optional sequence over context."""
    parts: list = [BATCH_AXES] + [None] * (ndim - 1)
    if seq_axis is not None:
        parts[seq_axis] = "context"
    return P(*parts)


def _llama_layer_specs() -> Specs:
    col, row = P("model", "fsdp"), P("fsdp", "model")
    return {"input_layernorm": P(None), "post_attention_layernorm": P(None),
            "q_proj": col, "k_proj": col, "v_proj": col, "o_proj": row,
            "gate_proj": col, "up_proj": col, "down_proj": row}


def llama_param_specs(num_layers: int) -> Specs:
    """Mirrors ``models/llama``'s tree: (V, D) embed and lm_head with the
    vocab over ``model`` and the features over ``fsdp``."""
    return {"embed_tokens": P("model", "fsdp"),
            "layers": [_llama_layer_specs() for _ in range(num_layers)],
            "norm": P(None),
            "lm_head": P("model", "fsdp")}


def clip_param_specs(num_layers: int) -> Specs:
    """Mirrors ``models/clip``'s tree. The patch embedding's input
    (3*14*14) has awkward factors: its output features shard instead."""
    ln = {"weight": P(None), "bias": P(None)}

    def lin(weight: P, bias: P = P(None)):
        return {"weight": weight, "bias": bias}

    def layer():
        return {"layer_norm1": dict(ln), "layer_norm2": dict(ln),
                "q_proj": lin(P("model", "fsdp")), "k_proj": lin(P("model", "fsdp")),
                "v_proj": lin(P("model", "fsdp")), "out_proj": lin(P("fsdp", "model")),
                "fc1": lin(P("model", "fsdp"), P("model")), "fc2": lin(P("fsdp", "model"))}

    return {"class_embedding": P(None),
            "patch_embedding": P("fsdp", None),
            "position_embedding": P(None, "fsdp"),
            "pre_layernorm": dict(ln),
            "layers": [layer() for _ in range(num_layers)],
            "post_layernorm": dict(ln)}


def projector_param_specs(use_feature_adaptor: bool = True, mlp_depth: int = 2) -> Specs:
    """The projector MLP and adaptor: input rows over ``fsdp``, replicated
    over ``model``."""
    def lin():
        return {"weight": P(None, "fsdp"), "bias": P(None)}

    specs: Specs = {"mlp": [lin() for _ in range(mlp_depth)]}
    if use_feature_adaptor:
        specs["adaptor"] = lin()
    return specs


def qformer_param_specs(num_layers: int) -> Specs:
    """Mirrors ``models/qformer``'s tree, whose kernels keep the JAX (in,
    out) layout: contraction rows over ``fsdp``; queries and norms
    replicate."""
    ln = {"scale": P(None), "bias": P(None)}

    def layer():
        return {"ln_q": dict(ln), "ln_kv": dict(ln), "ln_mlp": dict(ln),
                "attn": {k: P("fsdp", None) for k in ("q", "k", "v", "o")},
                "mlp": {"fc1": P("fsdp", None), "fc1_bias": P(None),
                        "fc2": P("fsdp", None), "fc2_bias": P(None)}}

    return {"query_embeddings": P(None, None),
            "attention_layers": [layer() for _ in range(num_layers)]}


def vocab_safe_llama_specs(llama_specs: Specs, vocab_size: int, mesh_shape) -> Specs:
    """Drop the vocab dim's ``model`` sharding when ``model`` does not
    divide the vocab (special tokens grow 32000 to 32003): embed and
    lm_head replicate their vocab dim, the features keep ``fsdp``. Returns
    the (mutated) spec tree."""
    model_n = int(dict(mesh_shape).get("model", 1))
    if model_n > 1 and vocab_size % model_n:
        llama_specs["embed_tokens"] = P(None, "fsdp")
        llama_specs["lm_head"] = P(None, "fsdp")
    return llama_specs


def eventchat_param_specs(cfg, use_qformer: Optional[bool] = None) -> Specs:
    """The spec tree of an EventChat tree of config ``cfg``; the Q-Former's
    specs when ``use_qformer`` (default: the config's gate)."""
    if use_qformer is None:
        use_qformer = cfg.use_event_qformer
    specs = {"clip": clip_param_specs(cfg.vision.num_layers),
             "projector": projector_param_specs(cfg.projector.use_feature_adaptor,
                                                cfg.projector.mlp_depth),
             "llama": llama_param_specs(cfg.llama.num_layers)}
    if use_qformer:
        specs["qformer"] = qformer_param_specs(cfg.qformer.num_layers)
    return specs


def kv_cache_specs() -> Specs:
    """KV cache (L, B, S, KV, hd): batch over (data, fsdp), heads over model."""
    return {"k": P(None, BATCH_AXES, None, "model", None),
            "v": P(None, BATCH_AXES, None, "model", None),
            "length": P(BATCH_AXES)}


def _axes(part: Axis) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def local_slice(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each dimension split into
    ``mesh.parts(axes)`` equal blocks, block ``mesh.index(axes)`` kept.
    Raises when a split does not divide its dimension."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec!r} has more entries than {tuple(x.shape)} has dims")
    for d, part in enumerate(spec):
        axes = _axes(part)
        n = mesh.parts(axes)
        if n == 1:
            continue
        size = x.shape[d]
        if size % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} ({size}) does not split over "
                             f"{axes} ({n} parts)")
        step = size // n
        x = x.narrow(d, mesh.index(axes) * step, step)
    return x


def shard_params(params: Any, specs: Any, mesh, dtype: Optional[torch.dtype] = None) -> Any:
    """This rank's shard of a plain tree, leaf by leaf under ``specs``
    (same structure), on ``mesh.device``; ``dtype`` casts float leaves.
    A structure mismatch raises here."""
    if isinstance(params, dict):
        if set(params) != set(specs):
            raise ValueError(f"spec tree keys {sorted(specs)} != param keys {sorted(params)}")
        return {k: shard_params(v, specs[k], mesh, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        if len(params) != len(specs):
            raise ValueError(f"spec list of {len(specs)} for {len(params)} entries")
        return type(params)(shard_params(v, s, mesh, dtype) for v, s in zip(params, specs))
    return _put(params, specs, mesh, dtype)


def _put(x, spec: P, mesh, dtype=None) -> torch.Tensor:
    """The local block of a host leaf (numpy or torch), copied to the mesh's
    device; ``dtype`` casts a float leaf."""
    t = torch.as_tensor(x)
    block = local_slice(t, spec, mesh)
    if dtype is not None and block.is_floating_point():
        block = block.to(dtype)
    return block.to(mesh.device, copy=True).contiguous()
