"""Mesh-sharded serving: parameter and KV-cache placement for ``generate``
and the ``ContinuousBatcher``.

Port of ``eventgpt_tpu/parallel/serving.py``. Each rank holds its shard of
the EventChat tree as plain local tensors, and the model code calls the
collectives (``models/llama.py`` with ``mesh=``). Layout decisions:

  * The LLaMA leaves take the spec trees of ``parallel/sharding.py``:
    contraction dims over ``fsdp`` (gathered at use, ``gather_at_use``),
    head and column dims over ``model`` (one sum over ``model`` a layer
    half). A rank's heads are ``head_shard``'s.
  * Quantized leaves shard their payload like the weight they replace.
    Their scales keep the weight's output-channel split; over the
    contraction axis an int8 scale (one row) replicates, and an int4 leaf
    split over ``model`` on K takes the scale groups of its own rows (the
    group must divide the rank's K, or its K lie in one group).
  * Fused ``qkv_proj`` / ``gate_up_proj`` leaves split each of their q, k, v
    (gate, up) column blocks over ``model`` and fuse the rank's blocks
    again, so a rank's fused columns are its q heads, then its k, then its
    v. A contiguous split of the fused columns would mix q and k on a rank
    (the JAX package leaves that reshard to GSPMD).
  * Where ``model`` does not divide the KV heads, k/v (and the cache's
    head axis) replicate and each rank maps its q heads onto the KV heads
    it needs; where it does not divide the q heads, attention replicates
    (GSPMD splits such heads unevenly; the port does not). A vocab that
    ``model`` does not divide replicates the vocab dim.
  * The vision tower, projector and Q-Former replicate on every rank (at
    ViT-L about 0.6 GB in bf16; a deliberate difference, memory only).
  * ``context`` must be 1: sequence parallelism is a long-context
    training optimization.

The sharded LLaMA tree carries its global vocab as the int ``vocab_size``:
a rank's embed rows cannot tell a split vocab from a replicated one.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from eventgpt_tpu_torch.ops import quant as quant_mod
from eventgpt_tpu_torch.parallel.sharding import (P, _axes, _put, llama_param_specs,
                                                  local_slice, vocab_safe_llama_specs)

class Fused(P):
    """The spec of a fused leaf: a dense spec whose output dim is made of
    ``blocks`` [(rows, axis or None), ...], each split over its own axis."""

    def __new__(cls, spec: P, blocks: Tuple[Tuple[int, Optional[str]], ...]):
        obj = super().__new__(cls, *spec)
        obj.blocks = tuple(blocks)
        return obj

    def __repr__(self) -> str:
        return f"Fused{tuple(self)!r}{self.blocks!r}"


class HeadShard(NamedTuple):
    """A rank's attention layout: its q heads (from ``first``), the KV heads
    it computes and caches, the KV head of each local q head when the KV
    heads replicate (None: the plain GQA repeat), and whether attention
    is split over ``model`` (an all-reduce after ``o_proj``)."""

    heads: int
    kv_heads: int
    first: int
    kv_index: Optional[Tuple[int, ...]]
    attn_tp: bool


def head_shard(cfg, mesh) -> HeadShard:
    """The attention layout of this rank of ``mesh`` for LLaMA config
    ``cfg`` (the whole model's without a mesh)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    m = 1 if mesh is None else mesh.shape["model"]
    if m == 1 or h % m:
        return HeadShard(h, kv, 0, None, False)
    hl = h // m
    first = mesh.coord["model"] * hl
    if kv % m == 0:
        return HeadShard(hl, kv // m, first, None, True)
    n_rep = h // kv
    return HeadShard(hl, kv, first, tuple((first + j) // n_rep for j in range(hl)), True)


def _not_gathered(part) -> Tuple[str, ...]:
    """The axes of a spec entry that stay split at use (all but ``fsdp``)."""
    return tuple(a for a in _axes(part) if a != "fsdp")


def _slice_out(t: torch.Tensor, dim: int, spec: P, mesh) -> torch.Tensor:
    """The rank's part of ``t``'s output-channel dim ``dim``: block by block
    for a ``Fused`` spec, else split over spec[0]."""
    if not isinstance(spec, Fused):
        return _slice_dim(t, dim, spec[0], mesh)
    parts, start = [], 0
    for rows, ax in spec.blocks:
        parts.append(_slice_dim(t.narrow(dim, start, rows), dim, ax, mesh))
        start += rows
    if start != t.shape[dim]:
        raise ValueError(f"fused blocks of {start} rows for a dim of {t.shape[dim]}")
    return torch.cat(parts, dim=dim)


def _slice_dim(t: torch.Tensor, dim: int, part, mesh) -> torch.Tensor:
    spec = [None] * t.ndim
    spec[dim] = part if part else None
    return local_slice(t, P(*spec), mesh)


def _int4_scale_rows(s: torch.Tensor, k: int, part, mesh) -> torch.Tensor:
    """The group rows of an int4 scale (Kg, N) that cover this rank's K rows
    when ``part``'s axes other than ``fsdp`` split K."""
    axes = _not_gathered(part)
    n = mesh.parts(axes)
    if n == 1:
        return s
    kl, g = k // n, k // s.shape[0]
    lo = mesh.index(axes) * kl
    if kl % g == 0:
        return s[lo // g:(lo + kl) // g]
    if g % kl == 0:
        return s[lo // g:lo // g + 1]
    raise ValueError(f"int4 group {g} neither divides nor is a multiple of the rank's "
                     f"K = {k}/{n}")


def _shard_leaf(leaf: Any, spec: P, mesh, dtype) -> Any:
    """One LLaMA leaf's local shard. ``spec`` is the dense (out, in) spec;
    a quantized leaf's (K, N) arrays read it transposed. Its scale takes
    the output channels' split and replicates over K (the JAX package's
    ``_scale_spec``), but for the group rows of the rank's own K where
    ``model`` splits K (``_int4_scale_rows``)."""
    out_part, in_part = (spec[0], spec[1]) if len(spec) == 2 else (None, None)
    if quant_mod.is_quantized(leaf) or quant_mod.is_quantized4(leaf):
        key = "q4" if "q4" in leaf else "q"
        q = torch.as_tensor(leaf[key])
        s = torch.as_tensor(leaf["s"])
        k = q.shape[0] * (2 if key == "q4" else 1)
        q = _slice_out(_slice_dim(q, 0, in_part, mesh), 1, spec, mesh)
        s = _slice_out(s, 1, spec, mesh)
        if key == "q4":
            s = _int4_scale_rows(s, k, in_part, mesh)
        return {key: q.to(mesh.device, copy=True).contiguous(),
                "s": s.to(mesh.device, dtype=torch.float32, copy=True).contiguous()}
    if quant_mod.is_lora(leaf):
        if isinstance(spec, Fused):
            raise NotImplementedError("LoRA composites over fused leaves do not shard")
        a = _slice_dim(torch.as_tensor(leaf["a"]), 0, _not_gathered(in_part), mesh)
        b = _slice_dim(torch.as_tensor(leaf["b"]), 1, _not_gathered(out_part), mesh)
        out = {"w": _shard_leaf(leaf["w"], spec, mesh, dtype),
               "a": _put(a, P(), mesh, dtype), "b": _put(b, P(), mesh, dtype)}
        out.update({k: v for k, v in leaf.items() if k not in ("w", "a", "b")})
        return out
    t = torch.as_tensor(leaf)
    if t.ndim == 2:
        t = _slice_dim(_slice_out(t, 0, spec, mesh), 1, in_part, mesh)
        return _put(t, P(), mesh, dtype)
    return _put(t, spec, mesh, dtype)


def _adapt_head_specs(llama_specs, cfg, mesh_shape) -> None:
    """Replicate over ``model`` what does not split over it: k/v where
    ``model`` does not divide the KV heads, all of attention where it does
    not divide the q heads. The MLP must split."""
    m = int(dict(mesh_shape).get("model", 1))
    if m == 1:
        return
    if cfg.intermediate_size % m:
        raise ValueError(f"intermediate_size {cfg.intermediate_size} does not split over "
                         f"model={m}")
    rep_attn = cfg.num_heads % m != 0
    rep_kv = rep_attn or cfg.num_kv_heads % m != 0
    if not rep_kv:
        return
    for layer in llama_specs["layers"]:
        for name in ("k_proj", "v_proj") + (("q_proj", "o_proj") if rep_attn else ()):
            layer[name] = P(*(None if p == "model" else p for p in layer[name]))


def _adapt_fused_llama_specs(llama_specs, llama_params, cfg, mesh_shape) -> None:
    """``fuse_llama_params``'s leaves: ``qkv_proj`` splits its q, k and v
    column blocks over ``model`` each (k/v only where the KV heads divide),
    ``gate_up_proj`` its gate and up blocks."""
    hd = cfg.resolved_head_dim()
    for spec, layer in zip(llama_specs["layers"], llama_params["layers"]):
        if "qkv_proj" in layer:
            qa, ka = spec.pop("q_proj")[0], spec.pop("k_proj")[0]
            spec.pop("v_proj")
            blocks = ((cfg.num_heads * hd, qa), (cfg.num_kv_heads * hd, ka),
                      (cfg.num_kv_heads * hd, ka))
            spec["qkv_proj"] = Fused(P("model", "fsdp"), blocks)
        if "gate_up_proj" in layer:
            spec.pop("gate_proj"), spec.pop("up_proj")
            i = cfg.intermediate_size
            spec["gate_up_proj"] = Fused(P("model", "fsdp"), ((i, "model"), (i, "model")))


def _vocab_of(llama_params) -> int:
    head = llama_params["lm_head"]
    if isinstance(head, dict) and "w" in head:
        head = head["w"]
    if isinstance(head, dict):
        return int(head.get("q", head.get("q4")).shape[-1])
    return int(head.shape[0])


def serving_llama_specs(llama_params, cfg, mesh_shape) -> Any:
    """The LLaMA spec tree of the serving layout for this tree: the vocab
    rule, the head rule and the fused leaves applied."""
    specs = llama_param_specs(cfg.num_layers)
    vocab_safe_llama_specs(specs, _vocab_of(llama_params), mesh_shape)
    _adapt_head_specs(specs, cfg, mesh_shape)
    _adapt_fused_llama_specs(specs, llama_params, cfg, mesh_shape)
    return specs


def shard_params_for_serving(params: Any, cfg, mesh, dtype: Optional[torch.dtype] = None) -> Any:
    """This rank's shard of an EventChat tree under the serving layout, on
    ``mesh.device``.

    ``params`` is a host tree (CPU tensors or numpy arrays, dense, int8,
    int4, fused or LoRA leaves); only the rank's slices are copied to its
    device, so a 7B load never holds the whole tree on one device.
    ``dtype`` casts float leaves (quantized payloads and scales keep their
    types). The vision side replicates. The LLaMA tree gains
    ``vocab_size``, the global vocab.
    """
    _require_serving_mesh(mesh)
    return shard_eventchat(params, cfg, mesh, dtype)


def shard_eventchat(params: Any, cfg, mesh, dtype: Optional[torch.dtype] = None) -> Any:
    """``shard_params_for_serving`` on any mesh (training's included): the
    LLaMA under the serving layout, the other subtrees replicated."""
    lp = params["llama"]
    specs = serving_llama_specs(lp, cfg.llama, mesh.shape)
    layers = []
    for layer, lspec in zip(lp["layers"], specs["layers"]):
        if set(layer) != set(lspec):
            raise ValueError(f"layer keys {sorted(layer)} != spec keys {sorted(lspec)}")
        layers.append({k: _shard_leaf(v, lspec[k], mesh, dtype) for k, v in layer.items()})
    llama = {"embed_tokens": _shard_leaf(lp["embed_tokens"], specs["embed_tokens"], mesh, dtype),
             "layers": layers,
             "norm": _put(lp["norm"], P(None), mesh, dtype),
             "lm_head": _shard_leaf(lp["lm_head"], specs["lm_head"], mesh, dtype),
             "vocab_size": _vocab_of(lp)}
    out = {k: replicate(v, mesh, dtype) for k, v in params.items() if k != "llama"}
    out["llama"] = llama
    return out


def gather_at_use(leaf: Any, role: str, mesh) -> Any:
    """A weight leaf with its ``fsdp`` shards gathered (ZeRO-3, at use).
    ``role`` is where the leaf's dense (out, in) spec puts ``fsdp``:
    ``col`` (the input features: q/k/v, gate/up, embed, lm_head) or
    ``row`` (the output features: o, down)."""
    if mesh is None or mesh.shape["fsdp"] == 1:
        return leaf
    if quant_mod.is_lora(leaf):
        return {**leaf, "w": gather_at_use(leaf["w"], role, mesh)}
    if isinstance(leaf, dict):
        key = "q4" if "q4" in leaf else "q"
        if role == "col":
            return {key: mesh.all_gather(leaf[key], "fsdp", 0), "s": leaf["s"]}
        return {key: mesh.all_gather(leaf[key], "fsdp", 1),
                "s": mesh.all_gather(leaf["s"], "fsdp", 1)}
    return mesh.all_gather(leaf, "fsdp", 1 if role == "col" else 0)


def vocab_split(llama_params, mesh) -> bool:
    """Is the vocab dim of embed/lm_head split over ``model`` on this tree?"""
    if mesh is None or mesh.shape["model"] == 1:
        return False
    return int(llama_params["vocab_size"]) % mesh.shape["model"] == 0


def _require_serving_mesh(mesh) -> None:
    if mesh.shape.get("context", 1) > 1:
        raise ValueError(
            "serving meshes must have context=1 (sequence parallelism is a "
            "long-context training optimization; decode attends to the full "
            "cache from one query token)")


def serving_divisors(num_kv_heads: int, mesh_shape, batch: int) -> dict:
    """Per-device byte divisors of the serving layout, as pure arithmetic on
    a ``{axis: size}`` mapping, the JAX package's (the memory ledger's
    capacity model): ``batch`` the largest prefix of (data, fsdp) dividing
    the batch, ``kv_heads`` ``model`` when it divides the KV heads,
    ``weights`` fsdp x model."""
    batch_div = 1
    for ax in ("data", "fsdp"):
        n = int(mesh_shape.get(ax, 1))
        if n > 1 and batch % (batch_div * n) == 0:
            batch_div *= n
    model_n = int(mesh_shape.get("model", 1))
    head_div = model_n if model_n > 1 and num_kv_heads % model_n == 0 else 1
    return {"batch": batch_div, "kv_heads": head_div,
            "weights": int(mesh_shape.get("fsdp", 1)) * model_n}


def serving_batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """Largest prefix of (data, fsdp) whose size product divides ``batch``:
    batch 1 on a wide mesh runs as pure tensor parallelism with weight
    gathering. ``mesh`` is a ``Mesh`` or a ``{axis: size}`` mapping."""
    shape = mesh.shape if hasattr(mesh, "shape") else mesh
    axes, prod = [], 1
    for ax in ("data", "fsdp"):
        n = int(shape.get(ax, 1))
        if n > 1 and batch % (prod * n) == 0:
            axes.append(ax)
            prod *= n
    return tuple(axes)


def batch_rows(mesh, batch: int) -> range:
    """The rows of a ``batch``-row array that this rank holds."""
    axes = serving_batch_axes(mesh, batch)
    n = mesh.parts(axes)
    i = mesh.index(axes)
    return range(i * batch // n, (i + 1) * batch // n)


def shard_batch_array(x, mesh, dtype=None) -> torch.Tensor:
    """This rank's rows of a (B, ...) array, on its device."""
    t = torch.as_tensor(x)
    r = batch_rows(mesh, t.shape[0])
    t = t[r.start:r.stop]
    return t.to(mesh.device, dtype=dtype, copy=True) if dtype is not None \
        else t.to(mesh.device, copy=True)


def replicate(x: Any, mesh, dtype=None) -> Any:
    """A whole tree (or tensor) on the rank's device; ``dtype`` casts float
    leaves."""
    if isinstance(x, dict):
        return {k: replicate(v, mesh, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(replicate(v, mesh, dtype) for v in x)
    if x is None or isinstance(x, (int, float, str)):
        return x
    return _put(x, P(), mesh, dtype)


def place_carry(mesh, batch: int, frozen, n_rem, base_pos=None):
    """The pipelined scheduler's (frozen, n_rem, base_pos) control carry on
    the rank's device. The port's batcher runs every row on every rank
    (its rows replicate over the batch axes), so the carry replicates."""
    put = (lambda x: None if x is None else torch.as_tensor(x).to(mesh.device))
    return put(frozen), put(n_rem), put(base_pos)


def prefix_block_sharding(mesh, cfg) -> P:
    """Spec of one prefix-KV cache entry block (L, 1, S, KV, hd): KV heads
    over ``model`` like the resident cache, the rest replicated."""
    model_n = mesh.shape.get("model", 1)
    head_ax = "model" if model_n > 1 and cfg.num_kv_heads % model_n == 0 else None
    return P(None, None, None, head_ax, None)


def shard_kv_cache(cache: Any, cfg, mesh) -> Any:
    """This rank's part of a whole KV cache: (L, B, S, KV, hd) with the batch
    over the serving batch axes and the KV heads over ``model`` (where it
    divides them); ``length`` with the batch. A paged cache (``bt``) keeps
    every block and row (its arena has no batch axis; the block table and
    lengths are host bookkeeping every rank repeats) and splits only the
    KV heads."""
    head = prefix_block_sharding(mesh, cfg)[3]

    def put(buf, spec):
        if isinstance(buf, dict):
            return {k: _put(v, spec, mesh) for k, v in buf.items()}
        return _put(buf, spec, mesh)

    if "bt" in cache:
        pool = P(None, None, None, head, None)
        return {"k": put(cache["k"], pool), "v": put(cache["v"], pool),
                "bt": _put(cache["bt"], P(), mesh), "length": _put(cache["length"], P(), mesh)}
    plane = cache["k"]["q"] if isinstance(cache["k"], dict) else cache["k"]
    baxes = serving_batch_axes(mesh, int(plane.shape[1])) or None
    buf = P(None, baxes, None, head, None)
    return {"k": put(cache["k"], buf), "v": put(cache["v"], buf),
            "length": _put(cache["length"], P(baxes), mesh)}


def serving_flash_shard_map(mesh, batch: int, num_heads: Optional[int] = None):
    """K1 under a serving mesh: ``f(q, k, v, valid) -> out`` over the rank's
    local blocks, batch rows over the serving batch axes and heads over
    ``model`` (the layout the column-parallel q/k/v products give), so no
    operand is gathered. q/k/v are (B_local, S, H_local, hd) after the GQA
    repeat, ``valid`` (B_local, S) bool; causality is local (context=1).
    Raises where ``model`` does not divide the heads."""
    from eventgpt_tpu_torch.ops.flash_attention import flash_attention

    model_n = mesh.shape.get("model", 1)
    if num_heads is not None and num_heads % model_n:
        raise ValueError(f"flash under a serving mesh shards heads over model: "
                         f"num_heads={num_heads} must divide by model={model_n} "
                         f"(use dense attention otherwise)")

    def local(q, k, v, valid):
        return flash_attention(q, k, v, valid=valid, causal=True)

    return local


def gather_batch(results: List[Any], mesh, batch: int) -> List[Any]:
    """Every row's answer from the rank holding it, in row order, on every
    rank. Ranks holding the same rows must agree: a disagreement raises."""
    axes = serving_batch_axes(mesh, batch)
    mine = (mesh.index(axes), results)
    by_part = {}
    for part, res in mesh.all_gather_object(mine):
        if part in by_part and by_part[part] != res:
            raise RuntimeError(f"ranks holding rows of batch part {part} disagree: "
                               f"{by_part[part]!r} != {res!r}")
        by_part[part] = res
    return [row for part in sorted(by_part) for row in by_part[part]]


def build_serving_mesh(data: int = 1, fsdp: int = 1, model: int = 1,
                       device_type: str = "cuda"):
    """CLI helper: the mesh of the --mesh_* flags; None when every size is 1
    (the single-device fast path)."""
    if data * fsdp * model <= 1:
        return None
    from eventgpt_tpu_torch.config import MeshConfig
    from eventgpt_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(data=data, fsdp=fsdp, context=1, model=model), device_type)
