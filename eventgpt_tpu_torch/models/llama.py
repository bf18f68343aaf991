"""LLaMA/Vicuna decoder-only LM in PyTorch.

Port of ``eventgpt_tpu/models/llama.py``: RMSNorm, RoPE, GQA attention,
SwiGLU MLP; ``prefill`` writes the KV cache and ``decode_step`` reads it;
``forward`` is the cache-free training forward, one layer block shared
with ``prefill``, each layer checkpointed under grad when ``cfg.remat``. Layers are a list of per-layer parameter dicts
that a Python loop walks (the JAX package's ``lax.scan`` over a stacked
axis). Softmax, RMSNorm and the lm_head logits are f32 whatever the weight
dtype. Prefill attention runs dense or through the flash kernel
(``ops/flash_attention.py``); decode attention is dense over the cache.

Parameters (dense weights in ``nn.Linear``'s (out, in) layout)::

    {"embed_tokens": (V, D),
     "layers": [{"input_layernorm": (D,), "q_proj", "k_proj", "v_proj",
                 "o_proj", "post_attention_layernorm": (D,), "gate_proj",
                 "up_proj", "down_proj"}, ...],
     "norm": (D,), "lm_head": (V, D)}

``decode_kstep`` is the K-token forward of speculative decoding: a window
of K tokens after the cache contents, one causal query per token.

``fuse_llama_params`` replaces q|k|v by ``qkv_proj`` and gate|up by
``gate_up_proj``; ``ops/quant.quantize_llama_params`` replaces weights by
int8 or int4 leaves in the JAX package's (K, N) layout. Every weight
product goes through ``ops/quant.matmul`` (lm_head through
``matmul_f32_out``), which dispatches on the leaf.

The KV cache is ``{"k": [L, B, S, KV, hd], "v": ..., "length": [B]}`` in
the compute dtype, or with ``quant=True`` ``{"k": {"q": int8 [L, B, S, KV,
hd], "s": f32 [L, B, S, KV, 1]}, "v": ...}``, one symmetric scale per
cached vector. The paged layout of the serving engine
(``init_paged_kv_cache``) holds one arena [L, N, bs, KV, hd] per plane
and a block table ``"bt"`` [B, S // bs]: logical slot p of row r lives at
(bt[r, p // bs], p % bs). The port updates every cache in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from eventgpt_tpu_torch.config import LlamaConfig
from eventgpt_tpu_torch.ops.flash_attention import NEG_INF, flash_attention
from eventgpt_tpu_torch.ops.quant import true_div
from eventgpt_tpu_torch.ops.quant import matmul as _mm
from eventgpt_tpu_torch.ops.quant import matmul_f32_out as _mm_f32

Params = Dict[str, Any]
KVCache = Dict[str, Any]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (norm * weight.float()).to(x.dtype)


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables for ``positions``: (..., head_dim) each.

    HF convention: inv_freq over even indices, the table is
    concat(freqs, freqs), rotation by rotate_half.
    """
    hd = cfg.resolved_head_dim()
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd
    inv_freq = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                            device=positions.device), exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd) f32 -> rotated x, the tables
    cast to x.dtype first."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + rotated * sin


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def resize_token_embeddings(params: Params, new_vocab_size: int) -> Params:
    """Grow embed/lm_head rows, new rows the mean of the old ones; shrinking
    truncates. Port of ``eventgpt_tpu/models/llama.resize_token_embeddings``
    (lm_head here is (V, D), so it grows by rows too)."""
    embed, head = params["embed_tokens"], params["lm_head"]
    old = embed.shape[0]
    if new_vocab_size <= old:
        return {**params, "embed_tokens": embed[:new_vocab_size],
                "lm_head": head[:new_vocab_size]}
    n_new = new_vocab_size - old
    embed_new = torch.cat([embed, embed.mean(dim=0, keepdim=True).expand(n_new, -1)])
    head_new = torch.cat([head, head.mean(dim=0, keepdim=True).expand(n_new, -1)])
    return {**params, "embed_tokens": embed_new, "lm_head": head_new}


def copy_tree(params: Params) -> Params:
    """A copy of the tree's dicts and layer list that shares the tensors:
    what the in-place ``fuse_llama_params`` and
    ``ops/quant.quantize_llama_params`` take to leave ``params`` as it is."""
    return {**params, "layers": [dict(layer) for layer in params["layers"]]}


def fuse_llama_params(params: Params) -> Params:
    """Concatenate q|k|v into ``qkv_proj`` and gate|up into ``gate_up_proj``
    along the (out, in) weights' out axis, the JAX package's order, so each
    layer runs 5 weight matmuls instead of 7. Fuse before quantizing, so
    the scales are computed on the fused weights.

    **Replaces the leaves of ``params`` in place**, one layer at a time, so
    that on the card the unfused and fused weights of at most one layer
    coexist (``copy_tree`` keeps the original). Returns ``params``.
    """
    for layer in params["layers"]:
        layer["qkv_proj"] = torch.cat(
            [layer.pop("q_proj"), layer.pop("k_proj"), layer.pop("v_proj")], dim=0)
        layer["gate_up_proj"] = torch.cat([layer.pop("gate_proj"), layer.pop("up_proj")], dim=0)
    return params


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd), GQA head replication."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def _project_qkv(cfg: LlamaConfig, y: torch.Tensor, layer: Params):
    """y (B, T, D) -> q (B, T, H, hd), k/v (B, T, KV, hd), pre-RoPE, from
    split or fused leaves."""
    b, t, _ = y.shape
    hd = cfg.resolved_head_dim()
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    if "qkv_proj" in layer:
        qkv = _mm(y, layer["qkv_proj"])
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        q, k, v = _mm(y, layer["q_proj"]), _mm(y, layer["k_proj"]), _mm(y, layer["v_proj"])
    return (q.reshape(b, t, cfg.num_heads, hd), k.reshape(b, t, cfg.num_kv_heads, hd),
            v.reshape(b, t, cfg.num_kv_heads, hd))


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Materialized-scores attention: f32 scores plus an additive mask
    (B, 1, Q, S), f32 softmax cast to q.dtype. q (B, Q, H, hd), k/v
    (B, S, H, hd) -> (B, Q, H, hd)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd)) + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _mlp_block(x: torch.Tensor, layer: Params) -> torch.Tensor:
    if "gate_up_proj" in layer:
        gu = _mm(x, layer["gate_up_proj"])
        i = gu.shape[-1] // 2
        gate, up = gu[..., :i], gu[..., i:]
    else:
        gate, up = _mm(x, layer["gate_proj"]), _mm(x, layer["up_proj"])
    return _mm(F.silu(gate) * up, layer["down_proj"])


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None, quant: bool = False) -> KVCache:
    """Dense KV cache buffers (L, B, max_len, KV, hd) in ``dtype``; with
    ``quant`` int8 payloads and one f32 scale per (layer, row, slot, head)."""
    hd = cfg.resolved_head_dim()
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)

    def buf():
        if quant:
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device)}
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k": buf(), "v": buf(),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_paged_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, n_blocks: int,
                        block_size: int, dtype: torch.dtype = torch.bfloat16,
                        device: Optional[torch.device] = None, quant: bool = False) -> KVCache:
    """Paged KV cache: one arena (L, n_blocks, block_size, KV, hd) per
    plane (int8 payloads and f32 scales with ``quant``) and a block table
    ``bt`` (batch, max_len // block_size) int32. Which pool block backs
    which row position is host bookkeeping (``serve_blocks.BlockPool``).
    Tables start at block 0, the pool's scratch block, so the frozen
    writes of an unadmitted row land where nothing reads."""
    if max_len % block_size:
        raise ValueError(f"max_len {max_len} must be a block_size {block_size} multiple")
    cache = init_kv_cache(cfg, n_blocks, block_size, dtype=dtype, device=device, quant=quant)
    cache["bt"] = torch.zeros((batch, max_len // block_size), dtype=torch.int32, device=device)
    cache["length"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _kv_is_paged(cache: KVCache) -> bool:
    return "bt" in cache


def _kv_max_len(cache: KVCache) -> int:
    """Logical slots per row: the buffer's slot axis for a dense cache,
    table width times block size for a paged one."""
    buf = cache["k"]
    slots = (buf["q"] if isinstance(buf, dict) else buf).shape[2]
    if _kv_is_paged(cache):
        return cache["bt"].shape[1] * slots
    return slots


def _kv_quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., hd) -> {"q": int8, "s": f32 (..., 1)}; symmetric per vector."""
    x32 = x.float()
    s = true_div(x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def _kv_dequant(leaf: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return (leaf["q"].float() * leaf["s"]).to(dtype)


def _cache_write(buf, li: int, index, vals: torch.Tensor, bt=None) -> None:
    """Write ``vals`` into layer ``li`` of a cache buffer at ``index`` (the
    slots after the layer axis), quantizing them for an int8 buffer.

    With a block table ``bt`` (paged cache), ``index`` is (rows, logical
    slots) and each slot goes to (its row's table block, slot % bs): pure
    indexing, so the values written are the dense path's."""
    if bt is not None:
        rows, slots = index
        bs = (buf["q"] if isinstance(buf, dict) else buf).shape[2]
        index = (bt[rows, slots // bs].long(), slots % bs)
    if isinstance(buf, dict):
        qs = _kv_quantize(vals)
        buf["q"][(li,) + index] = qs["q"]
        buf["s"][(li,) + index] = qs["s"]
    else:
        buf[(li,) + index] = vals.to(buf.dtype)


def _cache_read_layer(buf, li: int, dtype: torch.dtype, bt=None) -> torch.Tensor:
    """Layer ``li`` of a cache buffer as (B, S, KV, hd) in ``dtype``; an
    int8 buffer is dequantized first, as the JAX package's decode does.

    With a block table ``bt`` (paged cache) the row's blocks are gathered
    into the same (B, n_bpr * bs, KV, hd) view the dense cache gives (a
    per-layer temporary; the gather is a copy, so the attention after it
    is the dense path's), then dequantized."""
    if bt is not None:
        idx = bt.long()
        b, nbpr = idx.shape

        def gather(x):
            g = x[li][idx]  # (B, n_bpr, bs, KV, ...)
            return g.reshape((b, nbpr * g.shape[2]) + tuple(g.shape[3:]))

        if isinstance(buf, dict):
            return _kv_dequant({"q": gather(buf["q"]), "s": gather(buf["s"])}, dtype)
        return gather(buf).to(dtype)
    if isinstance(buf, dict):
        return _kv_dequant({"q": buf["q"][li], "s": buf["s"][li]}, dtype)
    return buf[li].to(dtype)


def _additive_mask(visible: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=visible.device)
    return torch.where(visible, zero, torch.tensor(NEG_INF, device=visible.device))


def _layer_block(cfg: LlamaConfig, layer: Params, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, attention_mask: torch.Tensor, mask: Optional[torch.Tensor],
                 cache: Optional[KVCache] = None, li: int = 0) -> torch.Tensor:
    """One decoder layer over a whole prompt (B, T, D) -> (B, T, D): the body
    of ``prefill``'s layer loop and of ``forward``'s. Attention is the flash
    kernel when ``mask`` is None, else dense with that additive mask; with a
    ``cache`` the rotated k/v are written into its layer ``li``."""
    b, t, _ = x.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    y = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
    q, k, v = _project_qkv(cfg, y, layer)
    k = apply_rope(k, cos, sin)
    q = apply_rope(q, cos, sin)
    if cache is not None:
        _cache_write(cache["k"], li, (slice(None), slice(0, t)), k)
        _cache_write(cache["v"], li, (slice(None), slice(0, t)), v)
    k_rep = _repeat_kv(k, h // kvh)
    v_rep = _repeat_kv(v, h // kvh)
    if mask is None:
        ctx = flash_attention(q.contiguous(), k_rep.contiguous(), v_rep.contiguous(),
                              valid=attention_mask, causal=True)
    else:
        ctx = _dense_attention(q, k_rep, v_rep, mask)
    x = x + _mm(ctx.reshape(b, t, -1), layer["o_proj"])
    y2 = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
    return x + _mlp_block(y2, layer)


def _prompt_tables(cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                   attention_mask: torch.Tensor):
    """RoPE tables at each token's position (its count of real tokens before
    it) and the dense path's additive causal + key-padding mask (None on
    the flash path)."""
    t = inputs_embeds.shape[1]
    positions = torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1
    positions = positions.clamp_min(0)
    cos, sin = rope_tables(cfg, positions)
    mask = None
    if cfg.attn_impl != "flash":
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=inputs_embeds.device))
        mask = _additive_mask(causal[None, None] & attention_mask[:, None, None, :])
    return cos, sin, mask


def prefill(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    cache: KVCache,
    last_only: bool = False,
    return_hidden: bool = False,
):
    """Run the full prompt; returns (f32 logits, cache filled in place).

    ``attention_mask`` is bool (B, T): True = real token, False = right
    pad. The prompt occupies cache slots [0, T); cache["length"] becomes
    each row's true prompt length. ``last_only`` returns (B, V) logits at
    each row's last real token instead of (B, T, V). ``return_hidden``
    returns (logits, final-norm hidden, cache): the hidden is (B, D) at the
    last real token with ``last_only``, (B, T, D) otherwise (the seed of
    the Medusa heads' first drafts).
    """
    if _kv_is_paged(cache):
        # Serving prefills a dense row cache and scatters it into the
        # row's pool blocks (serve._admit_row_paged).
        raise ValueError("prefill writes dense caches; scatter into a paged pool via "
                         "the serving admission path")
    b = inputs_embeds.shape[0]
    cos, sin, mask = _prompt_tables(cfg, inputs_embeds, attention_mask)

    x = inputs_embeds
    for li, layer in enumerate(params["layers"]):
        x = _layer_block(cfg, layer, x, cos, sin, attention_mask, mask, cache, li)

    lengths = attention_mask.to(torch.int32).sum(dim=1)
    cache["length"].copy_(lengths)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    if last_only:
        idx = (lengths - 1).clamp_min(0).long()
        x = x[torch.arange(b, device=x.device), idx]  # (B, D)
    logits = _mm_f32(x, params["lm_head"])
    if return_hidden:
        return logits, x, cache
    return logits, cache


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    token_embeds: torch.Tensor,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. token_embeds: (B, 1, D). Returns (f32 logits
    (B, V), cache updated in place).

    The new token lands at slot ``cache["length"]`` with position id equal
    to the number of real tokens so far; it attends to slots [0, length]
    (its own slot included). A paged cache is read through its block
    table and keeps it.
    """
    b = token_embeds.shape[0]
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    max_len = _kv_max_len(cache)
    pos = cache["length"]  # (B,)
    cos, sin = rope_tables(cfg, pos[:, None])
    slot = pos.long()
    valid = torch.arange(max_len, device=pos.device)[None, :] <= slot[:, None]
    mask = _additive_mask(valid[:, None, None, :])
    rows = torch.arange(b, device=pos.device)
    bt = cache.get("bt")

    x = token_embeds
    for li, layer in enumerate(params["layers"]):
        y = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        q, k_new, v_new = _project_qkv(cfg, y, layer)
        k_new = apply_rope(k_new, cos, sin)
        q = apply_rope(q, cos, sin)
        _cache_write(cache["k"], li, (rows, slot), k_new[:, 0], bt)
        _cache_write(cache["v"], li, (rows, slot), v_new[:, 0], bt)
        k_all = _repeat_kv(_cache_read_layer(cache["k"], li, x.dtype, bt), h // kvh)
        v_all = _repeat_kv(_cache_read_layer(cache["v"], li, x.dtype, bt), h // kvh)
        ctx = _dense_attention(q, k_all, v_all, mask)
        x = x + _mm(ctx.reshape(b, 1, -1), layer["o_proj"])
        y2 = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _mlp_block(y2, layer)

    cache["length"] += 1
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return _mm_f32(x[:, 0], params["lm_head"]), cache


def decode_kstep(
    params: Params,
    cfg: LlamaConfig,
    token_embeds: torch.Tensor,
    cache: KVCache,
    return_hidden: bool = False,
):
    """K-token verification step of speculative decoding. token_embeds:
    (B, K, D), a window of candidate tokens after the cache contents.
    Returns (f32 logits (B, K, V), cache) with K slots written and
    ``length`` advanced by K, in place; with ``return_hidden``, (logits,
    final-norm hidden (B, K, D), cache).

    Query i sits at position length + i and sees slots [0, length + i],
    what ``decode_step`` sees when the window is fed one token at a time.
    A caller that commits only a prefix of the window sets ``length``
    back itself (the cache is written in place): slots above ``length``
    are masked from every read and overwritten by the next window. A
    paged cache is read and written through its block table.
    """
    b, kq, _ = token_embeds.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    max_len = _kv_max_len(cache)
    pos = cache["length"][:, None] + torch.arange(kq, device=token_embeds.device)[None, :]
    cos, sin = rope_tables(cfg, pos)
    slots = pos.long()  # (B, K)
    valid = torch.arange(max_len, device=pos.device)[None, None, :] <= slots[:, :, None]
    mask = _additive_mask(valid[:, None])  # (B, 1, K, S)
    rows = torch.arange(b, device=pos.device)[:, None]
    bt = cache.get("bt")

    x = token_embeds
    for li, layer in enumerate(params["layers"]):
        y = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps)
        q, k_new, v_new = _project_qkv(cfg, y, layer)
        k_new = apply_rope(k_new, cos, sin)
        q = apply_rope(q, cos, sin)
        _cache_write(cache["k"], li, (rows, slots), k_new, bt)
        _cache_write(cache["v"], li, (rows, slots), v_new, bt)
        k_all = _repeat_kv(_cache_read_layer(cache["k"], li, x.dtype, bt), h // kvh)
        v_all = _repeat_kv(_cache_read_layer(cache["v"], li, x.dtype, bt), h // kvh)
        ctx = _dense_attention(q, k_all, v_all, mask)
        x = x + _mm(ctx.reshape(b, kq, -1), layer["o_proj"])
        y2 = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
        x = x + _mlp_block(y2, layer)

    cache["length"] += kq
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    logits = _mm_f32(x, params["lm_head"])
    if return_hidden:
        return logits, x, cache
    return logits, cache


def forward(
    params: Params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cache-free full forward -> f32 logits (B, T, V): the training and
    eval path (``eventgpt_tpu/models/llama.forward``). The layers are
    ``prefill``'s, without the cache write. Under grad with ``cfg.remat``,
    each layer runs inside ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward pass, so flash attention launches twice per layer."""
    b, t, _ = inputs_embeds.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.bool, device=inputs_embeds.device)
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy not in ("full", "nothing_saveable"):
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} (saving matmul outputs) is not ported to "
            f"eventgpt_tpu_torch yet; use 'full' or 'nothing_saveable'")
    cos, sin, mask = _prompt_tables(cfg, inputs_embeds, attention_mask)
    x = inputs_embeds
    for layer in params["layers"]:
        if remat:
            x = checkpoint(_layer_block, cfg, layer, x, cos, sin, attention_mask, mask,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_block(cfg, layer, x, cos, sin, attention_mask, mask)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return _mm_f32(x, params["lm_head"])
