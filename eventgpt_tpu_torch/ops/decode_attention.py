"""Int8-KV decode attention (K2): the sm_90a kernel and its plain version.

``decode_attention_int8`` is the port of
``eventgpt_tpu/ops/decode_attention.decode_attention_int8`` (the Pallas
``_decode_attn_kernel``): single-query GQA attention of q (B, KV, G, hd)
over one layer of the stacked int8 cache that ``models/llama.init_kv_cache
(quant=True)`` holds, k_q/v_q (L, B, S, KV, hd) int8 with f32 per-vector
scales k_s/v_s (L, B, S, KV, 1). The layer is the index ``li``; slots
``[0, n_valid[b])`` are visible. On a CUDA tensor it launches the kernel in
``csrc/decode_attention.cu`` or raises; on a CPU tensor it runs
``decode_attention_int8_plain``.

Like the JAX package, the port's decode does not call it: decode
dequantizes the cache and runs dense attention
(``models/llama._cache_read_layer``). The kernel is held against its plain
version on the cache that the quantized one-shot path writes.

Bound on an H100 SXM at B=4, S=896, KV=32, hd=128 with ~850 visible slots
a row: the int8 K/V payloads and f32 scales over the visible slots, about
28 MB -> 8.5 us at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import math

import torch

from eventgpt_tpu_torch.ops._build import CudaKernel

NEG_INF = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8  # query heads per KV head the kernel takes

_P = ctypes.c_void_p
_I = ctypes.c_int
DECODE_INT8_KERNEL = CudaKernel("decode_attention.cu", {
    "egpt_decode_attention_int8": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]),
})


def decode_attention_int8_plain(q, k_q, k_s, v_q, v_s, li, n_valid) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the Pallas kernel's arithmetic:
    bf16 q and int8 k; the f32 score times (k_s * scale); the finite
    NEG_INF at slots >= n_valid; the unnormalised exp; p * v_s rounded to
    bf16 before the P.V dot; division by max(l, 1e-30). Returns
    (B, KV, G, hd) in q.dtype."""
    b, kv, g, hd = q.shape
    s_len = k_q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qb = q.to(torch.bfloat16).float()
    k_scale = (k_s[li, ..., 0] * scale).permute(0, 2, 1)        # (B, KV, S)
    scores = torch.einsum("bkgd,bskd->bkgs", qb, k_q[li].float()) * k_scale[:, :, None, :]
    nv = torch.as_tensor(n_valid, device=q.device).long()
    visible = torch.arange(s_len, device=q.device)[None, :] < nv[:, None]
    scores = torch.where(visible[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    v_scale = v_s[li, ..., 0].permute(0, 2, 1)                   # (B, KV, S)
    pv = (p * v_scale[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bkgs,bskd->bkgd", pv, v_q[li].float()) / l.clamp_min(1e-30)
    return out.to(q.dtype)


def decode_attention_int8(q, k_q, k_s, v_q, v_s, li, n_valid) -> torch.Tensor:
    """Returns the (B, KV, G, hd) attention context in q.dtype.

    q: (B, KV, G, hd) post-RoPE queries; k_q/v_q: (L, B, S, KV, hd) int8;
    k_s/v_s: (L, B, S, KV, 1) f32; li: the layer; n_valid: (B,) visible
    slot counts. A CPU tensor runs the plain version. A CUDA tensor
    launches the kernel, which takes contiguous bf16 or f32 q with
    hd in {32, 64, 128} and G <= 8, and raises on anything else (a cache
    whose G * S scores overflow the block's shared memory, beyond ~47K
    slots at G = 1, is refused by the kernel's entry point).
    """
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_q, k_s, v_q, v_s, li, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: unsupported device {q.device}")
    if q.ndim != 4 or k_q.ndim != 5:
        raise ValueError("decode_attention_int8: q must be (B, KV, G, hd) and the "
                         "cache (L, B, S, KV, hd)")
    b, kv, g, hd = q.shape
    n_layers, cb, s_len, ckv, chd = k_q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode_attention_int8: q must be bfloat16 or float32, got {q.dtype}")
    for name, t, dtype, shape in (
            ("k_q", k_q, torch.int8, k_q.shape), ("v_q", v_q, torch.int8, k_q.shape),
            ("k_s", k_s, torch.float32, k_q.shape[:-1] + (1,)),
            ("v_s", v_s, torch.float32, k_q.shape[:-1] + (1,))):
        if t.dtype != dtype:
            raise ValueError(f"decode_attention_int8: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"decode_attention_int8: {name} shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
    if (cb, ckv, chd) != (b, kv, hd):
        raise ValueError(f"decode_attention_int8: q {tuple(q.shape)} does not match the "
                         f"cache {tuple(k_q.shape)}")
    if hd not in HEAD_DIMS or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"decode_attention_int8: the kernel takes hd in {HEAD_DIMS} and "
                         f"1 <= G <= {MAX_GROUP}; got hd={hd}, G={g}")
    li = int(li)
    if not 0 <= li < n_layers:
        raise ValueError(f"decode_attention_int8: layer {li} out of range [0, {n_layers})")
    for name, t in (("q", q), ("k_q", k_q), ("k_s", k_s), ("v_q", v_q), ("v_s", v_s)):
        if t.device != q.device:
            raise ValueError(f"decode_attention_int8: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention_int8: {name} must be contiguous and "
                             f"16-byte aligned")
    nv = torch.as_tensor(n_valid, device=q.device).to(torch.int32).contiguous()
    if tuple(nv.shape) != (b,):
        raise ValueError(f"decode_attention_int8: n_valid must be ({b},), got {tuple(nv.shape)}")
    qb = q.to(torch.bfloat16)
    out = torch.empty_like(q)
    lib = DECODE_INT8_KERNEL.lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.egpt_decode_attention_int8(
        qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
        nv.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16), li, b, s_len,
        kv, g, hd, 1.0 / math.sqrt(hd), stream)
    DECODE_INT8_KERNEL.check(err)
    DECODE_INT8_KERNEL.launches += 1
    return out
