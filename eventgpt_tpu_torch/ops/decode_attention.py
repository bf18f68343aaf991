"""Int8-KV decode attention: K2 over the stacked cache and K3 over the
paged arena, each an sm_90a kernel with its plain version.

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
28 MB -> 8.4 us at 3.35 TB/s.

``decode_attention_int8_paged`` (K3) is the port of
``eventgpt_tpu/ops/decode_attention.decode_attention_int8_paged`` (the
Pallas ``_paged_attn_kernel``): the same attention over the paged arena
that ``models/llama.init_paged_kv_cache(quant=True)`` holds, k_q/v_q
(L, N, bs, KV, hd) int8 with scales (L, N, bs, KV, 1), read through a
block table (B, n_bpr) int32: logical slot p of row b is slot p % bs of
pool block ``block_tables[b, p // bs]``. An online softmax (m, l, acc)
carries across the table's entries, one entry at a time, as the Pallas
grid does. Like K2 it is on no model path: the paged decode gathers the
table into a dense view (``models/llama._cache_read_layer``), as the JAX
package does. The kernel is in ``csrc/paged_attention.cu``.

Both kernels split the sequence across blocks, grid (B, KV, n_split): a
scores pass, then a P.V pass that rounds p * v_s against the same max as
the Pallas kernel (the row's for K2, the running max per table entry for
K3) and whose last block for each (row, KV head) combines the splits'
partials in split order (``csrc/decode_split.cuh``). The wrapper picks the
split from static shapes only (``decode_split``, ``paged_split``): never
from ``n_valid``, which lies on the device, so choosing costs no host
sync. It allocates the scratch with ``torch.empty``; the kernels allocate
nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from eventgpt_tpu_torch.ops._build import CudaKernel

NEG_INF = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8  # query heads per KV head the kernel takes
SPLIT_MIN_SLOTS = 64  # the fewest slots a split takes
BLOCKS_PER_SM = 8  # the blocks a launch aims for on each SM
MAX_SPLIT_ENTRIES = 128  # K3 table entries per split (csrc/decode_split.cuh)

_P = ctypes.c_void_p
_I = ctypes.c_int
DECODE_INT8_KERNEL = CudaKernel("decode_attention.cu", {
    "egpt_decode_attention_int8": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _P]),
})
PAGED_INT8_KERNEL = CudaKernel("paged_attention.cu", {
    "egpt_decode_attention_int8_paged": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, ctypes.c_float, _P]),
})


def _split_units(n_units: int, unit_slots: int, pairs: int, sm_count: int,
                 max_units: int) -> tuple:
    """(units per split, n_split) for ``n_units`` units of ``unit_slots``
    slots over ``pairs`` (row, KV head) pairs: enough splits for
    BLOCKS_PER_SM blocks on each of ``sm_count`` SMs, each of at least
    SPLIT_MIN_SLOTS slots and at most ``max_units`` units."""
    min_units = -(-SPLIT_MIN_SLOTS // unit_slots)
    want = -(-BLOCKS_PER_SM * sm_count // max(pairs, 1))
    per = min(max(min_units, -(-n_units // want)), max_units)
    return per, -(-n_units // per)


def decode_split(s_len: int, pairs: int, sm_count: int) -> tuple:
    """K2's (slots per split, n_split) for a cache of ``s_len`` slots and
    ``pairs`` = B * KV: splits of whole 64-slot units, the last one
    ragged."""
    per, n_split = _split_units(-(-s_len // SPLIT_MIN_SLOTS), SPLIT_MIN_SLOTS, pairs,
                                sm_count, s_len)
    return per * SPLIT_MIN_SLOTS, n_split


def paged_split(bs: int, nbpr: int, pairs: int, sm_count: int) -> tuple:
    """K3's (slots per split, n_split) for tables of ``nbpr`` entries of
    ``bs`` slots and ``pairs`` = B * KV: splits of whole table entries."""
    per, n_split = _split_units(nbpr, bs, pairs, sm_count, MAX_SPLIT_ENTRIES)
    return per * bs, n_split


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scratch(b: int, kv: int, g: int, hd: int, n_split: int, slots: int, n_units: int,
             device) -> torch.Tensor:
    """The kernels' f32 scratch, per (row, KV head): for each split acc
    (G * hd), (m, l) per query row and a bad flag; the scores of the
    ``slots`` logical slots and the max of each of ``n_units`` units, per
    query row; the ticket of the combine."""
    per_pair = n_split * (g * hd + 2 * g + 1) + g * slots + g * n_units + 1
    return torch.empty(b * kv * per_pair, dtype=torch.float32, device=device)


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


def _check_args(name: str, q, k_q, k_s, v_q, v_s, li, n_valid):
    """What both kernels take, checked before any pointer is passed: q
    (B, KV, G, hd) bf16 or f32 on a card; k_q/v_q int8 and k_s/v_s f32
    scales of one 5-d shape (L, ..., KV, hd) with hd in {32, 64, 128} and
    G <= 8; every tensor contiguous, 16-byte aligned and on q's device;
    0 <= li < L. Returns (li, n_valid as a contiguous int32 (B,))."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.ndim != 4 or k_q.ndim != 5:
        raise ValueError(f"{name}: q must be (B, KV, G, hd) and the cache (L, ..., KV, hd)")
    b, kv, g, hd = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: q must be bfloat16 or float32, got {q.dtype}")
    for arg, t, dtype, shape in (
            ("k_q", k_q, torch.int8, k_q.shape), ("v_q", v_q, torch.int8, k_q.shape),
            ("k_s", k_s, torch.float32, k_q.shape[:-1] + (1,)),
            ("v_s", v_s, torch.float32, k_q.shape[:-1] + (1,))):
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} != {tuple(shape)}")
    if tuple(k_q.shape[3:]) != (kv, hd):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_q.shape)}")
    if hd not in HEAD_DIMS or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"{name}: the kernel takes hd in {HEAD_DIMS} and 1 <= G <= "
                         f"{MAX_GROUP}; got hd={hd}, G={g}")
    li = int(li)
    if not 0 <= li < k_q.shape[0]:
        raise ValueError(f"{name}: layer {li} out of range [0, {k_q.shape[0]})")
    for arg, t in (("q", q), ("k_q", k_q), ("k_s", k_s), ("v_q", v_q), ("v_s", v_s)):
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    nv = torch.as_tensor(n_valid, device=q.device).to(torch.int32).contiguous()
    if tuple(nv.shape) != (b,):
        raise ValueError(f"{name}: n_valid must be ({b},), got {tuple(nv.shape)}")
    return li, nv


def decode_attention_int8(q, k_q, k_s, v_q, v_s, li, n_valid) -> torch.Tensor:
    """Returns the (B, KV, G, hd) attention context in q.dtype.

    q: (B, KV, G, hd) post-RoPE queries; k_q/v_q: (L, B, S, KV, hd) int8;
    k_s/v_s: (L, B, S, KV, 1) f32; li: the layer; n_valid: (B,) visible
    slot counts. A CPU tensor runs the plain version. A CUDA tensor
    launches the kernel, which takes contiguous bf16 or f32 q with
    hd in {32, 64, 128} and G <= 8, and raises on anything else. Its
    shared memory does not grow with S, so any cache length is taken.
    """
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_q, k_s, v_q, v_s, li, n_valid)
    li, nv = _check_args("decode_attention_int8", q, k_q, k_s, v_q, v_s, li, n_valid)
    b, kv, g, hd = q.shape
    if k_q.shape[1] != b:
        raise ValueError(f"decode_attention_int8: q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_q.shape)}")
    s_len = k_q.shape[2]
    split, n_split = decode_split(s_len, b * kv, sm_count(q.device))
    qb = q.to(torch.bfloat16)
    out = torch.empty_like(q)
    part = _scratch(b, kv, g, hd, n_split, s_len, n_split, q.device)
    lib = DECODE_INT8_KERNEL.lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.egpt_decode_attention_int8(
        qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
        nv.data_ptr(), out.data_ptr(), part.data_ptr(), int(out.dtype == torch.bfloat16), li,
        b, s_len, kv, g, hd, split, n_split, 1.0 / math.sqrt(hd), stream)
    DECODE_INT8_KERNEL.check(err)
    DECODE_INT8_KERNEL.launches += 1
    return out


def decode_attention_int8_paged_plain(q, k_q, k_s, v_q, v_s, li, block_tables,
                                      n_valid) -> torch.Tensor:
    """Plain PyTorch version of K3, in the Pallas kernel's order: one table
    entry at a time, the f32 score (bf16 q . int8 k) * (k_s * scale), the
    finite NEG_INF at logical slots >= n_valid, the running max m, sum l
    and context acc rescaled by exp(m_old - m_new) at each entry, p * v_s
    rounded to bf16 before the P.V dot, and division by max(l, 1e-30) at
    the end. With n_valid = 0 every slot of every entry counts with weight
    1. Returns (B, KV, G, hd) in q.dtype."""
    b, kv, g, hd = q.shape
    n_blocks, bs = k_q.shape[1], k_q.shape[2]
    bt = torch.as_tensor(block_tables, device=q.device).long()
    if bt.numel() and (int(bt.min()) < 0 or int(bt.max()) >= n_blocks):
        raise ValueError(f"decode_attention_int8_paged: block table entries must lie in "
                         f"[0, {n_blocks})")
    scale = 1.0 / math.sqrt(hd)
    qb = q.to(torch.bfloat16).float()
    nv = torch.as_tensor(n_valid, device=q.device).long()
    m = torch.full((b, kv, g, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, kv, g, 1), device=q.device)
    acc = torch.zeros((b, kv, g, hd), device=q.device)
    slot = torch.arange(bs, device=q.device)
    for ni in range(bt.shape[1]):
        blk = bt[:, ni]
        k_scale = (k_s[li, blk, ..., 0] * scale).permute(0, 2, 1)   # (B, KV, bs)
        s = torch.einsum("bkgd,bskd->bkgs", qb, k_q[li, blk].float()) * k_scale[:, :, None, :]
        visible = (slot[None, :] + ni * bs) < nv[:, None]           # (B, bs)
        s = torch.where(visible[:, None, None, :], s, torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        v_scale = v_s[li, blk, ..., 0].permute(0, 2, 1)               # (B, KV, bs)
        pv = (p * v_scale[:, :, None, :]).to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bkgs,bskd->bkgd", pv, v_q[li, blk].float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def decode_attention_int8_paged(q, k_q, k_s, v_q, v_s, li, block_tables,
                                n_valid) -> torch.Tensor:
    """Returns the (B, KV, G, hd) attention context in q.dtype.

    q: (B, KV, G, hd) post-RoPE queries; k_q/v_q: (L, N, bs, KV, hd) int8
    pool arena; k_s/v_s: (L, N, bs, KV, 1) f32; li: the layer;
    block_tables: (B, n_bpr) pool block per table entry; n_valid: (B,)
    visible logical slots. A CPU tensor runs the plain version. A CUDA
    tensor launches the kernel, which takes contiguous bf16 or f32 q with
    hd in {32, 64, 128} and G <= 8, and raises on anything else. The
    kernel reads no table entry outside [0, N): a row whose entries it
    needs fall outside gets NaN instead.
    """
    if q.device.type == "cpu":
        return decode_attention_int8_paged_plain(q, k_q, k_s, v_q, v_s, li, block_tables,
                                                 n_valid)
    name = "decode_attention_int8_paged"
    li, nv = _check_args(name, q, k_q, k_s, v_q, v_s, li, n_valid)
    b, kv, g, hd = q.shape
    n_blocks, bs = k_q.shape[1], k_q.shape[2]
    bt = torch.as_tensor(block_tables, device=q.device).to(torch.int32).contiguous()
    if bt.ndim != 2 or bt.shape[0] != b or bt.shape[1] < 1:
        raise ValueError(f"{name}: block_tables must be ({b}, n_bpr >= 1), got "
                         f"{tuple(bt.shape)}")
    nbpr = bt.shape[1]
    split, n_split = paged_split(bs, nbpr, b * kv, sm_count(q.device))
    qb = q.to(torch.bfloat16)
    out = torch.empty_like(q)
    part = _scratch(b, kv, g, hd, n_split, nbpr * bs, nbpr, q.device)
    lib = PAGED_INT8_KERNEL.lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.egpt_decode_attention_int8_paged(
        qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
        bt.data_ptr(), nv.data_ptr(), out.data_ptr(), part.data_ptr(),
        int(out.dtype == torch.bfloat16), li, b, n_blocks, bs, nbpr, kv, g, hd, split, n_split,
        1.0 / math.sqrt(hd), stream)
    PAGED_INT8_KERNEL.check(err)
    PAGED_INT8_KERNEL.launches += 1
    return out
