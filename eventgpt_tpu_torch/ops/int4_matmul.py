"""Packed-int4 weight-only matmul (K4): the sm_90a kernel and its plain version.

``int4_matmul`` is the port of ``eventgpt_tpu/ops/int4_matmul.py`` (the
Pallas ``_int4_kernel``). On a CUDA tensor it launches the hand-written
kernel in ``csrc/int4_matmul.cu`` or raises; on a CPU tensor it runs
``int4_matmul_reference``, the plain PyTorch version of the same function.

Layout (``ops/quant.quantize_tensor4``): byte ``[r, n]`` of ``q4`` holds
contraction rows ``2r`` (high nibble) and ``2r+1`` (low nibble) as
offset-binary ``value + 8``; ``s[g, n]`` scales the ``G = K / s.shape[0]``
rows of group ``g``. x is rounded to bf16; each group's even-row and
odd-row partial dots are summed in f32, multiplied by the f32 group scale,
and summed over the groups.

Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at decode (M = 4) the
packed weight and its scales, 0.53 bytes per weight; at prefill
(M = 3396, K = 4096, N = 11008) the 306 GFLOP of the product.

At M <= 16 the kernel splits K: ``decode_plan`` gives its launch, which
depends on the static shapes only. Each 128-column tile is one cluster of
8 blocks; split s folds groups s, s + 8, ... in ascending order, and the
cluster sums the 8 partials in split order from 0, in the same launch.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from eventgpt_tpu_torch.ops._build import CudaKernel

BLOCK_N = 256
BLOCK_KP = 128  # packed rows per Pallas step = 256 contraction rows
KERNEL_GROUP_STEP = 16  # the card kernel's mma depth: its group must be a multiple
DECODE_MAX_M = 16  # the card kernel's decode path takes M <= 16, its prefill path the rest
DECODE_SPLITS = 8  # decode blocks per column tile, one cluster (DEC_SPLITS in the source)
DECODE_TILE_N = 128  # output columns of a decode block (DEC_BN in the source)

_P = ctypes.c_void_p
_I = ctypes.c_int
INT4_KERNEL = CudaKernel("int4_matmul.cu", {
    "egpt_int4_matmul": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
})
# The kernel's launches by (path, K, N) and by (path, M), path "decode" or
# "prefill", raised beside ``INT4_KERNEL.launches``: a run can show how its
# products were routed.
LAUNCHES_BY_SHAPE: Counter = Counter()
LAUNCHES_BY_M: Counter = Counter()


def supported(k: int, n: int, group: int) -> bool:
    """The JAX package's shape gate for the kernel (a copy of
    ``eventgpt_tpu/ops/int4_matmul.supported``); ``quant._matmul4`` runs
    the grouped einsum where it does not hold."""
    hk = k // 2
    return (
        k % 2 == 0
        and n % BLOCK_N == 0
        and hk % BLOCK_KP == 0
        and group % 2 == 0
        and (group // 2) <= BLOCK_KP
        and BLOCK_KP % (group // 2) == 0
    )


def decode_plan(m: int, k: int, n: int, group: int) -> dict | None:
    """The card kernel's launch for x (m, k) @ a (k, n) weight in groups of
    ``group`` rows, or None where m > DECODE_MAX_M (the prefill path):
    ``n_split`` splits of the groups (``split_groups``) for each
    ``tile_n``-column tile, the splits of a tile one cluster of ``cluster``
    blocks, ``blocks`` in all."""
    if m > DECODE_MAX_M:
        return None
    return {"n_split": DECODE_SPLITS, "tile_n": DECODE_TILE_N, "cluster": DECODE_SPLITS,
            "blocks": -(-n // DECODE_TILE_N) * DECODE_SPLITS}


def split_groups(n_groups: int, n_split: int = DECODE_SPLITS) -> list:
    """The groups each split of the decode path folds, in its order: split
    s takes s, s + n_split, ...; a split past the last group is empty and
    adds zeros."""
    return [list(range(sp, n_groups, n_split)) for sp in range(n_split)]


def int4_matmul_reference(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x (M, K) -> (M, N) f32.

    x rounded to bf16; nibbles to centred integers; per group, the f32 dot
    of the even rows with the high plane plus the odd rows with the low
    plane, times the f32 group scale, summed over the groups in order.
    """
    m, k = x.shape
    hk, n = q4.shape
    gc = s.shape[0]
    hg = hk // gc  # packed rows per group
    xb = x.to(torch.bfloat16).float().reshape(m, hk, 2)
    hi = ((q4 >> 4).to(torch.int32) - 8).float()
    lo = ((q4 & 0xF).to(torch.int32) - 8).float()
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g in range(gc):
        rows = slice(g * hg, (g + 1) * hg)
        part = xb[:, rows, 0] @ hi[rows] + xb[:, rows, 1] @ lo[rows]
        out += part * s[g]
    return out


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ packed-int4 weight -> (M, N) f32.

    q4: (K/2, N) uint8, s: (K/G, N) f32, the ``quantize_tensor4`` layout.
    A CPU tensor runs the plain version. A CUDA tensor launches the kernel,
    which takes a contiguous floating x (rounded to bf16 here), contiguous
    uint8 q4 and f32 s with N a multiple of 32 and G a multiple of 16, and
    raises on anything else.
    """
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q4, s)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if x.ndim != 2 or q4.ndim != 2 or s.ndim != 2:
        raise ValueError("int4_matmul: x, q4 and s must be 2-D")
    m, k = x.shape
    hk, n = q4.shape
    gc = s.shape[0]
    if not x.is_floating_point():
        raise ValueError(f"int4_matmul: x must be floating, got {x.dtype}")
    if q4.dtype != torch.uint8:
        raise ValueError(f"int4_matmul: q4 must be uint8, got {q4.dtype}")
    if s.dtype != torch.float32:
        raise ValueError(f"int4_matmul: s must be float32, got {s.dtype}")
    if k != 2 * hk or s.shape[1] != n or gc == 0 or k % gc:
        raise ValueError(f"int4_matmul: shapes x {tuple(x.shape)}, q4 {tuple(q4.shape)}, "
                         f"s {tuple(s.shape)} do not match")
    group = k // gc
    if n % 32 or group % KERNEL_GROUP_STEP:
        raise ValueError(f"int4_matmul: the kernel needs N % 32 == 0 and a group that is a "
                         f"multiple of {KERNEL_GROUP_STEP}; got N={n}, group={group}")
    for name, t in (("x", x), ("q4", q4), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"int4_matmul: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4_matmul: {name} must be contiguous and 16-byte aligned")
    xb = x.to(torch.bfloat16)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    lib = INT4_KERNEL.lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.egpt_int4_matmul(xb.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(),
                               m, k, n, group, stream)
    INT4_KERNEL.check(err)
    path = "prefill" if decode_plan(m, k, n, group) is None else "decode"
    INT4_KERNEL.count_launch((LAUNCHES_BY_SHAPE, (path, k, n)), (LAUNCHES_BY_M, (path, m)))
    return out
