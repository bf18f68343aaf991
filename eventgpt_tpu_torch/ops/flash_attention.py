"""Flash attention for the prefill path: the sm_90a kernel and its plain version.

``flash_attention`` is the port of ``eventgpt_tpu/ops/flash_attention.py``
(the Pallas ``_flash_kernel``). On a CUDA tensor it launches the
hand-written kernel in ``csrc/flash_attention.cu`` or raises; on a CPU
tensor it runs ``flash_attention_reference``, the plain PyTorch version
of the same function.

Bound on an H100 SXM at the 7B prefill shape of ``chip_smoke.py`` (B=4,
S=849, H=32, hd=128, bf16): 111 MB of q/k/v/out and mask -> 33 us at
3.35 TB/s (the bound), against 23.6 GFLOP causal -> 24 us at 989 TFLOP/s.
What holds the kernel back is the issue slots and latency of its 4 warps
per 64-row q tile, not either bound: every 64-key tile costs each warp
128 ``mma.sync``, 32 ``expf`` a thread and the rescale of its f32
accumulator, and each tile comes from L2.

The kernel takes its Q, K and V fragments through ``ldmatrix`` (V
transposed), streams K and V tiles through a 2-stage ``cp.async`` ring
(tile kb + 1 in flight while tile kb computes, one barrier a tile, rows
past S zero-filled), tests each tile's key mask in a 64-bit register, and
runs the heaviest causal q tiles first. Its output is bit-identical to the
first version of the kernel: the same values reach the same fragment
registers, and the mma order, the 64-key tile order, ``expf`` on the scaled
f32 score and the row-sum order are kept; only how the operands arrive and
when blocks run changed.

Training differentiates through K1: under grad, ``flash_attention`` goes
through ``FlashAttentionFunction``, whose forward is the same kernel (the
plain version on a CPU tensor) and whose backward is
``flash_attention_backward``, the JAX package's ``_flash_vjp_bwd`` written
in plain torch on both devices: the scores rebuilt in f32 with the finite
NEG_INF mask, the softmax, padded query rows zeroed, then dv, dp, ds, dq and
dk as dense f32 products. The JAX backward is dense XLA outside any Pallas
kernel, so its port is plain torch; a hand-written Hopper backward is queued
work. It materializes four (B, H, S, S) f32 tensors per call.
``LAUNCHES_BY_PATH`` counts K1's launches by inference forward, training
forward and the recompute of a checkpointed layer, and the backward's calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from eventgpt_tpu_torch.ops._build import CudaKernel

NEG_INF = float(torch.finfo(torch.float32).min)
HEAD_DIM = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
FLASH_KERNEL = CudaKernel("flash_attention.cu", {
    "egpt_flash_attention_fwd_bf16": (
        ctypes.c_int, [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]),
})
# K1 launches by the path that made them ("inference": no autograd graph;
# "train_forward": under grad; "recompute": under grad inside a backward
# pass, i.e. a checkpointed layer run again), and "backward": calls of
# ``flash_attention_backward`` through the autograd Function, on any device.
LAUNCHES_BY_PATH: Dict[str, int] = {"inference": 0, "train_forward": 0, "recompute": 0,
                                    "backward": 0}


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: masked softmax attention in f32.

    q/k/v: (B, S, H, hd), KV already head-repeated; ``valid``: (B, S) bool
    padding mask. Masked scores take the finite NEG_INF, the softmax sum is
    clamped at 1e-30, and query rows with ``valid`` False come out exactly
    zero. Returns (B, S, H, hd) in q.dtype.
    """
    b, s, h, hd = q.shape
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    valid = valid.to(torch.bool)
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    mask = valid[:, None, None, :]
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    out = torch.where(valid[:, :, None, None], out, torch.zeros((), device=q.device))
    return out.to(q.dtype)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: Optional[torch.Tensor], causal: bool, path: str) -> torch.Tensor:
    """The forward on q's device: the plain version on a CPU tensor, the
    kernel on a CUDA tensor (counted under ``path``)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, valid, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, s, h, hd = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, got {x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"flash_attention: {name} shape {tuple(x.shape)} != q shape {tuple(q.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    if hd != HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim must be {HEAD_DIM}, got {hd}")
    if valid is None:
        valid_u8 = torch.ones((b, s), dtype=torch.uint8, device=q.device)
    else:
        if tuple(valid.shape) != (b, s) or valid.device != q.device:
            raise ValueError(f"flash_attention: valid must be ({b}, {s}) on {q.device}")
        valid_u8 = valid.to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    lib = FLASH_KERNEL.lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.egpt_flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_u8.data_ptr(),
        out.data_ptr(), b, s, h, int(causal), 1.0 / math.sqrt(hd), stream)
    FLASH_KERNEL.check(err)
    FLASH_KERNEL.count_launch((LAUNCHES_BY_PATH, path))
    return out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             valid: Optional[torch.Tensor], g: torch.Tensor,
                             causal: bool = True):
    """(dq, dk, dv) of the attention at the output cotangent ``g``, each in
    its input's dtype: the JAX package's ``_flash_vjp_bwd`` in f32. Padded
    query rows (``valid`` False) get zero probabilities, as the forward
    zeroes their output, so they pass no gradient."""
    b, s, h, hd = q.shape
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    valid = valid.to(torch.bool)
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = valid[:, None, None, :]
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    del scores, mask
    p = p * valid[:, None, :, None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    del dp, p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """K1 with a gradient: forward through ``_flash_forward``, saving q, k,
    v and the mask (not the output); backward through
    ``flash_attention_backward``. ``valid`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, valid, causal):
        path = "recompute" if torch._C._current_graph_task_id() != -1 else "train_forward"
        out = _flash_forward(q, k, v, valid, causal, path)
        ctx.save_for_backward(q, k, v, valid)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid = ctx.saved_tensors
        LAUNCHES_BY_PATH["backward"] += 1
        dq, dk, dv = flash_attention_backward(q, k, v, valid, g, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Fused attention. q/k/v: (B, S, H, hd) with KV already head-repeated;
    ``valid``: (B, S) bool padding mask. Returns (B, S, H, hd) in q.dtype.

    A CPU tensor runs the plain version. A CUDA tensor launches the kernel,
    which takes contiguous bf16 q/k/v of one shape with hd = 128, and
    raises on anything else. With grad enabled and an input that requires
    grad, the call goes through ``FlashAttentionFunction`` (the same
    forward, and a backward); otherwise straight to the forward.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, valid, causal)
    return _flash_forward(q, k, v, valid, causal, "inference")
