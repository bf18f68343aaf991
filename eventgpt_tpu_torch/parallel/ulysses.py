"""Ulysses all-to-all sequence parallelism over the ``context`` axis.

Port of ``eventgpt_tpu/parallel/ulysses.py``, the second context-parallel
mode beside the ring (``parallel/ring.py``): an all-to-all trades each
rank's sequence chunk for a head block (every rank then holds the whole
sequence for H/C of its heads), attention runs locally over the whole
sequence, and the inverse all-to-all gives the sequence chunks back. The
exchanges are ``parallel/autograd.all_to_all`` (the backward is the
inverse exchange). ``inner="flash"`` runs K1 (``ops/flash_attention``; its
autograd Function under grad, the plain version on a CPU tensor) over the
gathered sequence; ``inner="dense"`` the materialized scores.

K/V may come with their own (unrepeated) GQA head count
(``accepts_unrepeated_kv``): they cross the exchange at KV heads and are
repeated after it when contiguous query-head blocks map onto contiguous KV
blocks (KV % C == 0 and (H/C) % rep == 0), else before it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from eventgpt_tpu_torch.parallel import autograd as pgrad
from eventgpt_tpu_torch.parallel.ring import NEG, _gather_sp, local_blocks


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*rep, hd), the LLaMA GQA repeat."""
    from eventgpt_tpu_torch.models.llama import _repeat_kv

    return _repeat_kv(x, rep)


def _ulysses_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             q_valid: torch.Tensor, kv_valid: torch.Tensor, mesh,
                             axis_name: str = "context", causal: bool = True,
                             inner: str = "flash") -> torch.Tensor:
    """One rank's body: q (B, S/C, H, hd) and unrepeated k/v (B, S/C, KV,
    hd) exchanged to head blocks over the whole sequence, attended, and
    exchanged back; query rows with ``q_valid`` False come out zero."""
    ctx = mesh.shape[axis_name]
    rep = q.shape[2] // k.shape[2]
    post_repeat = rep > 1 and k.shape[2] % ctx == 0 and (q.shape[2] // ctx) % rep == 0
    if rep > 1 and not post_repeat:
        k, v = _repeat_heads(k, rep), _repeat_heads(v, rep)
    # sequence chunks -> head blocks: rank j receives head block j over the
    # whole sequence (chunks concatenated in coordinate = token order).
    qh, kh, vh = (pgrad.all_to_all(x.contiguous(), mesh, axis_name, 2, 1) for x in (q, k, v))
    kvv = mesh.all_gather(kv_valid.to(torch.bool), axis_name, 1)  # (B, S)
    if post_repeat:
        kh, vh = _repeat_heads(kh, rep), _repeat_heads(vh, rep)
    if inner == "flash":
        from eventgpt_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(), valid=kvv,
                              causal=causal)
    else:
        s = qh.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) / math.sqrt(qh.shape[-1])
        mask = kvv[:, None, None, :]
        if causal:
            pos = torch.arange(s, device=q.device)
            mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
        scores = torch.where(mask, scores, torch.tensor(NEG, device=q.device))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vh.dtype).float(),
                           vh.float()).to(q.dtype)
    # head blocks -> sequence chunks (the exact inverse exchange).
    out = pgrad.all_to_all(out.contiguous(), mesh, axis_name, 1, 2)
    return torch.where(q_valid.to(torch.bool)[:, :, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def ulysses_attention_shard_map(mesh, causal: bool = True, axis_name: str = "context",
                                inner: str = "flash"):
    """``f(q, k, v, q_valid, kv_valid) -> out`` over this rank's blocks, the
    ring's calling convention: the form ``models/llama.forward`` calls when
    ``attn_impl == "ulysses"``. A rank's heads (H / model) must divide by
    the context size; K/V may be unrepeated (``accepts_unrepeated_kv``)."""

    def checked(q, k, v, q_valid, kv_valid):
        local_heads = q.shape[2]
        ctx = mesh.shape[axis_name]
        if local_heads % max(ctx, 1):
            raise ValueError(
                f"ulysses re-shards heads over the context axis: "
                f"H/model = {local_heads} must divide by context={ctx} "
                f"(use ring attention otherwise)"
            )
        return _ulysses_attention_local(q, k, v, q_valid, kv_valid, mesh, axis_name,
                                        causal, inner)

    checked.accepts_unrepeated_kv = True
    return checked


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           valid: Optional[torch.Tensor] = None, causal: bool = True,
                           axis_name: str = "context", inner: str = "flash") -> torch.Tensor:
    """Global q/k/v (B, S, H, hd) that every rank holds -> the global output
    on every rank; S must divide by the context size and H by context x
    model."""
    if valid is None:
        valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    ql, kl, vl, vv = local_blocks(mesh, q, k, v, valid)
    out = ulysses_attention_shard_map(mesh, causal, axis_name, inner)(ql, kl, vl, vv, vv)
    return _gather_sp(out, mesh)
