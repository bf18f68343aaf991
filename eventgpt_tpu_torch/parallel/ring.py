"""Ring attention: sequence parallelism over the ``context`` mesh axis.

Port of ``eventgpt_tpu/parallel/ring.py``. Q/K/V are split along the
sequence over ``context`` (``sp_common.SP_QKV_SPEC``); each rank attends
its query chunk to the KV chunk it holds while the KV chunks rotate around
the ring (``Mesh.ppermute``, one hop a step), with a flash-style online
softmax in f32, so the (S, S) scores never exist. Causality uses global
positions: at step i a rank holds the chunk of rank ``(idx - i) mod n``.
The softmax is plain torch, as the JAX ring is plain ``jnp``; gradients
flow back around the ring through ``parallel/autograd.ppermute``.

``ring_attention_shard_map(mesh)`` returns ``f(q, k, v, q_valid,
kv_valid)`` over a rank's blocks, the callable ``models/llama.forward``
takes; ``ring_self_attention`` runs it on global arrays that every rank
holds and returns the global output on every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from eventgpt_tpu_torch.parallel import autograd as pgrad
from eventgpt_tpu_torch.parallel.sharding import local_slice
from eventgpt_tpu_torch.parallel.sp_common import SP_QKV_SPEC, SP_VALID_SPEC

NEG = float(torch.finfo(torch.float32).min)


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_valid: torch.Tensor, kv_valid: torch.Tensor, mesh,
                          axis_name: str = "context", causal: bool = True) -> torch.Tensor:
    """One rank's body: its query chunk (B, Sq, H, hd) against every KV
    chunk (B, Sk, H, hd) as they pass, the online softmax in f32; query
    rows with ``q_valid`` False come out zero. Returns q.dtype."""
    n = mesh.shape[axis_name]
    idx = mesh.coord[axis_name]
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    q_pos = idx * sq + torch.arange(sq, device=dev)
    neg = torch.tensor(NEG, device=dev)
    o = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    qf = q.float()
    k_cur, v_cur, kvv_cur = k, v, kv_valid.to(torch.bool)
    for i in range(n):
        src = (idx - i) % n
        k_pos = src * sk + torch.arange(sk, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * scale
        valid = kvv_cur[:, None, None, :]
        if causal:
            valid = valid & (k_pos[None, None, None, :] <= q_pos[None, None, :, None])
        s = torch.where(valid, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # exp(NEG - m_new) underflows to 0 once a row has seen a real key.
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cur.dtype).float(), v_cur.float())
        o = o * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if i + 1 < n:
            k_cur = pgrad.ppermute(k_cur, mesh, axis_name, 1)
            v_cur = pgrad.ppermute(v_cur, mesh, axis_name, 1)
            kvv_cur = mesh.ppermute(kvv_cur, axis_name, 1)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    out = torch.where(q_valid.to(torch.bool)[:, :, None, None], out,
                      torch.zeros((), device=dev))
    return out.to(q.dtype)


def ring_attention_shard_map(mesh, causal: bool = True, axis_name: str = "context"):
    """``f(q, k, v, q_valid, kv_valid) -> out`` over this rank's blocks of
    the ``sp_common`` layout: the form ``models/llama.forward`` calls when
    ``attn_impl == "ring"`` on a mesh with ``context`` > 1."""

    def f(q, k, v, q_valid, kv_valid):
        return _ring_attention_local(q, k, v, q_valid, kv_valid, mesh, axis_name, causal)

    return f


def _gather_sp(out: torch.Tensor, mesh) -> torch.Tensor:
    """The global (B, S, H, hd) array from each rank's block of the
    ``SP_QKV_SPEC`` layout, on every rank."""
    out = mesh.all_gather(out, "model", 2)
    out = mesh.all_gather(out, "context", 1)
    out = mesh.all_gather(out, "fsdp", 0)
    return mesh.all_gather(out, "data", 0)


def local_blocks(mesh, q, k, v, valid):
    """This rank's blocks of global q/k/v (B, S, H, hd) and ``valid`` (B, S)."""
    return ([local_slice(x, SP_QKV_SPEC, mesh) for x in (q, k, v)]
            + [local_slice(valid, SP_VALID_SPEC, mesh)])


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                        valid: Optional[torch.Tensor] = None, causal: bool = True,
                        axis_name: str = "context") -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``context`` axis on
    global q/k/v (B, S, H, hd) that every rank holds: each rank computes
    its block and the global output is gathered on every rank. S must
    divide by the context size; ``valid`` (B, S) marks real tokens."""
    if valid is None:
        valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    ql, kl, vl, vv = local_blocks(mesh, q, k, v, valid)
    out = ring_attention_shard_map(mesh, causal, axis_name)(ql, kl, vl, vv, vv)
    return _gather_sp(out, mesh)


def dense_reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              valid: Optional[torch.Tensor] = None,
                              causal: bool = True) -> torch.Tensor:
    """Unsharded reference: f32 scores, the finite f32 min as the mask
    value, the softmax, zero rows for invalid queries; q.dtype out."""
    b, s, h, hd = q.shape
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    valid = valid.to(torch.bool)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    mask = valid[:, None, None, :]
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
    scores = torch.where(mask, scores, torch.tensor(NEG, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    out = torch.where(valid[:, :, None, None], out, torch.zeros((), device=q.device))
    return out.to(q.dtype)
