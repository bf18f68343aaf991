"""Medusa draft heads: the trained alternative to suffix-lookup drafts.

Port of ``eventgpt_tpu/models/medusa.py`` for inference. K heads predict
the tokens at stream offsets +2 .. +K+1 from the final-norm hidden at one
position (offset +1 is the base lm_head's own prediction). Each head is
one residual SiLU block, ``h_k = x + silu(x @ w_k)``, and the stack is one
(K, D, D) tensor in the JAX package's (in, out) layout, so all heads run
in one batched product and the npz file is the same in both packages.
Logits go through the frozen, possibly quantized ``lm_head`` (K4 under
``--quant int4``). Zero heads give the base model's own next-token logits.

Verification makes any draft exact (``models/eventchat._spec_draft_verify``):
head quality moves the speed, never the chain. ``medusa_loss`` is the
heads' training objective (``train/medusa.py`` fits the stack with it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from eventgpt_tpu_torch.config import LlamaConfig
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models.llama import lm_head_logits

MedusaParams = Dict[str, Any]


def init_medusa_params(cfg: LlamaConfig, num_heads: int, dtype: torch.dtype = torch.float32,
                       device="cuda") -> MedusaParams:
    """K zero heads ``w`` (K, D, D): each head's logits equal the base
    model's next-token logits (the identity start)."""
    d = cfg.hidden_size
    return {"w": torch.zeros((num_heads, d, d), dtype=dtype, device=resolve_device(device))}


def num_draft_heads(medusa: MedusaParams) -> int:
    return int(medusa["w"].shape[0])


def medusa_hidden(medusa: MedusaParams, x: torch.Tensor,
                  k: Optional[int] = None) -> torch.Tensor:
    """(..., D) -> (..., K, D): x + silu(x @ w_k) for the first ``k`` heads
    (all when None), in one batched product in x's dtype."""
    w = medusa["w"] if k is None else medusa["w"][:k]
    proj = torch.einsum("...d,kde->...ke", x, w.to(x.dtype))
    return x[..., None, :] + F.silu(proj)


def medusa_logits(llama_params: Any, medusa: MedusaParams, x: torch.Tensor,
                  k: Optional[int] = None, mesh=None) -> torch.Tensor:
    """(..., D) -> (..., K, V) f32 through the frozen lm_head: head k scores
    the token at offset k + 2 from the position whose hidden is ``x``. On
    a serving mesh the heads replicate and the lm_head is the sharded
    tree's (``llama.lm_head_logits``)."""
    return lm_head_logits(llama_params, medusa_hidden(medusa, x, k), mesh)


def medusa_drafts(llama_params: Any, medusa: MedusaParams, x: torch.Tensor,
                  k: int, mesh=None) -> torch.Tensor:
    """Greedy drafts of the next verification window: (B, D) -> (B, k)
    int32, the argmax of each of the first ``k`` heads."""
    n = num_draft_heads(medusa)
    if k > n:
        raise ValueError(f"window needs {k} drafts but the Medusa stack has {n} heads "
                         f"(train with num_heads >= window - 1)")
    return torch.argmax(medusa_logits(llama_params, medusa, x, k, mesh), dim=-1).to(torch.int32)


def medusa_loss(llama_params: Any, medusa: MedusaParams, hidden: torch.Tensor,
                labels: torch.Tensor, ignore_index: int = -100):
    """Sum over heads of the next-(k+2)-token cross entropy, in f32.

    ``hidden`` (B, T, D) is the final-norm hidden (``llama.prefill`` with
    ``return_hidden=True``), ``labels`` (B, T) the token ids with
    ``ignore_index`` masked. Head k at position t scores ``labels[t + k +
    2]``; positions whose target lies past the end or is ``ignore_index``
    contribute nothing, and a head with no valid target gives 0.0. Returns
    (loss, per-head mean cross entropy (K,))."""
    t = hidden.shape[1]
    k = num_draft_heads(medusa)
    logp = torch.log_softmax(medusa_logits(llama_params, medusa, hidden).float(), dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    losses = []
    for ki in range(k):
        off = ki + 2
        val = t - off
        if val <= 0:
            losses.append(zero)
            continue
        tgt = labels[:, off:].long()                 # (B, T - off)
        valid = tgt != ignore_index
        safe = torch.where(valid, tgt, torch.zeros_like(tgt))
        ce = -torch.gather(logp[:, :val, ki], 2, safe[:, :, None])[:, :, 0]
        losses.append(torch.where(valid, ce, zero).sum() / valid.sum().clamp_min(1))
    per_head = torch.stack(losses)
    return per_head.sum(), per_head


def save_medusa(path: str, medusa: MedusaParams) -> None:
    """The head stack as an npz of ``w`` (K, D, D) f32, the file the JAX
    package's ``save_medusa`` writes and ``load_medusa`` reads."""
    np.savez(path, w=medusa["w"].detach().float().cpu().numpy())


def load_medusa(path: str, dtype: Optional[torch.dtype] = None, device="cuda") -> MedusaParams:
    """A head stack from an npz of either package, onto ``device`` in
    ``dtype`` (the file's own when None)."""
    with np.load(path) as z:
        w = torch.from_numpy(np.array(z["w"]))
    return {"w": w.to(device=resolve_device(device), dtype=dtype or w.dtype)}
