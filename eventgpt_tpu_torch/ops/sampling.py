"""Token sampling: greedy, temperature, top-p.

Port of ``eventgpt_tpu/ops/sampling.py``. Randomness comes from an
explicit ``torch.Generator``; it draws other numbers than ``jax.random``
from the same seed, so only greedy chains can match the JAX package token
for token.
"""

from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) argmax token ids (the first maximum on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the smallest nucleus with cumulative prob >= top_p.

    Keeps every token whose inclusion is needed to reach top_p (the first
    token crossing the threshold stays).
    """
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    # Position i is cut iff the cumulative mass *before* it already >= top_p.
    cut = (cum - sorted_probs) >= top_p
    inf = torch.tensor(float("inf"), dtype=logits.dtype, device=logits.device)
    threshold = torch.where(cut, inf, sorted_logits).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, -inf, logits)


def sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """(B, V) logits -> (B,) sampled ids. temperature <= 0 means greedy."""
    if temperature <= 0.0:
        return greedy(logits)
    scaled = logits.float() / temperature
    if top_p < 1.0:
        scaled = top_p_filter(scaled, top_p)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
