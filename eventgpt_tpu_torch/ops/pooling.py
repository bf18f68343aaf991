"""Spatio-temporal aggregation of per-frame vision features.

Port of ``eventgpt_tpu/ops/pooling.py``: from per-frame features
(t, s, c), temporal tokens are the mean over the spatial axis, zero-padded
or truncated to ``num_temporal_tokens``; spatial tokens are the mean over
the temporal axis; the output is their concatenation. With t=5 frames and
s=577 CLIP tokens that is 582 event tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def spatio_temporal_pool(
    features: torch.Tensor,
    num_temporal_tokens: Optional[int] = None,
) -> torch.Tensor:
    """(t, s, c) frame features -> (num_temporal_tokens + s, c) event tokens."""
    if features.ndim != 3:
        raise ValueError(f"expected (t, s, c) features, got shape {tuple(features.shape)}")
    t = features.shape[0]
    if num_temporal_tokens is None:
        num_temporal_tokens = t

    temporal = features.mean(dim=1)  # (t, c)
    if num_temporal_tokens > t:
        temporal = F.pad(temporal, (0, 0, 0, num_temporal_tokens - t))
    elif num_temporal_tokens < t:
        temporal = temporal[:num_temporal_tokens]

    spatial = features.mean(dim=0)  # (s, c)
    return torch.cat([temporal, spatial], dim=0)
