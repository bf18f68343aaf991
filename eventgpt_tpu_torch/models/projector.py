"""Event-feature projection stack: MLP projector + optional feature adaptor.

Port of ``eventgpt_tpu/models/projector.py``: Linear(in -> D), then
(GELU, Linear(D -> D)) x (mlp_depth - 1), then the Linear(D -> D) feature
adaptor. GELU is the exact erf form.

Parameters: ``{"mlp": [{"weight", "bias"}, ...], "adaptor": {"weight",
"bias"}}`` (weights (out, in); no "adaptor" when it is disabled).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def apply_projector(params: Params, features: torch.Tensor) -> torch.Tensor:
    """(..., input_dim) CLIP features -> (..., output_dim) LM-space features."""
    x = features
    for i, layer in enumerate(params["mlp"]):
        if i > 0:
            x = F.gelu(x, approximate="none")
        x = F.linear(x, layer["weight"], layer["bias"])
    return x


def apply_adaptor(params: Params, features: torch.Tensor) -> torch.Tensor:
    """Feature adaptor Linear; identity when the adaptor is disabled."""
    ad = params.get("adaptor")
    if ad is None:
        return features
    return F.linear(features, ad["weight"], ad["bias"])
