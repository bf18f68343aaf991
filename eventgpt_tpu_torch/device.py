"""Device selection for the port's entry points.

Entry points default to ``cuda`` and never fall back to the CPU on their
own: the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``device`` (default ``cuda``) as a ``torch.device``; raises when a
    CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
