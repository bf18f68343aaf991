"""EventGPT in PyTorch for NVIDIA Hopper (H100).

The port of ``eventgpt_tpu`` (JAX on a TPU) that runs one event-QA answer
on a CUDA card: event rasterization and CLIP preprocessing on the host,
CLIP ViT -> projector -> spatio-temporal pooling -> LLaMA on the device,
with prefill attention in a hand-written sm_90a kernel
(``csrc/flash_attention.cu``), and trains the projector and LoRA adapters
(``train/``, ``cli/train.py``) through the same kernel and its gradient.

Module names mirror ``eventgpt_tpu`` so each counterpart is easy to find.
The package imports ``torch`` and numpy only: never ``jax`` and never
``eventgpt_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from eventgpt_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
