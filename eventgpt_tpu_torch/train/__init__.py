"""Training: the two-stage recipe (stage-1 projector, stage-2 LoRA) on one
device, ported from ``eventgpt_tpu/train``: ``args``, ``data``, ``optim``,
``lora``, ``steps``, ``trainer``, ``prefetch`` and ``resilience``."""
