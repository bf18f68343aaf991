"""Training argument dataclasses: a copy of ``eventgpt_tpu/train/args.py``.

``ModelArguments``, ``DataArguments`` and ``TrainingArguments`` field for
field with the JAX package's defaults, so both packages' ``cli/train`` take
the same flags. In the port, ``mesh_*`` other than one device,
``mesh_context > 1`` and the sequence-parallel ``attn_impl`` values raise
``NotImplementedError`` in ``train/trainer.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ModelArguments:
    model_name_or_path: str = "tiny-random"
    freeze_backbone: bool = False
    tune_mm_mlp_adapter: bool = False
    vision_tower: Optional[str] = None
    mm_vision_select_layer: int = -1
    pretrain_mm_mlp_adapter: Optional[str] = None
    # Q-Former + adaptor pretrain hooks (initialize_vision_modules surface,
    # model/EventChatModel.py:117-163): component npz artifacts with the
    # reference's key prefixes.
    use_event_qformer: bool = False
    pretrain_feature_adaptor: Optional[str] = None
    pretrain_query_embedder: Optional[str] = None
    pretrain_attention_layers: Optional[str] = None
    mm_projector_type: str = "linear"
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = True
    mm_vision_select_feature: str = "patch"


@dataclass
class DataArguments:
    data_path: str = ""
    eval_data_path: str = ""            # held-out JSON; enables evaluation
    lazy_preprocess: bool = True
    is_multimodal: bool = True
    event_folder: str = ""
    image_aspect_ratio: str = "square"
    conv_version: str = "v1"


@dataclass
class TrainingArguments:
    output_dir: str = "./output"
    stage: int = 1                      # 1 = projector warm-up, 2 = LoRA finetune
    num_train_epochs: int = 1
    max_steps: int = -1
    per_device_train_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-3
    min_lr: float = 0.0
    warmup_steps: int = 0
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    model_max_length: int = 2048
    seed: int = 0
    logging_steps: int = 10
    save_steps: int = 500
    # Evaluate on eval_data_path every N optimizer steps (and at the end);
    # 0 = only at the end, -1 = never. No-op without an eval dataset.
    eval_steps: int = 0
    group_by_modality_length: bool = False
    freeze_mm_mlp_adapter: bool = False
    mm_projector_lr: Optional[float] = None
    bf16: bool = True
    # LoRA (stage 2)
    lora_enable: bool = False
    lora_r: int = 64
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    lora_weight_path: str = ""
    lora_bias: str = "none"
    # Failure handling (train/resilience.py): "raise" fails loudly on
    # non-finite loss; "rewind" reloads the latest checkpoint and continues
    # with a reshuffled batch order, at most max_divergence_rewinds times.
    on_divergence: str = "raise"
    max_divergence_rewinds: int = 2
    # Host batches prepared ahead of the device (train/prefetch.py);
    # 0 disables the producer thread.
    prefetch_depth: int = 2
    # Multi-host preemption agreement cadence (micro-batches) of the JAX
    # trainer; the port runs one process, which polls its local flag every
    # micro-batch.
    preempt_poll_micros: int = 8
    # Liveness cadence independent of logging_steps: heartbeat.json updates
    # at least this often (seconds) while steps complete, so watchdogs can
    # pick a staleness timeout without knowing the logging config.
    heartbeat_interval_s: float = 30.0
    # Telemetry: per-optimizer-step JSONL (output_dir/telemetry.jsonl) with
    # the data-wait vs compute split. Off = no extra host work.
    telemetry: bool = True
    # Profiler capture of optimizer steps [profile_start_step,
    # profile_start_step + profile_num_steps), a torch.profiler trace.
    profile_dir: str = ""
    profile_start_step: int = 2
    profile_num_steps: int = 2
    # Mesh: -1 -> auto, which is one device in the port; any other mesh
    # raises NotImplementedError there.
    mesh_data: int = -1
    mesh_fsdp: int = -1
    mesh_model: int = 1
    mesh_context: int = 1
    # Attention kernel override: "" keeps the model config's choice;
    # mesh_context > 1 requires "ring" (sequence parallelism).
    attn_impl: str = ""
    # What each checkpointed layer may save instead of recomputing in the
    # backward pass: "full" and "nothing_saveable" save nothing; the
    # policies that save matmul outputs are not ported (raise).
    remat_policy: str = "full"
