"""Typed configuration of the port: the EventChat model and its parts.

A copy of the dataclasses of ``eventgpt_tpu/config.py`` that the port runs
(vision tower, LLaMA, projector, Q-Former, top-level EventChat), their JSON
round trip, and ``from_hf_config`` for a checkpoint's ``config.json``.
``attn_impl`` takes ``dense`` or ``flash`` here; the sequence-parallel
choices of the JAX package's ``LlamaConfig`` come with a later slice.
``MeshConfig`` is the logical device mesh (``parallel/mesh.py``). The
LM's ``remat`` and ``remat_policy`` are carried with the JAX defaults and
validation; ``models/llama.forward`` runs ``full`` and ``nothing_saveable``
as per-layer ``torch.utils.checkpoint`` and raises ``NotImplementedError``
for the two policies that save matmul outputs. The JAX package's
``hidden_act`` and ``max_event_stream_us``, which nothing reads, are left
out.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import torch

from eventgpt_tpu_torch import constants


@dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT vision tower (CLIP ViT-L/14-336 by default)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        # +1 for the CLS token; ViT-L/14-336 -> 577.
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA/Vicuna decoder-only LM."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 2048
    tie_word_embeddings: bool = False
    # "dense" = materialized-scores attention; "flash" = the fused prefill
    # kernel (ops/flash_attention.py). Decode always uses the dense
    # single-query path against the KV cache.
    attn_impl: str = "dense"
    # Rematerialize each layer in the backward pass of ``llama.forward``
    # under grad (per-layer ``torch.utils.checkpoint``); what it may save
    # instead of recomputing is ``remat_policy``: "full" and
    # "nothing_saveable" save nothing (two spellings of one policy);
    # "dots_saveable" saves every matmul output, and
    # "dots_with_no_batch_dims_saveable" the weight products only
    # (``models/llama._remat_context_fn``).
    remat: bool = True
    remat_policy: str = "full"

    _ATTN_IMPLS = ("dense", "flash")
    _REMAT_POLICIES = ("full", "nothing_saveable", "dots_saveable",
                       "dots_with_no_batch_dims_saveable")

    def __post_init__(self):
        if self.remat_policy not in self._REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {self._REMAT_POLICIES}, "
                f"got {self.remat_policy!r}"
            )
        if self.attn_impl not in self._ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be one of {self._ATTN_IMPLS}, "
                f"got {self.attn_impl!r}"
            )

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @staticmethod
    def llama_7b() -> "LlamaConfig":
        # Flash prefill by default; decode uses the single-query dense path.
        return LlamaConfig(attn_impl="flash")

    @staticmethod
    def llama_13b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=5120, intermediate_size=13824, num_layers=40,
            num_heads=40, num_kv_heads=40, attn_impl="flash",
        )

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        """Small config for tests."""
        return LlamaConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
        )


@dataclass(frozen=True)
class ProjectorConfig:
    """Event-feature -> LM-embedding projection stack: an MLP
    (input_dim -> output_dim, GELU, output_dim -> output_dim) plus an
    optional Linear(output_dim -> output_dim) feature adaptor."""

    input_dim: int = 1024
    output_dim: int = 4096
    mlp_depth: int = 2
    use_feature_adaptor: bool = True


@dataclass(frozen=True)
class QFormerConfig:
    """Shape of the config-gated event Q-Former (``models/qformer.py``):
    ``num_queries`` learned queries in LM space cross-attend to the
    projected frame features."""

    num_queries: int = 32
    num_layers: int = 2
    num_heads: int = 8
    hidden_size: int = 4096   # = LM embedding dim
    mlp_ratio: int = 4

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: ``data`` (pure data parallelism), ``fsdp``
    (ZeRO-style parameter sharding), ``context`` (sequence parallelism)
    and ``model`` (tensor parallelism), one rank per device."""

    data: int = 1
    fsdp: int = 1
    model: int = 1
    context: int = 1


@dataclass(frozen=True)
class EventChatConfig:
    """Top-level multimodal model config."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    llama: LlamaConfig = field(default_factory=LlamaConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)

    num_event_frames: int = constants.DEFAULT_NUM_EVENT_FRAMES
    # None -> num_temporal_tokens == number of frames.
    num_temporal_tokens: Optional[int] = None
    # False feeds raw per-frame patch tokens to the LM instead of pooling.
    use_spatio_temporal_pool: bool = True

    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = True

    # When on, the Q-Former's learned queries replace the spatio-temporal
    # pool as the LM's event tokens.
    use_event_qformer: bool = False
    qformer: QFormerConfig = field(default_factory=QFormerConfig)

    @property
    def num_event_tokens(self) -> int:
        """Tokens contributed by one event clip after the encode stage."""
        if self.use_event_qformer:
            return self.qformer.num_queries
        if not self.use_spatio_temporal_pool:
            return self.num_event_frames * self.vision.num_tokens
        t = self.num_temporal_tokens if self.num_temporal_tokens is not None else self.num_event_frames
        return t + self.vision.num_tokens  # 5 + 577 = 582 for defaults

    @staticmethod
    def eventgpt_7b() -> "EventChatConfig":
        return EventChatConfig(llama=LlamaConfig.llama_7b())

    @staticmethod
    def eventgpt_13b() -> "EventChatConfig":
        return EventChatConfig(
            llama=LlamaConfig.llama_13b(),
            projector=ProjectorConfig(output_dim=5120),
        )

    @staticmethod
    def tiny(vocab_size: int = 256) -> "EventChatConfig":
        """Tiny end-to-end config for tests: real structure, toy dims."""
        vision = VisionConfig(
            hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            image_size=28, patch_size=14,
        )
        llama = LlamaConfig.tiny(vocab_size)
        proj = ProjectorConfig(input_dim=32, output_dim=llama.hidden_size)
        return EventChatConfig(vision=vision, llama=llama, projector=proj)


# ---------------------------------------------------------------------------
# Serialization


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    return cfg


_NESTED = {"vision": VisionConfig, "llama": LlamaConfig, "projector": ProjectorConfig,
           "qformer": QFormerConfig}
# Fields of the JAX package's dataclasses that the port does not carry: the
# tower's activation name, which neither package reads (both towers are
# CLIP's quick_gelu). A config file the JAX package saved holds it;
# top-level fields the port lacks (``max_event_stream_us``, read by neither
# package) are skipped as well.
_NOT_CARRIED = {"vision": ("hidden_act",)}


def event_chat_config_from_dict(data: dict) -> EventChatConfig:
    kwargs = {}
    for f in dataclasses.fields(EventChatConfig):
        if f.name not in data:
            continue
        v = data[f.name]
        if f.name in _NESTED and isinstance(v, dict):
            v = {k: x for k, x in v.items() if k not in _NOT_CARRIED.get(f.name, ())}
            v = _NESTED[f.name](**v)
        kwargs[f.name] = v
    return EventChatConfig(**kwargs)


def save_config(cfg: EventChatConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(path: str) -> EventChatConfig:
    with open(path) as f:
        return event_chat_config_from_dict(json.load(f))


def default_attn_impl(device: Union[str, torch.device, None] = "cuda") -> str:
    """Prefill attention for ``device``: the flash kernel (K1) on ``cuda``,
    dense on the CPU, where the flash wrapper would run its plain version."""
    return "flash" if torch.device("cuda" if device is None else device).type == "cuda" \
        else "dense"


def from_hf_config(hf: dict, attn_impl: Optional[str] = None,
                   device: Union[str, torch.device, None] = "cuda") -> EventChatConfig:
    """An EventChatConfig from an HF ``config.json`` dict: stock LLaMA
    fields plus the reference's gating fields, with the JAX package's
    rules (``eventgpt_tpu/config.py:from_hf_config``):

    - the feature adaptor is on when ``event_feature_adaptor`` is present,
      whatever its value; the Q-Former is on by ``use_event_qformer``'s value;
    - a ``vision_config`` dict overrides the tower's dims, foreign keys
      dropped;
    - ``max_seq_len`` is ``max_position_embeddings`` capped at 4096.

    ``attn_impl=None`` resolves by the device the model will run on
    (``default_attn_impl``).
    """
    llama = LlamaConfig(
        attn_impl=attn_impl if attn_impl is not None else default_attn_impl(device),
        vocab_size=hf.get("vocab_size", 32000),
        hidden_size=hf.get("hidden_size", 4096),
        intermediate_size=hf.get("intermediate_size", 11008),
        num_layers=hf.get("num_hidden_layers", 32),
        num_heads=hf.get("num_attention_heads", 32),
        num_kv_heads=hf.get("num_key_value_heads", hf.get("num_attention_heads", 32)),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=min(hf.get("max_position_embeddings", 2048), 4096),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    if isinstance(hf.get("vision_config"), dict):
        known = {f.name for f in dataclasses.fields(VisionConfig)}
        vision = VisionConfig(**{k: v for k, v in hf["vision_config"].items() if k in known})
    else:
        vision = VisionConfig()
    proj = ProjectorConfig(
        input_dim=vision.hidden_size,
        output_dim=llama.hidden_size,
        mlp_depth=hf.get("mm_projector_depth", 2),
        use_feature_adaptor="event_feature_adaptor" in hf,
    )
    qf_kwargs = {}
    if isinstance(hf.get("qformer_config"), dict):
        known_qf = {f.name for f in dataclasses.fields(QFormerConfig)} - {"hidden_size"}
        qf_kwargs = {k: v for k, v in hf["qformer_config"].items() if k in known_qf}
    return EventChatConfig(
        vision=vision,
        llama=llama,
        projector=proj,
        use_spatio_temporal_pool=hf.get("spatial_temporal_encoder", True),
        use_event_qformer=bool(hf.get("use_event_qformer", False)),
        qformer=QFormerConfig(hidden_size=llama.hidden_size, **qf_kwargs),
        mm_use_im_start_end=hf.get("mm_use_im_start_end", False),
        mm_use_im_patch_token=hf.get("mm_use_im_patch_token", True),
    )
