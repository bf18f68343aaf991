"""Typed configuration of the port: the EventChat model and its parts.

A copy of the dataclasses of ``eventgpt_tpu/config.py`` that this slice
runs (vision tower, LLaMA, projector, top-level EventChat). ``attn_impl``
takes ``dense`` or ``flash`` here; the sequence-parallel choices and the
Q-Former come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

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
    # "dense" = materialized-scores attention; "flash" = the fused prefill
    # kernel (ops/flash_attention.py). Decode always uses the dense
    # single-query path against the KV cache.
    attn_impl: str = "dense"

    _ATTN_IMPLS = ("dense", "flash")

    def __post_init__(self):
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

    @property
    def num_event_tokens(self) -> int:
        """Tokens contributed by one event clip after the encode stage."""
        if not self.use_spatio_temporal_pool:
            return self.num_event_frames * self.vision.num_tokens
        t = self.num_temporal_tokens if self.num_temporal_tokens is not None else self.num_event_frames
        return t + self.vision.num_tokens  # 5 + 577 = 582 for defaults

    @staticmethod
    def eventgpt_7b() -> "EventChatConfig":
        return EventChatConfig(llama=LlamaConfig.llama_7b())

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
