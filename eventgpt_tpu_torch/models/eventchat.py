"""EventChat: the multimodal composition (vision tower + projector + LLM).

Port of ``eventgpt_tpu/models/eventchat.py`` for one-shot generation:

  1. ``encode_events_batch`` -- CLIP -> projector -> adaptor -> pooling
                                (or the Q-Former, when the config gates it)
  2. ``llama.prefill``       -- spliced prompt embeddings, KV cache fill
  3. ``llama.decode_step``   -- the greedy or sampled decode loop

The host splits ids at the -200 sentinel; ``splice_embeddings``
concatenates [text embeds | event tokens | text embeds]; a batch is
right-padded to a shared length. Beam search, speculative decoding and
Medusa heads belong to a later slice of the port.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.constants import SEQ_BUCKET
from eventgpt_tpu_torch.data.tokenizer import split_at_event
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import clip as clip_mod
from eventgpt_tpu_torch.models import llama as llama_mod
from eventgpt_tpu_torch.models import projector as proj_mod
from eventgpt_tpu_torch.models import qformer as qformer_mod
from eventgpt_tpu_torch.ops.pooling import spatio_temporal_pool
from eventgpt_tpu_torch.ops.sampling import sample

Params = Dict[str, Any]


def _encode_feats(params: Params, cfg: EventChatConfig, frames: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) frames -> (N, num_tokens, D_lm) projected features."""
    feats = clip_mod.clip_encode(params["clip"], cfg.vision, frames)
    feats = proj_mod.apply_projector(params["projector"], feats)
    return proj_mod.apply_adaptor(params["projector"], feats)


def _encode_tail(params: Params, cfg: EventChatConfig, feats: torch.Tensor) -> torch.Tensor:
    """Per-sample (T, num_tokens, D) projected features -> (num_event_tokens,
    D): Q-Former aggregation, raw patch concatenation, or the
    spatio-temporal pool."""
    if cfg.use_event_qformer:
        return qformer_mod.qformer_encode(params["qformer"], cfg.qformer, feats)
    if not cfg.use_spatio_temporal_pool:
        return feats.reshape(-1, feats.shape[-1])
    return spatio_temporal_pool(feats, cfg.num_temporal_tokens)


@torch.inference_mode()
def encode_events_batch(params: Params, cfg: EventChatConfig,
                        pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, num_event_tokens, D_lm). The tower runs
    batched over the flattened B*T frame axis."""
    b, t = pixel_values.shape[:2]
    flat = pixel_values.reshape((b * t,) + tuple(pixel_values.shape[2:]))
    feats = _encode_feats(params, cfg, flat)
    feats = feats.reshape((b, t) + tuple(feats.shape[1:]))
    return torch.stack([_encode_tail(params, cfg, feats[i]) for i in range(b)])


def _interleave_segments(segments: Sequence[np.ndarray]):
    """The spliced-sequence layout: yields ("text", seg) / ("event", i)
    parts in order, skipping empty text segments."""
    num_events = len(segments) - 1
    for i, seg in enumerate(segments):
        if len(seg):
            yield ("text", seg)
        if i < num_events:
            yield ("event", i)


def splice_embeddings(
    params: Params,
    cfg: EventChatConfig,
    segments: Sequence[np.ndarray],
    event_tokens: torch.Tensor,
    max_context: Optional[int] = None,
) -> torch.Tensor:
    """Interleave text-segment embeddings with event-token blocks.

    ``segments`` are the host-side id chunks around each -200 sentinel
    (``split_at_event``); ``event_tokens`` is (num_events, n_tok, D) or
    (n_tok, D). Returns (T, D), truncated to the smaller of the model
    context and ``max_context``. Text overflow truncates silently; a cut
    inside an event block raises.
    """
    if event_tokens.ndim == 2:
        event_tokens = event_tokens[None]
    num_events = len(segments) - 1
    if event_tokens.shape[0] != num_events:
        raise ValueError(
            f"{num_events} event sentinel(s) in prompt but "
            f"{event_tokens.shape[0]} event clip(s) provided"
        )
    embed = params["llama"]["embed_tokens"]
    parts: List[torch.Tensor] = []
    for kind, val in _interleave_segments(segments):
        if kind == "text":
            ids = torch.as_tensor(np.asarray(val, dtype=np.int64), device=embed.device)
            parts.append(llama_mod.embed_tokens(params["llama"], ids))
        else:
            parts.append(event_tokens[val].to(embed.dtype))
    out = torch.cat(parts, dim=0)
    limit = cfg.llama.max_seq_len if max_context is None else min(cfg.llama.max_seq_len, max_context)
    if out.shape[0] > limit:
        n_text = sum(len(s) for s in segments)
        last_event_end = out.shape[0] - len(segments[-1])
        if num_events and last_event_end > limit:
            raise ValueError(
                f"spliced sequence ({out.shape[0]} tokens: {n_text} text + "
                f"{num_events}x{event_tokens.shape[1]} event) exceeds the "
                f"context cap {limit} inside an event block; raise "
                f"max_seq_len/--context_len or enable spatio-temporal pooling"
            )
    return out[:limit]


def _vocab_size(params: Params) -> int:
    """The vocab of the lm_head leaf, which special tokens may have grown
    past the config's: (V, D) when dense, (K, V) when quantized."""
    head = params["llama"]["lm_head"]
    if isinstance(head, dict):
        return int(head.get("q", head.get("q4")).shape[-1])
    return int(head.shape[0])


def _pad_batch(embeds: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Right-pad per-sample (T_i, D) embeds to (B, T_max, D) + bool mask."""
    lens = np.array([int(e.shape[0]) for e in embeds])
    t_max = int(lens.max())
    padded = torch.stack([F.pad(e, (0, 0, 0, t_max - e.shape[0])) for e in embeds])
    mask = torch.as_tensor(np.arange(t_max)[None, :] < lens[:, None], device=padded.device)
    return padded, mask, lens


def prepare_prefill(params: Params, cfg: EventChatConfig,
                    input_ids_batch: Sequence[Sequence[int]],
                    pixel_values_batch, max_context: Optional[int] = None):
    """Encode the events and splice each prompt: returns the right-padded
    (B, T, D) embeddings, their (B, T) mask and the per-row lengths."""
    embed = params["llama"]["embed_tokens"]
    pixels = torch.as_tensor(np.asarray(pixel_values_batch), device=embed.device).to(embed.dtype)
    event_tokens = encode_events_batch(params, cfg, pixels)
    embeds = [
        splice_embeddings(params, cfg, split_at_event(ids), event_tokens[i], max_context)
        for i, ids in enumerate(input_ids_batch)
    ]
    return _pad_batch(embeds)


@torch.inference_mode()
def _decode_loop(params: Params, cfg: EventChatConfig, first_logits: torch.Tensor,
                 cache, generator: Optional[torch.Generator], max_new_tokens: int,
                 temperature: float, top_p: float, eos_token_id: int):
    """The autoregressive loop. Returns (tokens (B, max_new_tokens) int32
    on the host, number of steps run).

    Rows that hit EOS are frozen to EOS thereafter; the loop stops when
    every row is done or the budget is spent. Each step samples, then runs
    one decode step unconditionally, so the step after the stop condition
    is computed and discarded, as in the JAX package's while_loop.
    """
    b = first_logits.shape[0]
    device = first_logits.device
    tokens = torch.zeros((b, max(max_new_tokens, 1)), dtype=torch.int32, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    eos = torch.tensor(eos_token_id, dtype=torch.int32, device=device)
    logits = first_logits
    step = 0
    while step < max_new_tokens:
        next_tok = sample(logits, generator, temperature, top_p)
        next_tok = torch.where(done, eos, next_tok)
        tokens[:, step] = next_tok
        done = done | (next_tok == eos)
        token_embeds = llama_mod.embed_tokens(params["llama"], next_tok[:, None].long())
        logits, cache = llama_mod.decode_step(params["llama"], cfg.llama, token_embeds, cache)
        step += 1
        if bool(done.all()):
            break
    return tokens[:, :max_new_tokens].cpu().numpy(), step


@torch.inference_mode()
def generate(
    params: Params,
    cfg: EventChatConfig,
    input_ids_batch: Sequence[Sequence[int]],
    pixel_values_batch,
    max_new_tokens: int = 512,
    temperature: float = 0.0,
    top_p: float = 1.0,
    eos_token_id: Optional[int] = 2,
    seed: int = 0,
    max_context: Optional[int] = None,
    num_beams: int = 1,
    kv_quant: bool = False,
    speculative: int = 0,
    draft_head=None,
    timings: Optional[Dict[str, float]] = None,
    device="cuda",
) -> List[List[int]]:
    """Autoregressive generation over a batch of event-QA prompts.

    Sampling is on iff temperature > 0 (nucleus ``top_p``), greedy
    otherwise; decode stops per row at EOS or after ``max_new_tokens``.

    Runs on ``device`` (default ``cuda``, which raises when no card is
    present); ``params`` must already live there.

    ``input_ids_batch``: token ids containing -200 sentinels.
    ``pixel_values_batch``: (B, T_frames, C, H, W).
    ``kv_quant``: keep the KV cache as int8 with per-vector f32 scales.
    ``timings``: when given, filled with host-clock seconds of the encode,
    prefill and decode phases, each ending in a device synchronize.
    """
    if num_beams > 1:
        raise NotImplementedError(
            "beam search (num_beams > 1) is not ported yet: it comes with the "
            "model-variants slice of the PyTorch port")
    if speculative or draft_head is not None:
        raise NotImplementedError(
            "speculative decoding and Medusa draft heads are not ported yet: "
            "they come with the model-variants slice of the PyTorch port")
    device = resolve_device(device)
    held = params["llama"]["embed_tokens"].device
    if held.type != device.type:
        raise ValueError(f"generate on {device}: the parameters are on {held}")
    clock = _PhaseClock(held, timings)

    padded, mask, lens = prepare_prefill(params, cfg, input_ids_batch,
                                         pixel_values_batch, max_context)
    clock.lap("encode_s")
    b, t = padded.shape[:2]

    # Bucket the cache length on 2x the training grain, as the JAX package
    # does, so a server cycles through few cache shapes.
    bucket = 2 * SEQ_BUCKET
    max_len = t + max_new_tokens
    max_len = ((max_len + bucket - 1) // bucket) * bucket
    cache = llama_mod.init_kv_cache(cfg.llama, b, max_len, dtype=padded.dtype, device=held,
                                    quant=kv_quant)
    last_logits, cache = llama_mod.prefill(params["llama"], cfg.llama, padded, mask,
                                           cache, last_only=True)
    clock.lap("prefill_s")
    if max_new_tokens == 0:
        return [[] for _ in range(b)]

    generator = torch.Generator(device=held)
    generator.manual_seed(seed)
    # EOS sentinel: a real id stops rows early; None decodes the full
    # budget (an out-of-vocab sentinel no sampled token matches).
    eos = eos_token_id if eos_token_id is not None else -1
    out_tokens, num_steps = _decode_loop(
        params, cfg, last_logits, cache, generator, max_new_tokens,
        float(temperature), float(top_p), int(eos))
    clock.lap("decode_s")
    if timings is not None:
        timings["decode_steps"] = num_steps

    results: List[List[int]] = []
    for i in range(b):
        ids: List[int] = []
        for tid in out_tokens[i, :num_steps]:
            if eos_token_id is not None and tid == eos_token_id:
                break
            ids.append(int(tid))
        results.append(ids)
    return results


class _PhaseClock:
    """Host-clock laps that end in a device synchronize; records nothing
    when no ``timings`` dict is given."""

    def __init__(self, device: torch.device, timings: Optional[Dict[str, float]]):
        self.device = device
        self.timings = timings
        self.t0 = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.t0
        self.t0 = now
