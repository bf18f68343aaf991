"""Training steps for the two-stage recipe, on one device.

The port of ``eventgpt_tpu/train/steps.py`` (without the mesh).

Stage 1 (projector warm-up): CLIP and the LM are frozen; the projector
(with its feature adaptor), the Q-Former where the config gates it in, and
the new special-token embedding rows where ``mm_use_im_start_end`` added
them are trained. Stage 2 (LoRA): the LM is adapted through apply-form LoRA
composite leaves (``train/lora.apply_lora``), and the projector keeps
training with its own LR group. The freeze is which tree is
differentiated: the step takes gradients with ``torch.autograd.grad`` of
the trainable leaves only; the frozen tensors never require grad, and CLIP
runs under ``torch.no_grad`` (the JAX package's ``stop_gradient``), so its
activations are not kept.

Both steps consume the fixed-layout batches of ``train/data.py``: the
splice is a gather along the event block and a ``where``. The pixels enter
CLIP in the tower's weight dtype, as in inference. ``make_train_step``
returns the loss and the norm of the gradients before clipping as device
scalars; the trainer reads them back only on logging and save steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.constants import IGNORE_INDEX
from eventgpt_tpu_torch.models import clip as clip_mod
from eventgpt_tpu_torch.models import eventchat
from eventgpt_tpu_torch.models import llama as llama_mod
from eventgpt_tpu_torch.models import projector as proj_mod
from eventgpt_tpu_torch.train.lora import LoraConfig, apply_lora, init_lora_params
from eventgpt_tpu_torch.train.optim import AdamW, global_norm, tree_leaves

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


def encode_events(params: Params, cfg: EventChatConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, num_event_tokens, D_lm) with gradients for the
    projector stack and the Q-Former: the frozen tower runs under
    ``torch.no_grad`` on the flattened B*T frames in its weights' dtype."""
    b, t = pixel_values.shape[:2]
    flat = pixel_values.reshape((b * t,) + tuple(pixel_values.shape[2:]))
    with torch.no_grad():
        feats = clip_mod.clip_encode(params["clip"], cfg.vision,
                                     flat.to(params["clip"]["patch_embedding"].dtype))
    feats = proj_mod.apply_projector(params["projector"], feats.to(
        params["projector"]["mlp"][0]["weight"].dtype))
    feats = proj_mod.apply_adaptor(params["projector"], feats)
    feats = feats.reshape((b, t) + tuple(feats.shape[1:]))
    return torch.stack([eventchat._encode_tail(params, cfg, feats[i]) for i in range(b)])


def multimodal_embeds(params: Params, cfg: EventChatConfig, batch: Batch) -> torch.Tensor:
    """Fixed-layout splice: text embeddings with the event tokens gathered
    in. ``event_index[b, t]`` is each event slot's row in the event-token
    block; other positions read the text embedding table."""
    ev = encode_events(params, cfg, batch["pixel_values"])  # (B, E, D)
    txt = llama_mod.embed_tokens(params["llama"], batch["token_ids"].long())  # (B, T, D)
    ev = ev.to(txt.dtype)
    idx = batch["event_index"].long()[:, :, None].expand(-1, -1, ev.shape[-1])
    gathered = torch.gather(ev, 1, idx)  # (B, T, D)
    return torch.where(batch["event_pos"][:, :, None], gathered, txt)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross entropy over non-IGNORE positions, in f32.
    Returns (loss, n_valid)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros((), dtype=torch.long,
                                                        device=labels.device))
    ll = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(ll, -1, safe[..., None])[..., 0]
    n_valid = valid.sum()
    loss = torch.where(valid, nll, torch.zeros((), device=nll.device)).sum() / n_valid.clamp_min(1)
    return loss, n_valid


def _forward_logits(params: Params, cfg: EventChatConfig, batch: Batch) -> torch.Tensor:
    embeds = multimodal_embeds(params, cfg, batch)
    return llama_mod.forward(params["llama"], cfg.llama, embeds, batch["attn_mask"])


@dataclass
class TrainState:
    trainable: Params   # differentiated tree (its structure depends on the stage)
    frozen: Params      # the base tensors, never differentiated
    opt_state: Any
    step: int           # micro-batches taken


def stage1_combine(trainable: Params, frozen: Params, step: Optional[int] = None) -> Params:
    """Trainable = {"projector" [, "qformer"] [, "embed_new"]}; CLIP and the
    LM frozen. ``embed_new`` shadows the LAST rows of the frozen embedding
    table (the new special tokens; the lm_head rows stay frozen)."""
    llama = frozen["llama"]
    if "embed_new" in trainable:
        emb = llama["embed_tokens"]
        n_new = trainable["embed_new"].shape[0]
        llama = {**llama, "embed_tokens": torch.cat(
            [emb[:-n_new], trainable["embed_new"].to(emb.dtype)])}
    out = {"clip": frozen["clip"], "llama": llama, "projector": trainable["projector"]}
    if "qformer" in trainable:
        out["qformer"] = trainable["qformer"]
    return out


def make_stage2_combine(lora_cfg: LoraConfig, dropout_seed: int = 0,
                        projector_source: str = "trainable") -> Callable[..., Params]:
    """Trainable = {"projector", "lora"}; the base LM enters through the
    LoRA composite leaves. With ``lora_cfg.dropout > 0`` a ``step`` makes
    the masks (seeded from (dropout_seed, step)); eval passes none and gets
    the deterministic adapted model. ``projector_source="frozen"`` reads
    the projector from the frozen tree (``freeze_mm_mlp_adapter``)."""

    def combine(trainable: Params, frozen: Params, step: Optional[int] = None) -> Params:
        key = None
        if lora_cfg.dropout > 0.0 and step is not None:
            key = (dropout_seed, int(step))
        source = frozen if projector_source == "frozen" else trainable
        out = {"clip": frozen["clip"], "projector": source["projector"],
               "llama": apply_lora(frozen["llama"], trainable["lora"], lora_cfg,
                                   dropout_key=key)}
        if "qformer" in trainable:
            out["qformer"] = trainable["qformer"]
        return out

    return combine


def make_train_step(cfg: EventChatConfig, optimizer: AdamW,
                    combine: Callable[..., Params] = stage1_combine):
    """(state, batch) -> (state, {"loss", "grad_norm"}), updating the
    trainable tensors and the optimizer state in place. Both metrics stay
    on the device; ``grad_norm`` is the global norm of this micro-batch's
    gradients before clipping (``optax.global_norm(grads)``)."""

    def step(state: TrainState, batch: Batch):
        leaves = [p for _, p in tree_leaves(state.trainable)]
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            params = combine(state.trainable, state.frozen, state.step)
            loss, _ = lm_loss(_forward_logits(params, cfg, batch), batch["labels"])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        gnorm = global_norm([g for g in grads if g is not None])
        state.opt_state = optimizer.update(state.trainable, list(grads), state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_eval_step(cfg: EventChatConfig, combine: Callable[..., Params] = stage1_combine):
    """(state, batch) -> {"loss", "n_tokens"} without grad (and so without
    dropout or recompute)."""

    @torch.no_grad()
    def step(state: TrainState, batch: Batch):
        params = combine(state.trainable, state.frozen)
        loss, n = lm_loss(_forward_logits(params, cfg, batch), batch["labels"])
        return {"loss": loss, "n_tokens": n}

    return step


def init_train_state(trainable: Params, frozen: Params, optimizer: AdamW) -> TrainState:
    return TrainState(trainable=trainable, frozen=frozen,
                      opt_state=optimizer.init(trainable), step=0)


def split_stage1(params: Params, trainable_embed_rows: int = 0) -> Tuple[Params, Params]:
    """Full tree -> (trainable, frozen) for stage 1. The Q-Former, where
    present, trains beside the projector; ``trainable_embed_rows`` > 0
    makes the last n embedding rows (the special tokens just appended) a
    trainable leaf."""
    trainable = {"projector": params["projector"]}
    if trainable_embed_rows > 0:
        trainable["embed_new"] = params["llama"]["embed_tokens"][-trainable_embed_rows:]
    if "qformer" in params:
        trainable["qformer"] = params["qformer"]
    return trainable, {"clip": params["clip"], "llama": params["llama"]}


def split_stage2(params: Params, cfg: EventChatConfig, lora_cfg: LoraConfig,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32
                 ) -> Tuple[Params, Params]:
    """Full tree -> (trainable with fresh LoRA factors, frozen base)."""
    trainable = {"projector": params["projector"],
                 "lora": init_lora_params(cfg.llama, lora_cfg, generator, dtype)}
    if "qformer" in params:
        trainable["qformer"] = params["qformer"]
    return trainable, {"clip": params["clip"], "llama": params["llama"]}


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Batch:
    """Host batch -> tensors on ``device``; to a CUDA device through pinned
    memory and non-blocking copies, so the host goes on while they land."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out
