"""Training of the Medusa draft heads (``models/medusa.py``).

The port of ``eventgpt_tpu/train/medusa.py``. The whole EventChat tree is
frozen and the trainable set is the (K, D, D) head stack alone, zero at the
start (each head then gives the base model's next-token logits). Head k
learns P(token_{t+k+2} | hidden_t): the base lm_head owns offset +1, the
heads the rest of the verification window.

The forward reuses ``train/steps.multimodal_embeds`` and
``llama.prefill(return_hidden=True)`` on a fresh KV cache, so the heads
train on the hidden states the decode path feeds them, event splice
included. It runs under ``torch.no_grad``, the JAX package's
``stop_gradient``: no autograd graph is kept for the model's forward, and
only the heads' loss is differentiated. ``llama.prefill`` is asked for the
hidden states alone, so the (B, T, V) lm_head logits that the JAX package
leaves to XLA to drop are never computed here.

The optimizer is the caller's ``train/optim.AdamW``. The JAX scripts use
``optax.adamw(lr)``: ``make_adamw`` builds its port (weight decay 1e-4, no
gradient clipping, a constant LR).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.constants import IGNORE_INDEX
from eventgpt_tpu_torch.models import llama as llama_mod
from eventgpt_tpu_torch.models import medusa as medusa_mod
from eventgpt_tpu_torch.models.medusa import load_medusa, save_medusa  # noqa: F401
from eventgpt_tpu_torch.train.optim import AdamW, global_norm
from eventgpt_tpu_torch.train.steps import TrainState, multimodal_embeds

Batch = Dict[str, torch.Tensor]


def make_adamw(lr: float, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8, decoupled weight
    decay 1e-4, no clipping, the LR constant (evaluated in f32 as optax
    does)."""
    return AdamW(lambda count: float(np.float32(lr)), weight_decay=weight_decay,
                 grad_clip=None)


def medusa_hidden_states(params: Any, cfg: EventChatConfig, batch: Batch) -> torch.Tensor:
    """(B, T, D) final-norm hidden states of the frozen model over the
    batch, with no autograd graph."""
    with torch.no_grad():
        embeds = multimodal_embeds(params, cfg, batch)
        cache = llama_mod.init_kv_cache(cfg.llama, embeds.shape[0], embeds.shape[1],
                                        dtype=embeds.dtype, device=embeds.device)
        _, hidden, _ = llama_mod.prefill(params["llama"], cfg.llama, embeds,
                                         batch["attn_mask"], cache, return_hidden=True,
                                         with_logits=False)
    return hidden


def medusa_head_update(state: TrainState, optimizer: AdamW, hidden: torch.Tensor,
                       labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The heads' loss over ``hidden``, its gradient and one optimizer
    update of the stack in place. Returns the metrics, on the device."""
    w = state.trainable["w"]
    with torch.enable_grad():
        w.requires_grad_(True)
        loss, per_head = medusa_mod.medusa_loss(state.frozen["llama"], {"w": w}, hidden, labels,
                                                ignore_index=IGNORE_INDEX)
        (grad,) = torch.autograd.grad(loss, [w])
    w.requires_grad_(False)
    state.opt_state = optimizer.update(state.trainable, [grad], state.opt_state)
    state.step += 1
    return {"loss": loss.detach(), "per_head_loss": per_head.detach(),
            "grad_norm": global_norm([grad])}


def make_medusa_train_step(cfg: EventChatConfig, optimizer: AdamW):
    """(state, batch) -> (state, {"loss", "per_head_loss", "grad_norm"}):
    ``medusa_hidden_states`` then ``medusa_head_update``. ``state.trainable``
    is the head stack, updated in place with the optimizer state;
    ``state.frozen`` is the full EventChat tree."""

    def step(state: TrainState, batch: Batch):
        hidden = medusa_hidden_states(state.frozen, cfg, batch)
        return state, medusa_head_update(state, optimizer, hidden, batch["labels"])

    return step


def init_medusa_state(cfg: EventChatConfig, params: Any, num_heads: int, optimizer: AdamW,
                      dtype: torch.dtype = torch.float32) -> TrainState:
    """Zero heads (the identity start) on the tree's device, and the frozen
    model tree."""
    device = params["llama"]["embed_tokens"].device
    medusa = medusa_mod.init_medusa_params(cfg.llama, num_heads, dtype, device)
    return TrainState(trainable=medusa, frozen=params, opt_state=optimizer.init(medusa), step=0)
