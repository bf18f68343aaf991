"""Train a Medusa draft-head stack on a finetune dataset.

The port of ``scripts/train_medusa.py``: take a (finetuned) EventChat
checkpoint and the dataset JSON the stage-2 trainer reads, freeze the whole
model, fit only the (K, D, D) head stack (``train/medusa.py``), and save an
``.npz`` that ``--draft_head`` of either package's infer CLI, batcher and
HTTP server loads. Heads learn P(token_{t+k+2} | hidden_t) over the model's
own supervision targets. The flags are the JAX script's, plus ``--device``
(default ``cuda``; ``cpu`` only when asked). Each logged step prints the
JSON line the JAX script prints; a non-finite last loss raises.

``--quant int4`` raises: the int4 lm_head goes through K4, which has no
gradient, in the JAX package as in the port (``jax.grad`` through its
Pallas call fails), and the heads' loss is differentiated through the
lm_head. ``--quant int8`` is plain torch and trains.

Smoke (tiny random weights, toy data, on the CPU):
  python -m eventgpt_tpu_torch.scripts.train_medusa --model_path tiny-random \\
      --data_path qa.json --event_folder data/ --num_heads 3 \\
      --max_steps 20 --out medusa.npz --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Callable, Dict, List, Tuple


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Medusa head training (PyTorch)")
    p.add_argument("--model_path", default="tiny-random")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--data_path", required=True)
    p.add_argument("--event_folder", default="")
    p.add_argument("--conv_version", default="v1")
    p.add_argument("--num_heads", type=int, default=3,
                   help="draft heads K (serve with speculative <= K+1)")
    p.add_argument("--max_steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--max_len", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"])
    p.add_argument("--out", default="medusa.npz")
    # prepare_model (shared with the infer CLI) reads these:
    p.add_argument("--use_event_qformer", action="store_true")
    p.add_argument("--pretrain_query_embedder", default=None)
    p.add_argument("--pretrain_attention_layers", default=None)
    p.add_argument("--spatial_temporal_encoder", default=True,
                   type=lambda s: s.lower() not in ("false", "0"))
    p.add_argument("--quant", default="none", choices=["none", "int8", "int4"],
                   help="frozen-base storage during head training (int4 has no gradient)")
    p.add_argument("--fuse_params", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def train_heads(cfg, params, dataset, num_heads: int, max_steps: int, batch_size: int,
                learning_rate: float, device, seed: int = 0, max_len=None,
                logging_steps: int = 10, log: Callable[[str], Any] = print,
                on_step: Callable[[int, Dict[str, Any]], Any] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any], List[Dict[str, Any]]]:
    """``max_steps`` head steps over ``dataset`` (shuffled anew with seed
    ``seed + step`` at each pass, as the JAX script does), logging every
    ``logging_steps`` and at the last step. ``on_step(step, metrics)``, when
    given, runs after each step. Returns (the head stack, the last logged
    record, every logged record)."""
    from eventgpt_tpu_torch.train.data import batch_iterator
    from eventgpt_tpu_torch.train.medusa import (init_medusa_state, make_adamw,
                                                 make_medusa_train_step)
    from eventgpt_tpu_torch.train.steps import batch_to_device

    opt = make_adamw(learning_rate)
    state = init_medusa_state(cfg, params, num_heads, opt)
    step_fn = make_medusa_train_step(cfg, opt)
    step = 0
    t0 = time.perf_counter()
    last: Dict[str, Any] = {"loss": float("nan")}
    records = []
    while step < max_steps:
        for host in batch_iterator(dataset, batch_size, cfg, shuffle=True, seed=seed + step,
                                   max_len=max_len):
            state, metrics = step_fn(state, batch_to_device(host, device))
            step += 1
            if on_step is not None:
                on_step(step, metrics)
            if step % logging_steps == 0 or step == max_steps:
                last = {
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "per_head": [round(float(x), 4) for x in metrics["per_head_loss"]],
                    "grad_norm": float(metrics["grad_norm"]),
                    "s_per_step": round((time.perf_counter() - t0) / step, 3),
                }
                records.append(last)
                log(json.dumps(last))
            if step >= max_steps:
                break
    if not math.isfinite(last["loss"]):
        raise RuntimeError(f"medusa training diverged: loss={last['loss']}")
    return state.trainable, last, records


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.quant == "int4":
        raise NotImplementedError(
            "--quant int4: the heads' loss is differentiated through the lm_head, and the "
            "int4 lm_head runs the int4 matmul kernel (K4), which has no gradient -- in the "
            "JAX package jax.grad through its Pallas call fails, and the port adds no "
            "backward for it. Train the heads with --quant none or int8.")

    from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
    from eventgpt_tpu_torch.device import resolve_device
    from eventgpt_tpu_torch.models.medusa import save_medusa
    from eventgpt_tpu_torch.train.data import EventChatDataset

    device = resolve_device(args.device)
    cfg, params, tokenizer = load_model(args.model_path, args.dtype, None, args.tokenizer_path,
                                        device=device)
    cfg, params = prepare_model(cfg, params, tokenizer, args)
    dataset = EventChatDataset(args.data_path, tokenizer, cfg, event_folder=args.event_folder,
                               conv_version=args.conv_version)
    heads, last, _ = train_heads(cfg, params, dataset, args.num_heads, args.max_steps,
                                 args.batch_size, args.learning_rate, device, seed=args.seed,
                                 max_len=args.max_len, logging_steps=args.logging_steps)
    save_medusa(args.out, heads)
    print(f"saved {args.num_heads}-head stack to {args.out}")
    return last


if __name__ == "__main__":
    main()
