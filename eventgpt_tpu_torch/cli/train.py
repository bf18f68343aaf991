"""Training CLI: the port of ``eventgpt_tpu/cli/train.py``, on one CUDA card.

Every field of ``ModelArguments``, ``DataArguments`` and
``TrainingArguments`` is a ``--flag`` (dataclass reflection, as in the JAX
CLI), plus ``--resume_from`` (a checkpoint directory, or ``auto`` for the
newest ``ckpt_*`` under ``--output_dir``), ``--tokenizer_path`` (``byte``,
as ``cli/infer`` takes it: the HF tokenizer is not ported) and ``--device``
(default ``cuda``; ``cpu`` only when asked). The model loads through
``cli/infer.load_model``; the Q-Former gate-in and the ``--pretrain_*``
component files load as in the JAX CLI. ``--trace_out FILE`` arms the span
tracer (a ring of 65536 events) for the run and writes it there as Chrome
trace events at the end; ``--profile_dir`` captures the trainer's profile
window. Through the trainer, ``--mesh_*`` raise ``NotImplementedError``.

Usage (projector warm-up on a toy dataset, on the CPU):
  python -m eventgpt_tpu_torch.cli.train --model_path tiny-random \\
      --data_path qa.json --event_folder DIR --stage 1 --max_steps 3 \\
      --bf16 false --device cpu

Stage 2 (LoRA): ``--stage 2 --lora_r 64 --lora_alpha 16``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Optional, Tuple, get_args, get_origin

import torch

from eventgpt_tpu_torch import checkpoint as ckpt
from eventgpt_tpu_torch.config import QFormerConfig
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import qformer as qformer_mod
from eventgpt_tpu_torch.models.convert import projector_params_from_jax
from eventgpt_tpu_torch.obs import trace as obs_trace
from eventgpt_tpu_torch.train.args import DataArguments, ModelArguments, TrainingArguments
from eventgpt_tpu_torch.train.trainer import Trainer, refuse_unported


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        tp = f.type if not isinstance(f.type, str) else eval(f.type)  # noqa: S307
        if get_origin(tp) is not None:  # Optional[X] -> X
            inner = [a for a in get_args(tp) if a is not type(None)]
            tp = inner[0] if inner else str
        if tp is bool:
            parser.add_argument(f"--{f.name}", type=lambda v: v.lower() in ("true", "1", "yes"),
                                default=f.default)
        else:
            parser.add_argument(f"--{f.name}", type=tp, default=f.default)


def _extract(args: argparse.Namespace, cls):
    return cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cls)})


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="EventGPT trainer (PyTorch, CUDA)")
    for cls in (ModelArguments, DataArguments, TrainingArguments):
        _add_dataclass_args(parser, cls)
    # The JAX CLI's --model_name_or_path under the name the port's other
    # CLIs use, too.
    parser.add_argument("--model_path", dest="model_name_or_path", type=str,
                        default=argparse.SUPPRESS)
    parser.add_argument("--resume_from", type=str, default=None,
                        help="checkpoint dir, or 'auto' for the newest ckpt_* under "
                             "--output_dir")
    parser.add_argument("--trace_out", type=str, default=None,
                        help="write the run's trace spans as Chrome trace events (Perfetto, "
                             "chrome://tracing) to this file at the end")
    parser.add_argument("--tokenizer_path", type=str, default=None,
                        help="'byte' for a checkpoint dir (the HF tokenizer is not ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu only when asked)")
    return parser


def build_trainer(margs: ModelArguments, dargs: DataArguments, targs: TrainingArguments,
                  device="cuda", tokenizer_path: Optional[str] = None,
                  loaded: Optional[Tuple] = None) -> Trainer:
    """Load the model (or take ``loaded`` = (cfg, params, tokenizer) already
    on the device), apply the Q-Former gate and the ``pretrain_*``
    components as the JAX CLI does, and build the ``Trainer``."""
    refuse_unported(targs)
    device = resolve_device(device)
    dtype = torch.bfloat16 if targs.bf16 else torch.float32
    if loaded is None:
        from eventgpt_tpu_torch.cli.infer import load_model

        loaded = load_model(margs.model_name_or_path, "bfloat16" if targs.bf16 else "float32",
                            tokenizer_path=tokenizer_path, device=device)
    cfg, params, tokenizer = loaded
    params = dict(params)

    if margs.use_event_qformer and not cfg.use_event_qformer:
        cfg = dataclasses.replace(cfg, use_event_qformer=True,
                                  qformer=QFormerConfig(hidden_size=cfg.llama.hidden_size))
    if cfg.use_event_qformer and "qformer" not in params:
        gen = torch.Generator(device=device)
        gen.manual_seed(targs.seed + 1)
        params["qformer"] = qformer_mod.init_qformer_params(cfg.qformer, gen, dtype, device)
    if margs.pretrain_mm_mlp_adapter:
        params["projector"] = projector_params_from_jax(
            ckpt.load_component(margs.pretrain_mm_mlp_adapter,
                                strip_prefix="model.visual_projector."), dtype, device)
    if margs.pretrain_feature_adaptor:
        adaptor = ckpt.load_component(margs.pretrain_feature_adaptor,
                                      strip_prefix="model.feature_adaptor.")
        params["projector"] = {**params["projector"], "adaptor": projector_params_from_jax(
            {"mlp": [], "adaptor": adaptor}, dtype, device)["adaptor"]}
        if not cfg.projector.use_feature_adaptor:
            cfg = dataclasses.replace(cfg, projector=dataclasses.replace(
                cfg.projector, use_feature_adaptor=True))
    if margs.pretrain_query_embedder or margs.pretrain_attention_layers:
        if "qformer" not in params:
            raise ValueError(
                "pretrain_query_embedder/pretrain_attention_layers require "
                "--use_event_qformer true (or a use_event_qformer checkpoint)")
        params["qformer"] = qformer_mod.load_qformer_components(
            params["qformer"], query_embedder_path=margs.pretrain_query_embedder,
            attention_layers_path=margs.pretrain_attention_layers)
    return Trainer(cfg, params, tokenizer, margs, dargs, targs, device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    margs = _extract(args, ModelArguments)
    dargs = _extract(args, DataArguments)
    targs = _extract(args, TrainingArguments)
    trainer = build_trainer(margs, dargs, targs, device=args.device,
                            tokenizer_path=args.tokenizer_path)
    if args.resume_from == "auto":
        latest = ckpt.find_latest_checkpoint(targs.output_dir)
        if latest:
            logging.getLogger(__name__).info("auto-resuming from %s", latest)
            trainer.resume(latest)
    elif args.resume_from:
        trainer.resume(args.resume_from)
    tracer = obs_trace.configure(65536) if args.trace_out else None
    try:
        metrics = trainer.train()
    finally:
        if tracer is not None:
            n = tracer.write(args.trace_out)
            logging.getLogger(__name__).info("wrote %d trace events to %s", n, args.trace_out)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
