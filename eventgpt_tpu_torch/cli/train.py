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
window.

The training mesh: ``--mesh_data/--mesh_fsdp/--mesh_context/--mesh_model``
(``mesh_data``/``mesh_fsdp`` of -1 fill the world) and ``--attn_impl ring``
or ``ulysses`` for ``--mesh_context`` > 1, one rank a device under ``python
-m torch.distributed.run --nproc_per_node N``. The process group's backend
is ``--dist_backend`` (default ``nccl`` on the card, ``gloo`` on the CPU;
two ranks of one card need ``gloo``, which NCCL refuses) and is printed. A
mesh of N > 1 ranks in a process that was not launched as a world of N
raises ``ValueError``. Each rank loads the model on the host and copies
its shard to its device; rank 0 writes every file and prints the metrics,
and every rank prints a ``[mesh-rank]`` JSON line to stderr at the end (its
heads, K1's launches by path, the collectives per micro-step, peak device
memory, its step times, losses and gradient norms).

Usage (projector warm-up on a toy dataset, on the CPU):
  python -m eventgpt_tpu_torch.cli.train --model_path tiny-random \\
      --data_path qa.json --event_folder DIR --stage 1 --max_steps 3 \\
      --bf16 false --device cpu

Stage 2 (LoRA): ``--stage 2 --lora_r 64 --lora_alpha 16``. On a mesh of
two CPU ranks:
  python -m torch.distributed.run --nproc_per_node 2 -m eventgpt_tpu_torch.cli.train \
      --model_path tiny-random --data_path qa.json --event_folder DIR --stage 2 \
      --bf16 false --device cpu --mesh_fsdp 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from typing import Optional, Tuple, get_args, get_origin

import torch

from eventgpt_tpu_torch import checkpoint as ckpt
from eventgpt_tpu_torch.config import QFormerConfig
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import qformer as qformer_mod
from eventgpt_tpu_torch.models.convert import projector_params_from_jax
from eventgpt_tpu_torch.obs import trace as obs_trace
from eventgpt_tpu_torch.train.args import DataArguments, ModelArguments, TrainingArguments
from eventgpt_tpu_torch.train.trainer import Trainer, build_training_mesh


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
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="the mesh's process-group backend (default: nccl on cuda, gloo "
                             "on the cpu)")
    return parser


def mesh_from_args(targs: TrainingArguments, device: str, backend: Optional[str] = None):
    """The training mesh of the ``mesh_*`` fields, its process group joined
    over ``backend``, or None for one device. A mesh of N > 1 ranks in a
    process not launched as a world of N raises ``ValueError``."""
    from eventgpt_tpu_torch.parallel import dist as pdist

    device_type = resolve_device(device).type
    explicit = targs.mesh_data > 0 or targs.mesh_fsdp > 0
    n = max(targs.mesh_data, 1) * max(targs.mesh_fsdp, 1) * targs.mesh_model \
        * targs.mesh_context
    backend = backend or pdist.default_backend(device_type)
    launched = pdist.initialize_distributed(backend=backend) if n > 1 or not explicit \
        else False
    if n > 1 and not launched:
        raise ValueError(f"--mesh_* asks for {n} ranks but this is a single process; launch "
                         f"with python -m torch.distributed.run --nproc_per_node {n} -m "
                         f"eventgpt_tpu_torch.cli.train")
    mesh = build_training_mesh(targs, device_type)
    if mesh is not None and mesh.rank == 0:
        print(f"[mesh] {mesh!r} over {torch.distributed.get_world_size()} ranks, backend "
              f"{mesh.backend}", file=sys.stderr, flush=True)
    return mesh


def mesh_rank_report(trainer: Trainer) -> dict:
    """One rank's numbers of a mesh run (the ``[mesh-rank]`` line)."""
    from eventgpt_tpu_torch.ops import flash_attention as fa
    from eventgpt_tpu_torch.parallel.mesh import COLLECTIVES
    from eventgpt_tpu_torch.parallel.serving import head_shard

    mesh = trainer.mesh
    micro = max(trainer.state.step, 1)
    peak = (torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda"
            else 0)
    return {"rank": mesh.rank, "mesh": mesh.shape, "backend": mesh.backend,
            "device": str(mesh.device), "heads": head_shard(trainer.cfg.llama, mesh).heads,
            "k1_launches": fa.FLASH_KERNEL.launches, "k1_by_path": dict(fa.LAUNCHES_BY_PATH),
            "micro_steps": trainer.state.step,
            "collectives_per_micro_step": {k: v / micro for k, v in COLLECTIVES.items()},
            "peak_mem_bytes": peak, "step_s": list(trainer.step_seconds),
            "losses": [m["loss"] for m in trainer.logged],
            "grad_norms": [m["grad_norm"] for m in trainer.logged]}


def build_trainer(margs: ModelArguments, dargs: DataArguments, targs: TrainingArguments,
                  device="cuda", tokenizer_path: Optional[str] = None,
                  loaded: Optional[Tuple] = None, mesh=None) -> Trainer:
    """Load the model (or take ``loaded`` = (cfg, params, tokenizer) already
    on the device), apply the Q-Former gate and the ``pretrain_*``
    components as the JAX CLI does, and build the ``Trainer`` (on ``mesh``
    when given: the model loads on the host and each leaf's shard is copied
    to the rank's device)."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if targs.bf16 else torch.float32
    if loaded is None:
        from eventgpt_tpu_torch.cli.infer import load_model

        loaded = load_model(margs.model_name_or_path, "bfloat16" if targs.bf16 else "float32",
                            tokenizer_path=tokenizer_path,
                            device=device if mesh is None else "cpu")
        if mesh is not None:
            device = torch.device("cpu")
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
    return Trainer(cfg, params, tokenizer, margs, dargs, targs, device=device, mesh=mesh)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    margs = _extract(args, ModelArguments)
    dargs = _extract(args, DataArguments)
    targs = _extract(args, TrainingArguments)
    mesh = mesh_from_args(targs, args.device, args.dist_backend)
    trainer = build_trainer(margs, dargs, targs, device=args.device,
                            tokenizer_path=args.tokenizer_path, mesh=mesh)

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
    if mesh is None or mesh.rank == 0:
        print(metrics)
    if mesh is not None:
        from eventgpt_tpu_torch.parallel import dist as pdist

        # One rank at a time, each line in one write: the ranks share the
        # launcher's stderr, and lines written at once would interleave.
        line = "[mesh-rank] " + json.dumps(mesh_rank_report(trainer)) + "\n"
        for r in range(torch.distributed.get_world_size()):
            if r == torch.distributed.get_rank():
                sys.stderr.write(line)
                sys.stderr.flush()
            pdist.barrier("report")
        pdist.shutdown()
    return metrics


if __name__ == "__main__":
    main()
