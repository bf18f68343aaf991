"""Export a (finetuned) model as an HF-style EventChat_llama checkpoint.

Port of ``eventgpt_tpu/cli/export.py``: merge the trainer's artifacts (a
stage-1 projector npz, a stage-2 LoRA npz, the Q-Former's component files)
into the base weights and write a sharded-safetensors directory and
``config.json`` in the reference's layout, which both packages' CLIs load.
The weights are merged in f32 on ``--device`` (default ``cuda``, as for
every entry point of the port) and written in f32.

Usage:
  python -m eventgpt_tpu_torch.cli.export --model_path <base ckpt|tiny-random>
      [--projector projector_last.npz] [--lora lora_last.npz
       --lora_r 64 --lora_alpha 16] [--query_embedder q.npz
       --attention_layers a.npz] --output_dir exported/
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from eventgpt_tpu_torch import checkpoint as ckpt
from eventgpt_tpu_torch.cli.infer import load_model
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import qformer as qformer_mod
from eventgpt_tpu_torch.models.convert import projector_params_from_jax, write_hf_checkpoint
from eventgpt_tpu_torch.train.lora import LoraConfig, merge_lora


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export HF-style checkpoint (PyTorch)")
    p.add_argument("--model_path", type=str, required=True,
                   help="base checkpoint dir (or tiny-random)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--projector", type=str, default=None,
                   help="stage-1 artifact (model.visual_projector.* npz)")
    p.add_argument("--lora", type=str, default=None,
                   help="stage-2 artifact (lora.* npz), merged into the LM")
    p.add_argument("--query_embedder", type=str, default=None,
                   help="trained Q-Former query artifact (re-exported as a "
                        "sibling component of the checkpoint)")
    p.add_argument("--attention_layers", type=str, default=None)
    p.add_argument("--lora_r", type=int, default=64)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--num_shards", type=int, default=2)
    p.add_argument("--visual_tower", type=str,
                   default="openai/clip-vit-large-patch14-336")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the weights are merged on (default cuda; cpu only "
                        "when asked)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # Weight export never touches the tokenizer.
    cfg, params, _ = load_model(args.model_path, "float32", tokenizer_path="byte",
                                device=device)

    if args.projector:
        tree = ckpt.load_component(args.projector, strip_prefix="model.visual_projector.")
        params["projector"] = projector_params_from_jax(tree, torch.float32, device)
    # Re-exporting a Q-Former checkpoint must not drop it: the component
    # files that write_hf_checkpoint puts beside a checkpoint load unless
    # explicit ones are given.
    qe_path, al_path = qformer_mod.find_components(args.model_path, args.query_embedder,
                                                   args.attention_layers)
    if cfg.use_event_qformer and not (qe_path and al_path):
        raise ValueError(
            f"{args.model_path} gates use_event_qformer but no Q-Former "
            f"component artifacts were found or given "
            f"(--query_embedder/--attention_layers); refusing to export a "
            f"checkpoint that would silently lose the module")
    if qe_path or al_path:
        if not cfg.use_event_qformer:
            cfg = dataclasses.replace(
                cfg, use_event_qformer=True,
                qformer=qformer_mod.qformer_config_from_artifacts(qe_path, al_path))
        if "qformer" not in params:
            params["qformer"] = qformer_mod.init_qformer_params(
                cfg.qformer, torch.Generator(device=device).manual_seed(1), torch.float32,
                device)
        params["qformer"] = qformer_mod.load_qformer_components(
            params["qformer"], query_embedder_path=qe_path, attention_layers_path=al_path)
    if args.lora:
        lora_tree = ckpt.load_component(args.lora, strip_prefix="lora.")
        params["llama"] = merge_lora(params["llama"], lora_tree,
                                     LoraConfig(r=args.lora_r, alpha=args.lora_alpha))

    os.makedirs(args.output_dir, exist_ok=True)
    out = write_hf_checkpoint(params, cfg, args.output_dir, num_shards=args.num_shards,
                              visual_tower=args.visual_tower)
    print(f"exported {out} ({len(os.listdir(out))} files)")
    return out


if __name__ == "__main__":
    main()
