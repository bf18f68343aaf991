"""Inference CLI: event stream + question -> answer, on a CUDA card.

Port of ``eventgpt_tpu/cli/infer.py`` for this slice of the port: the
same load -> preprocess -> generate -> detokenize flow and the same flags,
plus ``--device`` (default ``cuda``). ``--quant int8|int4``, ``--kv_cache
int8`` and ``--fuse_params`` run the quantized path (int4 through the K4
kernel of ``ops/int4_matmul.py``). Flags whose paths are not ported yet
(beam search, speculative and Medusa decoding, a serving mesh, Q-Former)
raise.

Usage:
  python -m eventgpt_tpu_torch.cli.infer --model_path tiny-random \\
      --event_frame events.npy --query "What is happening?" \
      [--quant int4 --kv_cache int8 --fuse_params] [--device cpu]

``--model_path tiny-random`` runs tiny random weights with the offline byte
tokenizer. Loading a real checkpoint is not ported yet; ``chip_smoke.py``
drives the same calls at EventGPT-7B's full widths.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from eventgpt_tpu_torch import constants
from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer, tokenize_with_event
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import eventchat
from eventgpt_tpu_torch.models.convert import init_eventchat_params
from eventgpt_tpu_torch.models.llama import fuse_llama_params, resize_token_embeddings
from eventgpt_tpu_torch.ops.image import process_event_file
from eventgpt_tpu_torch.ops.quant import quantize_llama_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected bool, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="EventGPT inference (PyTorch, CUDA)")
    p.add_argument("--model_path", type=str, required=True,
                   help="tiny-random (tiny random weights from --seed)")
    p.add_argument("--model_base", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None,
                   help="only 'byte' (the offline byte tokenizer) in this port")
    p.add_argument("--query", type=str, required=True)
    p.add_argument("--conv_mode", type=str, default="eventgpt_v1")
    p.add_argument("--context_len", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.6)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--spatial_temporal_encoder", type=_str2bool, default=True,
                   help="pool frame features spatio-temporally (reference default)")
    p.add_argument("--event_frame", type=str, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--attn_impl", type=str, default=None, choices=["dense", "flash"],
                   help="prefill attention (default: the config's, flash at 7B)")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8", "int4"])
    p.add_argument("--kv_cache", type=str, default="bf16", choices=["bf16", "int8"])
    p.add_argument("--fuse_params", action="store_true")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--speculative", type=int, default=0)
    p.add_argument("--draft_head", default=None)
    p.add_argument("--use_event_qformer", action="store_true")
    p.add_argument("--timing", action="store_true", help="print stage timings to stderr")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


def _refuse_unported(args) -> None:
    """Flags of paths that later slices of the port bring raise here."""
    unported = [
        (args.num_beams > 1, f"--num_beams {args.num_beams}", "beam search"),
        (args.speculative != 0, f"--speculative {args.speculative}", "speculative decoding"),
        (args.draft_head is not None, "--draft_head", "Medusa draft heads"),
        (args.mesh_data * args.mesh_fsdp * args.mesh_model != 1, "--mesh_*", "the serving mesh"),
        (args.use_event_qformer, "--use_event_qformer", "the Q-Former"),
        (args.model_base is not None, "--model_base", "checkpoint loading"),
    ]
    for bad, flag, what in unported:
        if bad:
            raise NotImplementedError(
                f"{flag}: {what} is not ported to eventgpt_tpu_torch yet")
    if args.num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {args.num_beams}")
    if args.model_path != "tiny-random":
        raise NotImplementedError(
            f"--model_path {args.model_path!r}: loading a checkpoint is not ported "
            f"yet; use tiny-random")
    if args.tokenizer_path not in (None, "byte"):
        raise NotImplementedError("--tokenizer_path: only the byte tokenizer is ported")


def load_model(args, device: torch.device):
    """(cfg, params on ``device``, tokenizer) for tiny random weights, with
    the JAX CLI's ``prepare_model`` order: special tokens, embedding resize,
    then ``--fuse_params``, then ``--quant`` (on ``device``, in place)."""
    import dataclasses

    cfg = EventChatConfig.tiny()
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, attn_impl=args.attn_impl))
    if args.spatial_temporal_encoder != cfg.use_spatio_temporal_pool:
        cfg = dataclasses.replace(cfg, use_spatio_temporal_pool=args.spatial_temporal_encoder)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    params = init_eventchat_params(cfg, generator, _DTYPES[args.dtype], device)
    tokenizer = ByteTokenizer()
    if cfg.mm_use_im_patch_token:
        tokenizer.add_tokens([constants.DEFAULT_EVENT_PATCH_TOKEN], special_tokens=True)
    if cfg.mm_use_im_start_end:
        tokenizer.add_tokens([constants.DEFAULT_EV_START_TOKEN, constants.DEFAULT_EV_END_TOKEN],
                             special_tokens=True)
    if len(tokenizer) > cfg.llama.vocab_size:
        params["llama"] = resize_token_embeddings(params["llama"], len(tokenizer))
    if args.fuse_params:
        fuse_llama_params(params["llama"])
    if args.quant in ("int8", "int4"):
        quantize_llama_params(params["llama"], bits=4 if args.quant == "int4" else 8)
    return cfg, params, tokenizer


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    cfg, params, tokenizer = load_model(args, device)
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    prompt = prepare_event_prompt(args.query, args.conv_mode)
    _, pixels = process_event_file(args.event_frame, cfg.num_event_frames, cfg.vision.image_size)
    input_ids = tokenize_with_event(prompt, tokenizer)
    t_prep = time.perf_counter() - t0

    t0 = time.perf_counter()
    out_ids = eventchat.generate(
        params, cfg, [input_ids], pixels[None],
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        eos_token_id=tokenizer.eos_token_id,
        seed=args.seed,
        max_context=args.context_len,
        kv_quant=args.kv_cache == "int8",
        device=device,
    )[0]
    t_gen = time.perf_counter() - t0

    output = tokenizer.batch_decode([out_ids], skip_special_tokens=True)[0].strip()
    if args.timing:
        n = max(len(out_ids), 1)
        print(
            f"[timing] load={t_load:.2f}s prep={t_prep:.2f}s generate={t_gen:.2f}s "
            f"({n} tokens, {n / t_gen:.2f} tok/s) on {device}",
            file=sys.stderr,
        )
    print(output)
    return output


if __name__ == "__main__":
    main()
