"""Inference CLI: event stream + question -> answer, on a CUDA card.

Port of ``eventgpt_tpu/cli/infer.py``: the same load -> prepare ->
preprocess -> generate -> detokenize flow and the same flags, plus
``--device`` (default ``cuda``). ``--model_path`` takes ``tiny-random`` or
an HF-layout checkpoint directory (``config.json``, sharded
``*.safetensors`` or ``pytorch_model*.bin``, and the Q-Former's component
files when its config gates it), read onto the device in ``--dtype``.
``--quant int8|int4``, ``--kv_cache int8`` and ``--fuse_params`` run the
quantized path (int4 through the K4 kernel of ``ops/int4_matmul.py``).
``--num_beams N`` runs beam search, ``--speculative K`` speculative
decoding with a K-token verify window, and ``--draft_head heads.npz``
(with ``--speculative``) Medusa drafts from a head stack of either
package. ``--model_base`` is accepted and ignored, as in the JAX CLI. The
serving mesh (``--mesh_*``) is not ported and raises, and so does a
tokenizer other than ``byte``: the HF tokenizer is not ported.

Usage:
  python -m eventgpt_tpu_torch.cli.infer --model_path <ckpt_dir|tiny-random> \\
      --tokenizer_path byte --event_frame events.npy --query "What is happening?" \\
      [--quant int4 --kv_cache int8 --fuse_params] \\
      [--num_beams N | --speculative K [--draft_head heads.npz]] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from eventgpt_tpu_torch import constants
from eventgpt_tpu_torch.config import EventChatConfig, QFormerConfig, from_hf_config
from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer, tokenize_with_event
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import convert, eventchat
from eventgpt_tpu_torch.models import medusa as medusa_mod
from eventgpt_tpu_torch.models import qformer as qformer_mod
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
                   help="HF-layout checkpoint dir, or tiny-random (tiny random weights "
                        "from --seed)")
    p.add_argument("--model_base", type=str, default=None,
                   help="accepted and ignored, as in the JAX CLI")
    p.add_argument("--tokenizer_path", type=str, default=None,
                   help="'byte' (the offline byte tokenizer); the HF tokenizer is not "
                        "ported, so a checkpoint dir needs --tokenizer_path byte")
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
                   help="prefill attention (default: flash on cuda, dense on the cpu)")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8", "int4"])
    p.add_argument("--kv_cache", type=str, default="bf16", choices=["bf16", "int8"])
    p.add_argument("--fuse_params", action="store_true")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--speculative", type=int, default=0,
                   help="speculative decode window K (suffix-lookup drafts + a K-token "
                        "verify); exactly the greedy chain at temperature 0, the sampling "
                        "distribution above; needs num_beams 1")
    p.add_argument("--draft_head", default=None,
                   help="Medusa head stack (.npz of w (K, D, D)) that drafts instead of "
                        "the lookup (needs --speculative > 0)")
    p.add_argument("--use_event_qformer", action="store_true",
                   help="gate the Q-Former on (fresh weights unless component files load)")
    p.add_argument("--pretrain_query_embedder", type=str, default=None,
                   help="Q-Former query artifact (model.query_embedder.* npz)")
    p.add_argument("--pretrain_attention_layers", type=str, default=None,
                   help="Q-Former layer artifact (model.attention_layers.* npz)")
    p.add_argument("--timing", action="store_true", help="print stage timings to stderr")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


def _refuse_unported(args) -> None:
    """The serving mesh, which the port does not have, raises here; so do
    the JAX CLI's flag errors."""
    if args.mesh_data * args.mesh_fsdp * args.mesh_model != 1:
        raise NotImplementedError(
            "--mesh_*: the serving mesh is not ported to eventgpt_tpu_torch yet")
    if args.num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {args.num_beams}")
    if args.draft_head is not None and not args.speculative:
        # Heads without a verify window would run plain decode under the
        # heads' name.
        raise ValueError("--draft_head requires --speculative K > 0 (the heads draft "
                         "into the K-token verification window)")


def load_model(model_path: str, dtype: str = "bfloat16", attn_impl=None, tokenizer_path=None,
               device="cuda", seed: int = 0):
    """(cfg, params on ``device`` in ``dtype``, tokenizer).

    ``tiny-random`` draws tiny random weights from ``seed``. A checkpoint
    directory is read with ``from_hf_config`` and ``convert.load_state_dict``
    one shard at a time, each tensor straight onto ``device`` in ``dtype``,
    so the load holds one tree and no host copy of it. The tokenizer comes
    from ``tokenizer_path`` (default: the checkpoint) and is resolved first,
    so that an unported one fails before the weights load.
    """
    device = resolve_device(device)
    tdt = _DTYPES[dtype]
    if model_path == "tiny-random":
        tokenizer = load_tokenizer("byte")
        cfg = EventChatConfig.tiny()
        if attn_impl is not None:
            cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama,
                                                                     attn_impl=attn_impl))
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        return cfg, convert.init_eventchat_params(cfg, generator, tdt, device), tokenizer
    tokenizer = load_tokenizer(tokenizer_path or model_path)
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = from_hf_config(json.load(f), attn_impl=attn_impl, device=device)
    sd = convert.load_state_dict(model_path, device, tdt)
    return cfg, convert.eventchat_params_from_hf(sd, cfg), tokenizer


def prepare_model(cfg, params, tokenizer, args):
    """The JAX CLI's post-load preparation, in its order, on the device
    the parameters live on: the spatio-temporal gate; the Q-Former gate,
    with its component files found beside the checkpoint or given by
    ``--pretrain_*``; special tokens; the embedding resize; ``--fuse_params``;
    ``--quant``. Fusing and quantizing replace leaves in place, one at a
    time, so the card never holds two full trees. Returns (cfg, params).
    """
    st = getattr(args, "spatial_temporal_encoder", None)
    if st is not None and st != cfg.use_spatio_temporal_pool:
        cfg = dataclasses.replace(cfg, use_spatio_temporal_pool=st)
    embed = params["llama"]["embed_tokens"]
    use_qformer = args.use_event_qformer
    if use_qformer or cfg.use_event_qformer:
        qe_path, al_path = qformer_mod.find_components(
            args.model_path, args.pretrain_query_embedder, args.pretrain_attention_layers)
        if not cfg.use_event_qformer:
            qcfg = QFormerConfig(hidden_size=cfg.llama.hidden_size)
            if args.pretrain_query_embedder or args.pretrain_attention_layers:
                qcfg = qformer_mod.qformer_config_from_artifacts(
                    args.pretrain_query_embedder, args.pretrain_attention_layers)
            cfg = dataclasses.replace(cfg, use_event_qformer=True, qformer=qcfg)
        if "qformer" not in params:
            if not (qe_path or al_path) and not use_qformer:
                # The gate came from the checkpoint's config, but no weights
                # exist: a fresh Q-Former would answer garbage. The explicit
                # flag keeps fresh weights for smoke runs.
                raise ValueError(
                    f"{args.model_path} gates use_event_qformer but no "
                    f"component artifacts were found in the checkpoint dir "
                    f"or given via --pretrain_query_embedder/"
                    f"--pretrain_attention_layers")
            generator = torch.Generator(device=embed.device)
            generator.manual_seed(getattr(args, "seed", 0) + 1)
            params["qformer"] = qformer_mod.init_qformer_params(cfg.qformer, generator,
                                                                embed.dtype, embed.device)
        if qe_path or al_path:
            params["qformer"] = qformer_mod.load_qformer_components(
                params["qformer"], query_embedder_path=qe_path, attention_layers_path=al_path)

    if cfg.mm_use_im_patch_token:
        tokenizer.add_tokens([constants.DEFAULT_EVENT_PATCH_TOKEN], special_tokens=True)
    if cfg.mm_use_im_start_end:
        tokenizer.add_tokens([constants.DEFAULT_EV_START_TOKEN, constants.DEFAULT_EV_END_TOKEN],
                             special_tokens=True)
    if len(tokenizer) > cfg.llama.vocab_size:
        params["llama"] = resize_token_embeddings(params["llama"], len(tokenizer))
    if getattr(args, "fuse_params", False):
        fuse_llama_params(params["llama"])
    if args.quant in ("int8", "int4"):
        quantize_llama_params(params["llama"], bits=4 if args.quant == "int4" else 8)
    return cfg, params


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    cfg, params, tokenizer = load_model(args.model_path, args.dtype, args.attn_impl,
                                        args.tokenizer_path, device, args.seed)
    cfg, params = prepare_model(cfg, params, tokenizer, args)
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    prompt = prepare_event_prompt(args.query, args.conv_mode)
    _, pixels = process_event_file(args.event_frame, cfg.num_event_frames, cfg.vision.image_size)
    input_ids = tokenize_with_event(prompt, tokenizer)
    t_prep = time.perf_counter() - t0

    draft_head = None
    if args.draft_head is not None:
        embed = params["llama"]["embed_tokens"]
        draft_head = medusa_mod.load_medusa(args.draft_head, dtype=embed.dtype,
                                            device=embed.device)

    t0 = time.perf_counter()
    out_ids = eventchat.generate(
        params, cfg, [input_ids], pixels[None],
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        eos_token_id=tokenizer.eos_token_id,
        seed=args.seed,
        max_context=args.context_len,
        num_beams=args.num_beams,
        kv_quant=args.kv_cache == "int8",
        speculative=args.speculative,
        draft_head=draft_head,
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
