"""Batched evaluation: N event files through one batched ``generate``.

The port of ``eventgpt_tpu/cli/eval.py`` (BASELINE config 2), with its
flags, plus ``--device`` (default ``cuda``). Every file is preprocessed on
the host, then the event encoder, the projector, prefill (K1 at batch N)
and decode run batched in one ``generate`` call (K4 under ``--quant
int4``). ``--queries_json`` gives
one query per file; ``--expected`` diffs each answer against a JSON list
of transcripts, prints PASS/FAIL per file and exits 1 on any mismatch (the
transcript gate; greedy ``--temperature 0`` makes it meaningful). The
serving mesh (``--mesh_*``) runs as in ``cli/infer``: one rank a device
under ``python -m torch.distributed.run``, each rank holding its shard and
its part of the batch; rank 0 prints the answers, and with ``--timing``
every rank prints a ``[mesh-rank]`` JSON line to stderr (K1's launches, its
peak device memory, the backend, the collectives a decode step, the
phases' seconds).

Usage:
  python -m eventgpt_tpu_torch.cli.eval --model_path <ckpt_dir|tiny-random> \\
      --tokenizer_path byte --event_frames s1.npy,s2.npy,s3.npy,s4.npy \\
      [--query "..." | --queries_json per_sample.json] [--expected expected.json] \\
      [--quant int4 --kv_cache int8] [--device cpu]
  python -m torch.distributed.run --nproc_per_node 2 -m eventgpt_tpu_torch.cli.eval \\
      --mesh_model 2 ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np

from eventgpt_tpu_torch.cli.infer import (_DTYPES, _refuse_unported, add_mesh_flags,
                                          load_for_mesh)
from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
from eventgpt_tpu_torch.models import eventchat
from eventgpt_tpu_torch.models import medusa as medusa_mod
from eventgpt_tpu_torch.ops.image import process_event_file


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batched EventGPT evaluation (PyTorch, CUDA)")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--event_frames", type=str, required=True,
                   help="comma-separated .npy event files")
    p.add_argument("--query", type=str, default="What is happening in this scene?")
    p.add_argument("--queries_json", type=str, default=None,
                   help="JSON list of one query per event file (overrides --query)")
    p.add_argument("--expected", type=str, default=None,
                   help="JSON list of expected answers; exit 1 on any mismatch")
    p.add_argument("--conv_mode", type=str, default="eventgpt_v1")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--context_len", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8", "int4"])
    p.add_argument("--kv_cache", type=str, default="bf16", choices=["bf16", "int8"],
                   help="KV cache storage; int8 halves cache memory and bandwidth")
    p.add_argument("--fuse_params", action="store_true",
                   help="fuse q|k|v and gate|up weights (5 matmuls a layer)")
    add_mesh_flags(p)
    p.add_argument("--use_event_qformer", action="store_true")
    p.add_argument("--pretrain_query_embedder", type=str, default=None)
    p.add_argument("--pretrain_attention_layers", type=str, default=None)
    p.add_argument("--speculative", type=int, default=0,
                   help="speculative decode window (the greedy chain at temperature 0, the "
                        "sampling distribution above; num_beams must be 1)")
    p.add_argument("--draft_head", default=None,
                   help="trained Medusa head stack (.npz) for speculative drafting "
                        "(requires --speculative > 0)")
    p.add_argument("--timing", action="store_true")
    p.add_argument("--ids_out", default=None,
                   help="also write each file's generated token ids to this JSON file")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


def read_queries(args, n_files: int) -> List[str]:
    """One query per event file: ``--queries_json`` or ``--query`` each time."""
    if not args.queries_json:
        return [args.query] * n_files
    with open(args.queries_json) as f:
        queries = json.load(f)
    if len(queries) != n_files:
        raise ValueError(f"{len(queries)} queries for {n_files} event files")
    return queries


def evaluate(cfg, params, tokenizer, files: List[str], queries: List[str], args,
             device="cuda", mesh=None) -> Dict:
    """One batched preprocessing and ``generate`` pass over a loaded, prepared
    tree (a rank's shard on a serving ``mesh``). Returns {"answers", "ids"
    (each file's generated chain), "prep_s", "generate_s", "timings"
    (``generate``'s phases)}."""
    t0 = time.perf_counter()
    pixels, ids = [], []
    for path, query in zip(files, queries):
        _, pv = process_event_file(path, cfg.num_event_frames, cfg.vision.image_size)
        pixels.append(pv)
        ids.append(tokenize_with_event(prepare_event_prompt(query, args.conv_mode), tokenizer))
    pixels = np.stack(pixels)
    prep_s = time.perf_counter() - t0

    draft_head = None
    if args.draft_head is not None:
        embed = params["llama"]["embed_tokens"]
        draft_head = medusa_mod.load_medusa(args.draft_head, dtype=embed.dtype,
                                            device=embed.device)
    t0 = time.perf_counter()
    timings: Dict = {}
    out_ids = eventchat.generate(
        params, cfg, ids, pixels,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        eos_token_id=getattr(tokenizer, "eos_token_id", None),
        seed=args.seed,
        max_context=args.context_len,
        num_beams=args.num_beams,
        kv_quant=args.kv_cache == "int8",
        speculative=args.speculative,
        draft_head=draft_head,
        timings=timings,
        device=device,
        mesh=mesh,
    )
    generate_s = time.perf_counter() - t0
    answers = [a.strip() for a in tokenizer.batch_decode(out_ids, skip_special_tokens=True)]
    return {"answers": answers, "ids": [list(map(int, o)) for o in out_ids],
            "prep_s": prep_s, "generate_s": generate_s, "timings": timings}


def mesh_rank_report(mesh, cfg, out: Dict, t_load: float) -> Dict:
    """One rank's numbers of a mesh run: its q heads, its kernel launches
    (K1's at ``flash_attention.cu``), its peak device memory, the backend, the collectives (count, bytes, host seconds) a
    decode step, and the load / prefill / decode seconds."""
    import torch

    from eventgpt_tpu_torch.fleet_proc import kernel_launches
    from eventgpt_tpu_torch.parallel.mesh import COLLECTIVES
    from eventgpt_tpu_torch.parallel.serving import head_shard

    tm = out["timings"]
    steps = max(int(tm.get("decode_steps", 0)), 1)
    peak = (torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda"
            else None)
    return {"rank": mesh.rank, "mesh": mesh.shape, "backend": mesh.backend,
            "device": str(mesh.device), "heads": head_shard(cfg.llama, mesh).heads,
            **kernel_launches(),
            "peak_mem_bytes": peak, "load_s": t_load,
            "encode_s": tm.get("encode_s"), "prefill_s": tm.get("prefill_s"),
            "decode_s": tm.get("decode_s"), "decode_steps": tm.get("decode_steps"),
            "collectives": dict(COLLECTIVES),
            "decode_collectives_per_step": tm.get("decode_collectives", 0) / steps,
            "decode_collective_s_per_step": tm.get("decode_collective_s", 0.0) / steps}


def main(argv=None) -> List[str]:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    files = [f for f in args.event_frames.split(",") if f]
    queries = read_queries(args, len(files))

    t0 = time.perf_counter()
    cfg, params, tokenizer, mesh, device = load_for_mesh(args)
    t_load = time.perf_counter() - t0

    out = evaluate(cfg, params, tokenizer, files, queries, args, device, mesh)
    answers = out["answers"]
    if args.ids_out and (mesh is None or mesh.rank == 0):
        with open(args.ids_out, "w") as f:
            json.dump(out["ids"], f)
    if mesh is not None:
        if args.timing:
            print("[mesh-rank] " + json.dumps(mesh_rank_report(mesh, cfg, out, t_load)),
                  file=sys.stderr, flush=True)
        if mesh.rank != 0:
            return answers
    for path, answer in zip(files, answers):
        print(f"=== {path}\n{answer}")
    if args.timing:
        n = sum(len(o) for o in out["ids"])
        print(f"[timing] load={t_load:.2f}s prep={out['prep_s']:.2f}s "
              f"generate={out['generate_s']:.2f}s ({n} tokens batch={len(files)}, "
              f"{n / out['generate_s']:.2f} tok/s) on {device}", file=sys.stderr)

    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f)
        if len(expected) != len(answers):
            raise ValueError(f"{len(expected)} expected answers for {len(answers)} samples")
        failures = 0
        for path, got, want in zip(files, answers, expected):
            ok = got == want.strip()
            failures += not ok
            print(f"[{'PASS' if ok else 'FAIL'}] {path}", file=sys.stderr)
        if failures:
            print(f"{failures}/{len(answers)} transcript mismatches", file=sys.stderr)
            sys.exit(1)
    return answers


if __name__ == "__main__":
    main()
