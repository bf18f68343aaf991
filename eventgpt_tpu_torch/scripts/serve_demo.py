"""Continuous-batching server demo: N event-QA requests through one
resident decode batch (``eventgpt_tpu_torch/serve.py``).

Port of ``scripts/serve_demo.py``: requests join a running batch as rows
free up -- submit more queries than ``--max_batch`` and they stream through
without a batch drain. The demo drives the ``ContinuousBatcher`` from the
main thread only (no engine, no lock needed). With ``--mesh_*`` it runs on
the serving mesh, one rank a device under ``python -m
torch.distributed.run``: every rank loads the host tree and puts its shard
on its device (``cli/infer.load_for_mesh``), runs the same batcher over
the same requests, and rank 0 prints.

Usage (tiny random weights):
  python -m eventgpt_tpu_torch.scripts.serve_demo --event_frame events.npy \\
      --queries "What is happening?;Describe the scene.;What moves fastest?" \\
      --max_batch 2 --max_new_tokens 24 [--device cpu]
  python -m torch.distributed.run --nproc_per_node 2 \\
      -m eventgpt_tpu_torch.scripts.serve_demo --mesh_model 2 --event_frame events.npy ...
Real checkpoints: --model_path <hf dir> --tokenizer_path byte (the loader of
``cli/infer``).
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    from eventgpt_tpu_torch.cli.infer import add_mesh_flags

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", default="tiny-random")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--event_frame", required=True,
                   help="event .npy to answer about; with --event_root, a path relative to "
                        "(and confined under) that root")
    p.add_argument("--event_root", default=None,
                   help="optional allowlist root: --event_frame must resolve inside it (the "
                        "confinement of cli/serve)")
    p.add_argument("--queries", required=True, help="';'-separated questions")
    p.add_argument("--conv_mode", default="eventgpt_v1")
    p.add_argument("--max_batch", type=int, default=2)
    p.add_argument("--max_len", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--quant", default="none", choices=["none", "int8", "int4"])
    p.add_argument("--fuse_params", action="store_true",
                   help="fuse q|k|v and gate|up before quantization")
    p.add_argument("--kv_cache", default="bf16", choices=["bf16", "int8"])
    p.add_argument("--speculative", type=int, default=0,
                   help="verify-window size K (0 = plain decode)")
    p.add_argument("--draft_head", default=None,
                   help="trained Medusa head stack (.npz) for speculative drafting "
                        "(requires --speculative > 0)")
    p.add_argument("--warmup", action="store_true",
                   help="run every function a request can reach once before serving "
                        "(ContinuousBatcher.warmup)")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="decode-interleaved admission prefill chunk (0 = one-shot)")
    p.add_argument("--no_pipeline", action="store_true",
                   help="the synchronous scheduler (chains are the same either way)")
    p.add_argument("--first_chunk", type=int, default=0,
                   help="TTFT ramp: short segment while a fresh admission owes its first "
                        "token (0 = off)")
    add_mesh_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")
    # prepare_model (shared with the infer/eval CLIs) reads these:
    p.add_argument("--use_event_qformer", action="store_true")
    p.add_argument("--pretrain_query_embedder", default=None)
    p.add_argument("--pretrain_attention_layers", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    frame = args.event_frame
    if args.event_root is not None:
        # Fail before touching the model: the confinement of cli/serve.
        from eventgpt_tpu_torch.cli.serve import _resolve_event_path

        frame = _resolve_event_path(args.event_root, frame)

    from eventgpt_tpu_torch.cli.infer import load_for_mesh
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
    from eventgpt_tpu_torch.ops.image import process_event_file
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    # The mesh goes through prepare_model, so the host tree lands sharded:
    # never a whole copy on one device first.
    cfg, params, tokenizer, mesh, device = load_for_mesh(args)
    primary = mesh is None or mesh.rank == 0
    _, pixels = process_event_file(frame, cfg.num_event_frames, cfg.vision.image_size)
    draft_head = None
    if args.draft_head:
        from eventgpt_tpu_torch.models.medusa import load_medusa

        embed = params["llama"]["embed_tokens"]
        draft_head = load_medusa(args.draft_head, dtype=embed.dtype, device=embed.device)
    srv = ContinuousBatcher(
        params, cfg, max_batch=args.max_batch, max_len=args.max_len, chunk=args.chunk,
        temperature=args.temperature, eos_token_id=getattr(tokenizer, "eos_token_id", None),
        kv_quant=args.kv_cache == "int8", speculative=args.speculative, mesh=mesh,
        prefill_chunk=args.prefill_chunk, draft_head=draft_head, first_chunk=args.first_chunk,
        pipeline=not args.no_pipeline, device=device)
    if args.warmup:
        t0 = time.perf_counter()
        n = srv.warmup()
        if primary:
            print(f"[warmup: {n} functions in {time.perf_counter() - t0:.2f}s]")
    queries = [q for q in args.queries.split(";") if q.strip()]
    t0 = time.perf_counter()
    rids = {}
    for q in queries:
        ids = tokenize_with_event(prepare_event_prompt(q.strip(), args.conv_mode), tokenizer)
        rids[srv.submit(ids, pixels, args.max_new_tokens)] = q.strip()
    out = srv.run_until_drained()
    dt = time.perf_counter() - t0
    if primary:
        tot = 0
        for rid, q in rids.items():
            answer = tokenizer.batch_decode([out[rid]], skip_special_tokens=True)[0].strip()
            tot += len(out[rid])
            print(f"Q: {q}\nA: {answer}\n")
        print(f"[{len(queries)} requests, {tot} tokens, {dt:.2f}s, "
              f"{tot / dt:.1f} tok/s aggregate]")
    return out


if __name__ == "__main__":
    main()
