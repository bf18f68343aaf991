"""Time the one-shot int4 decode (``--quant int4 --kv_cache int8``) of two or
more trees of this package on one card, in turns.

Each turn runs a worker process with ``PYTHONPATH`` set to one tree's root,
so that ``eventgpt_tpu_torch`` (its kernels included) is that tree's: it
builds the tree's kernels, makes EventGPT-7B at full width with random bf16
weights from seed 0, quantizes the LLaMA to int4 on the card, prepares four
requests from seeded synthetic event streams (as ``chip_smoke.py``'s
``slice_int4`` does), and runs greedy ``generate`` with the int8 KV cache:
once cold, then ``--warm`` times. It reports decode ms per step of each warm
run, the greedy chains' sha256 (``chip_smoke.py``'s ``digest``, so equal
trees give its ``slice_int4`` digest), and one more warm batch under
``torch.profiler``: the device's busy share of the wall and the host-to-
device and device-to-host copies per decode step, by count and device ms.

Usage (on a card; each root holds an ``eventgpt_tpu_torch`` directory):
  python eventgpt_tpu_torch/scripts/int4_decode_ab.py \\
      --tree parent=/path/to/old --tree head=. --order parent,head,head,parent
It prints one JSON line per turn and a last line with every turn.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

QUERIES = [
    "What is happening in this scene?",
    "Describe the motion of the objects you can see.",
    "Is there a person in the event stream? Answer briefly.",
    "Which direction is the camera moving, and how fast does the scene change?",
]
MAX_NEW_TOKENS = 32


def _device_us(event) -> float:
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


def _requests(cfg, work: str):
    import numpy as np

    from eventgpt_tpu_torch import constants
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer, tokenize_with_event
    from eventgpt_tpu_torch.ops.image import process_event_file
    from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

    tokenizer = ByteTokenizer()
    tokenizer.add_tokens([constants.DEFAULT_EVENT_PATCH_TOKEN], special_tokens=True)
    pixels, ids = [], []
    for i, query in enumerate(QUERIES):
        path = os.path.join(work, f"events_{i}.npy")
        np.save(path, synthetic_event_stream(seed=100 + i))
        _, px = process_event_file(path, cfg.num_event_frames, cfg.vision.image_size)
        pixels.append(px)
        ids.append(tokenize_with_event(prepare_event_prompt(query), tokenizer))
    return tokenizer, ids, np.stack(pixels)


def worker(warm: int) -> dict:
    """One turn: this process's ``eventgpt_tpu_torch`` on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import eventgpt_tpu_torch
    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.models import eventchat, llama
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops import quant
    from eventgpt_tpu_torch.ops._build import build_all
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.int4_matmul import INT4_KERNEL

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build_all([FLASH_KERNEL, INT4_KERNEL])
    out = {"package": os.path.dirname(eventgpt_tpu_torch.__file__),
           "build_s": time.perf_counter() - t0}
    cfg = EventChatConfig.eventgpt_7b()
    with tempfile.TemporaryDirectory() as work:
        tokenizer, ids, pixels = _requests(cfg, work)
    params = init_eventchat_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   torch.bfloat16, "cuda")
    params = {**params, "llama": quant.quantize_llama_params(llama.copy_tree(params["llama"]),
                                                             bits=4)}
    torch.cuda.synchronize()

    def run():
        timings = {}
        t1 = time.perf_counter()
        chains = eventchat.generate(params, cfg, ids, pixels, max_new_tokens=MAX_NEW_TOKENS,
                                    temperature=0.0, eos_token_id=tokenizer.eos_token_id,
                                    seed=0, timings=timings, kv_quant=True)
        torch.cuda.synchronize()
        steps = timings["decode_steps"]
        return {"generate_s": time.perf_counter() - t1, "decode_steps": steps,
                "decode_ms_per_step": timings["decode_s"] * 1e3 / max(steps, 1)}, chains

    cold, chains = run()
    out["cold"] = cold
    out["greedy_sha256"] = hashlib.sha256(json.dumps(chains).encode()).hexdigest()
    warm_runs = []
    for _ in range(warm):
        numbers, again = run()
        if again != chains:
            raise AssertionError("a warm int4 run gave other tokens than the cold one")
        warm_runs.append(numbers["decode_ms_per_step"])
    out["warm_decode_ms_per_step"] = warm_runs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        numbers, _ = run()
        wall_ms = (time.perf_counter() - t1) * 1e3
    steps = numbers["decode_steps"]
    avgs = prof.key_averages()
    copies = {}
    for kind in ("Memcpy HtoD", "Memcpy DtoH"):
        hit = [e for e in avgs if kind in e.key]
        copies[kind] = {"per_step": sum(e.count for e in hit) / steps,
                        "device_ms_per_step": sum(_device_us(e) for e in hit) / 1e3 / steps}
    busy_ms = sum(_device_us(e) for e in avgs) / 1e3
    out["profiled"] = {**numbers, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                       "device_busy_share": busy_ms / wall_ms, "copies": copies,
                       "top_device_ms": [[e.key, _device_us(e) / 1e3, e.count] for e in
                                         sorted(avgs, key=_device_us, reverse=True)[:8]]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="LABEL=ROOT: a root holding an eventgpt_tpu_torch directory")
    p.add_argument("--order", default="", help="comma-separated labels, one turn each")
    p.add_argument("--warm", type=int, default=3, help="warm batches a turn")
    p.add_argument("--timeout_s", type=float, default=900.0, help="the bound of one turn")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.warm)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = [x for x in args.order.split(",") if x] or list(trees)
    turns = []
    for label in order:
        root = os.path.abspath(trees[label])
        env = dict(os.environ, PYTHONPATH=root)
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", "--warm",
                              str(args.warm)], cwd=root, env=env, capture_output=True,
                             text=True, timeout=args.timeout_s)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            raise RuntimeError(f"the turn of {label} ({root}) exited {res.returncode}")
        turn = {"tree": label, **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    print(json.dumps({"turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
