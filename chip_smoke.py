"""Chip smoke test of the PyTorch port: EventGPT-7B event-QA on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed on its own line:

1. build   -- compiles every hand-written kernel with nvcc for sm_90a
              (one nvcc per source, all started together);
2. kernel  -- holds each kernel against its plain PyTorch version on the
              card at the shapes the main path gives it, and times the
              kernel, the plain version and one PyTorch library call;
3. slice   -- four event-QA requests through EventGPT-7B at full width
              (CLIP ViT-L/14-336, LLaMA-7B; random bf16 weights from a
              seed), through the calls ``eventgpt_tpu_torch.cli.infer``
              makes; checks that the main path launched every kernel, that
              the flash prefill agrees with the dense prefill, and that a
              tiny model gives the same greedy chain on the card as on the
              CPU;
4. kernels -- one JSON line per the kernel table, then the card's name and
              power limit, then the result line.

Any failure raises and exits non-zero. Without a CUDA card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, H100 SXM
QUERIES = [
    "What is happening in this scene?",
    "Describe the motion of the objects you can see.",
    "Is there a person in the event stream? Answer briefly.",
    "Which direction is the camera moving, and how fast does the scene change?",
]
MAX_NEW_TOKENS = 32
# bf16 kernel vs its f32 plain version: output rounding to bf16 (2^-8
# relative on |out| <= ~3) plus P rounded to bf16 before the P.V product.
KERNEL_ATOL = 2e-2
# First-token logits of flash vs dense prefill after 32 bf16 layers: both
# round P/probs and ctx to bf16 at different points, and each layer's
# difference passes through the rest of the stack. Logits are O(1).
PREFILL_LOGIT_ATOL = 0.25


def emit(phase: str, payload: dict) -> None:
    print(f"{phase}: {json.dumps(payload)}", flush=True)


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device ms per call: CUDA events around ``iters`` calls after
    ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def flash_bound_ms(b: int, s: int, h: int, hd: int, causal: bool = True):
    """Least time for the attention on an H100 SXM: each of q, k, v, out
    moved once (bf16) plus the valid mask, against the two products over
    the (q, k) pairs the causal loop visits."""
    nbytes = 4 * b * s * h * hd * 2 + b * s
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flops = 2 * 2 * hd * pairs
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def check_flash_kernel(lengths, seed: int) -> dict:
    """K1 against its plain version at (B, S) = (len(lengths), max(lengths)),
    32 heads of 128, bf16, right padding; returns error and times."""
    import torch
    import torch.nn.functional as F

    from eventgpt_tpu_torch.ops import flash_attention as fa

    b, s, h, hd = len(lengths), max(lengths), 32, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, hd), generator=g, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    valid = torch.arange(s, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
    out = fa.flash_attention(q, k, v, valid=valid, causal=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, valid, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > KERNEL_ATOL:
        raise AssertionError(f"flash kernel at B={b} S={s}: max abs err {err} > {KERNEL_ATOL}")
    for row, n in enumerate(lengths):
        if n < s and not bool((out[row, n:] == 0).all()):
            raise AssertionError(f"flash kernel: padded query rows of row {row} are not zero")

    # The library yardstick: one SDPA call with the same causal + key mask.
    mask = valid[:, None, None, :] & torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, valid=valid, causal=True))
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v, valid, causal=True),
                            warmup=1, iters=5)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    bound_ms, bound_by, nbytes, flops = flash_bound_ms(b, s, h, hd)
    return {"B": b, "S": s, "H": h, "hd": hd, "lengths": list(lengths), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops}


def tiny_card_matches_cpu(event_path: str) -> dict:
    """A tiny f32 model gives the same greedy chain on the card as on the CPU."""
    import torch

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer, tokenize_with_event
    from eventgpt_tpu_torch.models import eventchat
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops.image import process_event_file

    cfg = EventChatConfig.tiny(vocab_size=260)
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(1), torch.float32, "cpu")
    card = {k: _to(v, "cuda") for k, v in cpu.items()}
    _, pixels = process_event_file(event_path, cfg.num_event_frames, cfg.vision.image_size)
    ids = tokenize_with_event(prepare_event_prompt(QUERIES[0]), ByteTokenizer())
    kwargs = dict(max_new_tokens=16, temperature=0.0, eos_token_id=None)
    on_cpu = eventchat.generate(cpu, cfg, [ids], pixels[None], device="cpu", **kwargs)
    on_card = eventchat.generate(card, cfg, [ids], pixels[None], device="cuda", **kwargs)
    if on_cpu != on_card:
        raise AssertionError(f"tiny greedy chain differs: cpu {on_cpu} vs cuda {on_card}")
    return {"tokens": len(on_card[0]), "identical": True}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def prepare_requests(cfg, event_dir: str):
    """Four seeded synthetic event streams written as STREAM_DTYPE .npy, and
    each request's pixels and prompt ids, as cli/infer prepares them."""
    import numpy as np

    from eventgpt_tpu_torch import constants
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer, tokenize_with_event
    from eventgpt_tpu_torch.ops.image import process_event_file
    from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

    t0 = time.perf_counter()
    paths = []
    for i in range(len(QUERIES)):
        path = os.path.join(event_dir, f"events_{i}.npy")
        np.save(path, synthetic_event_stream(seed=100 + i))
        paths.append(path)
    t_events = time.perf_counter() - t0

    t0 = time.perf_counter()
    tokenizer = ByteTokenizer()
    tokenizer.add_tokens([constants.DEFAULT_EVENT_PATCH_TOKEN], special_tokens=True)
    pixels, ids = [], []
    for path, query in zip(paths, QUERIES):
        _, px = process_event_file(path, cfg.num_event_frames, cfg.vision.image_size)
        pixels.append(px)
        ids.append(tokenize_with_event(prepare_event_prompt(query), tokenizer))
    t_prep = time.perf_counter() - t0
    # Prefill length of each request: its text tokens plus the event block.
    lengths = [len(x) - 1 + cfg.num_event_tokens for x in ids]
    host = {"events_s": t_events, "preprocess_s": t_prep, "prompt_lengths": lengths}
    return tokenizer, ids, np.stack(pixels), lengths, host


def timed_generate(eventchat, params, cfg, ids, pixels, tokenizer):
    """One batch through ``generate`` with phase timings; returns (numbers, ids)."""
    import torch

    timings = {}
    t0 = time.perf_counter()
    out_ids = eventchat.generate(
        params, cfg, ids, pixels, max_new_tokens=MAX_NEW_TOKENS, temperature=0.0,
        eos_token_id=tokenizer.eos_token_id, seed=0, timings=timings)
    torch.cuda.synchronize()
    steps = timings["decode_steps"]
    return {
        "generate_s": time.perf_counter() - t0,
        "encode_ms": timings["encode_s"] * 1e3,
        "prefill_ms": timings["prefill_s"] * 1e3,
        "decode_ms": timings["decode_s"] * 1e3,
        "decode_steps": steps,
        "decode_ms_per_step": timings["decode_s"] * 1e3 / max(steps, 1),
        "decode_tok_s": len(ids) * steps / timings["decode_s"],
        "generated_tokens": [len(r) for r in out_ids],
    }, out_ids


def profile_generate(eventchat, params, cfg, ids, pixels, tokenizer, out_dir: str) -> dict:
    """torch.profiler over one more batch: device time by operator, and the
    device's busy share of the wall time (kernels on one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed_generate(eventchat, params, cfg, ids, pixels, tokenizer)
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(dev_us(e) for e in avgs) / 1e3
    top = sorted(avgs, key=dev_us, reverse=True)[:15]
    with open(os.path.join(out_dir, "profile_generate.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top_device_ms": [[e.key, dev_us(e) / 1e3, e.count] for e in top],
            "table": os.path.join(out_dir, "profile_generate.txt")}


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="also profile one batch; write the operator table to DIR")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import dataclasses

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.models import eventchat, llama
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops._build import build_all
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    kernels = [FLASH_KERNEL]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", {"kind": card, "count": torch.cuda.device_count(), "nvidia_smi": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda})

    # 1. build
    shutil.rmtree(os.path.join(ROOT, "eventgpt_tpu_torch", "csrc", "build"), ignore_errors=True)
    t0 = time.perf_counter()
    build_all(kernels)
    for k in kernels:
        k.lib()
        ptxas = [ln.strip() for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        emit("build", {"source": k.source, "seconds": k.build_seconds, "ptxas": ptxas})
    emit("build_total", {"seconds": time.perf_counter() - t0})

    cfg = EventChatConfig.eventgpt_7b()
    if cfg.llama.attn_impl != "flash":
        raise AssertionError("the 7B preset must prefill through the flash kernel")
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT)
    try:
        tokenizer, ids, pixels, lengths, host = prepare_requests(cfg, work)
        t0 = time.perf_counter()
        params = init_eventchat_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                       torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        emit("host", {**host, "init_weights_s": time.perf_counter() - t0})

        # 2. kernel checks at the main path's prefill shape and at an S
        # that is no multiple of the 64-row tile.
        main_check = check_flash_kernel(lengths, seed=1)
        emit("kernel_flash_main_shape", main_check)
        odd_check = check_flash_kernel([333, 201], seed=2)
        emit("kernel_flash_odd_s", odd_check)

        # 3. the slice: four requests through generate, as cli/infer calls
        # it. The first run is the counted main path (and the cold start);
        # the second is the same work with every shape seen before.
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        cold, out_ids = timed_generate(eventchat, params, cfg, ids, pixels, tokenizer)
        launches = {k.source: k.launches for k in kernels}
        cold["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        for k in kernels:
            if k.launches < cfg.llama.num_layers:
                raise AssertionError(f"{k.source}: {k.launches} launches on the main path, "
                                     f"want >= {cfg.llama.num_layers}")
        vocab = cfg.llama.vocab_size
        if len(out_ids) != len(QUERIES) or any(
                len(r) > MAX_NEW_TOKENS or any(not 0 <= t < vocab for t in r) for r in out_ids):
            raise AssertionError(f"malformed generations: {out_ids}")
        emit("slice", {
            "config": "EventGPT-7B (CLIP ViT-L/14-336 24 layers, LLaMA-7B 32 layers, d=4096, "
                      "vocab 32000), random bf16 weights, seed 0",
            "requests": len(QUERIES), "prompt_lengths": lengths, "run": "first (cold)",
            **cold, "launches": launches, "nvidia_smi": smi,
        })
        warm, warm_ids = timed_generate(eventchat, params, cfg, ids, pixels, tokenizer)
        if warm_ids != out_ids:
            raise AssertionError("a second greedy run gave other tokens")
        emit("slice_warm", {"run": "second (warm)", **warm, "nvidia_smi": smi})
        answers = tokenizer.batch_decode(out_ids, skip_special_tokens=True)
        if args.profile:
            emit("profile", profile_generate(eventchat, params, cfg, ids, pixels, tokenizer,
                                             args.profile))
        emit("answers", {"answers": answers, "first_ids": [r[:8] for r in out_ids]})

        # Flash vs dense prefill: first-token logits on the same embeddings.
        padded, mask, _ = eventchat.prepare_prefill(params, cfg, ids, pixels)
        b, t = padded.shape[:2]
        logits = {}
        for impl in ("flash", "dense"):
            lcfg = dataclasses.replace(cfg.llama, attn_impl=impl)
            cache = llama.init_kv_cache(lcfg, b, t, dtype=padded.dtype, device=padded.device)
            with torch.inference_mode():
                logits[impl], _ = llama.prefill(params["llama"], lcfg, padded, mask, cache,
                                                last_only=True)
        diff = (logits["flash"] - logits["dense"]).abs().max().item()
        finite = bool(torch.isfinite(logits["flash"]).all())
        same_first = (logits["flash"].argmax(-1) == logits["dense"].argmax(-1)).tolist()
        emit("prefill_flash_vs_dense", {"max_abs_logit_diff": diff, "tolerance": PREFILL_LOGIT_ATOL,
                                        "logit_absmax": logits["dense"].abs().max().item(),
                                        "finite": finite, "same_greedy_first_token": same_first})
        if not finite or diff > PREFILL_LOGIT_ATOL:
            raise AssertionError(f"flash vs dense prefill logits differ by {diff}")
        del params, padded, logits, cache
        torch.cuda.empty_cache()

        emit("tiny_card_vs_cpu", tiny_card_matches_cpu(os.path.join(work, "events_0.npy")))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 4. the kernel table, the card, the result.
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd_bf16",
        "route": "cuda",
        "source": "eventgpt_tpu_torch/csrc/flash_attention.cu",
        "replaces": "eventgpt_tpu/ops/flash_attention.py:29",
        "launches": launches[FLASH_KERNEL.source],
        "max_abs_err": max(main_check["max_abs_err"], odd_check["max_abs_err"]),
        "ms": main_check["ms"],
        "plain_ms": main_check["plain_ms"],
        "bound_ms": main_check["bound_ms"],
        "bound_by": main_check["bound_by"],
        "library_ms": main_check["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
