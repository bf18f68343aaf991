"""Chip smoke test of the PyTorch port: EventGPT-7B event-QA on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--profile DIR] [--int4_baseline FILE] [--flash_baseline FILE]

Phases, each printed on its own line:

1. build        -- compiles every hand-written kernel with nvcc for sm_90a
                   (one nvcc per source, all started together);
2. kernel_*     -- holds each kernel against its plain PyTorch version on
                   the card at the shapes the main paths give it, and times
                   the kernel, the plain version and one PyTorch library
                   call: K1 (flash prefill) at the 7B prefill shape, at
                   S = 333 and at the 64-row tile edges (with its registers
                   per thread and blocks per SM), K4 (int4 matmul) at the 7B
                   decode shapes (with the decode plan and the GB/s
                   reached) and prefill shapes; with ``--int4_baseline``
                   or ``--flash_baseline`` also another version of
                   ``csrc/int4_matmul.cu`` or ``csrc/flash_attention.cu``
                   on the same inputs, in turns with K4 or K1 (K1's
                   ``baseline_bit_identical`` per shape): how a redesign of
                   a kernel is held against its parent commit's kernel in
                   one call;
3. slice        -- four event-QA requests through EventGPT-7B at full width
                   (CLIP ViT-L/14-336, LLaMA-7B; random bf16 weights from a
                   seed), through the calls ``eventgpt_tpu_torch.cli.infer``
                   makes, with a sha256 of the greedy chains; with
                   ``--flash_baseline`` the same warm batch again through
                   the other K1 (``slice_flash_baseline``: its prefill ms
                   and digest), and with ``--profile`` K1's device ms per
                   prefill forward for both; then flash-vs-dense prefill
                   logits;
4. slice_int4   -- the same requests with ``--quant int4 --kv_cache int8``
                   (the bf16 tree quantized on the card): K4 launches
                   225 x (1 + decode steps), K1 32, and a sha256 of the
                   greedy chains; with ``--int4_baseline`` the same batch
                   again through the other K4 (``slice_int4_baseline``),
                   and with ``--profile`` K4's decode device ms per step
                   for both; ``slice_spec_int4`` (``--speculative 4``: K4
                   launches by path and M, the chain rule against
                   ``slice_int4``); then int4 vs the bf16
                   prefill of the dequantized weights, the int8 vs bf16 KV
                   cache, and K2 (int8 decode attention) on that cache, also
                   at n_valid 0, 1, 64 and 65, with each of its passes timed;
5. serve_*      -- with the bf16 7B tree of phase 3: six requests through
                   the continuous-batching server as ``cli/serve`` builds it
                   (a ContinuousBatcher under a ServingEngine), int8 KV cache,
                   4 rows, max_len 1024, chunk 32, greedy: ``serve_paged_int8kv``
                   (the paged arena) and ``serve_dense_int8kv`` (the dense
                   cache, the same chains); between them ``kernel_paged_int8``
                   holds K3 (paged int8 decode attention) on the arena that
                   the server's first step filled, against its plain version
                   and against K2 on the gathered view, also at n_valid 0, 1,
                   64 and 65;
6. slice_int8_fused -- ``--quant int8 --fuse_params`` with a bf16 cache;
7. checkpoint_7b -- phase 3's bf16 tree written as a sharded HF checkpoint
                   (``convert.write_hf_checkpoint``) into the work directory,
                   then loaded through ``cli.infer.load_model`` and
                   ``prepare_model`` on the card: every leaf equal to phase
                   3's, the four requests give ``slice``'s digest (K1 32
                   launches); loaded again with ``--quant int4`` and run with
                   the int8 cache, ``slice_int4``'s digest (K4 225 x (1 +
                   steps)); write and load seconds and GB/s, and the peak
                   device memory of the load over what was held before it;
                   ``python -m eventgpt_tpu_torch.cli.infer --model_path DIR``
                   as a subprocess on one stream (the first whose answer
                   decodes to text) prints the answer and token count of an
                   in-process batch-1 ``generate``, and so does it over a
                   tiny bf16 checkpoint whose every generated id is one
                   printable character (``cli_subprocess_tiny``). ``slice_qformer``: a
                   seeded Q-Former at 7B width (32 queries, 2 layers, d =
                   4096) saved as component files and loaded over the same
                   directory with ``--use_event_qformer
                   --pretrain_query_embedder --pretrain_attention_layers``;
                   the four requests run on 32 event tokens each, cold then
                   warm. The
                   directory is deleted when the phases end;
8. training     -- on the same bf16 tree, after ``slice_qformer``:
                   ``kernel_flash_grad`` holds K1's autograd Function at
                   the first training batch's shape (B = 2, T = 832, 32
                   heads): its forward against the plain version, dq/dk/dv
                   against autograd through the plain version, padded rows,
                   and the forward, backward and SDPA-backward times with
                   the backward's bound; ``train_stage1_7b`` (projector)
                   and ``train_stage2_7b`` (LoRA r 64 + projector) build
                   the trainer through ``cli.train.build_trainer`` on a toy
                   QA set of 8 entries (streams of seeds 100-107) and take
                   4 optimizer steps of batch 2 under full remat (K1 64
                   launches and 32 backward calls per micro-step), then
                   ``evaluate`` on 2 entries (K1 32), check that every
                   trainable moved and sampled frozen leaves did not, merge
                   ``lora_last.npz`` through ``merge_lora``, and hold a
                   fresh trainer's resumed step against the same step in
                   memory; with ``--profile``, one more step profiled;
9. tiny_*       -- tiny models give the same greedy chain on the card as on
                   the CPU, bf16-free f32, with int4 + int8 KV + fused (its
                   chain's sha256 printed), beam (k = 2, 3), speculative
                   (window 1, 2, 4) and Medusa chains, served paged with the int8
                   cache, and loaded from a checkpoint the port wrote
                   (plain and with a gated Q-Former);
                   ``serve_http_tiny`` runs ``cli/serve.build_server`` on the
                   card over a tiny bf16 checkpoint (``--model_path DIR``,
                   prefill through K1) and answers two POST /v1/generate;
                   ``train_tiny_card_vs_cpu``: one f32 stage-1 and stage-2
                   step agree on the card and the CPU, and ``cli.train``
                   trains 2 steps on the card in a subprocess;
10. kernels     -- one JSON line per the kernel table (K4 with one decode
                   step's and one prefill forward's launches; K1 with its
                   training launches by path and its backward's numbers),
                   then the card's name
                   and power limit, then the result line.

Any failure raises and exits non-zero. Without a CUDA card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import hashlib
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
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores, H100 SXM
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
# K4 vs its plain version: the same exact products (bf16 x times a small
# integer, times the f32 group scale) summed in f32 in another order, on
# outputs of O(1).
INT4_KERNEL_ATOL, INT4_KERNEL_RTOL = 1e-3, 1e-4
# int4 prefill vs the bf16 prefill of the dequantized weights: the only
# difference is the bf16 rounding of each weight q*s (2^-9 relative), in
# all 7 matmuls of each of 32 layers and in lm_head. One bf16 rounding per
# layer (flash vs dense, the prefill_flash_vs_dense line) gave 0.079 at
# |logits| 4.3 on an H100; seven in quadrature is ~0.21, so 0.5 leaves room
# for the lm_head and the tails.
INT4_DEQUANT_LOGIT_ATOL = 0.5
# K2 vs its plain version: the same arithmetic summed in another order and
# expf vs torch.exp, which can flip the bf16 rounding of one slot's
# p * v_s (2^-8 of that slot's share), plus the bf16 output rounding.
DECODE_KERNEL_ATOL = 2e-2
# The tiny f32 int4 model on the card vs the CPU: the same arithmetic in f32
# summed in another order, but K4 rounds its input to bf16. Where an f32
# activation differs in its last bit between the two, that rounding can
# land one bf16 step (2^-8) apart, which moves a logit by ~1e-2 through two
# layers: the bar of tests/test_torch_quant.py for the same effect between
# the port and the JAX package (1.1e-2 measured there).
TINY_LOGIT_ATOL = 3e-2
# 7B shapes of K4: (M, K, N) at decode (M = B = 4) and prefill (M = B*T).
INT4_DECODE_SHAPES = [(4, 4096, 4096), (4, 4096, 11008), (4, 11008, 4096), (4, 4096, 32000)]
# K3 vs its plain version and vs K2 on the gathered view, with f32 q and
# output: the same arithmetic summed in another order (K3 rescales by the
# running max after each 64-slot block, K2 takes one max); the JAX
# package's bar for the paged kernel against the dense one
# (tests/test_decode_attention.py::test_paged_kernel_matches_dense_kernel_on_gathered_view).
PAGED_KERNEL_ATOL = 2e-3
# One more batch of rows for K2 and K3 at the 7B shapes, at the split
# kernels' edges: none visible (every split reads every slot, each with
# weight 1), one, one whole 64-slot table entry and one past it; all but
# the first leave trailing splits wholly past n_valid.
SPLIT_EDGE_N_VALID = (0, 1, 64, 65)
# The serving phases: the four requests of the slice, then two more over
# streams 100 and 101 with queries 3 and 2, which wait for rows to free.
SERVE_EXTRA = [(0, 3, 16), (1, 2, 16)]  # (stream, query, new tokens)
# K4 launches per 7B decode step at each decode shape: q, k, v, o; gate,
# up; down; lm_head, in each of 32 layers but the last.
INT4_LAUNCHES_PER_STEP = {(4, 4096, 4096): 128, (4, 4096, 11008): 64,
                          (4, 11008, 4096): 32, (4, 4096, 32000): 1}
# The speculative phases' verify window (4 requests x 4 = M 16, K4's decode
# path under int4), the Medusa phase's head count and the beam width.
SPEC_WINDOW, MEDUSA_HEADS, BEAMS = 4, 3, 4
# decode_kstep vs sequential decode_step logits after 32 bf16 layers: the
# same arithmetic, but each weight product runs at M = B * window instead of
# M = B (another GEMM tiling, so another f32 summation order before the bf16
# rounding of its output) and attention multiplies W query rows at once.
# One bf16 rounding flip per layer (flash vs dense) gave 0.079 at |logits|
# 4.3 on an H100; seven products per layer are the int4-vs-dequantized
# case's seven roundings, hence its bar.
KSTEP_LOGIT_ATOL = 0.5
# Toy QA set of the training phases: 8 entries over streams of seeds
# 100-107, byte-tokenizer v1 dialogs; the 7B phases take 4 optimizer steps
# of 2 entries, then evaluate on 2.
TRAIN_QA = [
    ("What is happening in this scene?", "Cars move from left to right."),
    ("Describe the motion you can see.", "A person walks toward the camera."),
    ("Is the camera moving?", "Yes, it pans slowly to the left."),
    ("How many objects move?", "Two objects move."),
    ("What is in the foreground?", "A cyclist crosses the street."),
    ("Which way does the scene move?", "Everything drifts upward."),
    ("Is anything fast?", "A ball flies across the view."),
    ("Describe the edges.", "Strong vertical edges from buildings."),
]
TRAIN_STEPS, TRAIN_BATCH = 4, 2
# K1 launches per training micro-step under full remat: the forward and the
# recompute of each of 32 layers; the backward runs once per layer.
K1_PER_MICRO, K1_BACKWARD_PER_MICRO = 64, 32
# K1's gradient on the card (the Function: kernel forward, plain f32
# backward rounded to bf16) vs autograd through the plain version on the
# same bf16 inputs: the same f32 products summed in another order and
# rounded once to bf16, so at most about one bf16 step (2^-8) of the
# largest gradient apart; the bar is twice that.
FLASH_GRAD_RTOL = 2 ** -7
# The resumed step's loss vs the same step taken by the trainer that wrote
# the checkpoint, continued in memory, from the same state and batch: the
# forward is the same bf16 arithmetic (the loss is taken before the
# step's nondeterministic gather/embedding backward), so equal up to the
# f32 loss of O(10) read back; 1e-3 bounds a GEMM choosing another split.
RESUME_LOSS_ATOL = 1e-3
# The tiny f32 train steps on the card vs the CPU (TF32 off): the same f32
# arithmetic summed in another order; one Adam step moves each trainable by
# ~lr, and a gradient's last-bit difference moves its update by ~1e-7.
TINY_TRAIN_ATOL = 1e-4


# Shards of the 7B checkpoint that checkpoint_7b writes (~3.5 GB each).
CKPT_SHARDS = 4
# K4 launches per 7B prefill forward at M = B*T, by (K, N): gate, up;
# down; q, k, v, o, in each of 32 layers (lm_head runs on the last
# position only, at M = B).
INT4_PREFILL_LAUNCHES = {(4096, 11008): 64, (11008, 4096): 32, (4096, 4096): 128}


def emit(phase: str, payload: dict) -> None:
    print(f"{phase}: {json.dumps(payload)}", flush=True)


def digest(chains) -> str:
    """sha256 of greedy token chains: runs of two trees compare by it."""
    return hashlib.sha256(json.dumps(chains).encode()).hexdigest()


@contextlib.contextmanager
def routed_through(kernel, other):
    """Launch ``kernel``'s wrapper through ``other``'s library, which has the
    same C entry points, inside the block: another version of a kernel on
    the path that calls it."""
    saved = kernel._lib
    kernel._lib = other.lib()
    try:
        yield
    finally:
        kernel._lib = saved


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20, cold_l2: bool = False) -> float:
    """Mean device ms per call: CUDA events around ``iters`` calls after
    ``warmup`` calls, queued while the device sleeps ~2 ms, so that a call
    shorter than its host-side launch is timed back to back on the device,
    not at the host's pace. ``cold_l2`` writes 128 MB between calls, more
    than the 50 MB L2, and times each call alone: for a caller that finds its
    operands in device memory, as a decode step finds each layer's weights
    and cache. The device then sleeps ~0.5 ms, so that the host has queued
    the call before the start event runs and no host time is counted."""
    import torch

    for _ in range(warmup):
        fn()
    if cold_l2:
        scratch = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        torch.cuda.synchronize()
        for start, end in events:
            scratch.zero_()
            torch.cuda._sleep(1_000_000)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in events) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(event) -> float:
    """An operator's own device time in a torch.profiler table."""
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


def device_ms_by_kernel(fn, match: str, iters: int = 10) -> dict:
    """Device ms per call of each kernel whose name holds ``match``, from
    torch.profiler over ``iters`` calls of ``fn``, each after the L2 flush
    and the sleep of ``cuda_time_ms(cold_l2=True)``: how a kernel's time
    splits over its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            scratch.zero_()
            torch.cuda._sleep(1_000_000)
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if match in e.key:
            name = e.key.split("<")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + _device_us(e) / iters / 1e3
    return out


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


def flash_occupancy() -> dict:
    """K1's registers per thread, shared memory per block and resident
    blocks per SM, from the kernel library's own CUDA query."""
    import ctypes

    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    fn = FLASH_KERNEL.lib().egpt_flash_attention_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    regs, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    FLASH_KERNEL.check(fn(ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(blocks)))
    return {"registers_per_thread": regs.value, "smem_bytes_per_block": smem.value,
            "blocks_per_sm": blocks.value}


def check_flash_kernel(lengths, seed: int, baseline=None) -> dict:
    """K1 against its plain version at (B, S) = (len(lengths), max(lengths)),
    32 heads of 128, bf16, right padding; returns error and times. A
    ``baseline`` kernel (``baseline_kernel``) runs through the same wrapper
    on the same inputs: its difference from K1 and its time, timed in turns
    with K1."""
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
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"flash kernel at B={b} S={s}: non-finite output")
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

    def run():
        fa.flash_attention(q, k, v, valid=valid, causal=True)

    versus = {}
    if baseline is None:
        ms = cuda_time_ms(run)
    else:
        def run_baseline():
            with routed_through(fa.FLASH_KERNEL, baseline):
                return fa.flash_attention(q, k, v, valid=valid, causal=True)

        base_out = run_baseline()
        torch.cuda.synchronize()
        turns = [cuda_time_ms(f) for f in (run_baseline, run, run, run_baseline)]
        ms = (turns[1] + turns[2]) / 2
        versus = {"baseline_ms": (turns[0] + turns[3]) / 2, "baseline_turns_ms": turns,
                  "baseline_max_abs_diff": (base_out.float() - out.float()).abs().max().item(),
                  "baseline_bit_identical": bool(torch.equal(base_out, out))}
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v, valid, causal=True),
                            warmup=1, iters=5)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    bound_ms, bound_by, nbytes, flops = flash_bound_ms(b, s, h, hd)
    return {"B": b, "S": s, "H": h, "hd": hd, "lengths": list(lengths), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "tflop_s": flops / ms / 1e9, "bf16_peak_share": flops / (ms * 1e-3) / H100_BF16_FLOPS,
            **versus, **flash_occupancy()}


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


def _bound(nbytes: float, flops: float, peak_flops: float = H100_BF16_FLOPS):
    """Least time on an H100 SXM: the larger of bytes over 3.35 TB/s and
    operations over ``peak_flops``."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def baseline_kernel(kernel, path: str):
    """Another version of ``kernel``'s source with the same C entry points,
    built from ``path`` beside the port's kernels."""
    from eventgpt_tpu_torch.ops._build import CudaKernel

    class Baseline(CudaKernel):
        @property
        def path(self) -> str:
            return os.path.abspath(path)

    return Baseline("baseline_" + kernel.source, kernel.signatures)


def check_int4_kernel(m: int, k: int, n: int, seed: int, group: int = 128,
                      baseline=None) -> dict:
    """K4 against its plain version at (M, K, N): bf16 x, a seeded weight
    of the init's scale quantized on the card; returns error and times.
    The library call is one bf16 ``F.linear`` on the dequantized weight.
    A ``baseline`` kernel (``baseline_kernel``) runs on the same
    inputs: its difference from K4 and its time, timed in turns with K4."""
    import torch
    import torch.nn.functional as F

    from eventgpt_tpu_torch.ops import int4_matmul as i4
    from eventgpt_tpu_torch.ops.quant import dequantize_tensor4, quantize_tensor4

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda", dtype=torch.bfloat16)
    w = torch.randn((k, n), generator=g, device="cuda") / math.sqrt(k)
    leaf = quantize_tensor4(w, group)
    del w
    q4, s = leaf["q4"], leaf["s"]
    out = i4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    ref = i4.int4_matmul_reference(x, q4, s)
    err = (out - ref).abs().max().item()
    bad = (out - ref).abs() > INT4_KERNEL_ATOL + INT4_KERNEL_RTOL * ref.abs()
    if not math.isfinite(err) or bool(bad.any()):
        raise AssertionError(f"int4 kernel at M={m} K={k} N={n}: max abs err {err} over "
                             f"atol {INT4_KERNEL_ATOL} + rtol {INT4_KERNEL_RTOL}")
    w_lin = dequantize_tensor4(leaf, torch.bfloat16).T.contiguous()  # (N, K), not timed

    def run():
        i4.int4_matmul(x, q4, s)

    versus = {}
    if baseline is None:
        ms = cuda_time_ms(run, cold_l2=True)
    else:
        lib = baseline.lib()
        base_out = torch.empty_like(out)

        def run_baseline():
            baseline.check(lib.egpt_int4_matmul(
                x.data_ptr(), q4.data_ptr(), s.data_ptr(), base_out.data_ptr(), m, k, n,
                k // s.shape[0], torch.cuda.current_stream().cuda_stream))

        run_baseline()
        torch.cuda.synchronize()
        turns = [cuda_time_ms(f, cold_l2=True) for f in (run_baseline, run, run, run_baseline)]
        ms = (turns[1] + turns[2]) / 2
        versus = {"baseline_ms": (turns[0] + turns[3]) / 2, "baseline_turns_ms": turns,
                  "baseline_max_abs_diff": (base_out - out).abs().max().item(),
                  "baseline_bit_identical": bool(torch.equal(base_out, out))}
    plain_ms = cuda_time_ms(lambda: i4.int4_matmul_reference(x, q4, s), warmup=1, iters=3,
                            cold_l2=True)
    library_ms = cuda_time_ms(lambda: F.linear(x, w_lin), cold_l2=True)
    nbytes = m * k * 2 + q4.numel() + s.numel() * 4 + m * n * 4
    flops = 2 * m * k * n
    bound_ms, bound_by = _bound(nbytes, flops)
    plan = i4.decode_plan(m, k, n, group)
    decode = {} if plan is None else {"plan": plan, "gb_per_s": nbytes / ms / 1e6}
    return {"M": m, "K": k, "N": n, "group": group, "max_abs_err": err,
            "atol": INT4_KERNEL_ATOL, "rtol": INT4_KERNEL_RTOL, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "F.linear bf16 on the dequantized (N, K) weight",
            "bytes": nbytes, "flops": flops, **versus, **decode}


def check_decode_kernel(cache, li: int, n_valid, seed: int) -> dict:
    """K2 against its plain version on layer ``li`` of an int8 cache, with
    a seeded bf16 q (B, KV, 1, hd). The library call is SDPA on that
    layer's K/V dequantized to bf16 (the dequantize is not timed)."""
    import torch
    import torch.nn.functional as F

    from eventgpt_tpu_torch.ops import decode_attention as da

    kq, ks, vq, vs = cache["k"]["q"], cache["k"]["s"], cache["v"]["q"], cache["v"]["s"]
    _, b, s_len, kv, hd = kq.shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, kv, 1, hd), generator=g, device="cuda", dtype=torch.bfloat16)
    nv = torch.tensor(n_valid, device="cuda", dtype=torch.int32)
    errs = {}
    for rows in (n_valid, SPLIT_EDGE_N_VALID):
        nv_rows = torch.tensor(rows, device="cuda", dtype=torch.int32)
        out = da.decode_attention_int8(q, kq, ks, vq, vs, li, nv_rows)
        torch.cuda.synchronize()
        ref = da.decode_attention_int8_plain(q, kq, ks, vq, vs, li, nv_rows)
        err = (out.float() - ref.float()).abs().max().item()
        if not math.isfinite(err) or err > DECODE_KERNEL_ATOL:
            raise AssertionError(f"decode kernel at li={li}, n_valid {rows}: max abs err {err} > "
                                 f"{DECODE_KERNEL_ATOL}")
        errs[str(list(rows))] = err
    split, n_split = da.decode_split(s_len, b * kv, da.sm_count(q.device))
    k_l = (kq[li].float() * ks[li]).to(torch.bfloat16).transpose(1, 2)  # (B, KV, S, hd)
    v_l = (vq[li].float() * vs[li]).to(torch.bfloat16).transpose(1, 2)
    mask = (torch.arange(s_len, device="cuda")[None, :] < nv[:, None])[:, None, None, :]
    ms = cuda_time_ms(lambda: da.decode_attention_int8(q, kq, ks, vq, vs, li, nv), cold_l2=True)
    plain_ms = cuda_time_ms(lambda: da.decode_attention_int8_plain(q, kq, ks, vq, vs, li, nv),
                            warmup=1, iters=5, cold_l2=True)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k_l, v_l, attn_mask=mask),
                              cold_l2=True)
    passes_ms = device_ms_by_kernel(lambda: da.decode_attention_int8(q, kq, ks, vq, vs, li, nv),
                                    "egpt_split")
    visible = sum(min(int(x), s_len) for x in n_valid)
    nbytes = 2 * visible * kv * (hd + 4) + q.numel() * 2 + out.numel() * 2 + b * 4
    flops = 2 * 2 * visible * kv * hd
    bound_ms, bound_by = _bound(nbytes, flops, H100_F32_FLOPS)
    return {"li": li, "B": b, "S": s_len, "KV": kv, "G": 1, "hd": hd, "n_valid": list(n_valid),
            "split_slots": split, "n_split": n_split, "blocks": b * kv * n_split,
            "max_abs_err_by_n_valid": errs, "max_abs_err": max(errs.values()),
            "atol": DECODE_KERNEL_ATOL, "ms": ms, "passes_ms": passes_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "library": "SDPA, bool mask, on the layer dequantized to bf16 (dequantize not timed)",
            "bytes": nbytes, "flops": flops}


def check_generations(name: str, out_ids, vocab: int) -> None:
    """One list of at most MAX_NEW_TOKENS in-vocabulary ids per request."""
    if len(out_ids) != len(QUERIES) or any(
            len(r) > MAX_NEW_TOKENS or any(not 0 <= t < vocab for t in r) for r in out_ids):
        raise AssertionError(f"malformed {name} generations: {out_ids}")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def tiny_quant_card_matches_cpu(event_path: str) -> dict:
    """A tiny f32 model whose LLaMA widths pass the K4 gate, run with
    ``--quant int4 --kv_cache int8 --fuse_params``, gives the same greedy
    chain and first-step logits on the card as on the CPU."""
    import dataclasses

    import torch

    from eventgpt_tpu_torch.config import EventChatConfig, LlamaConfig
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer, tokenize_with_event
    from eventgpt_tpu_torch.models import eventchat, llama
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops.image import process_event_file
    from eventgpt_tpu_torch.ops.int4_matmul import INT4_KERNEL
    from eventgpt_tpu_torch.ops.quant import quantize_llama_params

    lm = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                     num_heads=4, num_kv_heads=2, max_seq_len=256)
    base = EventChatConfig.tiny()
    cfg = dataclasses.replace(base, llama=lm,
                              projector=dataclasses.replace(base.projector, output_dim=256))
    trees = {}
    for dev in ("cpu", "cuda"):
        params = init_eventchat_params(cfg, torch.Generator().manual_seed(2), torch.float32, "cpu")
        params = _to(params, dev)
        llama.fuse_llama_params(params["llama"])
        quantize_llama_params(params["llama"], bits=4)
        trees[dev] = params
    for name in ("qkv_proj", "gate_up_proj", "down_proj"):
        q_cpu = trees["cpu"]["llama"]["layers"][0][name]
        q_card = trees["cuda"]["llama"]["layers"][0][name]
        n_bad = {k: int((q_card[k].cpu() != q_cpu[k]).sum()) for k in ("q4", "s")}
        if any(n_bad.values()):
            raise AssertionError(f"int4 quantization of {name} on the card differs from the "
                                 f"CPU's in {n_bad} elements")
    _, pixels = process_event_file(event_path, cfg.num_event_frames, cfg.vision.image_size)
    ids = tokenize_with_event(prepare_event_prompt(QUERIES[1]), ByteTokenizer())
    kwargs = dict(max_new_tokens=16, temperature=0.0, eos_token_id=None, kv_quant=True)
    first = {}
    for dev, params in trees.items():
        padded, mask, _ = eventchat.prepare_prefill(params, cfg, [ids], pixels[None])
        cache = llama.init_kv_cache(cfg.llama, 1, padded.shape[1], dtype=padded.dtype,
                                    device=padded.device, quant=True)
        with torch.inference_mode():
            first[dev], _ = llama.prefill(params["llama"], cfg.llama, padded, mask, cache,
                                          last_only=True)
    INT4_KERNEL.launches = 0
    on_card = eventchat.generate(trees["cuda"], cfg, [ids], pixels[None], device="cuda", **kwargs)
    launches = INT4_KERNEL.launches
    on_cpu = eventchat.generate(trees["cpu"], cfg, [ids], pixels[None], device="cpu", **kwargs)
    diff = (first["cuda"].cpu() - first["cpu"]).abs().max().item()
    if on_cpu != on_card:
        raise AssertionError(f"tiny int4 greedy chain differs: cpu {on_cpu} vs cuda {on_card}")
    if not diff <= TINY_LOGIT_ATOL:
        raise AssertionError(f"tiny int4 first-step logits differ by {diff} > {TINY_LOGIT_ATOL}")
    if launches == 0:
        raise AssertionError("the tiny int4 model on the card did not launch K4")
    return {"config": "LLaMA d=256 ffn=512 vocab=512 2 layers 4 heads 2 KV heads, f32, "
                      "--quant int4 --kv_cache int8 --fuse_params",
            "tokens": len(on_card[0]), "identical": True, "first_logit_max_abs_diff": diff,
            "tolerance": TINY_LOGIT_ATOL, "int4_launches_on_card": launches,
            "greedy_sha256": digest(on_card)}


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


def timed_generate(eventchat, params, cfg, ids, pixels, tokenizer, kv_quant=False,
                   max_new_tokens=MAX_NEW_TOKENS, temperature=0.0, **variant):
    """One batch through ``generate`` with phase timings; returns (numbers, ids).
    ``variant`` passes beam, speculative or Medusa arguments on; a
    ``spec_stats`` dict among them gets the speculative loop's counts."""
    import torch

    timings = {}
    t0 = time.perf_counter()
    out_ids = eventchat.generate(
        params, cfg, ids, pixels, max_new_tokens=max_new_tokens, temperature=temperature,
        eos_token_id=tokenizer.eos_token_id, seed=0, timings=timings, kv_quant=kv_quant,
        **variant)
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


def profile_call(fn, out_dir: str, name: str, match: str = "") -> dict:
    """torch.profiler over one call of ``fn`` (one more batch, or one more
    server run): device time by operator, and the device's busy share of
    the wall time (kernels on one stream); with ``match``, the device ms
    and launches of the kernels whose names hold it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    busy_ms = sum(_device_us(e) for e in avgs) / 1e3
    top = sorted(avgs, key=_device_us, reverse=True)[:15]
    table = os.path.join(out_dir, f"profile_{name}.txt")
    with open(table, "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
    matched = [e for e in avgs if match and match in e.key]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top_device_ms": [[e.key, _device_us(e) / 1e3, e.count] for e in top],
            "table": table,
            **({"match": match, "matched_device_ms": sum(_device_us(e) for e in matched) / 1e3,
                "matched_launches": sum(e.count for e in matched)} if match else {})}


def serve_requests(ids, pixels, budget: int = MAX_NEW_TOKENS):
    """The serving phases' six requests: (prompt ids, pixels, new tokens)."""
    reqs = [(ids[i], pixels[i], budget) for i in range(len(QUERIES))]
    return reqs + [(ids[q], pixels[st], n) for st, q, n in SERVE_EXTRA]


def run_server(params, cfg, tokenizer, requests, kv_layout: str) -> tuple:
    """The requests through a ContinuousBatcher under a ServingEngine, as
    ``cli/serve`` builds them (int8 KV cache, 4 rows, max_len 1024, chunk
    32, greedy). All are queued before the scheduler thread starts, so the
    first four admit as one wave. Returns (numbers, chains)."""
    import torch

    from eventgpt_tpu_torch.cli.serve import ServingEngine
    from eventgpt_tpu_torch.models.eventchat import _vocab_size
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(params, cfg, max_batch=4, max_len=1024, chunk=32,
                                eos_token_id=tokenizer.eos_token_id, kv_quant=True,
                                kv_layout=kv_layout)
    engine = ServingEngine(batcher, tokenizer, start=False)
    try:
        rids = [engine.submit_ids(i, px, n) for i, px, n in requests]
        t0 = time.perf_counter()
        engine.start()
        chains = [engine.result(r, timeout=600) for r in rids]
        wall = time.perf_counter() - t0
        statuses = [engine.status(r) for r in rids]
    finally:
        engine.shutdown()
    if statuses != ["ok"] * len(rids):
        raise AssertionError(f"serve {kv_layout}: statuses {statuses}")
    vocab = _vocab_size(params)
    if any(len(c) > n or any(not 0 <= t < vocab for t in c)
           for c, (_, _, n) in zip(chains, requests)):
        raise AssertionError(f"serve {kv_layout}: malformed chains {chains}")
    stats = [batcher.request_stats[r] for r in rids]
    out = {
        "kv_layout": kv_layout, "kv_cache": "int8", "max_batch": 4, "max_len": batcher.max_len,
        "chunk": 32, "requests": len(rids), "new_tokens": [n for _, _, n in requests],
        "wall_s": wall, "generated_tokens": [len(c) for c in chains],
        "batch_tok_s": sum(len(c) for c in chains) / wall,
        "ttft_s": [st["ttft_s"] for st in stats], "latency_s": [st["latency_s"] for st in stats],
        "prefill_dispatches": batcher.prefill_dispatches, "segments": batcher.segments,
        "admission_s": batcher.admission_s, "decode_s": batcher.decode_s,
        "decode_steps": batcher.decode_steps,
        "decode_ms_per_step": batcher.decode_s * 1e3 / max(batcher.decode_steps, 1),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "kv_bytes": batcher.kv_bytes,
    }
    pool = batcher.pool_stats()
    if pool is not None:
        out["pool_after_drain"] = pool
        if pool["free_blocks"] != pool["usable_blocks"] or int(batcher.cache["bt"].abs().sum()):
            raise AssertionError(f"serve paged: blocks held after the drain: {pool}")
    del batcher, engine
    torch.cuda.empty_cache()
    return out, chains


def check_paged_kernel(params, cfg, tokenizer, requests, seed: int) -> tuple:
    """K3 on the arena a paged int8 server holds after its first step:
    the first four requests with a 64-token budget are admitted as one
    wave and decode one 32-step segment, so each row's table holds its
    reservation and ~860 visible slots. K3 is held against its plain
    version at layers 0 and 31 and against K2 on the gathered view, and
    timed with the plain version and SDPA on the gathered, dequantized
    bf16 view (the gather and dequantize not timed). The server then
    drains; returns (numbers, chains of 64 tokens)."""
    import torch
    import torch.nn.functional as F

    from eventgpt_tpu_torch.ops import decode_attention as da
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    srv = ContinuousBatcher(params, cfg, max_batch=4, max_len=1024, chunk=32,
                            eos_token_id=tokenizer.eos_token_id, kv_quant=True,
                            kv_layout="paged")
    rids = [srv.submit(i, px, 2 * MAX_NEW_TOKENS) for i, px, _ in requests[:len(QUERIES)]]
    srv.step()
    if srv.prefill_dispatches != 1 or any(r is None for r in srv.rows):
        raise AssertionError("the first step did not admit the four requests as one wave")
    cache = srv.cache
    kq, ks, vq, vs = cache["k"]["q"], cache["k"]["s"], cache["v"]["q"], cache["v"]["s"]
    bt, nv = cache["bt"].clone(), cache["length"].clone()
    n_layers, n_blocks, bs, kv, hd = kq.shape
    b, nbpr = bt.shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, kv, 1, hd), generator=g, device="cuda", dtype=torch.bfloat16)
    q32 = q.float()
    checks = []
    edges = torch.tensor(SPLIT_EDGE_N_VALID, device="cuda", dtype=torch.int32)
    for li, nv_rows in ((0, nv), (n_layers - 1, nv), (0, edges)):
        out = da.decode_attention_int8_paged(q32, kq, ks, vq, vs, li, bt, nv_rows)
        torch.cuda.synchronize()
        plain = da.decode_attention_int8_paged_plain(q32, kq, ks, vq, vs, li, bt, nv_rows)
        gathered = [x[li][bt.long()].reshape((1, b, nbpr * bs) + tuple(x.shape[3:])).contiguous()
                    for x in (kq, ks, vq, vs)]
        dense = da.decode_attention_int8(q32, *gathered, 0, nv_rows)
        err = (out - plain).abs().max().item()
        err_k2 = (out - dense).abs().max().item()
        if not (err <= PAGED_KERNEL_ATOL and err_k2 <= PAGED_KERNEL_ATOL):
            raise AssertionError(f"paged kernel at li={li}, n_valid {nv_rows.tolist()}: max abs "
                                 f"err {err} vs plain, {err_k2} vs K2 on the gathered view > "
                                 f"{PAGED_KERNEL_ATOL}")
        checks.append({"li": li, "n_valid": nv_rows.tolist(), "max_abs_err": err,
                       "max_abs_err_vs_k2_gathered": err_k2})
    split, n_split = da.paged_split(bs, nbpr, b * kv, da.sm_count(q.device))
    li = 0
    k_l = (kq[li][bt.long()].float() * ks[li][bt.long()]).to(torch.bfloat16)
    v_l = (vq[li][bt.long()].float() * vs[li][bt.long()]).to(torch.bfloat16)
    k_l = k_l.reshape(b, nbpr * bs, kv, hd).transpose(1, 2)
    v_l = v_l.reshape(b, nbpr * bs, kv, hd).transpose(1, 2)
    mask = (torch.arange(nbpr * bs, device="cuda")[None, :] < nv[:, None])[:, None, None, :]
    ms = cuda_time_ms(lambda: da.decode_attention_int8_paged(q, kq, ks, vq, vs, li, bt, nv),
                      cold_l2=True)
    plain_ms = cuda_time_ms(
        lambda: da.decode_attention_int8_paged_plain(q, kq, ks, vq, vs, li, bt, nv),
        warmup=1, iters=5, cold_l2=True)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k_l, v_l, attn_mask=mask),
                              cold_l2=True)
    passes_ms = device_ms_by_kernel(
        lambda: da.decode_attention_int8_paged(q, kq, ks, vq, vs, li, bt, nv), "egpt_split")
    # The kernel reads what this data needs: the visible slots' int8 K and
    # V and their scales (all table entries for a row with none visible),
    # q, out, the tables and n_valid once.
    lengths = [int(x) for x in nv.tolist()]
    slots = sum(min(n, nbpr * bs) if n > 0 else nbpr * bs for n in lengths)
    nbytes = 2 * slots * kv * (hd + 4) + q.numel() * 2 + q.numel() * 2 + bt.numel() * 4 + b * 4
    flops = 2 * 2 * slots * kv * hd
    bound_ms, bound_by = _bound(nbytes, flops, H100_F32_FLOPS)
    table_bytes = 2 * b * nbpr * bs * kv * (hd + 4)
    del k_l, v_l
    out = srv.run_until_drained()
    chains = [out[r] for r in rids]
    pool = srv.pool_stats()
    if pool["free_blocks"] != pool["usable_blocks"]:
        raise AssertionError(f"kernel_paged_int8: blocks held after the drain: {pool}")
    del srv, cache, kq, ks, vq, vs
    torch.cuda.empty_cache()
    return {"B": b, "KV": kv, "G": 1, "hd": hd, "block_size": bs, "table_entries": nbpr,
            "pool_blocks": n_blocks, "n_valid": lengths, "tables": bt.tolist(),
            "split_slots": split, "n_split": n_split, "blocks": b * kv * n_split,
            "checks": checks, "atol": PAGED_KERNEL_ATOL,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": ms, "passes_ms": passes_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "SDPA, bool mask, on the gathered layer dequantized to bf16 "
                       "(gather and dequantize not timed)",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "whole_table_bytes": table_bytes,
            "whole_table_bound_ms": table_bytes / H100_BYTES_PER_S * 1e3}, chains


def tiny_serve_card_matches_cpu(work: str) -> dict:
    """A tiny f32 model served paged with the int8 cache gives the same
    greedy chains on the card as on the CPU."""
    import numpy as np
    import torch

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer, tokenize_with_event
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops.image import process_event_file
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    cfg = EventChatConfig.tiny(vocab_size=260)
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(3), torch.float32, "cpu")
    trees = {"cpu": cpu, "cuda": _to(cpu, "cuda")}
    reqs = []
    for i in range(3):
        _, px = process_event_file(os.path.join(work, f"events_{i}.npy"), cfg.num_event_frames,
                                   cfg.vision.image_size)
        reqs.append((tokenize_with_event(prepare_event_prompt(QUERIES[i]), ByteTokenizer()),
                     np.asarray(px), 12 + 2 * i))
    chains = {}
    for dev, params in trees.items():
        srv = ContinuousBatcher(params, cfg, max_batch=2, max_len=512, chunk=8, eos_token_id=None,
                                kv_quant=True, kv_layout="paged", device=dev)
        rids = [srv.submit(*r) for r in reqs]
        out = srv.run_until_drained()
        chains[dev] = [out[r] for r in rids]
    if chains["cpu"] != chains["cuda"]:
        raise AssertionError(f"tiny served chains differ: cpu {chains['cpu']} vs "
                             f"cuda {chains['cuda']}")
    return {"config": "tiny f32, paged, int8 KV, 2 rows, chunk 8", "requests": len(reqs),
            "tokens": [len(c) for c in chains["cuda"]], "identical": True}


def serve_http_tiny(work: str) -> dict:
    """``cli/serve.build_server`` on the default device (the card) over a
    tiny bf16 checkpoint the port wrote, loaded through ``--model_path``
    (head_dim 128, so that prefill takes K1, the default on the card),
    paged with the int8 cache: two POST /v1/generate answer 200."""
    import base64
    import dataclasses
    import http.client
    import threading

    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.config import EventChatConfig, LlamaConfig
    from eventgpt_tpu_torch.models.convert import init_eventchat_params, write_hf_checkpoint
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    base = EventChatConfig.tiny()
    cfg = dataclasses.replace(
        base, llama=LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                                num_layers=2, num_heads=2, num_kv_heads=2, max_seq_len=2048),
        projector=dataclasses.replace(base.projector, output_dim=256))
    ckpt = os.path.join(work, "tiny_serve_checkpoint")
    write_hf_checkpoint(init_eventchat_params(cfg, torch.Generator().manual_seed(6),
                                              torch.bfloat16, "cpu"), cfg, ckpt)
    args = cli_serve.build_parser().parse_args(
        ["--model_path", ckpt, "--tokenizer_path", "byte", "--port", "0", "--kv_layout",
         "paged", "--kv_cache", "int8", "--max_new_tokens", "8"])
    httpd, engine = cli_serve.build_server(args)
    if engine.batcher.cfg.llama.attn_impl != "flash":
        raise AssertionError("a checkpoint served on the card must prefill through K1")
    FLASH_KERNEL.launches = 0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    answers = []
    try:
        for i in range(2):
            with open(os.path.join(work, f"events_{i}.npy"), "rb") as f:
                body = json.dumps({"query": QUERIES[i],
                                   "event_b64": base64.b64encode(f.read()).decode()})
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
            conn.request("POST", "/v1/generate", body=body)
            res = conn.getresponse()
            obj = json.loads(res.read())
            if res.status != 200 or obj.get("status") != "ok":
                raise AssertionError(f"POST /v1/generate answered {res.status}: {obj}")
            answers.append({"code": res.status, "tokens": obj["tokens"],
                            "latency_s": obj["latency_s"], "answer": obj["answer"]})
        device = str(engine.batcher.device)
        k1 = FLASH_KERNEL.launches
    finally:
        httpd.shutdown()
        engine.shutdown()
        httpd.server_close()
    if not device.startswith("cuda"):
        raise AssertionError(f"the server ran on {device}, not the card")
    if k1 == 0:
        raise AssertionError("the served checkpoint did not launch K1")
    return {"device": device, "model_path": "tiny bf16 checkpoint (LLaMA d=256, 2 heads of 128)",
            "k1_launches": k1, "answers": answers}


def tree_mismatches(a, b, path: str = "params") -> list:
    """Paths where two parameter trees differ: structure, dtype, shape or
    any value (``torch.equal``)."""
    import torch

    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or set(a) != set(b):
            return [path]
        return [m for k in a for m in tree_mismatches(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list) or isinstance(b, list):
        if not (isinstance(a, list) and isinstance(b, list)) or len(a) != len(b):
            return [path]
        return [m for i, (x, y) in enumerate(zip(a, b))
                for m in tree_mismatches(x, y, f"{path}[{i}]")]
    same = a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))
    return [] if same else [path]


def load_checkpoint_on_card(path: str, **flags) -> tuple:
    """``cli.infer.load_model`` and ``prepare_model`` on the card as the CLI
    runs them for ``--model_path path --tokenizer_path byte`` and ``flags``;
    returns (cfg, params, tokenizer, numbers): seconds of the read and of
    the whole load, and the peak device memory over what was held before."""
    import argparse

    import torch

    from eventgpt_tpu_torch.cli.infer import load_model, prepare_model

    args = argparse.Namespace(model_path=path, use_event_qformer=False,
                              pretrain_query_embedder=None, pretrain_attention_layers=None,
                              quant="none", fuse_params=False, seed=0,
                              spatial_temporal_encoder=True)
    for k, v in flags.items():
        setattr(args, k, v)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, tokenizer = load_model(path, "bfloat16", None, "byte", "cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    cfg, params = prepare_model(cfg, params, tokenizer, args)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if params["llama"]["embed_tokens"].device.type != "cuda":
        raise AssertionError("the checkpoint did not load onto the card")
    return cfg, params, tokenizer, {
        "read_s": read_s, "load_s": load_s,
        "peak_bytes_over_before": torch.cuda.max_memory_allocated() - before,
        "held_before_bytes": before}


def run_infer_cli(ckpt: str, event_path: str, query: str, answer: str, tokens: int) -> dict:
    """``python -m eventgpt_tpu_torch.cli.infer`` over ``ckpt`` with the
    byte tokenizer, greedy, on the default device (the card), as a user
    starts it; raises unless it prints ``answer`` after ``tokens`` generated
    tokens (the numbers of an in-process batch-1 ``generate``)."""
    cmd = [sys.executable, "-m", "eventgpt_tpu_torch.cli.infer", "--model_path", ckpt,
           "--tokenizer_path", "byte", "--temperature", "0", "--max_new_tokens",
           str(MAX_NEW_TOKENS), "--event_frame", event_path, "--query", query, "--timing"]
    env = dict(os.environ, PYTHONIOENCODING="utf-8",
               PYTHONPATH=os.pathsep.join([ROOT] + [x for x in [os.environ.get("PYTHONPATH")]
                                                    if x]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, timeout=600, cwd=ROOT, env=env)
    cli_s = time.perf_counter() - t0
    err = res.stderr.decode(errors="replace")
    if res.returncode != 0:
        raise AssertionError(f"the infer CLI exited {res.returncode}: {err[-2000:]}")
    timing = [ln for ln in err.splitlines() if ln.startswith("[timing]")]
    cli_tokens = int(timing[-1].split("(")[1].split()[0]) if timing else -1
    if res.stdout != (answer + "\n").encode() or cli_tokens != max(tokens, 1):
        raise AssertionError(f"the infer CLI printed {res.stdout[-300:]!r} of {cli_tokens} "
                             f"tokens; in-process generate gives {answer!r} of {tokens}")
    return {"argv": cmd[3:], "seconds": cli_s, "answer": answer, "tokens": tokens,
            "timing": timing[-1], "equals_in_process_batch_1": True}


def cli_subprocess_tiny(work: str, counted) -> dict:
    """The infer CLI in a subprocess over a tiny bf16 checkpoint (vocab 260:
    the byte tokenizer's 259 and ``<ev_patch>``; LLaMA heads of 128, so
    that prefill takes K1), against an in-process batch-1 ``generate`` on
    the card over the same directory loaded as the CLI loads it. The
    lm_head rows of every id but those of the printable ASCII bytes 33-126
    are zero, so greedy decoding picks one of those (their largest random
    logit lies above 0): each generated id is one character of the answer,
    and a wrong dtype, attention path or prefill in the CLI shows as
    another string."""
    import dataclasses

    import torch

    from eventgpt_tpu_torch.config import EventChatConfig, LlamaConfig
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
    from eventgpt_tpu_torch.models import eventchat
    from eventgpt_tpu_torch.models.convert import init_eventchat_params, write_hf_checkpoint
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.image import process_event_file

    base = EventChatConfig.tiny()
    cfg = dataclasses.replace(
        base, llama=LlamaConfig(vocab_size=260, hidden_size=256, intermediate_size=512,
                                num_layers=2, num_heads=2, num_kv_heads=2, max_seq_len=2048),
        projector=dataclasses.replace(base.projector, output_dim=256))
    ckpt = os.path.join(work, "tiny_cli_checkpoint")
    seeded = init_eventchat_params(cfg, torch.Generator().manual_seed(8), torch.bfloat16, "cpu")
    # The byte tokenizer's id of byte b is b + 3.
    seeded["llama"]["lm_head"][:33 + 3] = 0
    seeded["llama"]["lm_head"][126 + 3 + 1:] = 0
    write_hf_checkpoint(seeded, cfg, ckpt)
    lcfg, params, tok, _ = load_checkpoint_on_card(ckpt)
    if lcfg.llama.attn_impl != "flash" or lcfg.llama.vocab_size != 260:
        raise AssertionError(f"the tiny CLI checkpoint loaded as {lcfg.llama}")
    event_path = os.path.join(work, "events_2.npy")
    _, px = process_event_file(event_path, lcfg.num_event_frames, lcfg.vision.image_size)
    ids = tokenize_with_event(prepare_event_prompt(QUERIES[2]), tok)
    one, launches = counted(lambda: eventchat.generate(
        params, lcfg, [ids], px[None], max_new_tokens=MAX_NEW_TOKENS, temperature=0.0,
        top_p=1.0, eos_token_id=tok.eos_token_id, seed=0, max_context=2048)[0])
    answer = tok.batch_decode([one], skip_special_tokens=True)[0].strip()
    if (not len(answer) == len(one) == MAX_NEW_TOKENS
            or launches[FLASH_KERNEL.source] != lcfg.llama.num_layers):
        raise AssertionError(f"tiny in-process answer {answer!r} of {len(one)} tokens, "
                             f"launches {launches}")
    out = run_infer_cli(ckpt, event_path, QUERIES[2], answer, len(one))
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"model_path": "tiny bf16 checkpoint (vocab 260, LLaMA d=256, 2 heads of 128)",
            **out, "in_process_launches": launches}


def checkpoint_7b(params, cfg, ckpt: str, ids, pixels, event_paths, counted,
                  digests: dict) -> dict:
    """Phase 3's bf16 tree through a checkpoint on disk, as a user runs a
    real one: written by ``write_hf_checkpoint``, loaded by the CLI's
    functions (bf16, then ``--quant int4``), and by the CLI itself in a
    subprocess. Every check raises."""
    import torch

    from eventgpt_tpu_torch.models import eventchat
    from eventgpt_tpu_torch.models.convert import write_hf_checkpoint
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.int4_matmul import INT4_KERNEL

    n_layers = cfg.llama.num_layers
    tree = tree_bytes(params)
    work = os.path.dirname(ckpt)
    free = shutil.disk_usage(work).free
    if free < tree + 2**30:
        raise RuntimeError(f"checkpoint_7b: {free} bytes free under {work}, the bf16 7B "
                           f"checkpoint needs {tree + 2**30}")
    t0 = time.perf_counter()
    write_hf_checkpoint(params, cfg, ckpt, num_shards=CKPT_SHARDS)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.sync()
    sync_s = time.perf_counter() - t0
    files = sorted(os.listdir(ckpt))
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)

    lcfg, loaded, tokenizer, load_bf16 = load_checkpoint_on_card(ckpt)
    if lcfg != cfg:
        raise AssertionError(f"the loaded config differs from the 7B preset: {lcfg}")
    bad = tree_mismatches(loaded, params)
    if bad:
        raise AssertionError(f"the loaded 7B tree differs from phase 3's at {bad[:5]}")
    (run, out_ids), launches = counted(
        lambda: timed_generate(eventchat, loaded, lcfg, ids, pixels, tokenizer))
    if digest(out_ids) != digests["slice"] or launches[FLASH_KERNEL.source] != n_layers:
        raise AssertionError(f"checkpoint_7b bf16: digest {digest(out_ids)} (slice "
                             f"{digests['slice']}), launches {launches}")
    del loaded
    torch.cuda.empty_cache()

    _, loaded4, _, load_int4 = load_checkpoint_on_card(ckpt, quant="int4")
    (run4, ids4), launches4 = counted(
        lambda: timed_generate(eventchat, loaded4, lcfg, ids, pixels, tokenizer, kv_quant=True))
    want_k4 = (7 * n_layers + 1) * (1 + run4["decode_steps"])
    if (digest(ids4) != digests["slice_int4"] or launches4[INT4_KERNEL.source] != want_k4
            or launches4[FLASH_KERNEL.source] != n_layers):
        raise AssertionError(f"checkpoint_7b int4: digest {digest(ids4)} (slice_int4 "
                             f"{digests['slice_int4']}), launches {launches4}, want K4 {want_k4}")
    del loaded4
    torch.cuda.empty_cache()

    # The CLI as a user starts it, on one stream, against an in-process
    # batch-1 generate on the same tree with the CLI's defaults. The stream
    # is the first whose answer decodes to text: with random weights most
    # ids lie past the byte tokenizer's 259 and decode to nothing, so the
    # token counts are compared too, and ``cli_subprocess_tiny`` repeats the
    # check on a checkpoint whose every id decodes to text.
    for i in range(len(QUERIES)):
        one = eventchat.generate(params, cfg, [ids[i]], pixels[i:i + 1],
                                 max_new_tokens=MAX_NEW_TOKENS, temperature=0.0, top_p=1.0,
                                 eos_token_id=tokenizer.eos_token_id, seed=0,
                                 max_context=2048)[0]
        answer = tokenizer.batch_decode([one], skip_special_tokens=True)[0].strip()
        if answer:
            break
    cli = run_infer_cli(ckpt, event_paths[i], QUERIES[i], answer, len(one))
    return {
        "config": "EventGPT-7B, phase 3's random bf16 weights", "shards": CKPT_SHARDS,
        "files": files, "bytes": nbytes, "tree_bytes": tree, "free_bytes_before": free,
        "write_s": write_s, "sync_s": sync_s, "write_gb_s": nbytes / write_s / 1e9,
        "page_cache": "warm: the files were written in this phase, and the host holds "
                      "them in memory",
        "load_bf16": {**load_bf16, "gb_s": nbytes / load_bf16["load_s"] / 1e9,
                      "peak_over_tree": load_bf16["peak_bytes_over_before"] / tree},
        "leaves_equal_phase_3": True, "bf16_run": run, "bf16_launches": launches,
        "greedy_sha256": digest(out_ids), "same_digest_as_slice": True,
        "load_int4": {**load_int4, "flags": "--quant int4 (quantized on the card in place)",
                      "gb_s": nbytes / load_int4["load_s"] / 1e9},
        "int4_run": run4, "int4_launches": launches4, "k4_launches_want": want_k4,
        "int4_greedy_sha256": digest(ids4), "same_digest_as_slice_int4": True,
        "cli_subprocess": {**cli, "stream": i},
    }


def slice_qformer(cfg, ckpt: str, ids, pixels, counted) -> dict:
    """A seeded Q-Former at 7B width, saved as component files and loaded
    over the 7B checkpoint with ``--use_event_qformer
    --pretrain_query_embedder --pretrain_attention_layers``; the four
    requests run on its 32 event tokens each, twice (cold, then warm). At
    this width the card checks the Q-Former's shape, finiteness and the
    path's launches; its arithmetic is held against the JAX package's on
    the CPU at small widths (tests/test_torch_qformer.py)."""
    import torch

    from eventgpt_tpu_torch.config import QFormerConfig
    from eventgpt_tpu_torch.models import eventchat
    from eventgpt_tpu_torch.models.qformer import init_qformer_params, save_qformer_components
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    qcfg = QFormerConfig(hidden_size=cfg.llama.hidden_size)
    seeded = init_qformer_params(qcfg, torch.Generator(device="cuda").manual_seed(7),
                                 torch.bfloat16, "cuda")
    qe = os.path.join(os.path.dirname(ckpt), "qformer_7b", "query_embedder.npz")
    al = os.path.join(os.path.dirname(ckpt), "qformer_7b", "attention_layers.npz")
    t0 = time.perf_counter()
    save_qformer_components(seeded, qe, al, num_heads=qcfg.num_heads)
    save_s = time.perf_counter() - t0
    qcfg_loaded, params, tokenizer, load = load_checkpoint_on_card(
        ckpt, use_event_qformer=True, pretrain_query_embedder=qe, pretrain_attention_layers=al)
    if not qcfg_loaded.use_event_qformer or qcfg_loaded.qformer != qcfg:
        raise AssertionError(f"the Q-Former config read off the artifacts: {qcfg_loaded.qformer}")
    bad = tree_mismatches(params["qformer"], seeded, "qformer")
    if bad:
        raise AssertionError(f"the loaded Q-Former differs from the seeded one at {bad[:5]}")
    with torch.inference_mode():
        px = torch.as_tensor(pixels, device="cuda").to(torch.bfloat16)
        ev = eventchat.encode_events_batch(params, qcfg_loaded, px)
    if tuple(ev.shape) != (len(QUERIES), qcfg.num_queries, cfg.llama.hidden_size) \
            or not bool(torch.isfinite(ev.float()).all()):
        raise AssertionError(f"Q-Former event tokens {tuple(ev.shape)} or not finite")
    (run, out_ids), launches = counted(
        lambda: timed_generate(eventchat, params, qcfg_loaded, ids, pixels, tokenizer))
    if launches[FLASH_KERNEL.source] != cfg.llama.num_layers:
        raise AssertionError(f"slice_qformer: launches {launches}, want K1 = "
                             f"{cfg.llama.num_layers}")
    check_generations("qformer", out_ids, cfg.llama.vocab_size)
    # The first batch on a new tree is cold (the allocator grows, cuBLAS
    # picks its kernels for the new M); a second batch gives warm times.
    warm, warm_ids = timed_generate(eventchat, params, qcfg_loaded, ids, pixels, tokenizer)
    if warm_ids != out_ids:
        raise AssertionError("slice_qformer: the warm batch's ids differ from the first's")
    out = {
        "config": "EventGPT-7B from the checkpoint + Q-Former (32 queries, 2 layers, 8 "
                  "heads, d=4096, mlp 4x), seeded bf16, saved as f32 npz",
        "qformer_bytes": tree_bytes(seeded),
        "component_file_bytes": os.path.getsize(qe) + os.path.getsize(al),
        "save_s": save_s, "load": load,
        "event_tokens_per_request": [int(ev.shape[1])] * int(ev.shape[0]),
        "prefill_lengths": [len(x) - 1 + qcfg.num_queries for x in ids],
        "first_batch": "cold", **run, "warm": warm, "launches": launches,
        "greedy_sha256": digest(out_ids),
        "first_ids": [r[:8] for r in out_ids]}
    del params, seeded, ev
    torch.cuda.empty_cache()
    return out


def tiny_checkpoint_card_vs_cpu(work: str) -> dict:
    """A tiny f32 checkpoint written by the port, loaded by ``load_model``
    and ``prepare_model`` (``--attn_impl dense``: K1 takes bf16 and head_dim
    128 only), gives the same greedy chain on the card as on the CPU:
    plain, and with a gated Q-Former whose component files lie beside it."""
    import argparse
    import dataclasses

    import torch

    from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
    from eventgpt_tpu_torch.config import EventChatConfig, QFormerConfig
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
    from eventgpt_tpu_torch.models import eventchat
    from eventgpt_tpu_torch.models.convert import init_eventchat_params, write_hf_checkpoint
    from eventgpt_tpu_torch.ops.image import process_event_file

    base = EventChatConfig.tiny(vocab_size=260)
    out = {}
    for name, cfg in (("plain", base), ("qformer", dataclasses.replace(
            base, use_event_qformer=True,
            qformer=QFormerConfig(num_queries=6, num_layers=2, num_heads=2, hidden_size=64,
                                  mlp_ratio=2)))):
        ckpt = os.path.join(work, f"tiny_checkpoint_{name}")
        write_hf_checkpoint(init_eventchat_params(cfg, torch.Generator().manual_seed(4),
                                                  torch.float32, "cpu"), cfg, ckpt)
        chains = {}
        for dev in ("cpu", "cuda"):
            lcfg, params, tok = load_model(ckpt, "float32", "dense", "byte", dev)
            lcfg, params = prepare_model(lcfg, params, tok, argparse.Namespace(
                model_path=ckpt, use_event_qformer=False, pretrain_query_embedder=None,
                pretrain_attention_layers=None, quant="none"))
            if lcfg.use_event_qformer != (name == "qformer"):
                raise AssertionError(f"tiny {name} checkpoint: the Q-Former gate was lost")
            _, px = process_event_file(os.path.join(work, "events_2.npy"), lcfg.num_event_frames,
                                       lcfg.vision.image_size)
            ids = tokenize_with_event(prepare_event_prompt(QUERIES[2]), tok)
            chains[dev] = eventchat.generate(params, lcfg, [ids], px[None], max_new_tokens=16,
                                             temperature=0.0, eos_token_id=None, device=dev)
        if chains["cpu"] != chains["cuda"]:
            raise AssertionError(f"tiny {name} checkpoint chains differ: cpu {chains['cpu']} "
                                 f"vs cuda {chains['cuda']}")
        out[name] = {"event_tokens": lcfg.num_event_tokens, "tokens": len(chains["cuda"][0]),
                     "identical": True}
    return out


def _bucket_len(t: int, extra: int) -> int:
    """The cache length ``generate`` gives a prompt of ``t`` tokens and
    ``extra`` more slots (new tokens and the speculative reserve)."""
    return (t + extra + 127) // 128 * 128


def replay_logits(llama, params, cfg, padded, mask, chains, n_steps: int, max_len: int,
                  kv_quant: bool, eos: int):
    """The plain decode path replayed on given chains: prefill into a cache
    of ``max_len`` slots, then ``n_steps`` decode steps fed each row's
    chain (EOS past its end, as the decode loop feeds a finished row).
    Returns (logits of every step, first the prefill's, each (B, V) f32,
    the cache after the last step)."""
    import torch

    b = padded.shape[0]
    cache = llama.init_kv_cache(cfg.llama, b, max_len, dtype=padded.dtype,
                                device=padded.device, quant=kv_quant)
    with torch.inference_mode():
        logits, _ = llama.prefill(params["llama"], cfg.llama, padded, mask, cache,
                                  last_only=True)
        out = [logits]
        for i in range(n_steps):
            tok = torch.tensor([c[i] if i < len(c) else eos for c in chains],
                               dtype=torch.long, device=padded.device)
            logits, _ = llama.decode_step(params["llama"], cfg.llama,
                                          llama.embed_tokens(params["llama"], tok[:, None]), cache)
            out.append(logits)
    return out, cache


def kstep_vs_step(llama, params, cfg, padded, mask, chains, start: int, window: int,
                  max_len: int, kv_quant: bool, eos: int) -> float:
    """max |decode_kstep - sequential decode_step| over a window of the
    chains' tokens [start, start + window), after a prefix of ``start``
    tokens, in every row: the rounding gap between the speculative path's
    verify forward and the plain path's steps on one prefix."""
    import torch

    _, cache = replay_logits(llama, params, cfg, padded, mask, chains, start, max_len,
                             kv_quant, eos)
    twin = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
            for k, v in cache.items()}
    win = torch.tensor([[c[i] if i < len(c) else eos for i in range(start, start + window)]
                        for c in chains], dtype=torch.long, device=padded.device)
    with torch.inference_mode():
        k_logits, _ = llama.decode_kstep(params["llama"], cfg.llama,
                                         llama.embed_tokens(params["llama"], win), cache)
        steps = [llama.decode_step(params["llama"], cfg.llama,
                                   llama.embed_tokens(params["llama"], win[:, i:i + 1]),
                                   twin)[0] for i in range(window)]
    return (k_logits - torch.stack(steps, dim=1)).abs().max().item()


def chain_rule(name, llama, params, cfg, padded, mask, plain, got, window: int,
               kv_quant: bool, eos: int) -> dict:
    """Hold speculative chains to the plain greedy ones. A row that differs
    passes only where its first divergent step is a rounding tie: the plain
    path's top-2 logit margin there (replayed on the plain chains) below
    the largest |decode_kstep - decode_step| logit gap on that prefix.
    Anything else raises."""
    import torch

    report = []
    for r, (p_row, g_row) in enumerate(zip(plain, got)):
        if p_row == g_row:
            continue
        s = next((i for i, (a, b) in enumerate(zip(p_row, g_row)) if a != b),
                 min(len(p_row), len(g_row)))
        logits, _ = replay_logits(llama, params, cfg, padded, mask, plain, s,
                                  _bucket_len(padded.shape[1], MAX_NEW_TOKENS), kv_quant, eos)
        top2 = torch.topk(logits[s][r].float(), 2).values
        margin = (top2[0] - top2[1]).item()
        start = max(0, s - window)
        gap = kstep_vs_step(llama, params, cfg, padded, mask, plain, start, window,
                            _bucket_len(padded.shape[1], MAX_NEW_TOKENS + 2 * window),
                            kv_quant, eos)
        report.append({"row": r, "first_divergent_step": s, "plain_top2_margin": margin,
                       "kstep_vs_step_max_abs": gap, "window_start": start,
                       "rounding_tie": margin < gap})
        if not margin < gap:
            raise AssertionError(f"{name}: row {r} diverges from the plain greedy chain at step "
                                 f"{s} with a top-2 margin {margin} >= the kstep-vs-step gap "
                                 f"{gap}: not a rounding tie")
    return {"rows_identical": [p == g for p, g in zip(plain, got)], "divergences": report}


def spec_numbers(run: dict, stats: dict, plain_warm: dict, batch: int) -> dict:
    """Tokens per iteration and decode ms per committed token of a
    speculative run, beside the plain run's ms per step (one token per
    row) from the same call."""
    per_token = run["decode_ms"] * batch / max(stats["tokens"], 1)
    return {"spec_stats": stats,
            "tokens_per_iteration_per_row": stats["tokens"] / max(stats["iterations"] * batch, 1),
            "decode_ms_per_committed_token_per_row": per_token,
            "plain_decode_ms_per_step": plain_warm["decode_ms_per_step"],
            "plain_over_spec_ms_per_token": plain_warm["decode_ms_per_step"] / per_token}


def slice_spec_phases(eventchat, llama, params, cfg, ids, pixels, tokenizer, counted,
                      plain_ids, plain_warm, n_layers: int, smi: str) -> dict:
    """``slice_spec`` (lookup drafts), ``slice_medusa``, ``slice_spec_sampled``
    and ``slice_beam`` on the bf16 7B tree: each a counted cold run (K1 =
    one prefill forward), the greedy speculative ones also a warm run for
    time. Returns each phase's launches."""
    import torch

    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    b, eos, vocab = len(ids), tokenizer.eos_token_id, cfg.llama.vocab_size
    padded, mask, _ = eventchat.prepare_prefill(params, cfg, ids, pixels)
    t = padded.shape[1]

    counts = {}

    def k1_once(name, launches):
        counts[name] = launches
        if launches[FLASH_KERNEL.source] != n_layers:
            raise AssertionError(f"{name}: launches {launches}, want K1 = {n_layers}")

    # The rounding gap between the verify forward and the plain steps on
    # one prefix of the slice's chains.
    gap = kstep_vs_step(llama, params, cfg, padded, mask, plain_ids, 8, SPEC_WINDOW,
                        _bucket_len(t, MAX_NEW_TOKENS + 2 * SPEC_WINDOW), False, eos)
    emit("kstep_vs_step", {"max_abs_logit_diff": gap, "tolerance": KSTEP_LOGIT_ATOL,
                           "window": SPEC_WINDOW, "prefix_new_tokens": 8, "nvidia_smi": smi})
    if not gap <= KSTEP_LOGIT_ATOL:
        raise AssertionError(f"decode_kstep vs decode_step logits differ by {gap}")

    dev = padded.device
    heads = {"w": torch.randn((MEDUSA_HEADS, cfg.llama.hidden_size, cfg.llama.hidden_size),
                              generator=torch.Generator(device=dev).manual_seed(0),
                              device=dev, dtype=padded.dtype)
             * (1.0 / math.sqrt(cfg.llama.hidden_size))}
    for name, variant in (("slice_spec", {}), ("slice_medusa", {"draft_head": heads})):
        stats = {}
        (cold, got), launches = counted(lambda: timed_generate(
            eventchat, params, cfg, ids, pixels, tokenizer, speculative=SPEC_WINDOW,
            spec_stats=stats, **variant))
        k1_once(name, launches)
        check_generations(name, got, vocab)
        rule = chain_rule(name, llama, params, cfg, padded, mask, plain_ids, got, SPEC_WINDOW,
                          False, eos)
        warm_stats = {}
        warm, warm_ids = timed_generate(eventchat, params, cfg, ids, pixels, tokenizer,
                                        speculative=SPEC_WINDOW, spec_stats=warm_stats, **variant)
        if warm_ids != got:
            raise AssertionError(f"{name}: a second run gave other tokens")
        emit(name, {"window": SPEC_WINDOW, "cold": cold, "warm": warm, "launches": launches,
                    **({"medusa_heads": MEDUSA_HEADS, "head_scale": "1/sqrt(d)"}
                       if variant else {}),
                    **spec_numbers(warm, warm_stats, plain_warm, b), **rule,
                    "greedy_sha256": digest(got), "slice_greedy_sha256": digest(plain_ids),
                    "nvidia_smi": smi})

    stats = {}
    (sampled, got), launches = counted(lambda: timed_generate(
        eventchat, params, cfg, ids, pixels, tokenizer, temperature=0.6, top_p=0.9,
        speculative=SPEC_WINDOW, spec_stats=stats))
    k1_once("slice_spec_sampled", launches)
    check_generations("slice_spec_sampled", got, vocab)
    emit("slice_spec_sampled", {"window": SPEC_WINDOW, "temperature": 0.6, "top_p": 0.9,
                                "run": sampled, "launches": launches,
                                **spec_numbers(sampled, stats, plain_warm, b),
                                "first_ids": [r[:8] for r in got], "nvidia_smi": smi})

    # Beam search: B * k rows; the loop's own outputs are read through a
    # wrapper around it while generate runs.
    seen = {}
    loop = eventchat._beam_loop

    def spy(*args, **kw):
        seen["out"] = out = loop(*args, **kw)
        seen["gather_start"] = kw["gather_start"]
        return out

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    eventchat._beam_loop = spy
    try:
        (beam, got), launches = counted(lambda: timed_generate(
            eventchat, params, cfg, ids, pixels, tokenizer, num_beams=BEAMS))
    finally:
        eventchat._beam_loop = loop
    peak = torch.cuda.max_memory_allocated()
    k1_once("slice_beam", launches)
    check_generations("slice_beam", got, vocab)
    _, lengths, norm, steps = seen["out"]
    lengths, norm = lengths.tolist(), norm.tolist()
    if not all(math.isfinite(x) for x in norm) or not all(1 <= n <= MAX_NEW_TOKENS
                                                          for n in lengths):
        raise AssertionError(f"slice_beam: scores {norm}, lengths {lengths}")
    gs, s_len = seen["gather_start"], _bucket_len(t, MAX_NEW_TOKENS)
    cache = llama.init_kv_cache(cfg.llama, b * BEAMS, s_len, dtype=padded.dtype,
                                device=padded.device)
    parent = (torch.arange(b, device=dev)[:, None] * BEAMS
              + torch.randint(0, BEAMS, (b, BEAMS), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(1))).reshape(-1)
    slab = sum(x[:, :, gs:].numel() * x.element_size()
               for x in eventchat._cache_planes(cache))
    regather_ms = cuda_time_ms(lambda: eventchat._beam_regather(cache, parent, gs),
                               warmup=2, iters=10)
    del cache
    torch.cuda.empty_cache()
    emit("slice_beam", {"num_beams": BEAMS, "rows": b * BEAMS, "run": beam, "launches": launches,
                        "best_beam_lengths": lengths, "best_beam_norm_scores": norm,
                        "beam_steps": steps, "peak_mem_bytes": peak,
                        "peak_minus_held_bytes": peak - held,
                        "regather": {"gather_start": gs, "cache_slots": s_len,
                                     "tail_bytes_per_step": slab,
                                     "moved_bytes_min_per_step": 2 * slab,
                                     "ms_per_step": regather_ms,
                                     "gb_per_s_min": 2 * slab / regather_ms / 1e6},
                        "first_ids": [r[:8] for r in got], "nvidia_smi": smi})
    return counts


def slice_spec_int4(eventchat, llama, params_int4, cfg, ids, pixels, tokenizer, counted,
                    plain_ids4, plain_warm4, n_layers: int, smi: str) -> tuple:
    """``--quant int4 --kv_cache int8 --speculative 4``: K1 once, K4 by M
    (the prefill forward's 224 at M = B * T, its lm_head at M = B, 225 per
    verify forward at M = B * window, K4's decode path at M <= 16), and
    the chain rule against ``slice_int4``'s chains."""
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.int4_matmul import DECODE_MAX_M, INT4_KERNEL, LAUNCHES_BY_M

    b, eos = len(ids), tokenizer.eos_token_id
    stats = {}
    (cold, got), launches = counted(lambda: timed_generate(
        eventchat, params_int4, cfg, ids, pixels, tokenizer, kv_quant=True,
        speculative=SPEC_WINDOW, spec_stats=stats))
    by_m = dict(LAUNCHES_BY_M)
    padded, mask, _ = eventchat.prepare_prefill(params_int4, cfg, ids, pixels)
    m_verify = b * SPEC_WINDOW
    path = "decode" if m_verify <= DECODE_MAX_M else "prefill"
    want = {("prefill", b * padded.shape[1]): 7 * n_layers, ("decode", b): 1}
    want[path, m_verify] = want.get((path, m_verify), 0) + (7 * n_layers + 1) * stats["iterations"]
    if by_m != want or launches[INT4_KERNEL.source] != sum(want.values()) \
            or launches[FLASH_KERNEL.source] != n_layers:
        raise AssertionError(f"slice_spec_int4: K4 launches by (path, M) {by_m}, want {want}; "
                             f"launches {launches}")
    check_generations("slice_spec_int4", got, cfg.llama.vocab_size)
    rule = chain_rule("slice_spec_int4", llama, params_int4, cfg, padded, mask, plain_ids4, got,
                      SPEC_WINDOW, True, eos)
    warm_stats = {}
    warm, warm_ids = timed_generate(eventchat, params_int4, cfg, ids, pixels, tokenizer,
                                    kv_quant=True, speculative=SPEC_WINDOW,
                                    spec_stats=warm_stats)
    if warm_ids != got:
        raise AssertionError("slice_spec_int4: a second run gave other tokens")
    emit("slice_spec_int4", {
        "flags": "--quant int4 --kv_cache int8 --speculative 4", "cold": cold, "warm": warm,
        "launches": launches, "verify_m": m_verify, "verify_k4_path": path,
        "k4_launches_by_path_m": {f"{p} M={m}": c for (p, m), c in sorted(by_m.items())},
        **spec_numbers(warm, warm_stats, plain_warm4, b), **rule,
        "greedy_sha256": digest(got), "slice_int4_greedy_sha256": digest(plain_ids4),
        "nvidia_smi": smi})
    return launches, by_m


def tiny_variants_card_vs_cpu(event_path: str) -> dict:
    """A tiny f32 model gives the same beam (k = 2, 3), speculative (window
    1, 2, 4) and Medusa greedy chains on the card as on the CPU."""
    import numpy as np
    import torch

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer, tokenize_with_event
    from eventgpt_tpu_torch.models import eventchat
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops.image import process_event_file

    cfg = EventChatConfig.tiny(vocab_size=260)
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(4), torch.float32, "cpu")
    card = _to(cpu, "cuda")
    d = cfg.llama.hidden_size
    heads = {"w": torch.randn((3, d, d), generator=torch.Generator().manual_seed(5)) * 0.5}
    _, pixels = process_event_file(event_path, cfg.num_event_frames, cfg.vision.image_size)
    ids = [tokenize_with_event(prepare_event_prompt(q), ByteTokenizer()) for q in QUERIES[:2]]
    pixels = np.stack([pixels, pixels[::-1].copy()])
    cases = [("beam", {"num_beams": k}) for k in (2, 3)]
    cases += [("spec", {"speculative": w}) for w in (1, 2, 4)]
    cases += [("medusa", {"speculative": 4, "draft_head": heads})]
    out = []
    for name, kw in cases:
        chains = {}
        for dev, params in (("cpu", cpu), ("cuda", card)):
            kw_dev = ({**kw, "draft_head": _to(kw["draft_head"], dev)} if "draft_head" in kw
                      else kw)
            chains[dev] = eventchat.generate(params, cfg, ids, pixels, max_new_tokens=12,
                                             temperature=0.0, eos_token_id=None, device=dev,
                                             **kw_dev)
        if chains["cpu"] != chains["cuda"]:
            raise AssertionError(f"tiny {name} {kw.get('num_beams', kw.get('speculative'))}: "
                                 f"cpu {chains['cpu']} vs cuda {chains['cuda']}")
        out.append({"variant": name, "k": kw.get("num_beams", kw.get("speculative")),
                    "identical": True, "sha256": digest(chains["cuda"])})
    return {"config": "EventChatConfig.tiny(vocab 260), f32, batch 2, 12 new tokens",
            "cases": out}


def write_train_set(work: str) -> dict:
    """The toy QA set: ``train_{i}.npy`` streams, ``qa.json`` over all 8
    entries and ``eval.json`` over the first 2."""
    import numpy as np

    from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

    entries = []
    for i, (q, a) in enumerate(TRAIN_QA):
        np.save(os.path.join(work, f"train_{i}.npy"), synthetic_event_stream(seed=100 + i))
        entries.append({"id": i, "event": f"train_{i}.npy", "conversations": [
            {"from": "human", "value": f"<event>\n{q}"}, {"from": "gpt", "value": a}]})
    paths = {"data_path": os.path.join(work, "qa.json"),
             "eval_data_path": os.path.join(work, "eval.json"), "event_folder": work}
    with open(paths["data_path"], "w") as f:
        json.dump(entries, f)
    with open(paths["eval_data_path"], "w") as f:
        json.dump(entries[:2], f)
    return paths


def flash_backward_bound_ms(b: int, s: int, h: int, hd: int):
    """Least time for the dense f32 backward: q, k, v, the cotangent and
    the mask read once and dq, dk, dv written once (bf16), against its five
    f32 products over all (q, k) pairs (scores, dv, dp, dq, dk) at the f32
    peak outside the tensor cores; the softmax's elementwise work is not
    counted."""
    nbytes = 7 * b * s * h * hd * 2 + b * s
    flops = 5 * 2 * b * h * s * s * hd
    bound_ms, bound_by = _bound(nbytes, flops, H100_F32_FLOPS)
    return bound_ms, bound_by, nbytes, flops


def check_flash_grad(lengths, s: int, seed: int) -> dict:
    """K1's autograd Function at a training shape (B = len(lengths), the
    padded length S, 32 heads of 128, bf16, right padding): the forward
    against the plain version, dq/dk/dv against autograd through the plain
    version, padded rows, and the forward, backward and SDPA-backward times."""
    import torch
    import torch.nn.functional as F

    from eventgpt_tpu_torch.ops import flash_attention as fa

    b, h, hd = len(lengths), 32, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, cot = (torch.randn((b, s, h, hd), generator=g, device="cuda", dtype=torch.bfloat16)
                    for _ in range(4))
    valid = torch.arange(s, device="cuda")[None, :] < torch.tensor(lengths, device="cuda")[:, None]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    launches = fa.FLASH_KERNEL.launches
    out = fa.flash_attention(*leaves, valid=valid, causal=True)
    (out.float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    if fa.FLASH_KERNEL.launches != launches + 1:
        raise AssertionError("K1's Function did not launch the kernel once")
    ref_out = fa.flash_attention_reference(q, k, v, valid, causal=True)
    fwd_err = (out.detach().float() - ref_out.float()).abs().max().item()
    if not math.isfinite(fwd_err) or fwd_err > KERNEL_ATOL:
        raise AssertionError(f"K1 forward under grad: max abs err {fwd_err} > {KERNEL_ATOL}")
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention_reference(*refs, valid, causal=True).float() * cot.float()).sum().backward()
    grads = {}
    for name, got, want in zip("qkv", leaves, refs):
        if not bool(torch.isfinite(got.grad).all()):
            raise AssertionError(f"K1 gradient d{name} is not finite")
        err = (got.grad.float() - want.grad.float()).abs().max().item()
        bar = FLASH_GRAD_RTOL * want.grad.float().abs().max().item()
        grads[f"d{name}_max_abs_err"], grads[f"d{name}_bar"] = err, bar
        if err > bar:
            raise AssertionError(f"K1 gradient d{name}: max abs err {err} > {bar}")
    for row, n in enumerate(lengths):
        if n < s and not bool((leaves[0].grad[row, n:] == 0).all()):
            raise AssertionError(f"K1 gradient: padded query rows of row {row} are not zero")
    del out, ref_out, refs, leaves

    fwd_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, valid=valid, causal=True))
    bwd_ms = cuda_time_ms(lambda: fa.flash_attention_backward(q, k, v, valid, cot),
                          warmup=1, iters=5)
    mask = valid[:, None, None, :] & torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    cot_t = cot.transpose(1, 2)
    sdpa_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), cot_t,
                                                           retain_graph=True), warmup=1, iters=5)
    bound_ms, bound_by, nbytes, flops = flash_backward_bound_ms(b, s, h, hd)
    return {"B": b, "S": s, "H": h, "hd": hd, "lengths": list(lengths),
            "forward_max_abs_err": fwd_err, "grad_rtol": FLASH_GRAD_RTOL, **grads,
            "padded_rows_zero_grad": True, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "backward_bound_ms": bound_ms, "backward_bound_by": bound_by,
            "backward_bytes": nbytes, "backward_f32_flops": flops,
            "backward_f32_tflop_s": flops / bwd_ms / 1e9,
            "sdpa_backward_ms": sdpa_bwd_ms}


def _sha_leaves(leaves) -> str:
    import torch

    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def frozen_sample(params) -> list:
    """Sampled frozen leaves whose hash must not move in training: a CLIP
    layer, two LLaMA layers and lm_head."""
    lm = params["llama"]
    return ([params["clip"]["layers"][0]["q_proj"]["weight"]]
            + [lm["layers"][i][name] for i in (0, len(lm["layers"]) - 1)
               for name in ("q_proj", "down_proj")] + [lm["lm_head"]])


def _train_args(stage: int, paths: dict, out: str, **kw):
    from eventgpt_tpu_torch.train.args import DataArguments, ModelArguments, TrainingArguments

    targs = dict(output_dir=out, stage=stage, max_steps=TRAIN_STEPS,
                 per_device_train_batch_size=TRAIN_BATCH, logging_steps=1, save_steps=-1,
                 eval_steps=-1, bf16=True)
    if stage == 1:
        targs.update(learning_rate=2e-3)
    else:
        targs.update(lora_r=64, lora_alpha=16.0, learning_rate=2e-4, mm_projector_lr=2e-5)
    targs.update(kw)
    return (ModelArguments(), DataArguments(**paths), TrainingArguments(**targs))


def train_7b(stage: int, params, cfg, tokenizer, paths: dict, work: str,
             profile_dir=None) -> dict:
    """One training stage at EventGPT-7B width through ``cli.train.build_trainer``
    on the bf16 tree already on the card: 4 optimizer steps (full remat),
    ``evaluate`` on 2 entries, then ``save``, a fresh trainer that resumes
    and takes step 5, against the first trainer taking step 5 in memory.
    With ``profile_dir``, torch.profiler over one more step on the first
    batch (K1's forward and recompute launches matched by name)."""
    import torch

    from eventgpt_tpu_torch.checkpoint import load_component
    from eventgpt_tpu_torch.cli.train import build_trainer
    from eventgpt_tpu_torch.models import clip as clip_mod
    from eventgpt_tpu_torch.ops import flash_attention as fa
    from eventgpt_tpu_torch.train.lora import LoraConfig, merge_lora
    from eventgpt_tpu_torch.train.data import batch_iterator
    from eventgpt_tpu_torch.train.optim import tree_leaves
    from eventgpt_tpu_torch.train.steps import batch_to_device

    def reset():
        fa.FLASH_KERNEL.launches = 0
        for key in fa.LAUNCHES_BY_PATH:
            fa.LAUNCHES_BY_PATH[key] = 0

    n_layers = cfg.llama.num_layers
    out = os.path.join(work, f"train_stage{stage}")
    frozen_hash = _sha_leaves(frozen_sample(params))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = build_trainer(*_train_args(stage, paths, out), device="cuda",
                            loaded=(cfg, params, tokenizer))
    build_s = time.perf_counter() - t0
    start = [t.detach().clone() for _, t in tree_leaves(trainer.state.trainable)]
    trainable_bytes = sum(t.numel() * t.element_size() for t in start)
    first = next(batch_iterator(trainer.dataset, TRAIN_BATCH, trainer.cfg,
                                seed=trainer.targs.seed, max_len=trainer.targs.model_max_length))
    shape = {"T": int(first["attn_mask"].shape[1]),
             "lengths": [int(x) for x in first["attn_mask"].sum(1)]}

    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    final = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    micro = trainer.state.step
    paths_k1 = dict(fa.LAUNCHES_BY_PATH)
    launches_train = fa.FLASH_KERNEL.launches
    if micro != TRAIN_STEPS:
        raise AssertionError(f"stage {stage}: {micro} micro-steps, want {TRAIN_STEPS}")
    k1_per_micro = (paths_k1["train_forward"] + paths_k1["recompute"]) / micro
    if (launches_train != K1_PER_MICRO * micro
            or paths_k1["train_forward"] != n_layers * micro
            or paths_k1["recompute"] != n_layers * micro
            or paths_k1["backward"] != K1_BACKWARD_PER_MICRO * micro
            or paths_k1["inference"] != 0):
        raise AssertionError(f"stage {stage}: K1 launches {launches_train} by path {paths_k1}, "
                             f"want {K1_PER_MICRO} a micro-step (forward + recompute) and "
                             f"{K1_BACKWARD_PER_MICRO} backward calls")
    records = [json.loads(line) for line in open(trainer.metrics_path)]
    steps = [r for r in records if "loss" in r and "event" not in r]
    tele = [json.loads(line) for line in open(trainer.telemetry_path)]
    losses = [r["loss"] for r in steps]
    if len(steps) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"stage {stage}: losses {losses}")
    end = [t.detach() for _, t in tree_leaves(trainer.state.trainable)]
    unmoved = [str(p) for (p, _), a, b in zip(tree_leaves(trainer.state.trainable), start, end)
               if torch.equal(a, b)]
    if unmoved:
        raise AssertionError(f"stage {stage}: trainable leaves that did not move: {unmoved}")
    if _sha_leaves(frozen_sample(params)) != frozen_hash:
        raise AssertionError(f"stage {stage}: a frozen leaf changed")
    del start, end
    per_step = []
    prev_tokens = 0
    for r, t in zip(steps, tele):
        per_step.append({"step": r["step"], "loss": r["loss"], "grad_norm": r["grad_norm"],
                         "ms": t["step_wall_s"] * 1e3,
                         "tokens": t["tokens_seen"] - prev_tokens,
                         "tokens_per_s": (t["tokens_seen"] - prev_tokens) / t["step_wall_s"]})
        prev_tokens = t["tokens_seen"]

    # Eval on 2 entries: one no-grad forward, K1 32 launches.
    reset()
    t0 = time.perf_counter()
    ev = trainer.evaluate(micro)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_k1 = fa.LAUNCHES_BY_PATH["inference"]
    if eval_k1 != n_layers or not math.isfinite(ev["eval_loss"]):
        raise AssertionError(f"stage {stage}: eval {ev}, K1 {dict(fa.LAUNCHES_BY_PATH)}")

    # Where the step's time goes: CLIP alone and the no-grad forward (CLIP +
    # LM + loss) on the first batch, timed on the device.
    batch = batch_to_device(first, "cuda")
    pix = batch["pixel_values"].reshape((-1,) + tuple(batch["pixel_values"].shape[2:]))
    with torch.no_grad():
        clip_ms = cuda_time_ms(lambda: clip_mod.clip_encode(
            params["clip"], cfg.vision, pix.to(torch.bfloat16)), warmup=1, iters=3)
        fwd_ms = cuda_time_ms(lambda: trainer.eval_step(trainer.state, batch), warmup=1, iters=3)

    # Components the JAX package reads, and the LoRA merge of the port.
    comps = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    merged = None
    if stage == 2:
        lora = load_component(os.path.join(out, "lora_last.npz"), strip_prefix="lora.")
        lcfg = LoraConfig(r=64, alpha=16.0)
        two = {"layers": [params["llama"]["layers"][i] for i in (0, n_layers - 1)]}
        sub = {g: {n: {k: v[[0, n_layers - 1]] for k, v in ab.items()} for n, ab in names.items()}
               for g, names in lora.items()}
        out_two = merge_lora(two, sub, lcfg)
        a = trainer.state.trainable["lora"]["attn"]["q"]["a"][-1].detach()
        b = trainer.state.trainable["lora"]["attn"]["q"]["b"][-1].detach()
        want = (two["layers"][1]["q_proj"].float() + lcfg.scaling * (a @ b).T)
        diff = (out_two["layers"][1]["q_proj"].float() - want).abs().max().item()
        if diff > 2 ** -8 * want.abs().max().item():
            raise AssertionError(f"merge_lora of lora_last.npz differs by {diff}")
        merged = {"layers_merged": [0, n_layers - 1], "max_abs_diff_bf16": diff}
        del out_two, two, sub, lora

    # Resume: a fresh trainer from ckpt_last takes step 5; the first trainer
    # takes step 5 in memory from the same state and batch.
    resumed = build_trainer(*_train_args(stage, paths, out + "_resumed"), device="cuda",
                            loaded=(cfg, params, tokenizer))
    t0 = time.perf_counter()
    resumed.resume(os.path.join(out, "ckpt_last"))
    resume_s = time.perf_counter() - t0
    resumed.targs.max_steps = TRAIN_STEPS + 1
    resumed.train()
    trainer.targs.max_steps = TRAIN_STEPS + 1
    trainer.train()
    got = [json.loads(line) for line in open(resumed.metrics_path)][0]
    want = [r for r in map(json.loads, open(trainer.metrics_path))
            if r.get("step") == TRAIN_STEPS + 1 and "loss" in r][0]
    resume_diff = abs(got["loss"] - want["loss"])
    if got["step"] != TRAIN_STEPS + 1 or not resume_diff <= RESUME_LOSS_ATOL:
        raise AssertionError(f"stage {stage}: resumed step {got} vs in memory {want}")
    if _sha_leaves(frozen_sample(params)) != frozen_hash:
        raise AssertionError(f"stage {stage}: a frozen leaf changed")
    prof = None
    if profile_dir:
        prof = profile_call(lambda: trainer.train_step(trainer.state, batch), profile_dir,
                            f"train_stage{stage}", match="flash_fwd_kernel")
    del trainer, resumed, batch
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(out + "_resumed", ignore_errors=True)
    torch.cuda.empty_cache()
    warm = [s["ms"] for s in per_step[1:]]
    return {
        "stage": stage, "batch": shape, "build_s": build_s, "train_s": train_s,
        "per_step": per_step, "cold_step_ms": per_step[0]["ms"],
        "warm_step_ms": sum(warm) / len(warm), "final": final,
        "eval": {**ev, "ms": eval_ms, "k1_inference": eval_k1},
        "split_ms": {"clip_no_grad": clip_ms, "eval_forward_no_grad": fwd_ms},
        "k1_launches": launches_train, "k1_by_path": paths_k1,
        "k1_launches_per_micro_step": k1_per_micro, "k1_launches_per_micro_step_want": K1_PER_MICRO,
        "k1_backward_per_micro_step": paths_k1["backward"] / micro,
        "peak_mem_bytes": peak, "held_before_bytes": held,
        "peak_above_held_bytes": peak - held, "bf16_tree_bytes": tree_bytes(params),
        "trainable_f32_bytes": trainable_bytes,
        "trainables_moved": True, "frozen_sha256_unchanged": frozen_hash,
        "components": comps, "lora_merge": merged,
        "resume": {"loss_resumed": got["loss"], "loss_in_memory": want["loss"],
                   "abs_diff": resume_diff, "bar": RESUME_LOSS_ATOL, "resume_s": resume_s},
        **({"profile_step": prof} if prof else {}),
    }


def train_tiny_card_vs_cpu(work: str, paths: dict) -> dict:
    """The tiny f32 config with dense attention: one stage-1 and one stage-2
    step from the same state on the card and on the CPU agree in loss,
    grad_norm and the updated trainables; then ``cli.train`` on the card in
    a subprocess for 2 steps."""
    import dataclasses

    import numpy as np
    import torch

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.train import steps as steps_mod
    from eventgpt_tpu_torch.train.data import synthetic_multimodal_batch
    from eventgpt_tpu_torch.train.lora import LoraConfig
    from eventgpt_tpu_torch.train.optim import linear_warmup_cosine, make_optimizer, tree_leaves
    from eventgpt_tpu_torch.train.trainer import tree_map

    cfg = EventChatConfig.tiny(vocab_size=260)
    if cfg.llama.attn_impl != "dense":
        raise AssertionError("the tiny config must train with dense attention")
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu")
    rng = np.random.default_rng(6)
    size = cfg.vision.image_size
    pix = rng.standard_normal((2, cfg.num_event_frames, 3, size, size)).astype(np.float32)
    batch = synthetic_multimodal_batch(cfg, 2, 48, event_offset=5, pixel_values=pix,
                                       mask_event_labels=True)
    batch["token_ids"] = rng.integers(3, 259, (2, 48)).astype(np.int32)
    batch["labels"] = np.where(batch["event_pos"], -100, batch["token_ids"]).astype(np.int32)
    lcfg = LoraConfig(r=4, alpha=8.0)
    lora = steps_mod.split_stage2(cpu, cfg, lcfg, torch.Generator().manual_seed(7))[0]["lora"]
    for ab in lora["attn"].values():
        ab["b"] += 0.02
    result = {}
    for stage in (1, 2):
        runs = {}
        for dev in ("cpu", "cuda"):
            params = _to(cpu, dev)
            if stage == 1:
                tr, fz = steps_mod.split_stage1(params)
                combine = steps_mod.stage1_combine
            else:
                tr, fz = steps_mod.split_stage2(params, cfg, lcfg,
                                                torch.Generator().manual_seed(0))
                tr["lora"] = _to(lora, dev)
                combine = steps_mod.make_stage2_combine(lcfg)
            tr = tree_map(lambda x: x.to(dev).detach().clone(), tr)
            opt = make_optimizer(linear_warmup_cosine(1e-3, 4), weight_decay=0.01,
                                 projector_lr=5e-4 if stage == 2 else None)
            state = steps_mod.init_train_state(tr, fz, opt)
            step = steps_mod.make_train_step(cfg, opt, combine)
            state, m = step(state, steps_mod.batch_to_device(batch, dev))
            runs[dev] = (float(m["loss"]), float(m["grad_norm"]),
                         [t.detach().cpu() for _, t in tree_leaves(state.trainable)])
        (lc, gc, tc), (lg, gg, tg) = runs["cpu"], runs["cuda"]
        tree_diff = max((a - b).abs().max().item() for a, b in zip(tc, tg))
        numbers = {"loss_cpu": lc, "loss_cuda": lg, "grad_norm_cpu": gc, "grad_norm_cuda": gg,
                   "trainables_max_abs_diff": tree_diff, "bar": TINY_TRAIN_ATOL}
        if (abs(lc - lg) > TINY_TRAIN_ATOL or abs(gc - gg) > TINY_TRAIN_ATOL
                or tree_diff > TINY_TRAIN_ATOL):
            raise AssertionError(f"tiny stage-{stage} step differs on the card: {numbers}")
        result[f"stage{stage}"] = numbers

    out = os.path.join(work, "cli_train_tiny")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "eventgpt_tpu_torch.cli.train", "--model_path", "tiny-random",
         "--data_path", paths["data_path"], "--event_folder", paths["event_folder"],
         "--stage", "2", "--max_steps", "2", "--bf16", "false", "--lora_r", "8",
         "--per_device_train_batch_size", "2", "--output_dir", out, "--logging_steps", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    if res.returncode != 0:
        raise AssertionError(f"cli.train on the card exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    steps_logged = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    if [r["step"] for r in steps_logged] != [1, 2] or not all(
            math.isfinite(r["loss"]) for r in steps_logged):
        raise AssertionError(f"cli.train on the card logged {steps_logged}")
    result["cli_train"] = {"returncode": 0, "seconds": time.perf_counter() - t0,
                           "losses": [r["loss"] for r in steps_logged],
                           "files": sorted(os.listdir(out))}
    shutil.rmtree(out, ignore_errors=True)
    return result


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="also profile one bf16 and one int4 batch and one paged server "
                             "run; write the operator tables to DIR")
    parser.add_argument("--int4_baseline", default=None, metavar="FILE",
                        help="another version of csrc/int4_matmul.cu to build and time in "
                             "turns with K4 on the K4 checks' inputs")
    parser.add_argument("--flash_baseline", default=None, metavar="FILE",
                        help="another version of csrc/flash_attention.cu to build, time in "
                             "turns with K1 on the K1 checks' inputs, and run the bf16 "
                             "slice through")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import dataclasses

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.models import eventchat, llama
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.ops import quant
    from eventgpt_tpu_torch.ops._build import build_all
    from eventgpt_tpu_torch.ops.decode_attention import DECODE_INT8_KERNEL, PAGED_INT8_KERNEL
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.int4_matmul import (INT4_KERNEL, LAUNCHES_BY_M,
                                                     LAUNCHES_BY_SHAPE)

    kernels = [FLASH_KERNEL, INT4_KERNEL, DECODE_INT8_KERNEL, PAGED_INT8_KERNEL]
    baseline = baseline_kernel(INT4_KERNEL, args.int4_baseline) if args.int4_baseline else None
    flash_base = (baseline_kernel(FLASH_KERNEL, args.flash_baseline)
                  if args.flash_baseline else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", {"kind": card, "count": torch.cuda.device_count(), "nvidia_smi": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda})

    def counted(run):
        """Drive one main path with every launch count set to 0 just before
        it; returns (its result, the counts read just after). K4's counts
        by path and shape are left in ``LAUNCHES_BY_SHAPE`` for the caller."""
        for k in kernels:
            k.launches = 0
        LAUNCHES_BY_SHAPE.clear()
        LAUNCHES_BY_M.clear()
        out = run()
        return out, {k.source: k.launches for k in kernels}

    # 1. build
    shutil.rmtree(os.path.join(ROOT, "eventgpt_tpu_torch", "csrc", "build"), ignore_errors=True)
    t0 = time.perf_counter()
    built = kernels + [x for x in (baseline, flash_base) if x is not None]
    build_all(built)
    for k in built:
        k.lib()
        ptxas = [ln.strip() for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        emit("build", {"source": k.source, "seconds": k.build_seconds, "ptxas": ptxas})
    emit("build_total", {"seconds": time.perf_counter() - t0})

    cfg = EventChatConfig.eventgpt_7b()
    if cfg.llama.attn_impl != "flash":
        raise AssertionError("the 7B preset must prefill through the flash kernel")
    n_layers = cfg.llama.num_layers
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=ROOT)
    try:
        tokenizer, ids, pixels, lengths, host = prepare_requests(cfg, work)
        t0 = time.perf_counter()
        params = init_eventchat_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                       torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        emit("host", {**host, "init_weights_s": time.perf_counter() - t0})

        # 2. kernel checks at the main paths' shapes: K1 at the prefill
        # shape, at an S that is no multiple of the 64-row tile and at the
        # tile edges (rows of 129, 128, 64 and 1 keys); K4 at the 7B decode
        # shapes and at the prefill M = B * T.
        main_check = check_flash_kernel(lengths, seed=1, baseline=flash_base)
        emit("kernel_flash_main_shape", main_check)
        odd_check = check_flash_kernel([333, 201], seed=2, baseline=flash_base)
        emit("kernel_flash_odd_s", odd_check)
        edge_check = check_flash_kernel([129, 128, 64, 1], seed=3, baseline=flash_base)
        emit("kernel_flash_tile_edges", edge_check)
        flash_checks = (main_check, odd_check, edge_check)
        m_prefill = len(lengths) * max(lengths)
        int4_checks = {}
        prefill_shapes = [(m_prefill, k, n) for k, n in INT4_PREFILL_LAUNCHES]
        for i, shape in enumerate(INT4_DECODE_SHAPES + prefill_shapes):
            int4_checks[shape] = check_int4_kernel(*shape, seed=10 + i, baseline=baseline)
            emit("kernel_int4_M{}_K{}_N{}".format(*shape), int4_checks[shape])

        # 3. the bf16 slice: four requests through generate, as cli/infer
        # calls it. The first run is the counted main path (and the cold
        # start); the second is the same work with every shape seen before.
        torch.cuda.reset_peak_memory_stats()
        (cold, out_ids), launches = counted(
            lambda: timed_generate(eventchat, params, cfg, ids, pixels, tokenizer))
        cold["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        if launches[FLASH_KERNEL.source] != n_layers:
            raise AssertionError(f"bf16 slice: {launches} launches, want K1 = {n_layers}")
        vocab = cfg.llama.vocab_size
        check_generations("bf16", out_ids, vocab)
        emit("slice", {
            "config": "EventGPT-7B (CLIP ViT-L/14-336 24 layers, LLaMA-7B 32 layers, d=4096, "
                      "vocab 32000), random bf16 weights, seed 0",
            "requests": len(QUERIES), "prompt_lengths": lengths, "run": "first (cold)",
            **cold, "launches": launches, "greedy_sha256": digest(out_ids), "nvidia_smi": smi,
        })
        warm, warm_ids = timed_generate(eventchat, params, cfg, ids, pixels, tokenizer)
        if warm_ids != out_ids:
            raise AssertionError("a second greedy run gave other tokens")
        emit("slice_warm", {"run": "second (warm)", **warm, "nvidia_smi": smi})
        answers = tokenizer.batch_decode(out_ids, skip_special_tokens=True)

        def profile_bf16(name):
            """K1's device ms per prefill forward, from one more profiled
            bf16 batch (one prefill forward of 32 launches)."""
            prof = profile_call(
                lambda: timed_generate(eventchat, params, cfg, ids, pixels, tokenizer),
                args.profile, name, match="flash_fwd_kernel")
            return {**prof, "k1_device_ms_per_prefill": prof["matched_device_ms"]}

        if args.profile:
            emit("profile", profile_bf16("generate"))
        if flash_base is not None:
            # The same warm batch with K1 launched from the baseline's
            # library, then once more through K1: prefill in turns.
            with routed_through(FLASH_KERNEL, flash_base):
                base, base_ids = timed_generate(eventchat, params, cfg, ids, pixels, tokenizer)
                base_prof = profile_bf16("generate_flash_baseline") if args.profile else None
            again, again_ids = timed_generate(eventchat, params, cfg, ids, pixels, tokenizer)
            if again_ids != out_ids:
                raise AssertionError("a third greedy run gave other tokens")
            emit("slice_flash_baseline", {
                "kernel": flash_base.path, "warm": base, "greedy_sha256": digest(base_ids),
                "same_chains_as_kernel": base_ids == out_ids,
                "kernel_prefill_ms_turns": [warm["prefill_ms"], again["prefill_ms"]],
                "nvidia_smi": smi})
            if base_prof is not None:
                emit("profile_flash_baseline", base_prof)
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
        del logits, cache
        torch.cuda.empty_cache()

        # The decoding variants on the bf16 tree: speculative (lookup and
        # Medusa drafts, greedy and sampled) and beam search.
        variant_launches = slice_spec_phases(eventchat, llama, params, cfg, ids, pixels,
                                             tokenizer, counted, out_ids, warm, n_layers, smi)
        torch.cuda.empty_cache()

        # 4. the continuous-batching server on the bf16 tree, paged then
        # dense, with K3 held on the paged arena in between.
        requests = serve_requests(ids, pixels)
        (paged, paged_chains), serve_launches = counted(
            lambda: run_server(params, cfg, tokenizer, requests, "paged"))
        want_k1 = n_layers * paged["prefill_dispatches"]
        if (serve_launches[FLASH_KERNEL.source] != want_k1
                or serve_launches[PAGED_INT8_KERNEL.source] != 0):
            raise AssertionError(f"serve paged: launches {serve_launches}, want K1 = {want_k1} "
                                 f"(32 per prefill dispatch) and K3 = 0")
        emit("serve_paged_int8kv", {**paged, "launches": serve_launches,
                                    "first_ids": [c[:8] for c in paged_chains],
                                    "nvidia_smi": smi})
        paged_check, check_chains = check_paged_kernel(params, cfg, tokenizer, requests,
                                                       seed=30)
        same_prefix = [c[:MAX_NEW_TOKENS] == p for c, p in zip(check_chains, paged_chains)]
        emit("kernel_paged_int8", {**paged_check, "chains_64_prefix_equal_serve": same_prefix,
                                   "nvidia_smi": smi})
        if not all(same_prefix):
            raise AssertionError("the 64-token served chains do not begin with the 32-token ones")
        dense, dense_chains = run_server(params, cfg, tokenizer, requests, "dense")
        agree = [sum(a == b for a, b in zip(c, o)) for c, o in zip(dense_chains, out_ids)]
        emit("serve_dense_int8kv", {**dense, "same_chains_as_paged": dense_chains == paged_chains,
                                    "tokens_agreeing_with_slice": agree,
                                    "nvidia_smi": smi})
        if dense_chains != paged_chains:
            raise AssertionError("dense and paged served chains differ")
        if args.profile:
            emit("profile_serve_paged", profile_call(
                lambda: run_server(params, cfg, tokenizer, requests, "paged"),
                args.profile, "serve_paged"))

        # 5. --quant int4 --kv_cache int8: the bf16 LLaMA quantized on the
        # card (a copy of the tree, so the bf16 weights stay for phase 5).
        bf16_bytes = tree_bytes(params)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        llama_int4 = quant.quantize_llama_params(llama.copy_tree(params["llama"]), bits=4)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        params_int4 = {**params, "llama": llama_int4}
        (cold4, ids4), launches4 = counted(lambda: timed_generate(
            eventchat, params_int4, cfg, ids, pixels, tokenizer, kv_quant=True))
        by_shape4 = dict(LAUNCHES_BY_SHAPE)
        peak4 = torch.cuda.max_memory_allocated()
        steps4 = cold4["decode_steps"]
        want_k4 = (7 * n_layers + 1) * (1 + steps4)
        if launches4[INT4_KERNEL.source] != want_k4 or launches4[FLASH_KERNEL.source] != n_layers:
            raise AssertionError(f"int4 slice: launches {launches4}, want K4 = {want_k4} "
                                 f"(225 x (1 + {steps4})) and K1 = {n_layers}")
        # The same launches by path and shape: the one prefill forward's at
        # M = B * T, and each decode step's at M = B plus prefill's lm_head.
        prefill4 = {(k, n): c for (path, k, n), c in by_shape4.items() if path == "prefill"}
        decode4 = {(k, n): c for (path, k, n), c in by_shape4.items() if path == "decode"}
        want_decode4 = {(k, n): c * steps4 for (_, k, n), c in INT4_LAUNCHES_PER_STEP.items()}
        want_decode4[(4096, cfg.llama.vocab_size)] += 1
        if prefill4 != INT4_PREFILL_LAUNCHES or decode4 != want_decode4:
            raise AssertionError(f"int4 slice: K4 launches by (K, N) {by_shape4}, want prefill "
                                 f"{INT4_PREFILL_LAUNCHES} and decode {want_decode4}")
        check_generations("int4", ids4, vocab)
        warm4, warm_ids4 = timed_generate(eventchat, params_int4, cfg, ids, pixels, tokenizer,
                                          kv_quant=True)
        if warm_ids4 != ids4:
            raise AssertionError("a second int4 greedy run gave other tokens")
        cache_bytes = 2 * n_layers * len(QUERIES) * ((t + MAX_NEW_TOKENS + 127) // 128 * 128) \
            * cfg.llama.num_kv_heads * (cfg.llama.resolved_head_dim() + 4)
        emit("slice_int4", {
            "flags": "--quant int4 --kv_cache int8", "quantize_on_card_s": quantize_s,
            "cold": cold4, "warm": warm4, "launches": launches4,
            "k4_launches_want": want_k4,
            "k4_launches_by_shape": {f"{path} K={k} N={n}": c
                                     for (path, k, n), c in sorted(by_shape4.items())},
            "same_tokens_cold_warm": True,
            "same_first_token_as_bf16": [a[:1] == c[:1] for a, c in zip(ids4, out_ids)],
            "peak_mem_bytes": peak4, "bf16_tree_bytes": bf16_bytes,
            "peak_minus_bf16_tree_bytes": peak4 - bf16_bytes,
            "int4_llama_bytes": tree_bytes(llama_int4), "int8_cache_bytes": cache_bytes,
            "first_ids": [r[:8] for r in ids4], "greedy_sha256": digest(ids4),
            "nvidia_smi": smi,
        })

        def profile_int4(name):
            """K4's decode-path device ms per decode step, from one more
            profiled batch (the prefill's lm_head launch included)."""
            prof = profile_call(
                lambda: timed_generate(eventchat, params_int4, cfg, ids, pixels, tokenizer,
                                       kv_quant=True),
                args.profile, name, match="int4_mm_decode")
            return {**prof, "k4_decode_ms_per_step": prof["matched_device_ms"] / steps4}

        if args.profile:
            emit("profile_int4", profile_int4("generate_int4"))
        if baseline is not None:
            # The same batch with K4 launched from the baseline's library.
            with routed_through(INT4_KERNEL, baseline):
                base4, base_ids4 = timed_generate(eventchat, params_int4, cfg, ids, pixels,
                                                  tokenizer, kv_quant=True)
                base_prof = profile_int4("generate_int4_baseline") if args.profile else None
            emit("slice_int4_baseline", {
                "kernel": baseline.path, "warm": base4, "greedy_sha256": digest(base_ids4),
                "same_chains_as_kernel": base_ids4 == ids4, "nvidia_smi": smi})
            if base_prof is not None:
                emit("profile_int4_baseline", base_prof)
        variant_launches["slice_spec_int4"], spec_by_m4 = slice_spec_int4(
            eventchat, llama, params_int4, cfg, ids, pixels, tokenizer, counted, ids4, warm4,
            n_layers, smi)

        # int4 vs the bf16 prefill of the dequantized weights.
        llama_deq = quant.dequantize_llama_params(llama_int4, torch.bfloat16)
        first = {}
        for name, lp in (("int4", llama_int4), ("dequant_bf16", llama_deq)):
            cache = llama.init_kv_cache(cfg.llama, b, t, dtype=padded.dtype, device=padded.device)
            with torch.inference_mode():
                first[name], _ = llama.prefill(lp, cfg.llama, padded, mask, cache, last_only=True)
        del llama_deq, cache
        torch.cuda.empty_cache()
        diff = (first["int4"] - first["dequant_bf16"]).abs().max().item()
        finite = bool(torch.isfinite(first["int4"]).all())
        emit("int4_vs_dequant_bf16", {
            "max_abs_logit_diff": diff, "tolerance": INT4_DEQUANT_LOGIT_ATOL,
            "logit_absmax": first["dequant_bf16"].abs().max().item(), "finite": finite,
            "same_greedy_first_token": (first["int4"].argmax(-1)
                                        == first["dequant_bf16"].argmax(-1)).tolist()})
        if not finite or diff > INT4_DEQUANT_LOGIT_ATOL:
            raise AssertionError(f"int4 vs dequantized bf16 prefill logits differ by {diff}")

        # The int8 KV cache against the bf16 one: first decode-step logits,
        # int4 weights on both, at the cache length generate uses.
        max_len = (t + MAX_NEW_TOKENS + 127) // 128 * 128
        step_logits, caches = {}, {}
        tok = first["int4"].argmax(-1)
        for kv_name, kv_quant in (("bf16", False), ("int8", True)):
            cache = llama.init_kv_cache(cfg.llama, b, max_len, dtype=padded.dtype,
                                        device=padded.device, quant=kv_quant)
            with torch.inference_mode():
                llama.prefill(llama_int4, cfg.llama, padded, mask, cache, last_only=True)
                emb = llama.embed_tokens(llama_int4, tok[:, None])
                step_logits[kv_name], caches[kv_name] = llama.decode_step(
                    llama_int4, cfg.llama, emb, cache)
        ref = step_logits["bf16"]
        diff = (step_logits["int8"] - ref).abs().max().item()
        bound = 0.1 * (ref.abs().max().item() + 1)
        emit("kv_int8_vs_bf16", {"max_abs_logit_diff": diff, "bound": bound,
                                 "bound_rule": "0.1 * (max|ref| + 1), tests/test_quant.py",
                                 "same_greedy_token": (step_logits["int8"].argmax(-1)
                                                       == ref.argmax(-1)).tolist()})
        if not math.isfinite(diff) or diff > bound:
            raise AssertionError(f"int8 vs bf16 KV cache step logits differ by {diff} > {bound}")
        del caches["bf16"], step_logits

        # K2 on the int8 cache that the int4 prefill wrote.
        decode_checks = [check_decode_kernel(caches["int8"], li, lengths, seed=20 + li)
                         for li in (0, n_layers - 1)]
        for chk in decode_checks:
            emit("kernel_decode_int8", chk)
        del caches, params_int4, llama_int4, padded, mask
        torch.cuda.empty_cache()

        # 6. --quant int8 --fuse_params, bf16 cache: a short run warms the
        # new GEMM shapes, then the counted run.
        llama_i8 = quant.quantize_llama_params(
            llama.fuse_llama_params(llama.copy_tree(params["llama"])), bits=8)
        params_i8 = {**params, "llama": llama_i8}
        timed_generate(eventchat, params_i8, cfg, ids, pixels, tokenizer, max_new_tokens=2)
        (warm8, ids8), launches8 = counted(lambda: timed_generate(
            eventchat, params_i8, cfg, ids, pixels, tokenizer))
        if launches8[INT4_KERNEL.source] != 0 or launches8[FLASH_KERNEL.source] != n_layers:
            raise AssertionError(f"int8 fused slice: launches {launches8}, want K4 = 0 and "
                                 f"K1 = {n_layers}")
        check_generations("int8", ids8, vocab)
        probe = torch.zeros((1, 8), dtype=torch.bfloat16, device="cuda")
        emit("slice_int8_fused", {
            "flags": "--quant int8 --fuse_params", "run": "warm", **warm8,
            "launches": launches8, "int8_gemm_form": quant.int8_gemm_form(probe),
            "int8_llama_bytes": tree_bytes(llama_i8), "first_ids": [r[:8] for r in ids8],
            "nvidia_smi": smi})
        del params_i8, llama_i8
        torch.cuda.empty_cache()

        # 7. the 7B tree through a checkpoint on disk, then the Q-Former
        # loaded over it; the directory goes when the phases end.
        ckpt = os.path.join(work, "checkpoint_7b")
        try:
            emit("checkpoint_7b", {**checkpoint_7b(
                params, cfg, ckpt, ids, pixels,
                [os.path.join(work, f"events_{i}.npy") for i in range(len(QUERIES))], counted,
                {"slice": digest(out_ids), "slice_int4": digest(ids4)}),
                "cli_subprocess_tiny": cli_subprocess_tiny(work, counted), "nvidia_smi": smi})
            emit("slice_qformer", {**slice_qformer(cfg, ckpt, ids, pixels, counted),
                                   "nvidia_smi": smi})
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
            shutil.rmtree(os.path.join(work, "qformer_7b"), ignore_errors=True)

        # 8. training at 7B width on the bf16 tree: K1's gradient at the
        # first training batch's shape, then stage 1 and stage 2 through
        # cli.train's construction.
        from eventgpt_tpu_torch.train.data import EventChatDataset, batch_iterator

        train_paths = write_train_set(work)
        first = next(batch_iterator(
            EventChatDataset(train_paths["data_path"], tokenizer, cfg,
                             event_folder=train_paths["event_folder"]),
            TRAIN_BATCH, cfg, seed=0))
        grad_check = check_flash_grad([int(n) for n in first["attn_mask"].sum(1)],
                                      int(first["attn_mask"].shape[1]), seed=40)
        emit("kernel_flash_grad", {**grad_check, "nvidia_smi": smi})
        train_runs = {}
        for stage in (1, 2):
            train_runs[stage] = train_7b(stage, params, cfg, tokenizer, train_paths, work,
                                         profile_dir=args.profile)
            emit(f"train_stage{stage}_7b", {**train_runs[stage], "nvidia_smi": smi})
        del params
        torch.cuda.empty_cache()

        emit("tiny_card_vs_cpu", tiny_card_matches_cpu(os.path.join(work, "events_0.npy")))
        emit("tiny_quant_card_vs_cpu",
             tiny_quant_card_matches_cpu(os.path.join(work, "events_1.npy")))
        emit("tiny_variants_card_vs_cpu",
             tiny_variants_card_vs_cpu(os.path.join(work, "events_2.npy")))
        emit("tiny_serve_card_vs_cpu", tiny_serve_card_matches_cpu(work))
        emit("tiny_checkpoint_card_vs_cpu", tiny_checkpoint_card_vs_cpu(work))
        emit("serve_http_tiny", serve_http_tiny(work))
        emit("train_tiny_card_vs_cpu", train_tiny_card_vs_cpu(work, train_paths))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 8. the kernel table, the card, the result. K4's numbers are one 7B
    # decode step's 225 launches at M = 4, and its prefill_* numbers the
    # prefill forward's launches at M = B * T, as counted by shape in
    # slice_int4 (224); K2 and K3 are on no main path (decode reads the int8
    # cache densely, or through the gathered block table, as in the JAX
    # package).
    step = {key: sum(INT4_LAUNCHES_PER_STEP[sh] * int4_checks[sh][key]
                     for sh in INT4_DECODE_SHAPES)
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    prefill = {key: sum(launches_kn * int4_checks[(m_prefill, *kn)][key]
                        for kn, launches_kn in prefill4.items())
               for key in ("ms", "bound_ms", "library_ms")}
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd_bf16",
        "route": "cuda",
        "source": "eventgpt_tpu_torch/csrc/flash_attention.cu",
        "replaces": "eventgpt_tpu/ops/flash_attention.py:29",
        "launches": launches[FLASH_KERNEL.source],
        "max_abs_err": max(c["max_abs_err"] for c in flash_checks),
        "ms": main_check["ms"],
        "plain_ms": main_check["plain_ms"],
        "bound_ms": main_check["bound_ms"],
        "bound_by": main_check["bound_by"],
        "library_ms": main_check["library_ms"],
        "launches_by_path": {"slice": launches[FLASH_KERNEL.source],
                             "slice_int4": launches4[FLASH_KERNEL.source],
                             **{name: n[FLASH_KERNEL.source]
                                for name, n in variant_launches.items()},
                             **{f"train_stage{st}": run["k1_launches"]
                                for st, run in train_runs.items()},
                             **{f"train_stage{st}_eval": run["eval"]["k1_inference"]
                                for st, run in train_runs.items()}},
        "train_launches_by_path": {f"train_stage{st}": run["k1_by_path"]
                                   for st, run in train_runs.items()},
        "train_launches_per_micro_step": {f"train_stage{st}": run["k1_launches_per_micro_step"]
                                          for st, run in train_runs.items()},
        "backward": "plain torch (eventgpt_tpu_torch/ops/flash_attention.py"
                    ":flash_attention_backward)",
        "backward_calls_per_micro_step": {f"train_stage{st}": run["k1_backward_per_micro_step"]
                                          for st, run in train_runs.items()},
        "backward_shape": [grad_check["B"], grad_check["S"], grad_check["H"], grad_check["hd"]],
        "backward_ms": grad_check["backward_ms"],
        "backward_bound_ms": grad_check["backward_bound_ms"],
        "backward_bound_by": grad_check["backward_bound_by"],
        "backward_library_ms": grad_check["sdpa_backward_ms"],
        "forward_ms_at_backward_shape": grad_check["forward_ms"],
        **({"baseline_ms": main_check["baseline_ms"]} if flash_base else {}),
    }, {
        "name": "int4_matmul",
        "route": "cuda",
        "source": "eventgpt_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "eventgpt_tpu/ops/int4_matmul.py:36",
        "launches": launches4[INT4_KERNEL.source],
        "max_abs_err": max(c["max_abs_err"] for c in int4_checks.values()),
        "ms": step["ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": "bytes",
        "library_ms": step["library_ms"],
        "prefill_ms": prefill["ms"],
        "prefill_bound_ms": prefill["bound_ms"],
        "prefill_library_ms": prefill["library_ms"],
        "prefill_launches": sum(prefill4.values()),
        "launches_by_path": {"slice_int4": launches4[INT4_KERNEL.source],
                             **{name: n[INT4_KERNEL.source]
                                for name, n in variant_launches.items()}},
        "slice_spec_int4_launches_by_path_m": {f"{p} M={m}": c
                                               for (p, m), c in sorted(spec_by_m4.items())},
        **({"baseline_ms": sum(INT4_LAUNCHES_PER_STEP[sh] * int4_checks[sh]["baseline_ms"]
                               for sh in INT4_DECODE_SHAPES)} if baseline else {}),
    }, {
        "name": "decode_attention_int8",
        "route": "cuda",
        "source": "eventgpt_tpu_torch/csrc/decode_attention.cu",
        "replaces": "eventgpt_tpu/ops/decode_attention.py:50",
        "launches": launches4[DECODE_INT8_KERNEL.source],
        "max_abs_err": max(c["max_abs_err"] for c in decode_checks),
        "ms": decode_checks[0]["ms"],
        "plain_ms": decode_checks[0]["plain_ms"],
        "bound_ms": decode_checks[0]["bound_ms"],
        "bound_by": decode_checks[0]["bound_by"],
        "library_ms": decode_checks[0]["library_ms"],
    }, {
        "name": "decode_attention_int8_paged",
        "route": "cuda",
        "source": "eventgpt_tpu_torch/csrc/paged_attention.cu",
        "replaces": "eventgpt_tpu/ops/decode_attention.py:176",
        "launches": serve_launches[PAGED_INT8_KERNEL.source],
        "max_abs_err": paged_check["max_abs_err"],
        "ms": paged_check["ms"],
        "plain_ms": paged_check["plain_ms"],
        "bound_ms": paged_check["bound_ms"],
        "bound_by": paged_check["bound_by"],
        "library_ms": paged_check["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
