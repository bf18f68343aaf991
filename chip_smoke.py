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
                   and at the speculative server's M (8, 16: a verify of
                   4 rows; 32: a lane) with each M's time per 7B forward;
                   with ``--int4_baseline``
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
                   64 and 65. These three run the synchronous scheduler
                   without the prefix cache or lanes. ``serve_defaults_*``:
                   the served path at the JAX CLI's defaults (pipelined,
                   prefix cache 512 MiB, prefill_budget = chunk), built by
                   ``cli/serve.make_batcher``, paged then dense, budgets 48,
                   16, 16, 16 and the last two requests submitted after the
                   first harvest; also with ``--prefix_cache_mb 0`` (the
                   late requests hit requests 1 and 2's event heads and
                   join as suffix lanes), with ``--first_chunk 4``, and the
                   synchronous, cache-off, lane-off oracle. Per run: TTFT,
                   latency, tok/s, decode ms per step, overlap ratio, hits,
                   lanes, copy-on-write copies, K1 launches (32 per
                   full-prefill dispatch), peak memory, and each chain held
                   to the oracle's by ``chain_rule``. ``serve_spec_*``: the
                   same traffic and defaults with ``--speculative 4``
                   (paged, dense), ``--spec_buckets 0,2,4`` (paged, dense),
                   ``--speculative 4 --draft_head`` (a saved random 3-head
                   stack at 7B width, dense) and ``--speculative 4
                   --warmup`` (dense; warmup seconds and request 1's TTFT
                   against the cold lookup run), each held to its layout's
                   oracle: tokens per verify iteration, the chosen windows,
                   decode ms per committed token, TTFT, K1 launches;
                   every served run counts the decode steps and verifies
                   run with no live row (``idle_steps``/``idle_verifies``,
                   beside the count recorded before the repair) and fails if one
                   ran at a lane-only boundary or if a transition to all
                   frozen added more than one;
                   after ``slice_spec_int4``, ``serve_spec_int4``
                   (``--quant int4 --speculative 4``, dense) against an int4
                   oracle, with K4 launches by (path, M).
                   ``kernel_flash_preempt_shapes`` holds K1 against its
                   plain version at the admission wave of the two batch
                   requests (B = 2) and at one request's full prefill (B =
                   1), each padded to its prompt bucket;
                   ``serve_preempt_7b_*``: 3 rows on a 40-block pool, two
                   batch requests (128 tokens) and, after the first harvest,
                   an interactive one (16 tokens) that the free blocks
                   cannot cover: preemption off (it defers), ``--preempt
                   --spill_capacity_mb 1024`` (the victim's run spills to
                   pinned host memory and restores) and ``--spill_capacity_mb
                   0`` (drop and re-prefill), each held to the requests run
                   alone (``chain_rule``): preemptions, spills, restores,
                   deferrals, the gather's bytes, copy and allocation ms
                   and GB/s, restore ms, each victim's way back, TTFT,
                   latency, ``slo_stats()``, and the pool clean after the
                   drain. ``serve_handoff_7b_*``: a prefill-role and a
                   decode-role batcher over the same tree, the four
                   requests gathered, spliced and drained, plain and with
                   ``--speculative 4``, against the colocated run: shipped
                   blocks and bytes, gather and splice ms, the rebased
                   TTFT, both pools clean. ``serve_fleet_7b``:
                   ``cli/serve --fleet 2`` (``make_engine``: two replicas
                   over the tree) and one engine, each given the four
                   requests, then streams 100 and 101 again as repeated
                   sessions: routing, each repeat pinned to its first
                   request's replica and hitting its prefix cache, prefix
                   hits and K1 launches by replica (counted by the
                   launching thread, 32 per full prefill), TTFT and wall
                   against one engine, chains held to the oracle.
                   ``serve_fleet_chaos_7b_lanes``: a replica killed
                   mid-decode by ``fleet.replica_kill``, its requests
                   drained and re-decoded on the survivor (the moved
                   requests, the survivor's K1 after the kill, the time
                   from the kill to each one's first token), pools clean,
                   the replica restarted and given a new session.
                   ``serve_breaker_7b``: ``serve.dispatch`` faults with
                   the pipeline on, the breaker opened (``/health`` and a
                   POST 503 with Retry-After) and closed by a clean request
                   after the cooldown. These two run while
                   ``train_mesh_7b``'s ranks load and step, on the same
                   card (their times are then shared; see PERF.md).
                   ``handoff_wire_7b``: the plain handoff records
                   through ``rpc.dumps_frame``/``loads_frame`` (bytes, ms to
                   encode and to decode) and spliced to the in-process
                   chains;
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
                   as a subprocess prints the answer and token count of an
                   in-process batch-1 ``generate`` over a tiny bf16
                   checkpoint whose every generated id is one printable
                   character (``cli_subprocess_tiny``; the 7B run of it left
                   where ``eval_mesh_7b`` starts a 7B CLI from
                   the directory). ``slice_qformer``: a
                   seeded Q-Former at 7B width (32 queries, 2 layers, d =
                   4096) saved as component files and loaded over the same
                   directory with ``--use_event_qformer
                   --pretrain_query_embedder --pretrain_attention_layers``;
                   the four requests run on 32 event tokens each, cold then
                   warm. ``serve_telemetry_7b``: ``python -m
                   eventgpt_tpu_torch.cli.serve`` over the directory as a
                   subprocess (paged int8 KV, 4 rows, chunk 32, the JAX CLI's
                   telemetry defaults), two runs one at a time on
                   ``serve_defaults``' six requests over HTTP: armed, and
                   armed with the headroom guard set
                   under the ledger's total and a 2 s ``POST /profile``
                   over the first requests (after ``--warmup``); each run's
                   chains held to the oracle, ``/metrics``
                   counts, journeys whose phases sum to their latency, one
                   queued/active trace pair per request, the ``--trace_out``
                   file, the ledger's reconciliation (at least 0.9 of the
                   process's allocated bytes), the guard's deferrals, K1 by
                   name in the capture; the wall and decode ms per step of
                   each run side by side; the four posted at once admitted
                   as one wave of four rows (the idle engine gathers them).
                   Process fleets over the same directory:
                   ``serve_procfleet_7b`` (``cli/serve --proc_fleet 2``
                   with ``serve_fleet_7b``'s flags and traffic: two worker
                   processes loading the checkpoint onto the card, routing
                   and affinity hits, K1 by worker from each worker's
                   ``stats`` op, boot, wall, TTFTs and decode ms per step
                   against this call's one engine and ``--fleet 2``, the
                   card's used memory and each worker's peak),
                   ``serve_procfleet_chaos_7b`` (the same fleet, the four
                   of 64 tokens, the busiest worker SIGKILLed by
                   ``procfleet.worker_kill`` mid-decode, its requests
                   redone on the survivor, kill to first token, the
                   respawn's boot and a new session on it) and
                   ``serve_disagg_7b`` (``--proc_fleet_roles 1:1``: the
                   records cross as runs of capped frames, bytes and
                   frames per message, ``handoff_s`` per record, the
                   rebased TTFT, K1 on the prefill worker only, both
                   pools clean), each held to its oracle. While the
                   workers are up the script's tree waits on the host,
                   after a garbage collection (the bytes it held before
                   and after each are printed); each oracle runs before
                   the spawn and the chains are held to it after the
                   shutdown. The directory is deleted when the phases end;
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
                   2 optimizer steps of batch 2 under full remat (K1 64
                   launches and 32 backward calls per micro-step), then
                   ``evaluate`` on 2 entries (K1 32), check that every
                   trainable moved and sampled frozen leaves did not, merge
                   ``lora_last.npz`` through ``merge_lora``, and hold a
                   fresh trainer's resumed step against the same step in
                   memory; with ``--profile``, one more step profiled;
                   ``train_remat_7b``: one stage-2 micro-step under the
                   remat policies full and ``dots_saveable``: equal loss and
                   gradient norm, K1 64 launches each, peak memory and ms;
                   ``train_mesh_7b``: ``cli.train`` under ``python -m
                   torch.distributed.run`` on two ranks of the card (gloo)
                   over ``checkpoint_7b``, ``--mesh_context 2 --attn_impl
                   ulysses``, ``train_stage2_7b``'s data and flags: per rank
                   K1 64 a micro-step over 16 heads and 32 backward calls,
                   collectives, peak memory, step ms; step 1's loss and the
                   gradient norms held to ``train_stage2_7b``'s, rank 0
                   alone writing the files (its world runs inside phase 7,
                   beside ``serve_fleet_chaos_7b`` and ``serve_breaker_7b``);
                   ``medusa_train_7b``: 8 Medusa-head steps (3 heads, batch
                   2) on the motion corpus through ``scripts/train_medusa``'s
                   functions (K1 held against its plain version at the
                   batch's shape first, then 32 forward launches a step, no
                   backward), again at lr 1e-4 where every head's loss must
                   fall, the step split into the hidden forward and the
                   heads' loss + backward + update, only the stack moving,
                   the heads' gradient held against finite differences of
                   the loss and the loss after one Adam step of each LR; the
                   saved stack serves the held-out requests with
                   ``--speculative 4 --draft_head`` against the oracle, and
                   the script runs 2 steps on a tiny model in a subprocess;
9. tiny_*       -- tiny models give the same greedy chain on the card as on
                   the CPU, bf16-free f32, with int4 + int8 KV + fused (its
                   chain's sha256 printed), beam (k = 2, 3), speculative
                   (window 1, 2, 4) and Medusa chains, served paged with the int8
                   cache, served with the scheduler defaults (pipelined,
                   prefix hits, suffix and full lanes; dense f32 and paged
                   int8), served speculatively (lookup, adaptive and
                   Medusa; ``tiny_serve_spec_card_vs_cpu``), and loaded
                   from a checkpoint the port wrote
                   (plain and with a gated Q-Former);
                   ``serve_http_tiny`` runs ``cli/serve.build_server`` on the
                   card over a tiny bf16 checkpoint (``--model_path DIR``,
                   prefill through K1) and answers three POST /v1/generate
                   (the third SLO-classed, scored in GET /stats);
                   ``tiny_preempt_card_vs_cpu``: the CPU tests' preemption
                   scenario (spill forced, f32 and int8 KV; drop) gives
                   the same chains and counters on the card;
                   ``tiny_fleet_card_vs_cpu``: the same fleet traffic and
                   kill, with identical routing and chains on both;
                   ``tiny_procfleet_card_vs_cpu``: tiny ``--proc_fleet 2``
                   workers on the card and on the CPU, identical routing
                   and chains; ``tiny_telemetry_card_vs_cpu``: the tiny
                   server at the scheduler defaults with journeys armed,
                   the same chains, journey event kinds and serving
                   counters on both;
                   ``train_tiny_card_vs_cpu``: one f32 stage-1 and stage-2
                   step agree on the card and the CPU, and ``cli.train``
                   trains 2 steps on the card in a subprocess;
                   ``tiny_medusa_card_vs_cpu``: ``medusa_loss``, its
                   gradient and one head step agree on the card and the
                   CPU; ``medusa_acceptance_tiny``: the acceptance study at
                   the JAX gate's scale on the card, held to the JAX
                   gate's bars (random heads 1.0 +- 0.15 tokens an
                   iteration, trained heads above 1.5 and random + 0.5,
                   one chain across the three drafts);
                   ``tiny_mesh_card_vs_cpu``: a world of two ranks on the
                   card (gloo) against the same world on the CPU over a tiny
                   bf16 checkpoint with ``--quant int4 --kv_cache int8`` at
                   meshes model 2 and fsdp 2: equal chains, prefill logits
                   within MESH_TINY_LOGIT_ATOL, K4 launched on every shard,
                   and on the model-2 mesh the batcher's features
                   (``tiny_mesh_serve_numbers``): preemption spilled and
                   dropped with a planted clock jump on rank 1, a prefill
                   role on the mesh spliced into a one-device decode
                   batcher, and ``make_engine``'s ``--fleet 2`` with a
                   replica killed mid-decode, equal on card and CPU;
                   beside them one rank over NCCL (world-group collectives
                   on the card); the worlds run at once, beside the other
                   tiny phases; ``tiny_train_mesh_card_vs_cpu``: a world of
                   two on the card against the CPU's, two training steps at
                   fsdp 2 (stages 1, 2), model 2, ring and Ulysses (losses,
                   gradient norms and each leaf's update within their bars,
                   K1 on the card's ranks), and a planted control that must
                   fail the update bar; then ``multiproc_dryrun_card``:
                   ``python -m eventgpt_tpu_torch.parallel.multiproc`` at
                   its defaults (two workers and the reference on the
                   card); both beside the other tiny phases;
    serving mesh -- inside phase 7, after ``serve_telemetry_7b``, two ranks of
                   the one card under ``python -m torch.distributed.run``
                   over gloo, each holding half of every LLaMA matmul (16
                   of the 32 heads) and the whole vision side:
                   ``eval_mesh_7b`` (``cli/eval --mesh_model 2`` on
                   ``eval_7b``'s batch; chains held to ``slice``'s by
                   ``chain_rule``; per rank K1 32, peak memory, backend,
                   collectives a decode step, load / prefill / decode s) and
                   ``serve_mesh_7b`` (``cli/serve --mesh_model 2``, rank 0
                   serving ``telemetry_requests()``' six over HTTP, rank 1
                   following; chains held to the telemetry oracle, the pool
                   clean, TTFTs, K1 per rank, the follower's steps equal
                   rank 0's, no agreed decision). ``serve_mesh_preempt_7b``
                   (``cli/serve --mesh_model 2 --fleet 2``, each replica
                   ``serve_preempt_7b``'s spill arm with the headroom
                   guard and a far deadline armed; the two sessions of its
                   three requests on different replicas; the six chains
                   held to its oracle, spills and restores on both
                   replicas and ranks, the followers' steps, pools clean,
                   K1 per rank and replica, peak memory, collectives and
                   agreements a decode step) starts at the end of phase 7
                   and runs beside phase 8 and the tiny phases when the
                   card has the room. The ``--no_telemetry`` server of
                   ``serve_telemetry_7b``, the spill-without-lanes arm of
                   ``serve_preempt_7b``, the by-waves arm of
                   ``serve_fleet_chaos_7b``, the paged lookup and adaptive
                   and the dense Medusa runs of ``serve_spec``, the dense
                   defaults, unbounded-cache and first-chunk runs of
                   ``serve_defaults`` and the 7B infer CLI subprocess left
                   the run to pay for these;
10. kernels     -- one JSON line per the kernel table (K4 with one decode
                   step's and one prefill forward's launches; K1 with its
                   training and head-training launches by path and its
                   backward's numbers),
                   then the card's name
                   and power limit, then the result line.

Every line carries the script's memory ledger total beside
``torch.cuda.memory_allocated``; the run fails at its end if the ledger
passed the card's bytes at any line. Any failure raises and exits
non-zero. Without a CUDA card it exits non-zero before printing any
result.
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
# The scheduler of the first serve phases: synchronous, no prefix cache,
# no piggyback lanes (the JAX CLI's defaults are the serve_defaults phase).
SYNC_NO_CACHE = {"pipeline": False, "prefix_cache": False, "prefill_budget": 0}
# serve_defaults: the first four requests' budgets (the last two keep
# SERVE_EXTRA's), and the configurations, as cli/serve flags over
# "--max_batch 4 --max_len 1024 --chunk 32 --kv_cache int8". The last is
# the oracle the others' chains are held to. On the paged layout the
# unbounded run gets a pool twice the default, so that the gate's
# reclaim does not evict the entries the late requests hit.
SERVE_DEFAULTS_BUDGETS = (48, 16, 16, 16)
SERVE_DEFAULTS_CONFIGS = [
    ("defaults", []),
    ("unbounded_cache", ["--prefix_cache_mb", "0"]),
    ("first_chunk_4", ["--first_chunk", "4"]),
    ("oracle", ["--no_pipeline", "--no_prefix_cache", "--prefill_budget", "0"]),
]
UNBOUNDED_PAGED_POOL = ["--kv_pool_blocks", "129"]
# The dense layout runs its oracle only (serve_spec's dense runs are held to
# it): its defaults, unbounded-cache and first-chunk runs, the paged runs'
# layout twins, left the run to pay for the serving mesh's phases.
DENSE_DEFAULTS_SKIPPED = ("defaults", "unbounded_cache", "first_chunk_4")
# serve_spec: (layout, kind, cli/serve flags over serve_defaults' base
# flags); HEADS stands for the saved 7B-width Medusa stack. The warmup run
# is the dense lookup server warmed first. (The paged lookup and adaptive
# runs, the dense ones' layout twins, and the dense Medusa run, which
# medusa_train_7b repeats with its trained stack, left the run to pay for
# the serving mesh; tiny_serve_spec_card_vs_cpu serves paged.)
SERVE_SPEC_CONFIGS = [
    ("dense", "lookup", ["--speculative", "4"]),
    ("dense", "adaptive", ["--spec_buckets", "0,2,4"]),
    ("dense", "warmup", ["--speculative", "4", "--warmup"]),
]
# The lane chunk of the 7B runs (prefill_budget = chunk = 32): the window
# of the decode_kstep-vs-decode_step gap chain_rule measures.
SERVE_KSTEP_WINDOW = 32
# K4 launches per 7B decode step at each decode shape: q, k, v, o; gate,
# up; down; lm_head, in each of 32 layers but the last.
INT4_LAUNCHES_PER_STEP = {(4, 4096, 4096): 128, (4, 4096, 11008): 64,
                          (4, 11008, 4096): 32, (4, 4096, 32000): 1}
# The speculative phases' verify window (4 requests x 4 = M 16, K4's decode
# path under int4), the Medusa phase's head count and the beam width.
SPEC_WINDOW, MEDUSA_HEADS, BEAMS = 4, 3, 4
# K4's M on the speculative server: a verify of 4 rows x window 2 or 4
# (the decode path), one lane of 32 prompt tokens (the prefill path).
SPEC_K4_M = (8, 16, 32)
# decode_kstep vs sequential decode_step logits after 32 bf16 layers: the
# same arithmetic, but each weight product runs at M = B * window instead of
# M = B (another GEMM tiling, so another f32 summation order before the bf16
# rounding of its output) and attention multiplies W query rows at once.
# One bf16 rounding flip per layer (flash vs dense) gave 0.079 at |logits|
# 4.3 on an H100; seven products per layer are the int4-vs-dequantized
# case's seven roundings, hence its bar.
KSTEP_LOGIT_ATOL = 0.5
# Toy QA set of the training phases: 8 entries over streams of seeds
# 100-107, byte-tokenizer v1 dialogs; the 7B phases take TRAIN_STEPS
# optimizer steps of 2 entries, then evaluate on 2 (4 steps before the
# training mesh's phases, whose oracle is those first steps).
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
TRAIN_STEPS, TRAIN_BATCH = 2, 2
# K1 launches per training micro-step under full remat: the forward and the
# recompute of each of 32 layers; the backward runs once per layer.
K1_PER_MICRO, K1_BACKWARD_PER_MICRO = 64, 32
# stream_7b: the window of the stream script, and the shift between the
# four streams in the one structured stream it replays.
STREAM_WINDOW_US = 50_000
# train_remat_7b's policies, full remat first (what the other equals);
# dots_with_no_batch_dims_saveable, a subset of dots_saveable's saves, left
# for the CPU test (tests/test_torch_remat.py) to pay for train_mesh_7b.
REMAT_POLICIES = ("full", "dots_saveable")
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
# The verifies before the repair, as PERF.md records them: (with no live
# row, run), on the same traffic and flags.
# serve_preempt_7b: two batch requests (streams 100, 101) of
# PREEMPT_BATCH_BUDGET tokens reserve 15-16 blocks each of a pool of
# PREEMPT_POOL_BLOCKS (the scratch block included; one block of 64 int8
# positions is 17.3 MB at 7B); after the first harvest an interactive one
# (stream 102, PREEMPT_INTER_BUDGET tokens) needs 14 of the 7-8 free. Each
# arm is PREEMPT_FLAGS (3 rows, the JAX CLI's scheduler defaults) plus its
# own.
PREEMPT_POOL_BLOCKS = 40
PREEMPT_BATCH_BUDGET = 128
PREEMPT_INTER_BUDGET = 16
PREEMPT_BATCH_LATENCY_S = 30.0
PREEMPT_INTER_TTFT_S = 1.0
PREEMPT_INTER_ITL_S = 0.25
PREEMPT_FLAGS = ["--max_batch", "3", "--max_len", "1024", "--chunk", "32", "--kv_cache",
                 "int8", "--kv_layout", "paged"]
PREEMPT_ARMS = [
    ("preempt_off", ["--kv_pool_blocks", str(PREEMPT_POOL_BLOCKS)]),
    ("spill", ["--kv_pool_blocks", str(PREEMPT_POOL_BLOCKS), "--preempt",
               "--spill_capacity_mb", "1024"]),
    ("drop", ["--kv_pool_blocks", str(PREEMPT_POOL_BLOCKS), "--preempt",
              "--spill_capacity_mb", "0"]),
]
# (The spill arm without lanes, a repeat of "spill" with exclusive admission,
# left the run to pay for the serving mesh's phases.)
IDLE_VERIFIES_BEFORE_REPAIR = {"serve_spec_paged_lookup": (46, 68),
                               "serve_spec_dense_lookup": (46, 68),
                               "serve_spec_paged_adaptive": (46, 68),
                               "serve_spec_dense_adaptive": (46, 68),
                               "serve_spec_dense_medusa": (42, 119),
                               "serve_spec_warmup": (46, 68), "serve_spec_int4": (46, 72)}
# medusa_train_7b: the motion corpus' size, the head steps, their batch,
# the heads and the LR; then the 4 held-out requests served with the saved
# stack, MEDUSA_SERVE_BUDGET tokens each.
MEDUSA_CORPUS = (16, 4)
MEDUSA_STEPS, MEDUSA_BATCH, MEDUSA_LR = 8, 2, 1e-3
# The same steps again at a tenth of the LR, where each head's loss must
# fall over the steps.
MEDUSA_LR_LOW = 1e-4
# The heads' gradient at 7B width on the first batch, f32: the central
# difference of the loss with step MEDUSA_FD_EPS along a direction agrees
# with autograd's directional derivative within MEDUSA_FD_RTOL; then the
# loss after one Adam step of each LR in MEDUSA_LINE_LRS from the zero stack.
MEDUSA_FD_EPS, MEDUSA_FD_RTOL = 1e-5, 1e-2
# ... and the training dtype's gradient (bf16 products) points where the f32
# one does.
MEDUSA_GRAD_COS = 0.99
MEDUSA_LINE_LRS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3)
MEDUSA_SERVE_BUDGET = 24
# The tiny f32 head step on the card vs the CPU (TF32 off): the same f32
# products summed in another order; the loss, its gradient and the first
# Adam step of a zero stack (each entry moves by ~lr * sign(g)).
TINY_MEDUSA_ATOL = 1e-5
# medusa_acceptance_tiny: the JAX gate's scale and bars
# (tests/test_medusa_acceptance.py): random heads commit ~1 token an
# iteration, trained heads decisively more.
ACCEPTANCE_ARGS = ["--n_train", "48", "--n_eval", "8", "--finetune_steps", "200",
                   "--medusa_steps", "200", "--budget", "40"]
ACCEPTANCE_RANDOM, ACCEPTANCE_RANDOM_TOL = 1.0, 0.15
ACCEPTANCE_TRAINED_MIN, ACCEPTANCE_TRAINED_OVER_RANDOM = 1.5, 0.5


# Shards of the 7B checkpoint that checkpoint_7b writes (~3.5 GB each).
CKPT_SHARDS = 4
# K4 launches per 7B prefill forward at M = B*T, by (K, N): gate, up;
# down; q, k, v, o, in each of 32 layers (lm_head runs on the last
# position only, at M = B).
INT4_PREFILL_LAUNCHES = {(4096, 11008): 64, (11008, 4096): 32, (4096, 4096): 128}


_T_START = time.perf_counter()
# (line, ledger bytes, allocated bytes) wherever the script's memory ledger
# passed the card's allocated bytes: the run fails at its end if any.
LEDGER_OVER = []


def _ledger_vs_card(phase: str) -> dict:
    """The script's memory ledger total beside ``torch.cuda.memory_allocated``
    (once the card is in use). A dropped batcher in a reference cycle lets go
    of its entries when it is collected, so an excess is read again after a
    collection before it counts."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    from eventgpt_tpu_torch.obs.memory import LEDGER

    total, alloc = LEDGER.total(), torch.cuda.memory_allocated()
    if total > alloc:
        import gc

        gc.collect()
        total, alloc = LEDGER.total(), torch.cuda.memory_allocated()
        if total > alloc:
            LEDGER_OVER.append((phase, total, alloc))
    return {"script_ledger_bytes": total, "script_allocated_bytes": alloc}


def emit(phase: str, payload: dict) -> None:
    """One phase's line; ``t_s`` is the script's wall seconds at the line
    (the run's time budget read phase by phase), and the script's memory
    ledger beside the card's allocated bytes."""
    line = {**payload, **_ledger_vs_card(phase), "t_s": time.perf_counter() - _T_START}
    print(f"{phase}: {json.dumps(line)}", flush=True)


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


def check_flash_kernel(lengths, seed: int, baseline=None, s=None) -> dict:
    """K1 against its plain version at (B, S) = (len(lengths), ``s`` or
    max(lengths)), 32 heads of 128, bf16, right padding; returns error and
    times. A
    ``baseline`` kernel (``baseline_kernel``) runs through the same wrapper
    on the same inputs: its difference from K1 and its time, timed in turns
    with K1."""
    import torch
    import torch.nn.functional as F

    from eventgpt_tpu_torch.ops import flash_attention as fa

    b, s, h, hd = len(lengths), s or max(lengths), 32, 128
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
                                kv_layout=kv_layout, **SYNC_NO_CACHE)
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
        "prefill_dispatches": batcher.prefill_dispatches, "segments": batcher.seg_count,
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
                            kv_layout="paged", **SYNC_NO_CACHE)
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


def serve_defaults_requests(requests):
    """serve_defaults' six requests: the first four with budgets 48, 16,
    16, 16, then SERVE_EXTRA's two (stream 0 with query 3 and stream 1 with
    query 2, 16 tokens each: the streams and system text of requests 1 and
    2, so their event-block heads are prefix-cache hits)."""
    return ([(i, px, n) for (i, px, _), n in zip(requests, SERVE_DEFAULTS_BUDGETS)]
            + list(requests[len(QUERIES):]))


class IdleTally:
    """What the bar on steps run with no live row reads from a served run:
    the lane-only boundaries (every row frozen in the host mirror, lanes
    still filling, nothing queued) and those at which a decode step or a
    verify ran (must be 0), and the harvests that turned the mirror all
    frozen (the transitions; each may add at most one idle step or verify:
    the stop rule's step past the last live one, or, pipelined, the first
    step of the next segment on a carry the host did not yet know to be
    all frozen)."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.lane_only = self.lane_only_ran = self.transitions = 0
        harvest = batcher._harvest_segment

        def counted_harvest(rec):
            before = bool(batcher.frozen.all())
            harvest(rec)
            self.transitions += (not before) and bool(batcher.frozen.all())

        batcher._harvest_segment = counted_harvest

    def step(self) -> None:
        b = self.batcher
        lane_only = bool(b.frozen.all() and b._lanes and not b.queue
                         and all(x.filled < x.prompt_len for x in b._lanes))
        before = b.decode_steps_run
        b.step()
        if lane_only:
            self.lane_only += 1
            self.lane_only_ran += b.decode_steps_run > before

    def numbers(self, name: str) -> dict:
        b = self.batcher
        idle = b.idle_verifies if b.speculative else b.idle_steps
        out = {"idle_steps": b.idle_steps, "idle_verifies": b.idle_verifies,
               "steps_run": b.decode_steps_run, "lane_only_boundaries": self.lane_only,
               "lane_only_boundaries_that_ran": self.lane_only_ran,
               "transitions_to_all_frozen": self.transitions}
        if self.lane_only_ran or idle > self.transitions:
            raise AssertionError(f"{name}: steps run with no live row: {out}")
        return out


def serve_defaults_run(params, cfg, tokenizer, requests, layout: str, flags) -> tuple:
    """One configuration of ``serve_defaults`` (or ``serve_spec``): the
    batcher that ``cli/serve`` builds from ``flags`` (``make_batcher``,
    then ``warmup()`` under ``--warmup``, as ``build_engine`` does),
    stepped in this thread as the ServingEngine's loop steps it, so that
    the late submission is deterministic. The first four requests are
    queued before the first step (one admission wave); the last two are
    submitted right after the first harvest, while row 0 still decodes.
    After the drain only prefix entries may hold blocks, and none after
    ``reset_prefix_cache()``. Returns (numbers, chains in request order)."""
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    args = cli_serve.build_parser().parse_args(
        ["--max_batch", "4", "--max_len", "1024", "--chunk", "32", "--kv_cache", "int8",
         "--kv_layout", layout] + list(flags))
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    batcher = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda")
    warm = None
    if args.warmup:
        k1_before = FLASH_KERNEL.launches
        t0 = time.perf_counter()
        warm = {"functions": batcher.warmup(), "seconds": time.perf_counter() - t0}
        warm["k1_launches"] = FLASH_KERNEL.launches - k1_before
    build_s = time.perf_counter() - t_build
    tally = IdleTally(batcher)
    rids = [batcher.submit(i, px, n) for i, px, n in requests[:len(QUERIES)]]
    t0 = time.perf_counter()
    while batcher.decode_steps == 0:  # until the first harvest
        tally.step()
    t_late = time.perf_counter() - t0
    rids += [batcher.submit(i, px, n) for i, px, n in requests[len(QUERIES):]]
    while batcher.queue or any(r is not None for r in batcher.rows):
        tally.step()
    batcher._drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chains = [batcher.finished[r] for r in rids]
    statuses = [batcher.finish_status[r] for r in rids]
    if statuses != ["ok"] * len(rids):
        raise AssertionError(f"serve_defaults {layout} {flags}: statuses {statuses}")
    from eventgpt_tpu_torch.models.eventchat import _vocab_size

    vocab = _vocab_size(params)
    if any(len(c) != n or any(not 0 <= t < vocab for t in c)
           for c, (_, _, n) in zip(chains, requests)):
        raise AssertionError(f"serve_defaults {layout} {flags}: malformed chains")
    stats = [batcher.request_stats[r] for r in rids]
    pc = batcher.prefix_cache_stats()
    out = {
        "flags": " ".join(flags), "kv_layout": layout, "pipeline": batcher.pipeline,
        "prefix_cache_budget_bytes": pc.get("budget_bytes"),
        "prefill_budget": batcher.prefill_budget, "lane_chunk": batcher._lane_chunk,
        "lane_cap": batcher._lane_cap, "first_chunk": batcher.first_chunk,
        "late_submit_s": t_late, "wall_s": wall, "generated_tokens": [len(c) for c in chains],
        "batch_tok_s": sum(len(c) for c in chains) / wall,
        "ttft_s": [st["ttft_s"] for st in stats], "latency_s": [st["latency_s"] for st in stats],
        "admission_s": batcher.admission_s, "admission_max_s": batcher.admission_max_s,
        "decode_s": batcher.decode_s, "decode_steps": batcher.decode_steps,
        "decode_steps_run": batcher.decode_steps_run, "segments": batcher.seg_count,
        "decode_ms_per_step": batcher.decode_s * 1e3 / max(batcher.decode_steps, 1),
        "decode_ms_per_step_run": batcher.decode_s * 1e3 / max(batcher.decode_steps_run, 1),
        "overlap_ratio": batcher.overlap_ratio(), "host_gap_s": batcher.host_gap_s,
        "overlap_hidden_s": batcher.overlap_hidden_s,
        "device_segment_s": batcher.device_segment_s, "carry_uploads": batcher.carry_uploads,
        "dispatches": dict(batcher.dispatches),
        "prefix_hits": pc.get("hits", 0), "prefix_misses": pc.get("misses", 0),
        "prefix_evictions": pc.get("evictions", 0), "prefix_entries": pc.get("n_entries", 0),
        "prefix_bytes": pc.get("bytes", 0),
        "lanes_started": dict(batcher.lanes_started), "mixed_segments": batcher.mixed_segments,
        "mixed_boundaries": batcher.mixed_boundaries,
        "mixed_zero_harvests": batcher.mixed_zero_harvests,
        "no_live_row": tally.numbers(f"serve_defaults {layout} {' '.join(flags)}"),
        "ttft_s_requests_5_6": [st["ttft_s"] for st in stats[len(QUERIES):]],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "build_and_warmup_s": build_s,
    }
    if warm is not None:
        out["warmup"] = warm
    if batcher.speculative:
        committed = sum(len(c) for c in chains) - len(chains)  # the first ones at admission
        out.update({
            "speculative": batcher.speculative, "spec_windows": batcher.spec_windows,
            "medusa_heads": (None if batcher.draft_head is None
                             else int(batcher.draft_head["w"].shape[0])),
            "spec_stats": batcher.spec_stats(), "spec_iterations": batcher.spec_iterations,
            "spec_tokens": batcher.spec_tokens,
            "tokens_per_iteration": batcher.spec_tokens_per_iteration(),
            "spec_depth_trace": list(batcher.spec_depth_trace),
            "decode_ms_per_committed_token": batcher.decode_s * 1e3 / max(committed, 1),
            "resident_spec_bytes": {
                "ids_buf": batcher.ids_buf.numel() * batcher.ids_buf.element_size(),
                "spec_drafts": batcher.spec_drafts.numel() * batcher.spec_drafts.element_size(),
                "history_host": batcher._history.nbytes if batcher._history is not None else 0,
                "medusa_heads": (0 if batcher.draft_head is None
                                 else tree_bytes(batcher.draft_head))}})
        if batcher.spec_tokens != committed:
            raise AssertionError(f"serve_spec {layout} {flags}: {batcher.spec_tokens} tokens "
                                 f"committed in segments, want {committed}")
    else:
        out["decode_ms_per_committed_token"] = batcher.decode_s * 1e3 / max(
            sum(len(c) for c in chains), 1)
    if batcher.mixed_zero_harvests:
        raise AssertionError(f"serve_defaults {layout} {flags}: a lane boundary left live rows "
                             f"without a token")
    pool = batcher.pool_stats()
    if pool is not None:
        out["cow_copies"] = pool["cow_copies"]
        out["pool_after_drain"] = pool
        if pool["free_blocks"] != pool["usable_blocks"] - pc.get("blocks_held", 0):
            raise AssertionError(f"serve_defaults paged: blocks held after the drain beyond "
                                 f"the prefix entries': {pool}, {pc.get('blocks_held')}")
        batcher.reset_prefix_cache()
        pool = batcher.pool_stats()
        out["pool_after_reset"] = pool
        if pool["free_blocks"] != pool["usable_blocks"] or int(batcher.cache["bt"].abs().sum()):
            raise AssertionError(f"serve_defaults paged: blocks held after "
                                 f"reset_prefix_cache(): {pool}")
    del batcher
    torch.cuda.empty_cache()
    return out, chains


def serve_defaults(eventchat, llama, params, cfg, tokenizer, requests, layout: str, counted,
                   n_layers: int, smi: str) -> dict:
    """``serve_defaults`` on one layout: each configuration of
    SERVE_DEFAULTS_CONFIGS, counted (K1 = 32 per full-prefill dispatch:
    waves and batch-1 admissions; suffix, lane and chunked admissions run
    decode_kstep). Every chain is held to the oracle's through
    ``chain_rule``. The unbounded run must hit the event-block entries of
    requests 1 and 2 and open a suffix lane. Returns ({config: K1
    launches}, (the oracle's numbers, its chains))."""
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    reqs = serve_defaults_requests(requests)
    runs, k1 = {}, {}
    for name, flags in SERVE_DEFAULTS_CONFIGS:
        if layout == "dense" and name in DENSE_DEFAULTS_SKIPPED:
            continue
        if name == "unbounded_cache" and layout == "paged":
            flags = flags + UNBOUNDED_PAGED_POOL
        (numbers, chains), launches = counted(
            lambda: serve_defaults_run(params, cfg, tokenizer, reqs, layout, flags))
        full = sum(numbers["dispatches"].get(k, 0) for k in ("full", "wave", "prefix_set"))
        if launches[FLASH_KERNEL.source] != n_layers * full or full == 0:
            raise AssertionError(f"serve_defaults {layout} {name}: K1 launches {launches}, want "
                                 f"{n_layers} x {full} full-prefill dispatches")
        numbers["k1_launches"] = launches[FLASH_KERNEL.source]
        numbers["launches"] = launches
        k1[name] = launches[FLASH_KERNEL.source]
        runs[name] = (numbers, chains)
    oracle, want = runs["oracle"]
    padded = mask = None
    for name, (numbers, chains) in runs.items():
        if name != "oracle" and chains != want and padded is None:
            padded, mask, _ = eventchat.prepare_prefill(
                params, cfg, [r[0] for r in reqs], [r[1] for r in reqs])
        rule = (chain_rule(f"serve_defaults {layout} {name}", llama, params, cfg, padded, mask,
                           want, chains, SERVE_KSTEP_WINDOW, True, tokenizer.eos_token_id)
                if name != "oracle" else {"rows_identical": [True] * len(chains),
                                          "divergences": []})
        numbers["vs_oracle"] = {
            **rule,
            "ttft_s_over_oracle": [a / b for a, b in zip(numbers["ttft_s"], oracle["ttft_s"])],
            "latency_s_over_oracle": [a / b for a, b in zip(numbers["latency_s"],
                                                            oracle["latency_s"])],
            "decode_ms_per_step_oracle": oracle["decode_ms_per_step"],
            "overlap_ratio_oracle": oracle["overlap_ratio"],
            "wall_s_oracle": oracle["wall_s"]}
        if name == "unbounded_cache" and (numbers["prefix_hits"] < 2
                                          or numbers["lanes_started"]["suffix"] < 1):
            raise AssertionError(f"serve_defaults {layout} unbounded: requests 5 and 6 did not "
                                 f"hit (hits {numbers['prefix_hits']}, lanes "
                                 f"{numbers['lanes_started']})")
        emit(f"serve_defaults_{layout}_{name}",
             {**numbers, "first_ids": [c[:8] for c in chains], "nvidia_smi": smi})
    emit(f"serve_defaults_{layout}", {
        "config": "EventGPT-7B bf16 tree, int8 KV, 4 rows, max_len 1024, chunk 32, six "
                  "requests (budgets 48, 16, 16, 16, then 16, 16 after the first harvest)",
        "configs": [n for n, _ in SERVE_DEFAULTS_CONFIGS],
        "chains_identical_to_oracle": {n: r[1] == want for n, r in runs.items()},
        "ttft_s": {n: r[0]["ttft_s"] for n, r in runs.items()},
        "wall_s": {n: r[0]["wall_s"] for n, r in runs.items()},
        "decode_ms_per_step": {n: r[0]["decode_ms_per_step"] for n, r in runs.items()},
        "overlap_ratio": {n: r[0]["overlap_ratio"] for n, r in runs.items()},
        "prefix_hits": {n: r[0]["prefix_hits"] for n, r in runs.items()},
        "no_live_row": {n: r[0]["no_live_row"] for n, r in runs.items()},
        "k1_launches": k1, "nvidia_smi": smi})
    # The ties verified here: serve_telemetry_7b holds its chains to the same
    # oracle and replays only (row, step) pairs not seen here.
    oracle["verified_ties"] = {(d["row"], d["first_divergent_step"]): d
                               for numbers, _ in runs.values()
                               for d in numbers["vs_oracle"]["divergences"]}
    return k1, (oracle, want)


def medusa_stack(cfg, dtype):
    """The Medusa phases' random stack at 7B width: MEDUSA_HEADS heads from
    seed 0, scaled by 1/sqrt(d)."""
    import torch

    d = cfg.llama.hidden_size
    return {"w": torch.randn((MEDUSA_HEADS, d, d),
                             generator=torch.Generator(device="cuda").manual_seed(0),
                             device="cuda", dtype=dtype) * (1.0 / math.sqrt(d))}


def spec_vs_oracle(name, eventchat, llama, params, cfg, tokenizer, reqs, numbers, chains,
                   oracle) -> dict:
    """A served speculative run held to the same call's non-speculative
    oracle on the same traffic: chains through ``chain_rule`` (equal, or
    apart only at a measured tie), and the times beside the oracle's."""
    o_numbers, want = oracle
    padded = mask = None
    if chains != want:
        padded, mask, _ = eventchat.prepare_prefill(params, cfg, [r[0] for r in reqs],
                                                    [r[1] for r in reqs])
    rule = chain_rule(name, llama, params, cfg, padded, mask, want, chains, SERVE_KSTEP_WINDOW,
                      True, tokenizer.eos_token_id)
    return {**rule,
            "ttft_s_oracle": o_numbers["ttft_s"], "latency_s_oracle": o_numbers["latency_s"],
            "wall_s_oracle": o_numbers["wall_s"], "batch_tok_s_oracle": o_numbers["batch_tok_s"],
            "decode_ms_per_step_oracle": o_numbers["decode_ms_per_step"],
            "decode_ms_per_committed_token_oracle": o_numbers["decode_ms_per_committed_token"],
            "peak_mem_bytes_oracle": o_numbers["peak_mem_bytes"],
            "overlap_ratio_oracle": o_numbers["overlap_ratio"]}


def serve_spec(eventchat, llama, params, cfg, tokenizer, requests, oracles, counted,
               n_layers: int, smi: str, work: str) -> dict:
    """``serve_spec_*``: the speculative server at 7B width through
    ``cli/serve.make_batcher`` on serve_defaults' traffic and flags, held to
    the same call's ``serve_defaults`` oracle of its layout. Each run is
    counted: K1 = 32 per full-prefill dispatch (and per warmed bucket).
    Returns {run: launches}."""
    import torch

    from eventgpt_tpu_torch.models.medusa import save_medusa
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    heads_path = os.path.join(work, "medusa_7b.npz")
    if any("HEADS" in flags for _, _, flags in SERVE_SPEC_CONFIGS):
        save_medusa(heads_path, medusa_stack(cfg, torch.bfloat16))
    reqs = serve_defaults_requests(requests)
    runs, launches_by_run = {}, {}
    for layout, kind, flags in SERVE_SPEC_CONFIGS:
        name = "serve_spec_warmup" if kind == "warmup" else f"serve_spec_{layout}_{kind}"
        flags = [heads_path if f == "HEADS" else f for f in flags]
        (numbers, chains), launches = counted(
            lambda: serve_defaults_run(params, cfg, tokenizer, reqs, layout, flags))
        full = sum(numbers["dispatches"].get(k, 0) for k in ("full", "wave", "prefix_set"))
        warm_k1 = numbers.get("warmup", {}).get("k1_launches", 0)
        if full == 0 or launches[FLASH_KERNEL.source] != n_layers * full + warm_k1:
            raise AssertionError(f"{name}: K1 launches {launches}, want {n_layers} x {full} "
                                 f"full-prefill dispatches + {warm_k1} in warmup")
        trace = numbers["spec_depth_trace"]
        if not set(trace) <= set(numbers["spec_windows"] or (4,)):
            raise AssertionError(f"{name}: windows {set(trace)} outside the buckets")
        numbers["vs_oracle"] = spec_vs_oracle(name, eventchat, llama, params, cfg, tokenizer,
                                              reqs, numbers, chains, oracles[layout])
        numbers["launches"] = launches
        runs[name], launches_by_run[name] = numbers, launches
        emit(name, {**numbers, "first_ids": [c[:8] for c in chains], "nvidia_smi": smi})
    cold, warm = runs["serve_spec_dense_lookup"], runs["serve_spec_warmup"]
    emit("serve_spec", {
        "config": "EventGPT-7B bf16 tree, int8 KV, 4 rows, max_len 1024, chunk 32, the JAX "
                  "CLI's defaults plus the speculative flags; serve_defaults' six requests",
        "runs": list(runs),
        "chains_identical_to_oracle": {n: all(r["vs_oracle"]["rows_identical"])
                                       for n, r in runs.items()},
        "tokens_per_iteration": {n: r["tokens_per_iteration"] for n, r in runs.items()},
        "ttft_s": {n: r["ttft_s"] for n, r in runs.items()},
        "wall_s": {n: r["wall_s"] for n, r in runs.items()},
        "decode_ms_per_committed_token": {n: r["decode_ms_per_committed_token"]
                                          for n, r in runs.items()},
        "verifies_live_run_idle": {n: (r["spec_iterations"], r["no_live_row"]["steps_run"],
                                       r["no_live_row"]["idle_verifies"])
                                   for n, r in runs.items()},
        "idle_run_before_repair": {n: IDLE_VERIFIES_BEFORE_REPAIR[n] for n in runs},
        "ttft_s_requests_5_6": {n: r["ttft_s_requests_5_6"] for n, r in runs.items()},
        "ttft_s_requests_5_6_oracle": {n: r["vs_oracle"]["ttft_s_oracle"][len(QUERIES):]
                                       for n, r in runs.items()},
        "batch_tok_s": {n: (r["batch_tok_s"], r["vs_oracle"]["batch_tok_s_oracle"])
                        for n, r in runs.items()},
        "wall_s_with_oracle": {n: (r["wall_s"], r["vs_oracle"]["wall_s_oracle"])
                               for n, r in runs.items()},
        "warmup_s": warm["warmup"]["seconds"], "warmup_functions": warm["warmup"]["functions"],
        "ttft_request1_s": {"warmed": warm["ttft_s"][0], "cold": cold["ttft_s"][0]},
        "k1_launches": {n: l[FLASH_KERNEL.source] for n, l in launches_by_run.items()},
        "nvidia_smi": smi})
    return launches_by_run


def serve_spec_int4(eventchat, llama, params_int4, cfg, tokenizer, requests, counted,
                    n_layers: int, smi: str) -> tuple:
    """``serve_spec_int4``: ``--quant int4 --speculative 4``, dense, int8 KV,
    on serve_defaults' traffic, held to an int4 oracle of the same call
    (synchronous, no prefix cache, no lanes). K4 by (path, M): 225 per
    verify iteration at M = 4 x 4 = 16 (the decode path), 225 per lane
    advance at M = 32 (the prefill path), the wave's prefill forward at
    M = B x T. Returns (launches, K4 launches by (path, M))."""
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.int4_matmul import DECODE_MAX_M, INT4_KERNEL, LAUNCHES_BY_M

    reqs = serve_defaults_requests(requests)
    oracle, _ = counted(lambda: serve_defaults_run(params_int4, cfg, tokenizer, reqs, "dense",
                                                   SERVE_DEFAULTS_CONFIGS[-1][1]))
    (numbers, chains), launches = counted(lambda: serve_defaults_run(
        params_int4, cfg, tokenizer, reqs, "dense", ["--speculative", str(SPEC_WINDOW)]))
    by_m = dict(LAUNCHES_BY_M)
    per_forward = 7 * n_layers + 1
    m_verify, m_lane = len(QUERIES) * SPEC_WINDOW, SERVE_KSTEP_WINDOW
    verify_path = "decode" if m_verify <= DECODE_MAX_M else "prefill"
    want = {(verify_path, m_verify): per_forward * numbers["decode_steps_run"],
            ("prefill", m_lane): per_forward * numbers["mixed_segments"]}
    full = sum(numbers["dispatches"].get(k, 0) for k in ("full", "wave", "prefix_set"))
    if (any(by_m.get(k, 0) != v for k, v in want.items()) or numbers["mixed_segments"] == 0
            or launches[INT4_KERNEL.source] != sum(by_m.values())
            or launches[FLASH_KERNEL.source] != n_layers * full or full == 0):
        raise AssertionError(f"serve_spec_int4: K4 launches by (path, M) {by_m}, want at least "
                             f"{want}; launches {launches}, {full} full prefills")
    numbers["vs_oracle"] = spec_vs_oracle("serve_spec_int4", eventchat, llama, params_int4, cfg,
                                          tokenizer, reqs, numbers, chains, oracle)
    numbers["launches"] = launches
    numbers["k4_launches_by_path_m"] = {f"{p} M={m}": c for (p, m), c in sorted(by_m.items())}
    emit("serve_spec_int4", {"flags": "--quant int4 --kv_cache int8 --speculative 4",
                             **numbers, "verify_m": m_verify, "lane_m": m_lane,
                             "idle_run_before_repair":
                                 IDLE_VERIFIES_BEFORE_REPAIR["serve_spec_int4"],
                             "first_ids": [c[:8] for c in chains], "nvidia_smi": smi})
    return launches, by_m


def preempt_oracle_run(params, cfg, tokenizer, req) -> tuple:
    """One of ``serve_preempt_7b``'s requests alone on an ample pool (the
    dense capacity), with the arms' flags but no preemption: (numbers,
    chain)."""
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve

    args = cli_serve.build_parser().parse_args(PREEMPT_FLAGS)
    batcher = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda")
    rid = batcher.submit(*req)
    t0 = time.perf_counter()
    chain = batcher.run_until_drained()[rid]
    torch.cuda.synchronize()
    st = batcher.request_stats[rid]
    out = {"wall_s": time.perf_counter() - t0, "ttft_s": st["ttft_s"],
           "latency_s": st["latency_s"], "itl_s": st["itl_s"], "tokens": len(chain),
           "admission_s": batcher.admission_s, "dispatches": dict(batcher.dispatches),
           "param_count": batcher._spill_param_count, "status": batcher.finish_status[rid]}
    del batcher
    torch.cuda.empty_cache()
    return out, chain


def preempt_run(params, cfg, tokenizer, reqs, flags) -> tuple:
    """One arm of ``serve_preempt_7b``: the batcher ``cli/serve`` builds from
    ``flags`` (``make_batcher``), stepped in this thread. The two batch
    requests are queued first (one admission wave); the interactive one is
    submitted after the first harvest, when the free blocks cannot cover
    it. Each restore is timed between two synchronizes, and so is each
    victim's way back: from the start of the step that took it from the
    queue to the end of the step its row went live in. Returns (numbers,
    chains in request order)."""
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.workload import SLO

    args = cli_serve.build_parser().parse_args(PREEMPT_FLAGS + list(flags))
    torch.cuda.reset_peak_memory_stats()
    batcher = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda")
    restore_ms = []
    restore = batcher._paged_restore

    def timed_restore(req, row):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = restore(req, row)
        torch.cuda.synchronize()
        if ok:
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        return ok

    batcher._paged_restore = timed_restore
    tally = IdleTally(batcher)
    slos = [SLO("batch", latency_s=PREEMPT_BATCH_LATENCY_S)] * 2 + [
        SLO("interactive", ttft_s=PREEMPT_INTER_TTFT_S, itl_s=PREEMPT_INTER_ITL_S)]
    rids = [batcher.submit(*r, slo=slo) for r, slo in zip(reqs[:2], slos)]
    t0 = time.perf_counter()
    while batcher.decode_steps == 0:  # until the first harvest
        tally.step()
    t_late = time.perf_counter() - t0
    rids.append(batcher.submit(*reqs[2], slo=slos[2]))
    victims, back, readmit = set(), {}, []
    while batcher.queue or any(r is not None for r in batcher.rows):
        waiting = {q.rid for q in batcher.queue if q.preempts}
        t_step = time.perf_counter()
        tally.step()
        victims |= {q.rid for q in batcher.queue if q.preempts}
        for rid in waiting - {q.rid for q in batcher.queue}:
            back[rid] = t_step
        live = {req.rid for r, req in enumerate(batcher.rows)
                if req is not None and not batcher.frozen[r]}
        done = [rid for rid in back if rid in live or rid in batcher.finished]
        if done:
            torch.cuda.synchronize()
            for rid in done:
                readmit.append(time.perf_counter() - back.pop(rid))
    batcher._drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chains = [batcher.finished[r] for r in rids]
    statuses = [batcher.finish_status[r] for r in rids]
    stats = [batcher.request_stats[r] for r in rids]
    pool, spill = batcher.pool_stats(), batcher.spill_stats()
    pc = batcher.prefix_cache_stats()
    clean = (pool["free_blocks"] + pool["used_blocks"] == pool["usable_blocks"]
             and pool["spilled_runs"] == 0 and spill["records"] == 0
             and pool["free_blocks"] == pool["usable_blocks"] - pc.get("blocks_held", 0))
    batcher.reset_prefix_cache()
    after = batcher.pool_stats()
    clean = clean and after["free_blocks"] == after["usable_blocks"] and not int(
        batcher.cache["bt"].abs().sum())
    gathers = [{"bytes": g["bytes"], "blocks": g["blocks"], "alloc_ms": g["alloc_s"] * 1e3,
                "copy_ms": g["copy_s"] * 1e3, "gb_s": g["bytes"] / max(g["copy_s"], 1e-9) / 1e9}
               for g in batcher.gather_timings]
    out = {
        "flags": " ".join(flags), "statuses": statuses, "late_submit_s": t_late, "wall_s": wall,
        "generated_tokens": [len(c) for c in chains], "ttft_s": [s["ttft_s"] for s in stats],
        "latency_s": [s["latency_s"] for s in stats], "itl_s": [s["itl_s"] for s in stats],
        "slo_met": [s.get("slo_met") for s in stats], "slo_stats": batcher.slo_stats(),
        "interactive_ttft_s": stats[2]["ttft_s"],
        "victims": sorted(victims), "victim_latency_s": {r: stats[rids.index(r)]["latency_s"]
                                                         for r in sorted(victims)},
        "preemptions": pool["preemptions"], "spills": pool["spills"],
        "restores": pool["restores"], "deferrals": pool["deferrals"],
        "block_bytes": pool["block_bytes"], "spill_store": spill, "gathers": gathers,
        "restore_ms": restore_ms, "readmit_s": readmit,
        "spill_bw_ewma_gb_s": batcher._spill_bw_Bps / 1e9,
        "recompute_flops_per_s_policy": batcher._recompute_flops_per_s,
        "param_count": batcher._spill_param_count,
        "dispatches": dict(batcher.dispatches), "segments": batcher.seg_count,
        "lanes_started": dict(batcher.lanes_started),
        "no_live_row": tally.numbers(f"serve_preempt_7b {' '.join(flags)}"),
        "pool_after_drain": pool, "pool_after_reset": after, "clean": clean,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    del batcher
    torch.cuda.empty_cache()
    return out, chains


def serve_preempt_7b(eventchat, llama, params, cfg, tokenizer, ids, pixels, counted,
                     n_layers: int, smi: str) -> dict:
    """``serve_preempt_7b``: block-tier preemption at 7B width. Two batch
    requests (streams 100, 101, PREEMPT_BATCH_BUDGET tokens) reserve most
    of a PREEMPT_POOL_BLOCKS pool; after the first harvest an interactive
    one (stream 102, PREEMPT_INTER_BUDGET tokens) needs more blocks than
    are free. The arms: preemption off (the head defers), preemption with
    a host store (the price picks spill at 7B), with none (drop and
    re-prefill), and with the store but no lanes (the head prefills at
    once instead of 32 positions a boundary); the oracle runs each request
    alone on an ample pool.
    K1 is first held against its plain version at the two shapes this
    phase adds: the batch pair's admission wave (B=2) and a lone request's
    full prefill (B=1: the head without lanes or preemption, a victim's
    re-prefill, the oracles), each padded to its prompt bucket.
    Chains are held to the oracle's by ``chain_rule``. Fails if an arm's
    pool is not clean after the drain, if the spill arm does not spill
    and restore, or if the drop arm spills. Returns ({arm: K1 launches},
    the K1 checks, the oracle's chains)."""
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.serve import _bucket

    reqs = [(ids[0], pixels[0], PREEMPT_BATCH_BUDGET), (ids[1], pixels[1], PREEMPT_BATCH_BUDGET),
            (ids[2], pixels[2], PREEMPT_INTER_BUDGET)]
    lens = [len(r[0]) - 1 + cfg.num_event_tokens for r in reqs]
    max_len = int(PREEMPT_FLAGS[PREEMPT_FLAGS.index("--max_len") + 1])
    flash_checks = [check_flash_kernel(group, seed=seed, s=_bucket(max(group), max_len))
                    for group, seed in ((lens[:2], 21), (lens[2:], 22))]
    emit("kernel_flash_preempt_shapes", {"wave_b2": flash_checks[0], "lone_b1": flash_checks[1],
                                         "nvidia_smi": smi})
    oracle, want, k1 = [], [], {}
    for i, req in enumerate(reqs):
        (numbers, chain), launches = counted(
            lambda: preempt_oracle_run(params, cfg, tokenizer, req))
        if numbers["status"] != "ok" or launches[FLASH_KERNEL.source] != n_layers:
            raise AssertionError(f"serve_preempt_7b oracle {i}: {numbers['status']}, launches "
                                 f"{launches}, want K1 = {n_layers}")
        oracle.append(numbers)
        want.append(chain)
    k1["oracle"] = n_layers * len(reqs)
    runs = {}
    padded = mask = None
    for arm, flags in PREEMPT_ARMS:
        (numbers, chains), launches = counted(
            lambda: preempt_run(params, cfg, tokenizer, reqs, flags))
        full = sum(numbers["dispatches"].get(k, 0) for k in ("full", "wave", "prefix_set"))
        if launches[FLASH_KERNEL.source] != n_layers * full or full == 0:
            raise AssertionError(f"serve_preempt_7b {arm}: K1 launches {launches}, want "
                                 f"{n_layers} x {full} full-prefill dispatches")
        if numbers["statuses"] != ["ok"] * 3 or not numbers["clean"]:
            raise AssertionError(f"serve_preempt_7b {arm}: statuses {numbers['statuses']}, "
                                 f"pool after the drain {numbers['pool_after_drain']}, after "
                                 f"the reset {numbers['pool_after_reset']}")
        bad = (numbers["preemptions"] != 0 or numbers["deferrals"] == 0 if arm == "preempt_off"
               else numbers["preemptions"] < 1 or numbers["spills"] != 0 if arm == "drop"
               else numbers["spills"] < 1 or numbers["restores"] < 1)
        if bad:
            raise AssertionError(f"serve_preempt_7b {arm}: preemptions {numbers['preemptions']}, "
                                 f"spills {numbers['spills']}, restores {numbers['restores']}, "
                                 f"deferrals {numbers['deferrals']}")
        if chains != want and padded is None:
            padded, mask, _ = eventchat.prepare_prefill(params, cfg, [r[0] for r in reqs],
                                                        [r[1] for r in reqs])
        numbers["vs_oracle"] = chain_rule(f"serve_preempt_7b {arm}", llama, params, cfg, padded,
                                          mask, want, chains, SERVE_KSTEP_WINDOW, True,
                                          tokenizer.eos_token_id, PREEMPT_BATCH_BUDGET)
        numbers["launches"] = launches
        k1[arm] = launches[FLASH_KERNEL.source]
        runs[arm] = numbers
        emit(f"serve_preempt_7b_{arm}", {**numbers, "first_ids": [c[:8] for c in chains],
                                         "nvidia_smi": smi})
    spill, drop = runs["spill"], runs["drop"]
    # The price's two sides on the card: the spill's round trip (the copy
    # out, the restore) against the drop's way back, and the recompute rate
    # a full prefill of the interactive request alone implies.
    inter = oracle[2]
    prompt_positions = len(ids[2]) - 1 + cfg.num_event_tokens
    emit("serve_preempt_7b", {
        "config": "EventGPT-7B bf16 tree, paged int8 KV, 3 rows, max_len 1024, chunk 32, "
                  f"{PREEMPT_POOL_BLOCKS} pool blocks, the JAX CLI's defaults; streams 100 and "
                  f"101 batch ({PREEMPT_BATCH_BUDGET} tokens), 102 interactive "
                  f"({PREEMPT_INTER_BUDGET} tokens) after the first harvest",
        "arms": list(runs), "block_bytes": spill["block_bytes"],
        "chains_identical_to_oracle": {a: all(r["vs_oracle"]["rows_identical"])
                                       for a, r in runs.items()},
        "interactive_ttft_s": {**{a: r["interactive_ttft_s"] for a, r in runs.items()},
                               "oracle": inter["ttft_s"]},
        "victim_latency_s": {a: r["victim_latency_s"] for a, r in runs.items()},
        "wall_s": {a: r["wall_s"] for a, r in runs.items()},
        "preemptions_spills_restores_deferrals": {
            a: (r["preemptions"], r["spills"], r["restores"], r["deferrals"])
            for a, r in runs.items()},
        "spill_gathers": spill["gathers"], "restore_ms": spill["restore_ms"],
        "spill_readmit_s": spill["readmit_s"], "drop_readmit_s": drop["readmit_s"],
        "spill_round_trip_ms": [g["copy_ms"] for g in spill["gathers"]] + spill["restore_ms"],
        "policy": {"spill_bw_seed_gb_s": 5.0, "spill_bw_ewma_gb_s": spill["spill_bw_ewma_gb_s"],
                   "recompute_flops_per_s_seed": spill["recompute_flops_per_s_policy"],
                   "param_count": spill["param_count"],
                   "interactive_alone_admission_s": inter["admission_s"],
                   "interactive_prompt_positions": prompt_positions,
                   "recompute_flops_per_s_implied": (2.0 * spill["param_count"] * prompt_positions
                                                     / max(inter["admission_s"], 1e-9))},
        "slo_stats": {a: r["slo_stats"] for a, r in runs.items()},
        "oracle": oracle, "k1_launches": k1, "nvidia_smi": smi})
    return k1, flash_checks, want


def serve_handoff_7b(eventchat, llama, params, cfg, tokenizer, ids, pixels, counted,
                     n_layers: int, smi: str) -> dict:
    """``serve_handoff_7b``: a prefill-role and a decode-role batcher in this
    process over the same params, each with its own paged int8 arena, the
    JAX CLI's defaults, 4 rows: the four 7B requests are prefilled,
    gathered (``pop_handoffs``), spliced (``import_handoff``) and drained,
    plain and with ``--speculative 4``, beside a colocated run of the same
    flags (the oracle). The prefill role runs K1 (32 per full-prefill
    dispatch), the decode role none. Returns ({run: K1 launches}, the plain
    run's outbox records and handed-off chains, for ``handoff_wire_7b``)."""
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    reqs = [(ids[i], pixels[i], MAX_NEW_TOKENS) for i in range(len(QUERIES))]
    base = FLEET_FLAGS
    k1, plain = {}, None
    padded = mask = None
    for name, extra in (("plain", []), ("speculative", ["--speculative", str(SPEC_WINDOW)])):
        args = cli_serve.build_parser().parse_args(base + extra)

        def colocated():
            b = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda")
            rids = [b.submit(*r) for r in reqs]
            done = b.run_until_drained()
            return [done[r] for r in rids], [b.request_stats[r]["ttft_s"] for r in rids]

        (oracle, oracle_ttft), launches = counted(colocated)
        k1[f"{name}_colocated"] = launches[FLASH_KERNEL.source]
        plain = oracle if plain is None else plain
        pre = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda", role="prefill")
        dec = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda", role="decode")
        splice_ms = []
        splice = dec._handoff_splice

        def timed_splice(req, row):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = splice(req, row)
            torch.cuda.synchronize()
            if ok:
                splice_ms.append((time.perf_counter() - t0) * 1e3)
            return ok

        dec._handoff_splice = timed_splice

        def prefill_leg():
            rids = [pre.submit(*r) for r in reqs]
            for _ in range(100):
                if len(pre.handoff_ready) == len(rids):
                    break
                pre.step()
            return rids, pre.pop_handoffs()

        t0 = time.perf_counter()
        (pre_rids, outs), pre_launches = counted(prefill_leg)
        prefill_s = time.perf_counter() - t0
        if [o["rid"] for o in outs] != pre_rids or pre.seg_count:
            raise AssertionError(f"serve_handoff_7b {name}: outbox {[o['rid'] for o in outs]} "
                                 f"for {pre_rids}, {pre.seg_count} segments on the prefill role")

        def decode_leg():
            rids = []
            for o in outs:
                rids.append(dec.import_handoff(
                    o["input_ids"], o["max_new_tokens"], o["rec"], tokens=o["tokens"],
                    prompt_len=o["prompt_len"], deadline_s=o["deadline_s"], slo=o["slo"],
                    elapsed_s=o["elapsed_s"] + time.perf_counter() - o["t_gather"],
                    ttft_s=o["ttft_s"]))
            done = dec.run_until_drained()
            return [done[r] for r in rids], rids

        t0 = time.perf_counter()
        (chains, dec_rids), dec_launches = counted(decode_leg)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        full = sum(pre.dispatches.get(k, 0) for k in ("full", "wave"))
        if (pre_launches[FLASH_KERNEL.source] != n_layers * full or full == 0
                or dec_launches[FLASH_KERNEL.source] != 0):
            raise AssertionError(f"serve_handoff_7b {name}: K1 launches {pre_launches} "
                                 f"(prefill, {full} full prefills), {dec_launches} (decode)")
        pools = {}
        for role, b in (("prefill", pre), ("decode", dec)):
            st = b.pool_stats()
            held = b.prefix_cache_stats().get("blocks_held", 0)
            b.reset_prefix_cache()
            after = b.pool_stats()
            pools[role] = {"after_drain": st, "after_reset": after}
            if (st["free_blocks"] + st["used_blocks"] != st["usable_blocks"]
                    or st["free_blocks"] != st["usable_blocks"] - held
                    or after["free_blocks"] != after["usable_blocks"]
                    or int(b.cache["bt"].abs().sum())):
                raise AssertionError(f"serve_handoff_7b {name}: the {role} pool is not clean: "
                                     f"{pools[role]}")
        statuses = [dec.finish_status[r] for r in dec_rids]
        if statuses != ["ok"] * len(reqs) or dec.handoffs_spliced != len(reqs):
            raise AssertionError(f"serve_handoff_7b {name}: statuses {statuses}, "
                                 f"{dec.handoffs_spliced} spliced")
        rules = {}
        for ref_name, ref in (("colocated", oracle), ("plain_colocated", plain)):
            if chains != ref and padded is None:
                padded, mask, _ = eventchat.prepare_prefill(params, cfg, ids, pixels)
            rules[ref_name] = chain_rule(f"serve_handoff_7b {name} vs {ref_name}", llama,
                                         params, cfg, padded, mask, ref, chains,
                                         SERVE_KSTEP_WINDOW, True, tokenizer.eos_token_id)
        gathers = list(pre.gather_timings)
        if name == "plain":
            wire = (outs, chains)
        k1[f"{name}_prefill_role"] = pre_launches[FLASH_KERNEL.source]
        k1[f"{name}_decode_role"] = dec_launches[FLASH_KERNEL.source]
        emit(f"serve_handoff_7b_{name}", {
            "flags": " ".join(extra), "vs_colocated": rules["colocated"],
            "vs_plain_colocated": rules["plain_colocated"],
            "shipped_blocks": [o["rec"]["n_blocks"] for o in outs],
            "reserved_blocks": [o["rec"]["n_total"] for o in outs],
            "shipped_bytes": [o["rec"]["nbytes_kv"] for o in outs],
            "prompt_lengths": [o["prompt_len"] for o in outs],
            "gather_ms": [g["copy_s"] * 1e3 for g in gathers],
            "gather_alloc_ms": [g["alloc_s"] * 1e3 for g in gathers],
            "gather_gb_s": [g["bytes"] / max(g["copy_s"], 1e-9) / 1e9 for g in gathers],
            "splice_ms": splice_ms, "prefill_leg_s": prefill_s, "decode_leg_s": decode_s,
            "rebased_ttft_s": [dec.request_stats[r]["ttft_s"] for r in dec_rids],
            "colocated_ttft_s": oracle_ttft,
            "latency_s": [dec.request_stats[r]["latency_s"] for r in dec_rids],
            "handoffs": {"gathered": pre.handoffs_gathered,
                         "gathered_bytes": pre.handoffs_gathered_bytes,
                         "spliced": dec.handoffs_spliced,
                         "spliced_bytes": dec.handoffs_spliced_bytes},
            "pools": pools, "launches": {"prefill": pre_launches, "decode": dec_launches},
            "first_ids": [c[:8] for c in chains], "nvidia_smi": smi})
        del pre, dec
        torch.cuda.empty_cache()
    return k1, wire


FLEET_FLAGS = ["--max_batch", "4", "--max_len", "1024", "--chunk", "32", "--kv_cache", "int8",
               "--kv_layout", "paged"]
ORACLE_FLAGS = ["--no_pipeline", "--no_prefix_cache", "--prefill_budget", "0"]
# The chaos phase's segments are 8 steps, so that a request is seen
# mid-decode (tokens committed, budget left) before the kill, and the
# supervisor probes every 5 ms, so that the kill lands within a few ms of
# the state it was armed on. Its arms: piggyback lanes of 32 prompt
# positions a boundary (the budget the other served phases have at chunk
# 32; the default, --chunk, would be 8) and exclusive admission.
# (The arm by waves, "--prefill_budget 0", left the run to pay for the
# serving mesh's phases; the CPU chaos tests run both.)
CHAOS_ARMS = [("lanes", ["--chunk", "8", "--fleet_probe_interval_s", "0.005",
                         "--prefill_budget", "32"])]
BREAKER_FLAGS = ["--max_batch", "2", "--breaker_threshold", "3", "--breaker_cooldown_s", "2"]
CHAOS_BUDGET = 64  # two segments past a row seen mid-decode leave it unfinished
WAIT_S = 300.0  # the bound of every wait on a served state at 7B


def wait_for(cond, what: str, bound_s: float = WAIT_S) -> float:
    """Poll ``cond`` until it holds; its wall seconds. Raises past the bound."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > bound_s:
            raise AssertionError(f"timed out after {bound_s} s waiting for {what}")
        time.sleep(0.002)
    return time.perf_counter() - t0


def serve_oracle(params, cfg, tokenizer, reqs, flags=()) -> list:
    """The single-engine oracle of a served phase: the synchronous, cache-off,
    lane-off batcher of ``FLEET_FLAGS`` (plus ``flags``) run to the drain."""
    from eventgpt_tpu_torch.cli import serve as cli_serve

    args = cli_serve.build_parser().parse_args(FLEET_FLAGS + list(flags) + ORACLE_FLAGS)
    batcher = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda")
    rids = [batcher.submit(*r) for r in reqs]
    done = batcher.run_until_drained()
    return [done[r] for r in rids]


def hold_to_oracle(name, eventchat, llama, params, cfg, tokenizer, reqs, want, chains,
                   new_tokens: int = MAX_NEW_TOKENS) -> dict:
    """``chain_rule`` of served chains against the oracle's on ``reqs``."""
    padded = mask = None
    if chains != want:
        padded, mask, _ = eventchat.prepare_prefill(params, cfg, [r[0] for r in reqs],
                                                    [r[1] for r in reqs])
    return chain_rule(name, llama, params, cfg, padded, mask, want, chains, SERVE_KSTEP_WINDOW,
                      True, tokenizer.eos_token_id, new_tokens)


def replica_threads(fleet) -> list:
    """Per replica, the set of scheduler threads that step its batcher (a
    restart runs on a fresh one): the keys of its K1 launches by thread."""
    import threading

    seen = []
    for rep in fleet.replicas:
        b, idents = rep.engine.batcher, set()

        def traced(step=b.step, idents=idents):
            idents.add(threading.get_ident())
            step()

        b.step = traced
        seen.append(idents)
    return seen


def replica_k1(fleet, threads, n_layers: int, name: str) -> list:
    """Each replica's K1 launches by its threads, held to 32 per full-prefill
    dispatch of its batcher; their sum is every launch counted."""
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    per = [sum(FLASH_KERNEL.launches_by_thread[t] for t in idents) for idents in threads]
    full = [sum(rep.engine.batcher.dispatches.get(k, 0) for k in ("full", "wave", "prefix_set"))
            for rep in fleet.replicas]
    if per != [n_layers * f for f in full] or sum(per) != FLASH_KERNEL.launches:
        raise AssertionError(f"{name}: K1 launches by replica {per}, want {n_layers} x {full} "
                             f"full prefills, of {FLASH_KERNEL.launches} counted")
    return per


def pool_clean(batcher, name: str) -> dict:
    """After a drain only prefix entries hold blocks."""
    st = batcher.pool_stats()
    held = batcher.prefix_cache_stats().get("blocks_held", 0)
    if (st["free_blocks"] + st["used_blocks"] != st["usable_blocks"]
            or st["free_blocks"] != st["usable_blocks"] - held or st["spilled_runs"]):
        raise AssertionError(f"{name}: the pool is not clean after the drain: {st}, "
                             f"{held} held by prefix entries")
    return {**st, "prefix_blocks_held": held}


def scheduler_numbers(b) -> dict:
    """Where a batcher's time went: admission, decode segments (host time
    blocked on fetches, the host's gaps between them) and its steps."""
    return {"admission_s": b.admission_s, "decode_s": b.decode_s,
            "decode_steps": b.decode_steps, "decode_steps_run": b.decode_steps_run,
            "decode_ms_per_step": b.decode_s * 1e3 / max(b.decode_steps, 1),
            "device_segment_s": b.device_segment_s, "host_gap_s": b.host_gap_s,
            "overlap_ratio": b.overlap_ratio(), "segments": b.seg_count,
            "dispatches": dict(b.dispatches)}


def fleet_traffic(engine, reqs, streamed=()) -> tuple:
    """The four requests, then (once they are answered) streams 100 and 101
    again as repeated sessions, through ``submit_ids``/``result``: (chains,
    ids, wall seconds). The first four's ``streamed`` indices go out with
    ``stream=True`` (a process fleet delivers them at their finish): each
    queue must hold the chain ``result`` gives, then the end sentinel."""
    t0 = time.perf_counter()
    first = [engine.submit_ids(*r, stream=i in streamed)
             for i, r in enumerate(reqs[:len(QUERIES)])]
    chains = [engine.result(f, timeout=WAIT_S) for f in first]
    for i in streamed:
        delivered = stream_delivered(engine, first[i])
        if delivered != [chains[i], None]:
            raise AssertionError(f"request {i}'s stream delivered {delivered}, not its chain "
                                 f"{chains[i]} and the end")
    late = [engine.submit_ids(*r) for r in reqs[len(QUERIES):]]
    chains += [engine.result(f, timeout=WAIT_S) for f in late]
    return chains, first + late, time.perf_counter() - t0


def stream_delivered(fleet, frid) -> list:
    """What a process fleet's stream queue holds once the request is over:
    its lists up to the end sentinel (or the fault)."""
    q = fleet.stream_queue(frid)
    out = [q.get(timeout=WAIT_S)]
    while isinstance(out[-1], list):
        out.append(q.get(timeout=WAIT_S))
    return out


def procfleet_telemetry(fleet, frids, name: str, handoffs: bool = False) -> dict:
    """A process fleet's telemetry after its traffic: ``fleet_journeys`` of
    the coordinator (stitched from the workers' phase durations); its
    ``series``, ``alerts`` and ``memory_stats`` answered by every worker;
    each worker's ledger reconciled against its own ``cuda_memory`` (its
    ``stats`` op, read just after): the live bytes the ledger read are the
    allocator's, and the ledger accounts for RECONCILE_MIN of them."""
    journeys, problems = fleet_journeys(fleet, frids, name, handoffs)
    series, alerts, mem = fleet.series(n=4), fleet.alerts(), fleet.memory_stats()
    workers = []
    for slot, sw, aw, mw in zip(fleet.slots, series["workers"], alerts["workers"],
                                mem["workers"]):
        allocated = fleet.worker_stats(slot.idx).get("cuda_memory", {}).get("allocated")
        rec = mw.get("reconcile") or {}
        w = {"worker": slot.idx, "series_samples": sw.get("samples"),
             "alerts_active": aw.get("active"), "reconcile": rec, "cuda_allocated": allocated,
             "ledger_total_bytes": mw.get("total_bytes")}
        if (any("error" in x for x in (sw, aw, mw)) or not sw.get("enabled")
                or "rules" not in aw or not allocated
                or abs(rec.get("live_bytes", 0) - allocated) > 0.01 * allocated
                or rec.get("accounted_ratio", 0.0) < RECONCILE_MIN):
            problems.append(f"{name}: worker {slot.idx}'s telemetry {w}")
        workers.append(w)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"journeys": journeys, "workers": workers,
            "coordinator_series_samples": series["coordinator"].get("samples"),
            "aggregate": series["aggregate"], "alerts_active": alerts["active"],
            "metrics": fleet.stats()["metrics"]}


def arm_fleet_telemetry() -> None:
    """The registry zeroed and counting and the flight recorder armed, for
    an in-process fleet phase (``disarm_fleet_telemetry`` after it): the
    script's process arms neither, and a fleet's journeys need both."""
    from eventgpt_tpu_torch.obs import journey as obs_journey
    from eventgpt_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.configure(True)
    obs_metrics.REGISTRY.reset()
    obs_journey.configure(512)


def disarm_fleet_telemetry() -> None:
    from eventgpt_tpu_torch.obs import journey as obs_journey

    obs_journey.disable()


def metric_sum(text: str, name: str) -> float:
    """The sum of every sample of ``name`` (any labels) in a Prometheus
    text; 0 when it has none."""
    return sum(float(line.split()[-1]) for line in text.splitlines()
               if line.startswith((name + " ", name + "{")))


def fleet_journeys(fleet, frids, name: str, handoffs: bool = False) -> tuple:
    """One stitched journey a request, from the fleet's ``journey`` (the
    in-process router's or a process coordinator's): finished ``ok``, its
    failover events and assignments those of the request (one assignment
    more for a shipped handoff), phases summing to its latency. Returns
    (numbers, problems)."""
    problems, out = [], []
    index = {r["rid"] for r in fleet.journeys(4096)}
    for f in frids:
        j = fleet.journey(f)
        freq = fleet._requests[f]
        if j is None or not j.get("finished"):
            problems.append(f"{name}: request {f} has no finished journey: {j}")
            continue
        kinds = [e["kind"] for e in j["events"]]
        gap = abs(sum(j["phases"].values()) - j["e2e_s"])
        legs = 1 + freq.failovers + kinds.count("kv_handoff")
        if (j["status"] != "ok" or f not in index or gap > 1e-6
                or kinds.count("failover") != freq.failovers or len(j["assignments"]) != legs
                or (handoffs and "kv_handoff" not in kinds)):
            problems.append(f"{name}: request {f}'s journey: status {j['status']}, events "
                            f"{kinds}, {len(j['assignments'])} assignments for "
                            f"{freq.failovers} failovers, phases off e2e by {gap}")
        out.append({"frid": f, "events": kinds, "phases": j["phases"], "e2e_s": j["e2e_s"],
                    "assignments": [(a.get("replica", a.get("worker")), a["rid"],
                                     (a["journey"] or {}).get("status"))
                                    for a in j["assignments"]]})
    return out, problems


def fleet_telemetry(fleet, frids, name: str) -> dict:
    """The in-process fleet's telemetry after its traffic (armed by
    ``arm_fleet_telemetry``): ``fleet_journeys``; ``memory_stats``'
    reconciliation beside ``torch.cuda.memory_allocated`` read at once; and
    ``egpt_fleet_routed_total`` and ``egpt_fleet_failovers_total`` in the
    metrics text equal to the fleet's own counters (a route per submit and
    per failover)."""
    import torch

    from eventgpt_tpu_torch.obs import metrics as obs_metrics

    journeys, problems = fleet_journeys(fleet, frids, name)
    mem = fleet.memory_stats()
    allocated = torch.cuda.memory_allocated()
    text = obs_metrics.REGISTRY.render_prometheus()
    counters = {"routed_total": metric_sum(text, "egpt_fleet_routed_total"),
                "failovers_total": metric_sum(text, "egpt_fleet_failovers_total"),
                "fleet_requests": fleet.n_requests, "fleet_failovers": fleet.n_failovers}
    if (counters["routed_total"] != fleet.n_requests + fleet.n_failovers
            or counters["failovers_total"] != fleet.n_failovers):
        problems.append(f"{name}: /metrics {counters}")
    if [r["replica"] for r in mem["replicas"]] != [rep.idx for rep in fleet.replicas]:
        problems.append(f"{name}: memory_stats replicas {mem['replicas']}")
    if abs(mem["reconcile"]["live_bytes"] - allocated) > 0.01 * allocated:
        problems.append(f"{name}: the reconciliation read {mem['reconcile']['live_bytes']} live "
                        f"bytes, the allocator {allocated}")
    if problems:
        raise AssertionError("; ".join(problems))
    return {"journeys": journeys, "metrics": counters,
            "memory": {"reconcile": mem["reconcile"], "cuda_allocated": allocated,
                       "total_bytes": mem["total_bytes"],
                       "replicas": [{"replica": r["replica"],
                                     "bytes": sum(r["components"].values())}
                                    for r in mem["replicas"]]},
            "alerts_active": fleet.alerts().get("active")}


def serve_fleet_7b(eventchat, llama, params, cfg, tokenizer, requests, counted, n_layers: int,
                   smi: str) -> dict:
    """``serve_fleet_7b``: ``cli/serve --fleet 2`` (``make_engine``: two
    batchers over the held tree, each with its own paged int8 pool, behind
    the prefix-affinity router) and one engine of the same flags, each
    given the four requests and then streams 100 and 101 again as repeated
    sessions; both held to the single-engine oracle. Affinity must pin each
    repeat to its first request's replica, where it hits the prefix cache.
    Returns ({run: K1 launches}, the oracle's chains and the walls, TTFTs and
    decode ms per step of both runs, which the process fleet is set beside)."""
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    want = serve_oracle(params, cfg, tokenizer, requests)
    parser = cli_serve.build_parser()
    k1 = {}

    def one_engine():
        engine = cli_serve.make_engine(parser.parse_args(FLEET_FLAGS), params, cfg, tokenizer,
                                       "cuda")
        try:
            chains, rids, wall = fleet_traffic(engine, requests)
            b = engine.batcher
            stats = [b.request_stats[r] for r in rids]
            pool_clean(b, "serve_fleet_7b")
            return chains, wall, stats, b.prefix_cache_stats(), scheduler_numbers(b)
        finally:
            engine.shutdown()

    (one, one_wall, one_stats, one_pc, one_sched), launches = counted(one_engine)
    k1["one_engine"] = launches[FLASH_KERNEL.source]

    def fleet_run():
        arm_fleet_telemetry()
        fleet = cli_serve.make_engine(parser.parse_args(FLEET_FLAGS + ["--fleet", "2"]), params,
                                      cfg, tokenizer, "cuda")
        threads = replica_threads(fleet)
        try:
            chains, frids, wall = fleet_traffic(fleet, requests)
            telemetry = fleet_telemetry(fleet, frids, "serve_fleet_7b")
            homes = [fleet.replica_of(f) for f in frids]
            per_k1 = replica_k1(fleet, threads, n_layers, "serve_fleet_7b")
            reps = []
            for rep, k in zip(fleet.replicas, per_k1):
                b = rep.engine.batcher
                pc = b.prefix_cache_stats()
                reps.append({"replica": rep.idx, "routed": homes.count(rep.idx),
                             "prefix_hits": pc["hits"], "prefix_misses": pc["misses"],
                             "prefix_entries": pc["n_entries"], "k1_launches": k,
                             "scheduler": scheduler_numbers(b),
                             "pool": pool_clean(b, f"serve_fleet_7b replica {rep.idx}")})
            stats = [fleet.batcher.request_stats.get(f) for f in frids]
            return chains, wall, homes, reps, stats, fleet.fleet_stats(), telemetry
        finally:
            fleet.shutdown()
            disarm_fleet_telemetry()

    torch.cuda.reset_peak_memory_stats()
    (chains, wall, homes, reps, stats, fl, telemetry), launches = counted(fleet_run)
    peak = torch.cuda.max_memory_allocated()
    k1["fleet"] = launches[FLASH_KERNEL.source]
    n = len(QUERIES)
    repeat_home = [homes[st] for st, _, _ in SERVE_EXTRA]
    if homes[n:] != repeat_home or any(reps[h]["prefix_hits"] < 1 for h in homes[n:]):
        raise AssertionError(f"serve_fleet_7b: the repeated sessions went to {homes[n:]} (their "
                             f"first requests' replicas: {repeat_home}) or missed: {reps}")
    if sorted(set(homes)) != [0, 1]:
        raise AssertionError(f"serve_fleet_7b: one replica took all the traffic: {homes}")
    rules = {run: hold_to_oracle(f"serve_fleet_7b {run}", eventchat, llama, params, cfg,
                                 tokenizer, requests, want, got)
             for run, got in (("one_engine", one), ("fleet", chains))}
    emit("serve_fleet_7b", {
        "config": "EventGPT-7B bf16 tree, cli/serve --fleet 2 --max_batch 4 --max_len 1024 "
                  "--chunk 32 --kv_cache int8 --kv_layout paged (the JAX CLI's defaults "
                  "otherwise), two replicas in one process on one card",
        "requests": [f"stream {100 + i} query {i}" for i in range(n)]
        + [f"stream {100 + st} query {q} (repeated session)" for st, q, _ in SERVE_EXTRA],
        "routed_to": homes, "per_replica": reps, "fleet": fl,
        "ttft_s": [s["ttft_s"] for s in stats], "latency_s": [s["latency_s"] for s in stats],
        "wall_s": wall, "one_engine": {"ttft_s": [s["ttft_s"] for s in one_stats],
                                       "latency_s": [s["latency_s"] for s in one_stats],
                                       "wall_s": one_wall, "prefix_hits": one_pc["hits"],
                                       "prefix_misses": one_pc["misses"],
                                       "scheduler": one_sched},
        "fleet_wall_over_one_engine": wall / one_wall, "vs_oracle": rules["fleet"],
        "one_engine_vs_oracle": rules["one_engine"], "k1_launches": k1,
        "telemetry": telemetry, "peak_mem_bytes": peak, "first_ids": [c[:8] for c in chains],
        "nvidia_smi": smi})
    ref = {"want": want, "fleet_wall_s": wall, "one_engine_wall_s": one_wall,
           "fleet_ttft_s": [s["ttft_s"] for s in stats],
           "one_engine_ttft_s": [s["ttft_s"] for s in one_stats],
           "fleet_decode_ms_per_step": [r["scheduler"]["decode_ms_per_step"] for r in reps],
           "one_engine_decode_ms_per_step": one_sched["decode_ms_per_step"]}
    return k1, ref


def fleet_chaos_run(params, cfg, tokenizer, reqs, new_session, flags, n_layers: int,
                    name: str) -> tuple:
    """One arm of ``serve_fleet_chaos_7b``: a two-replica fleet takes the
    four requests; once each replica has a row with committed tokens and
    budget left, ``fleet.replica_kill:n=1`` is armed, and the supervisor's next tick kills
    the busiest replica. Its requests drain through ``export_requests`` and
    re-decode on the survivor. Once they are moved, ``restart_replica``
    brings the dead replica back and a new session must route to it (the
    survivor is busy). Returns (numbers, chains of the four and the new
    session)."""
    import torch

    from eventgpt_tpu_torch import faults
    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    args = cli_serve.build_parser().parse_args(FLEET_FLAGS + list(flags) + ["--fleet", "2"])
    arm_fleet_telemetry()
    fleet = cli_serve.make_engine(args, params, cfg, tokenizer, "cuda")
    threads = replica_threads(fleet)
    kill = fleet.kill_replica
    at_kill, submitted = {}, {}

    def timed_kill(idx):
        rows = fleet.replicas[idx].engine.batcher.rows
        at_kill.update(t=time.perf_counter(), idx=idx,
                       k1=[sum(FLASH_KERNEL.launches_by_thread[t] for t in ts) for ts in threads],
                       dispatches=[dict(rep.engine.batcher.dispatches) for rep in fleet.replicas],
                       tokens={r.rid: len(r.tokens) for r in rows if r is not None})
        moved = kill(idx)
        at_kill.update(moved=moved, t_moved=time.perf_counter())
        return moved

    fleet.kill_replica = timed_kill
    for rep in fleet.replicas:
        def traced(*a, submit=rep.engine.submit_ids, idx=rep.idx, **kw):
            rid = submit(*a, **kw)
            submitted[idx, rid] = time.perf_counter()
            return rid

        rep.engine.submit_ids = traced
    try:
        frids = [fleet.submit_ids(*r) for r in reqs]
        homes = [fleet.replica_of(f) for f in frids]
        wait_for(lambda: all(any(r is not None and 0 < len(r.tokens) <= CHAOS_BUDGET // 2
                                 for r in rep.engine.batcher.rows) for rep in fleet.replicas),
                 f"{name}: a row mid-decode on each replica")
        faults.configure("fleet.replica_kill:n=1")
        wait_for(lambda: "moved" in at_kill, f"{name}: the scripted kill")
        faults.disable()
        dead = at_kill["idx"]
        survivor = 1 - dead
        moved = [f for f in frids if fleet._requests[f].failovers]
        if (not moved or at_kill["moved"] != len(moved)
                or not any(0 < n < CHAOS_BUDGET for n in at_kill["tokens"].values())):
            raise AssertionError(f"{name}: the kill moved {at_kill['moved']} requests "
                                 f"({moved}); rows at the kill: {at_kill['tokens']}")
        fleet.restart_replica(dead)
        survivor_depth = fleet.replicas[survivor].depth()
        f_new = fleet.submit_ids(*new_session)
        if fleet.replica_of(f_new) != dead:
            raise AssertionError(f"{name}: the new session went to replica "
                                 f"{fleet.replica_of(f_new)}, not the restarted {dead} "
                                 f"(survivor depth {survivor_depth})")
        chains = [fleet.result(f, timeout=WAIT_S) for f in frids + [f_new]]
        wait_for(lambda: all(not rep.engine.batcher.queue and all(
            r is None for r in rep.engine.batcher.rows) for rep in fleet.replicas),
            f"{name}: the drain")
        per_k1 = replica_k1(fleet, threads, n_layers, name)
        first_token = []
        for f in moved:
            freq = fleet._requests[f]
            st = fleet.replicas[freq.replica].engine.batcher.request_stats[freq.rid]
            first_token.append(submitted[freq.replica, freq.rid] + st["ttft_s"] - at_kill["t"])
        statuses = [fleet.status(f) for f in frids + [f_new]]
        if statuses != ["ok"] * len(statuses):
            raise AssertionError(f"{name}: statuses {statuses}")
        numbers = {
            "flags": " ".join(flags), "routed_to": homes, "killed": dead,
            "rows_at_kill_tokens": at_kill["tokens"], "moved_requests": moved,
            "moved_to": [fleet.replica_of(f) for f in moved],
            "kill_s": at_kill["t_moved"] - at_kill["t"],
            "first_token_after_kill_s": first_token,
            "k1_by_replica": per_k1,
            "k1_survivor_after_kill": per_k1[survivor] - at_kill["k1"][survivor],
            "k1_dead_before_kill": at_kill["k1"][dead],
            "new_session_replica": fleet.replica_of(f_new),
            "survivor_depth_at_new_session": survivor_depth,
            "pools": [pool_clean(rep.engine.batcher, f"{name} replica {rep.idx}")
                      for rep in fleet.replicas],
            "survivor_dispatches_after_kill": {
                k: n - at_kill["dispatches"][survivor].get(k, 0)
                for k, n in fleet.replicas[survivor].engine.batcher.dispatches.items()},
            "scheduler": [scheduler_numbers(rep.engine.batcher) for rep in fleet.replicas],
            "fleet": fleet.fleet_stats(),
            "telemetry": fleet_telemetry(fleet, frids + [f_new], name)}
        return numbers, chains
    finally:
        faults.disable()
        fleet.shutdown()
        disarm_fleet_telemetry()
        del fleet
        torch.cuda.empty_cache()


def serve_fleet_chaos_7b(eventchat, llama, params, cfg, tokenizer, ids, pixels, counted,
                         n_layers: int, smi: str) -> dict:
    """``serve_fleet_chaos_7b``: ``fleet_chaos_run`` in each of CHAOS_ARMS,
    held to the single-engine oracle (the new session is stream 100's frames
    mirrored, query 1). Returns {arm: K1 launches}."""
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    reqs = [(ids[i], pixels[i], CHAOS_BUDGET) for i in range(len(QUERIES))]
    new_session = (ids[1], pixels[0][..., ::-1].copy(), 16)
    k1 = {}
    for arm, flags in CHAOS_ARMS:
        want = serve_oracle(params, cfg, tokenizer, reqs + [new_session], flags)
        (numbers, chains), launches = counted(
            lambda: fleet_chaos_run(params, cfg, tokenizer, reqs, new_session, flags, n_layers,
                                    f"serve_fleet_chaos_7b {arm}"))
        k1[arm] = launches[FLASH_KERNEL.source]
        rule = hold_to_oracle(f"serve_fleet_chaos_7b {arm}", eventchat, llama, params, cfg,
                              tokenizer, reqs + [new_session], want, chains, CHAOS_BUDGET)
        emit(f"serve_fleet_chaos_7b_{arm}", {**numbers, "vs_oracle": rule, "k1_launches": k1[arm],
                                            "first_ids": [c[:8] for c in chains],
                                            "nvidia_smi": smi})
    return k1


def serve_breaker_7b(eventchat, llama, params, cfg, tokenizer, ids, pixels, work: str,
                     counted, n_layers: int, smi: str) -> dict:
    """``serve_breaker_7b``: one engine from ``make_engine`` (2 rows, breaker
    threshold 3, cooldown 2 s, pipelined) at 7B, under ``make_handler``.
    ``serve.dispatch:n=2``: the second dispatch faults with the first
    segment in flight; the rows then in flight end as ``engine_fault``, the
    queued requests survive and the restarted scheduler's chains equal the
    oracle's. Then ``serve.dispatch:every=1,times=3`` over six requests: the
    third fault in a row opens the breaker and fails the queue; ``GET
    /health`` reads 503 ``degraded`` and a POST gets a 503, each with the
    remaining cooldown as Retry-After, and ``submit`` is refused; after the
    cooldown a clean request closes the breaker. Returns {run: K1
    launches}."""
    import base64
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    from eventgpt_tpu_torch import faults
    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    reqs = [(ids[i], pixels[i], MAX_NEW_TOKENS) for i in range(len(QUERIES))]
    want = serve_oracle(params, cfg, tokenizer, reqs, ["--max_batch", "2"])
    args = cli_serve.build_parser().parse_args(FLEET_FLAGS + BREAKER_FLAGS)
    engine = cli_serve.make_engine(args, params, cfg, tokenizer, "cuda")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), cli_serve.make_handler(engine, cfg))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]

    def ask(method, path, obj=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request(method, path, body=None if obj is None else json.dumps(obj))
        res = conn.getresponse()
        return res.status, dict(res.getheaders()), json.loads(res.read())

    def served(batch):
        """Submit every request, then each one's chain, or None if it failed."""
        rids = [engine.submit_ids(*r) for r in batch]
        out = []
        for rid in rids:
            try:
                out.append(engine.result(rid, timeout=WAIT_S))
            except RuntimeError:
                out.append(None)
        return out

    k1 = {}
    try:
        faults.configure("serve.dispatch:n=2")
        got, launches = counted(lambda: served(reqs))
        k1["one_fault"] = launches[FLASH_KERNEL.source]
        failed = [i for i, c in enumerate(got) if c is None]
        kept = [i for i, c in enumerate(got) if c is not None]
        if not failed or not kept or engine.n_faults != 1 or engine.breaker_open():
            raise AssertionError(f"serve_breaker_7b: {failed} failed, {kept} served, "
                                 f"{engine.n_faults} faults, breaker {engine.breaker_open()}")
        rule = hold_to_oracle("serve_breaker_7b", eventchat, llama, params, cfg, tokenizer,
                              [reqs[i] for i in kept], [want[i] for i in kept],
                              [got[i] for i in kept])
        one_fault = {"failed_requests": failed, "served_requests": kept, "vs_oracle": rule,
                     "statuses": [engine.status(r) for r in range(len(reqs))],
                     "restarts": engine.n_restarts, "k1_launches": k1["one_fault"]}
        faults.configure("serve.dispatch:every=1,times=3")
        streak = reqs + reqs[:2]
        t0 = time.perf_counter()
        got, launches = counted(lambda: served(streak))
        k1["streak"] = launches[FLASH_KERNEL.source]
        if any(c is not None for c in got) or not engine.breaker_open() or engine.n_faults != 4:
            raise AssertionError(f"serve_breaker_7b: after the streak {engine.n_faults} faults, "
                                 f"breaker open {engine.breaker_open()}, served "
                                 f"{[c is not None for c in got]}")
        t_open = time.perf_counter()
        code, headers, health = ask("GET", "/health")
        with open(os.path.join(work, "events_0.npy"), "rb") as f:
            b64 = base64.b64encode(f.read()).decode()
        post_code, post_headers, post = ask("POST", "/v1/generate",
                                            {"query": QUERIES[0], "event_b64": b64})
        try:
            engine.submit_ids(*reqs[0])
            refused = False
        except RuntimeError:
            refused = True
        if (code != 503 or health["status"] != "degraded" or post_code != 503 or not refused
                or int(headers["Retry-After"]) < 1 or int(post_headers["Retry-After"]) < 1):
            raise AssertionError(f"serve_breaker_7b: the open breaker answered /health {code} "
                                 f"{health}, POST {post_code} {post}, submit refused {refused}")
        half_open_s = wait_for(lambda: not engine.breaker_open(), "the half-open breaker")
        clean, launches = counted(lambda: served(reqs[:1]))
        k1["clean"] = launches[FLASH_KERNEL.source]
        closed_code, _, closed = ask("GET", "/health")
        if clean[0] != want[0] or engine.fault is not None or closed_code != 200:
            raise AssertionError(f"serve_breaker_7b: after the cooldown the clean request gave "
                                 f"the oracle's chain: {clean[0] == want[0]}, fault "
                                 f"{engine.fault}, /health {closed_code}")
        line = {
            "flags": " ".join(FLEET_FLAGS + BREAKER_FLAGS), "one_fault": one_fault,
            "streak": {"requests": len(streak), "faults": engine.n_faults,
                       "restarts": engine.n_restarts, "streak_s": t_open - t0,
                       "health": {"code": code, "retry_after": headers["Retry-After"], **health},
                       "post": {"code": post_code, "retry_after": post_headers["Retry-After"],
                                **post},
                       "submit_refused": refused, "half_open_after_s": half_open_s,
                       "k1_launches": k1["streak"]},
            "closed": {"health_code": closed_code, "restarts": closed["restarts"],
                       "chain_equals_oracle": True, "k1_launches": k1["clean"]},
            "nvidia_smi": smi}
    finally:
        faults.disable()
        httpd.shutdown()
        httpd.server_close()
        engine.shutdown()
    # The line is printed once the engine is gone: a live paged server's
    # prefix entries count in its pool and in its prefix cache (as in the
    # JAX ledger), so its ledger can pass the card's allocated bytes.
    del engine, httpd
    emit("serve_breaker_7b", line)
    return k1


def handoff_wire_7b(params, cfg, tokenizer, outs, want, counted, smi: str) -> int:
    """``handoff_wire_7b``: ``serve_handoff_7b``'s plain records through the
    RPC wire (``rpc.dumps_frame``, then ``rpc.loads_frame``), every plane bit
    for bit, then spliced into a fresh decode-role batcher and drained to the
    in-process handoff's chains; bytes per record and ms to encode and to
    decode. Returns the decode role's K1 launches (0: a splice is a
    scatter)."""
    import torch

    from eventgpt_tpu_torch import rpc
    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    def leaves(x):
        if isinstance(x, dict):
            return [t for v in x.values() for t in leaves(v)]
        return [x] if isinstance(x, torch.Tensor) else []

    wired, frame_bytes, enc_ms, dec_ms = [], [], [], []
    for o in outs:
        msg = {k: v for k, v in o.items() if k != "t_gather"}
        t0 = time.perf_counter()
        buf = rpc.dumps_frame(msg)
        t1 = time.perf_counter()
        back = rpc.loads_frame(buf)
        t2 = time.perf_counter()
        for got, sent in zip(leaves(back["rec"]), leaves(msg["rec"])):
            if got.dtype != sent.dtype or not torch.equal(got.reshape(-1).view(torch.uint8),
                                                          sent.reshape(-1).view(torch.uint8)):
                raise AssertionError("handoff_wire_7b: a plane changed on the wire")
        frame_bytes.append(len(buf))
        enc_ms.append((t1 - t0) * 1e3)
        dec_ms.append((t2 - t1) * 1e3)
        wired.append((o, back))
        del buf
    args = cli_serve.build_parser().parse_args(FLEET_FLAGS)
    dec = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda", role="decode")

    def decode_leg():
        rids = [dec.import_handoff(
            b["input_ids"], b["max_new_tokens"], b["rec"], tokens=b["tokens"],
            prompt_len=b["prompt_len"], deadline_s=b["deadline_s"], slo=b["slo"],
            elapsed_s=b["elapsed_s"] + time.perf_counter() - o["t_gather"], ttft_s=b["ttft_s"])
            for o, b in wired]
        done = dec.run_until_drained()
        return [done[r] for r in rids]

    chains, launches = counted(decode_leg)
    if chains != want or launches[FLASH_KERNEL.source] != 0:
        raise AssertionError(f"handoff_wire_7b: chains equal the in-process handoff's: "
                             f"{chains == want}; K1 launches {launches} (want 0)")
    emit("handoff_wire_7b", {
        "records": len(outs), "frame_bytes": frame_bytes,
        "kv_bytes": [o["rec"]["nbytes_kv"] for o in outs],
        "encode_ms": enc_ms, "decode_ms": dec_ms,
        "encode_gb_s": [n / max(ms, 1e-9) / 1e6 for n, ms in zip(frame_bytes, enc_ms)],
        "decode_gb_s": [n / max(ms, 1e-9) / 1e6 for n, ms in zip(frame_bytes, dec_ms)],
        "over_the_socket_frame_cap": [n > rpc.MAX_MSG_BYTES for n in frame_bytes],
        "chains_equal_in_process_handoff": True, "pool": pool_clean(dec, "handoff_wire_7b"),
        "k1_launches": 0, "nvidia_smi": smi})
    del dec
    torch.cuda.empty_cache()
    return launches[FLASH_KERNEL.source]


def tiny_fleet_card_vs_cpu() -> dict:
    """The fleet traffic and kill on a tiny f32 model, on the card and on the
    CPU: two engines with parked loops take the four requests (routed by
    least queue), replica 0's batcher steps once (its rows admitted, one
    segment in flight), ``kill_replica(0)`` moves its requests to replica 1,
    the loops start; after ``restart_replica(0)`` the two repeated sessions
    follow their pins and a new one goes to the idle replica 0. Chains,
    routing and failovers must be identical."""
    import numpy as np
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer
    from eventgpt_tpu_torch.fleet import Fleet
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    cfg = EventChatConfig.tiny(vocab_size=260)
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(4), torch.float32, "cpu")
    size = cfg.vision.image_size

    def pv(seed):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(cfg.num_event_frames, 3, size, size)).astype(np.float32)

    head = [1, 7, 7, -200, 9, 10, 11]
    first = [(head + [20 + i], pv(i), 10) for i in range(4)]
    later = [(head + [30], pv(0), 6), (head + [31], pv(1), 6), (head + [32], pv(9), 6)]
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        tok = ByteTokenizer()
        engines = [cli_serve.ServingEngine(
            ContinuousBatcher(params, cfg, max_batch=2, max_len=256, chunk=2, eos_token_id=None,
                              kv_quant=True, kv_layout="paged", device=dev), tok, start=False)
            for _ in range(2)]
        fleet = Fleet(engines, tok, probe_interval_s=0.01)
        try:
            frids = [fleet.submit_ids(*r) for r in first]
            homes = [fleet.replica_of(f) for f in frids]
            with engines[0]._lock:
                engines[0].batcher.step()
            moved = fleet.kill_replica(0)
            for eng in engines:
                eng.start()
            chains = [fleet.result(f, timeout=WAIT_S) for f in frids]
            fleet.restart_replica(0)
            late = [fleet.submit_ids(*r) for r in later[:2]]
            chains += [fleet.result(f, timeout=WAIT_S) for f in late]
            f_new = fleet.submit_ids(*later[2])
            chains.append(fleet.result(f_new, timeout=WAIT_S))
            runs[dev] = {"chains": chains, "routed_to": homes, "moved": moved,
                         "after": [fleet.replica_of(f) for f in frids + late + [f_new]],
                         "failovers": fleet.n_failovers}
        finally:
            fleet.shutdown()
    if runs["cpu"] != runs["cuda"]:
        raise AssertionError(f"tiny fleet differs: cpu {runs['cpu']} vs cuda {runs['cuda']}")
    if runs["cuda"]["moved"] < 1 or runs["cuda"]["after"][-1] != 0:
        raise AssertionError(f"tiny fleet: the kill moved nothing or the new session did not "
                             f"go to the restarted replica: {runs['cuda']}")
    return {"config": "tiny f32, paged, int8 KV, 2 replicas of 2 rows, chunk 2", "identical": True,
            **{k: v for k, v in runs["cuda"].items() if k != "chains"},
            "tokens": [len(c) for c in runs["cuda"]["chains"]]}


# The process fleet's 7B workers load the checkpoint that ``checkpoint_7b``
# wrote. A boot imports torch, starts a CUDA context and loads 14.2 GB.
PROCFLEET_BOOT_S = 600.0
# serve_telemetry_7b: the served flags; the bound of a server's boot; the
# profile window, which starts PROFILE_LEAD_S before the guarded run's
# requests (that server runs --warmup, so the first request's prefill comes
# within a second, inside the window, with no lazy module loading in it);
# the ledger's reconciliation bar (the JAX package's,
# tests/test_memory_ledger.py).
TELEMETRY_FLAGS = ["--max_batch", "4", "--max_len", "1024", "--chunk", "32", "--kv_cache",
                   "int8", "--kv_layout", "paged"]
TELEMETRY_BOOT_S = 600.0
# The requests of ``telemetry_requests`` that go out with "stream": true: one
# of the first four, one of the late two.
TELEMETRY_STREAMED = (1, 4)
PROFILE_SECONDS = 2.0
PROFILE_LEAD_S = 0.3
RECONCILE_MIN = 0.9


def procfleet_args(ckpt: str, *flags):
    """``cli/serve --proc_fleet 2`` over the 7B checkpoint with
    ``FLEET_FLAGS`` (each worker on the card, as ``--device`` defaults)."""
    from eventgpt_tpu_torch.cli import serve as cli_serve

    return cli_serve.build_parser().parse_args(
        ["--model_path", ckpt, "--tokenizer_path", "byte", "--proc_fleet", "2",
         "--procfleet_spawn_timeout_s", str(PROCFLEET_BOOT_S), *FLEET_FLAGS, *flags])


def smi_used_mib() -> list:
    """The card's used memory in MiB, by ``nvidia-smi`` (every process)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [int(x) for x in res.stdout.split()]


def worker_numbers(fleet, n_layers: int, name: str, only=None) -> list:
    """Each worker's (or the ``only`` ones') ``stats`` op: its kernel launches
    (K1 held to 32 per full-prefill dispatch of its own batcher), scheduler
    numbers, prefix counters, pool and peak device memory, and its boot
    time."""
    out = []
    for slot in fleet.slots if only is None else [fleet.slots[i] for i in only]:
        st = fleet.worker_stats(slot.idx)
        k1 = st["launches"]["flash_attention.cu"]
        full = sum(st["dispatches"].get(k, 0) for k in ("full", "wave", "prefix_set"))
        if k1 != n_layers * full:
            raise AssertionError(f"{name}: worker {slot.idx} launched K1 {k1} times for {full} "
                                 f"full prefills (want {n_layers} each)")
        sched = st["scheduler"]
        out.append({"worker": slot.idx, "role": slot.role, "generation": slot.generation,
                    "boot_s": slot.t_ready - slot.t_spawn, "launches": st["launches"], "k1": k1,
                    "dispatches": st["dispatches"], "requests": st["requests"],
                    "prefix_hits": st["prefix_cache"].get("hits", 0),
                    "prefix_misses": st["prefix_cache"].get("misses", 0),
                    "scheduler": {**sched, "decode_ms_per_step":
                                  sched["decode_s"] * 1e3 / max(sched["decode_steps"], 1)},
                    "kv_blocks": st.get("kv_blocks"), "handoff": st.get("handoff"),
                    "cuda_max_allocated": st.get("cuda_memory", {}).get("max_allocated"),
                    "cuda_max_reserved": st.get("cuda_memory", {}).get("max_reserved")})
    return out


def procfleet_pools_clean(fleet, name: str) -> list:
    """After a drain only prefix entries hold blocks, on every worker (a fresh
    snapshot each)."""
    out = []
    for slot in fleet.slots:
        snap = fleet._rpc(slot, "snapshot", deadline_s=30.0)
        st, held = snap["kv_blocks"], snap["prefix_cache"].get("blocks_held", 0)
        if (st["free_blocks"] != st["usable_blocks"] - held or st["spilled_runs"]
                or snap["handoff"]["pending"]):
            raise AssertionError(f"{name}: worker {slot.idx}'s pool is not clean after the "
                                 f"drain: {st}, {held} held by prefix entries, handoff "
                                 f"{snap['handoff']}")
        out.append({"worker": slot.idx, "free_blocks": st["free_blocks"],
                    "usable_blocks": st["usable_blocks"], "prefix_blocks_held": held})
    return out


def tree_to_(tree, device) -> None:
    """Move every tensor leaf of ``tree`` to ``device`` in place: its dicts
    and lists stay the objects they are, so every holder of the tree sees
    the move (a leaf held twice moves once). No closure: a recursive inner
    function would sit in a reference cycle with the memo, and the old
    leaves would outlive the call until the next garbage collection."""
    moved, stack = {}, [tree]
    while stack:
        node = stack.pop()
        for k, v in list(node.items() if isinstance(node, dict) else enumerate(node)):
            if isinstance(v, (dict, list)):
                stack.append(v)
            elif hasattr(v, "to"):
                if id(v) not in moved:
                    moved[id(v)] = (v, v.to(device))
                node[k] = moved[id(v)][1]


def card_room(params) -> dict:
    """Clear the script's share of the card before worker processes load
    their own 7B trees: collect Python garbage (objects of earlier phases
    left in reference cycles), then move the held tree to the host until
    ``tree_to_(params, "cuda")``. The bytes the script holds at each step;
    the peak counter starts again here."""
    import gc

    import torch

    out = {"allocated": torch.cuda.memory_allocated()}
    gc.collect()
    torch.cuda.empty_cache()
    out["after_gc"] = torch.cuda.memory_allocated()
    tree_to_(params, "cpu")
    torch.cuda.empty_cache()
    out["tree_on_host"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return out


def procfleet_chaos_requests(ids, pixels) -> tuple:
    """``serve_procfleet_chaos_7b``'s traffic: the four of 64 tokens, and
    the new session that must route to the respawned worker (stream 100's
    frames mirrored, query 1)."""
    return ([(ids[i], pixels[i], CHAOS_BUDGET) for i in range(len(QUERIES))],
            (ids[1], pixels[0][..., ::-1].copy(), 16))


def procfleet_chaos(fleet, reqs, new_session, counted, n_layers: int, smi: str) -> tuple:
    """``serve_procfleet_chaos_7b`` on the colocated fleet: the four of 64
    tokens; ``procfleet.worker_kill:n=1`` SIGKILLs the busiest worker once
    its rows hold 32 tokens of 64; its requests redo on the survivor from the
    coordinator's records, the slot respawns, and a new session routes to
    it. Returns (the phase's numbers, the chains of ``reqs`` and the new
    session, which the caller holds to the single-engine oracle once the
    workers are gone, the K1 launches by worker)."""
    from eventgpt_tpu_torch import faults

    fleet.reset_stats()
    at_kill = {}
    kill = fleet.kill_worker

    def timed_kill(idx):
        at_kill.update(t=time.perf_counter(), idx=idx,
                       inflight=[s.inflight for s in fleet.slots])
        kill(idx)

    fleet.kill_worker = timed_kill

    def mid_decode():
        # The worker the kill takes (the busiest): its second segment is in
        # flight, so its rows hold 32 tokens of 64 (steps count at dispatch).
        slot = max(fleet.slots, key=lambda s: (s.inflight, -s.idx))
        snap = fleet._rpc(slot, "snapshot", deadline_s=30.0)
        return snap["active_rows"] > 0 and snap["decode_steps_run"] >= 2 * 32

    def run():
        # Streamed, so that the moved requests' streams must survive the
        # redo (delivered at the finish).
        frids = [fleet.submit_ids(*r, stream=True) for r in reqs]
        homes = [fleet.worker_of(f) for f in frids]
        wait_for(mid_decode, "serve_procfleet_chaos_7b: the busiest worker mid-decode")
        faults.configure("procfleet.worker_kill:n=1")
        wait_for(lambda: fleet.n_deaths >= 1, "serve_procfleet_chaos_7b: the scripted SIGKILL")
        faults.disable()
        chains = [fleet.result(f, timeout=WAIT_S) for f in frids]
        return frids, homes, chains

    try:
        (frids, homes, chains), launches = counted(run)
    finally:
        faults.disable()
        fleet.kill_worker = kill
    victim, survivor = at_kill["idx"], 1 - at_kill["idx"]
    moved = [f for f in frids if fleet._requests[f].failovers]
    if not moved or any(fleet.worker_of(f) != survivor for f in moved):
        raise AssertionError(f"serve_procfleet_chaos_7b: the kill of worker {victim} moved "
                             f"{moved} to {[fleet.worker_of(f) for f in moved]}")
    delivered = [stream_delivered(fleet, f) for f in frids]
    if delivered != [[c, None] for c in chains]:
        raise AssertionError(f"serve_procfleet_chaos_7b: the streams delivered "
                             f"{[[x if x is None else len(x) for x in d] for d in delivered]}, "
                             f"not each chain and the end")
    first_token = [fleet._requests[f].t_assign + fleet._requests[f].stats["ttft_s"] - at_kill["t"]
                   for f in moved]
    survivor_stats = worker_numbers(fleet, n_layers, "serve_procfleet_chaos_7b",
                                    only=[survivor])[0]
    respawn_s = wait_for(lambda: all(s.state == "ok" for s in fleet.slots),
                         "serve_procfleet_chaos_7b: the respawn")
    f_new = fleet.submit_ids(*new_session)
    chains.append(fleet.result(f_new, timeout=WAIT_S))
    if fleet.worker_of(f_new) != victim:
        raise AssertionError(f"serve_procfleet_chaos_7b: the new session went to worker "
                             f"{fleet.worker_of(f_new)}, not the respawned {victim}")
    workers = worker_numbers(fleet, n_layers, "serve_procfleet_chaos_7b respawned")
    telemetry = procfleet_telemetry(fleet, frids + [f_new], "serve_procfleet_chaos_7b")
    statuses = [fleet.status(f) for f in frids + [f_new]]
    if statuses != ["ok"] * len(statuses) or launches["flash_attention.cu"]:
        raise AssertionError(f"serve_procfleet_chaos_7b: statuses {statuses}, coordinator "
                             f"launches {launches}")
    slot = fleet.slots[victim]
    numbers = {
        "flags": " ".join(FLEET_FLAGS), "routed_to": homes, "killed": victim,
        "inflight_at_kill": at_kill["inflight"], "moved_requests": moved,
        "moved_to": [fleet.worker_of(f) for f in moved],
        "first_token_after_kill_s": first_token,
        "survivor_after_kill": {k: survivor_stats[k] for k in ("k1", "dispatches", "scheduler")},
        "respawn": {"generation": slot.generation, "boot_s": slot.t_ready - slot.t_spawn,
                    "crashes": len(slot.crashes), "respawns": fleet.n_respawns,
                    "wait_after_results_s": respawn_s},
        "new_session_worker": fleet.worker_of(f_new), "respawned_k1": workers[victim]["k1"],
        "streamed_moved_delivered": [len(delivered[frids.index(f)][0]) for f in moved],
        "telemetry": telemetry,
        "cuda_max_allocated_by_worker": [w["cuda_max_allocated"] for w in workers],
        "fleet": fleet.fleet_stats(), "first_ids": [c[:8] for c in chains], "nvidia_smi": smi}
    return numbers, chains, {"survivor_after_kill": survivor_stats["k1"],
                             "respawned": workers[victim]["k1"]}


def serve_procfleet_7b(eventchat, llama, params, cfg, tokenizer, ids, pixels, requests,
                       ckpt: str, fleet_ref: dict, counted, n_layers: int, smi: str) -> dict:
    """``serve_procfleet_7b``: ``cli/serve --proc_fleet 2`` (two worker
    processes, each loading the 7B checkpoint onto the card with
    ``FLEET_FLAGS``) given ``serve_fleet_7b``'s traffic, held to its oracle:
    routing and affinity hits, K1 by worker (each worker's ``stats`` op),
    boot, wall, TTFTs and each worker's decode ms per step against one engine
    and the in-process ``--fleet 2`` of this call; then
    ``serve_procfleet_chaos_7b`` on the same fleet; then
    ``serve_disagg_7b``. While the workers are up the script's tree waits on
    the host (``card_room``), so the card holds the two workers and little
    else; the oracles run before the spawn and the chains are held to them
    after the shutdown. Returns {run: K1 launches by worker}."""
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve

    want = fleet_ref["want"]
    chaos_reqs, new_session = procfleet_chaos_requests(ids, pixels)
    chaos_want = serve_oracle(params, cfg, tokenizer, chaos_reqs + [new_session])
    memory = card_room(params)
    k1 = {}
    try:
        used = {"before": smi_used_mib()}
        t0 = time.perf_counter()
        _, fleet = cli_serve.build_engine(procfleet_args(ckpt))
        boot_s = time.perf_counter() - t0
        try:
            used["workers_up"] = smi_used_mib()
            (chains, frids, wall), launches = counted(
                lambda: fleet_traffic(fleet, requests, streamed=(0,)))
            used["after_traffic"] = smi_used_mib()
            homes = [fleet.worker_of(f) for f in frids]
            workers = worker_numbers(fleet, n_layers, "serve_procfleet_7b")
            telemetry = procfleet_telemetry(fleet, frids, "serve_procfleet_7b")
            n = len(QUERIES)
            repeat_home = [homes[st] for st, _, _ in SERVE_EXTRA]
            if (homes[n:] != repeat_home or sorted(set(homes)) != [0, 1]
                    or any(workers[h]["prefix_hits"] < 1 for h in homes[n:])):
                raise AssertionError(f"serve_procfleet_7b: routed {homes}, the repeats' first "
                                     f"requests on {repeat_home}; workers {workers}")
            if ([w["k1"] for w in workers] != [n_layers, n_layers]
                    or launches["flash_attention.cu"]):
                raise AssertionError(f"serve_procfleet_7b: K1 by worker "
                                     f"{[w['k1'] for w in workers]} (want {n_layers} + "
                                     f"{n_layers}), coordinator {launches}")
            stats = [fleet.batcher.request_stats.get(f) for f in frids]
            k1["colocated"] = [w["k1"] for w in workers]
            colocated = {
                "config": "EventGPT-7B bf16 checkpoint, cli/serve --proc_fleet 2 "
                          + " ".join(FLEET_FLAGS) + ", two worker processes on one card",
                "boot_s": boot_s, "routed_to": homes, "per_worker": workers,
                "ttft_s": [s["ttft_s"] for s in stats],
                "latency_s": [s["latency_s"] for s in stats], "wall_s": wall,
                "in_process_fleet": {k: v for k, v in fleet_ref.items() if k != "want"},
                "wall_over_in_process_fleet": wall / fleet_ref["fleet_wall_s"],
                "wall_over_one_engine": wall / fleet_ref["one_engine_wall_s"],
                "streamed": [0], "telemetry": telemetry,
                "smi_used_mib": used, "fleet": fleet.fleet_stats(),
                "first_ids": [c[:8] for c in chains], "nvidia_smi": smi}
            chaos, chaos_chains, k1["chaos"] = procfleet_chaos(
                fleet, chaos_reqs, new_session, counted, n_layers, smi)
        finally:
            fleet.shutdown()
        memory["max_allocated_workers_up"] = torch.cuda.max_memory_allocated()
    finally:
        tree_to_(params, "cuda")
    colocated["script_memory"] = memory
    colocated["vs_oracle"] = hold_to_oracle("serve_procfleet_7b", eventchat, llama, params, cfg,
                                            tokenizer, requests, want, chains)
    emit("serve_procfleet_7b", colocated)
    chaos["vs_oracle"] = hold_to_oracle("serve_procfleet_chaos_7b", eventchat, llama, params, cfg,
                                        tokenizer, chaos_reqs + [new_session], chaos_want,
                                        chaos_chains, CHAOS_BUDGET)
    emit("serve_procfleet_chaos_7b", chaos)
    k1["disagg"] = serve_disagg_7b(eventchat, llama, params, cfg, tokenizer, requests[:len(QUERIES)],
                                   want[:len(QUERIES)], ckpt, counted, n_layers, smi)
    return k1


def serve_disagg_7b(eventchat, llama, params, cfg, tokenizer, reqs, want, ckpt: str, counted,
                    n_layers: int, smi: str) -> list:
    """``serve_disagg_7b``: ``--proc_fleet 2 --proc_fleet_roles 1:1`` on the
    four requests. The prefill worker admits them as one wave, each record
    (13-14 blocks, 225-242 MB) crosses to the coordinator and on to the
    decode worker as a run of capped frames; chains held to the colocated
    oracle once the workers are gone, both pools clean after the drain, K1
    32 on the prefill worker and 0 on the decode worker. Reports each
    message's bytes and frames, the coordinator's collect-to-import seconds
    per record and the rebased TTFT. Returns the K1 launches by worker."""
    import torch

    from eventgpt_tpu_torch import rpc
    from eventgpt_tpu_torch.cli import serve as cli_serve

    memory = card_room(params)
    sizes = {"sent": [], "received": []}
    send, recv = rpc.send_frames, rpc.recv_msg

    def send_frames(sock, data):
        sizes["sent"].append(len(data))
        return send(sock, data)

    def recv_msg(sock):
        data = recv(sock)
        sizes["received"].append(len(data))
        return data

    try:
        t0 = time.perf_counter()
        _, fleet = cli_serve.build_engine(procfleet_args(ckpt, "--proc_fleet_roles", "1:1"))
        boot_s = time.perf_counter() - t0
        rpc.send_frames, rpc.recv_msg = send_frames, recv_msg
        try:
            used = {"workers_up": smi_used_mib()}

            def run():
                t0 = time.perf_counter()
                frids = [fleet.submit_ids(*r) for r in reqs]
                chains = [fleet.result(f, timeout=WAIT_S) for f in frids]
                return chains, frids, time.perf_counter() - t0

            (chains, frids, wall), launches = counted(run)
            used["after_traffic"] = smi_used_mib()
            workers = worker_numbers(fleet, n_layers, "serve_disagg_7b")
            journeys, problems = fleet_journeys(fleet, frids, "serve_disagg_7b", handoffs=True)
            if problems:
                raise AssertionError("; ".join(problems))
            pools = procfleet_pools_clean(fleet, "serve_disagg_7b")
            fl = fleet.fleet_stats()
            if ([w["k1"] for w in workers] != [n_layers, 0] or launches["flash_attention.cu"]
                    or fl["handoffs"]["shipped"] != len(reqs) or fl["handoffs"]["redos"]
                    or any(fleet.worker_of(f) != 1 for f in frids)):
                raise AssertionError(f"serve_disagg_7b: K1 by worker "
                                     f"{[w['k1'] for w in workers]} (want {n_layers}, 0), "
                                     f"handoffs {fl['handoffs']}, ended on "
                                     f"{[fleet.worker_of(f) for f in frids]}")
            big_sent = [n for n in sizes["sent"] if n > rpc.MAX_MSG_BYTES]
            big_received = [n for n in sizes["received"] if n > rpc.MAX_MSG_BYTES]
            if len(big_sent) != len(reqs):
                raise AssertionError(f"serve_disagg_7b: {len(big_sent)} import messages above "
                                     f"the frame cap, want {len(reqs)}: {sizes}")
            stats = [fleet.batcher.request_stats.get(f) for f in frids]
            numbers = {
                "config": "EventGPT-7B bf16 checkpoint, cli/serve --proc_fleet 2 "
                          "--proc_fleet_roles 1:1 " + " ".join(FLEET_FLAGS),
                "boot_s": boot_s, "per_worker": workers, "pools": pools,
                "import_messages": {"bytes": big_sent,
                                    "frames": [rpc.run_frames(n) for n in big_sent]},
                "collect_messages": {"bytes": big_received,
                                     "frames": [rpc.run_frames(n) for n in big_received]},
                "kv_bytes_shipped": fl["handoffs"]["bytes"],
                "handoff_s": [fleet._requests[f].handoff_s for f in frids],
                "journeys": journeys,
                "rebased_ttft_s": [s["ttft_s"] for s in stats],
                "latency_s": [s["latency_s"] for s in stats], "wall_s": wall,
                "smi_used_mib": used, "fleet": fl, "first_ids": [c[:8] for c in chains],
                "nvidia_smi": smi}
        finally:
            rpc.send_frames, rpc.recv_msg = send, recv
            fleet.shutdown()
        memory["max_allocated_workers_up"] = torch.cuda.max_memory_allocated()
    finally:
        tree_to_(params, "cuda")
    numbers["script_memory"] = memory
    numbers["vs_oracle"] = hold_to_oracle("serve_disagg_7b", eventchat, llama, params, cfg,
                                          tokenizer, reqs, want, chains)
    emit("serve_disagg_7b", numbers)
    return [w["k1"] for w in workers]


class ServerProcess:
    """``python -m eventgpt_tpu_torch.cli.serve ARGV --port 0`` as a user
    starts it, its stderr in ``log_path``; the port comes from its listening
    line. ``stop()`` sends SIGTERM (the CLI drains, writes ``--trace_out``
    and exits) and waits for the exit, so that the card's memory is free
    before the next phase."""

    def __init__(self, argv, log_path: str):
        import re
        import threading

        self.log_path = log_path
        self._log = open(log_path, "w")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            self._command(argv), stdout=subprocess.PIPE, stderr=self._log, cwd=ROOT,
            env=self._env(), text=True)
        self.lines, self.port = [], None
        pat = re.compile(r"listening on http://[^:]+:(\d+) ")

        def read():
            for line in self.proc.stdout:
                self.lines.append(line.rstrip("\n"))
                m = pat.search(line)
                if m and self.port is None:
                    self.port = int(m.group(1))

        self._reader = threading.Thread(target=read, daemon=True)
        self._reader.start()
        try:
            wait_for(lambda: self.port is not None or self.proc.poll() is not None,
                     "the server's listening line", TELEMETRY_BOOT_S)
        except AssertionError:
            self.stop()
            raise
        if self.port is None:
            self.stop()
            raise AssertionError(f"the server exited {self.proc.returncode} before listening: "
                                 f"{self.log_tail()}")
        self.boot_s = time.perf_counter() - t0

    def _command(self, argv) -> list:
        return [sys.executable, "-u", "-m", "eventgpt_tpu_torch.cli.serve", *argv, "--port", "0"]

    def _env(self) -> dict:
        return dict(os.environ, PYTHONIOENCODING="utf-8",
                    PYTHONPATH=os.pathsep.join([ROOT] + [x for x in [os.environ.get("PYTHONPATH")]
                                                         if x]))

    def log_tail(self) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()[-3000:]

    def request(self, method: str, path: str, obj=None, timeout: float = WAIT_S):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        conn.request(method, path, body=None if obj is None else json.dumps(obj))
        res = conn.getresponse()
        body = res.read()
        ctype = res.getheader("Content-Type", "")
        return res.status, (json.loads(body) if "json" in ctype else body.decode())

    def stream(self, obj, timeout: float = WAIT_S) -> tuple:
        return http_stream(self.port, obj, timeout)

    def get(self, path: str):
        code, body = self.request("GET", path)
        if code != 200:
            raise AssertionError(f"GET {path} answered {code}: {body}")
        return body

    def stop(self) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=60)
        self._reader.join(timeout=10)
        self._log.close()
        return self.proc.returncode


def telemetry_requests() -> list:
    """``serve_defaults``' six requests as HTTP payloads, in its order: the
    four streams (budgets 48, 16, 16, 16), then SERVE_EXTRA's two."""
    first = [{"query": QUERIES[i], "event_path": f"events_{i}.npy", "max_new_tokens": n}
             for i, n in enumerate(SERVE_DEFAULTS_BUDGETS)]
    return first + [{"query": QUERIES[q], "event_path": f"events_{st}.npy", "max_new_tokens": n}
                    for st, q, n in SERVE_EXTRA]


def telemetry_run(ckpt: str, work: str, name: str, extra=(), profile: bool = False,
                  armed: bool = True) -> dict:
    """One ``cli/serve`` process over the 7B checkpoint with
    ``TELEMETRY_FLAGS`` (+ ``extra``): the four first requests at once, the
    two late ones after the first harvest (``segments`` in ``/stats``),
    every answer with its ids and journey; TELEMETRY_STREAMED's go out
    streamed (the client stamps its first delta; the ``done`` record carries
    the ids, the TTFT comes from ``/stats``' recent requests). With
    ``profile`` a ``POST /profile`` of PROFILE_SECONDS starts PROFILE_LEAD_S before the first
    requests (a 0 s capture before it starts the profiler once). Then the
    telemetry routes are read, and the process is stopped."""
    import threading

    reqs = telemetry_requests()
    trace_out = os.path.join(work, f"{name}_trace.json")
    argv = ["--model_path", ckpt, "--tokenizer_path", "byte", "--event_root", work,
            *TELEMETRY_FLAGS, "--trace_out", trace_out, *extra]
    if profile:
        # Only here: --profile_dir also arms the dispatch ranges for the run.
        argv += ["--profile_dir", os.path.join(work, f"{name}_profile")]
    srv = ServerProcess(argv, os.path.join(work, f"{name}.log"))
    out = {"argv": argv, "boot_s": srv.boot_s}
    try:
        if profile:
            code, warm = srv.request("POST", "/profile", {"seconds": 0})
            if code != 200:
                raise AssertionError(f"{name}: POST /profile {{seconds: 0}} answered {code}: {warm}")
        results = [None] * len(reqs)

        def send(i):
            if i not in TELEMETRY_STREAMED:
                results[i] = srv.request("POST", "/v1/generate",
                                         {**reqs[i], "return_ids": True, "debug": True})
                return
            code, events, first_event, first_delta = srv.stream({**reqs[i], "return_ids": True})
            done = events[-1] if events else {}
            results[i] = (code, {**done, "stream": {
                "events": len(events), "first_event_s": first_event,
                "first_delta_s": first_delta, "answer_chars": len(done.get("answer", "")),
                "deltas_equal_answer": stream_text(events).strip() == done.get("answer")}})

        def capture():
            out["profile"] = srv.request("POST", "/profile", {"seconds": PROFILE_SECONDS})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(QUERIES))]
        if profile:
            threads.insert(0, threading.Thread(target=capture))
            threads[0].start()
            time.sleep(PROFILE_LEAD_S)
        t0 = time.perf_counter()
        for th in threads[int(profile):]:
            th.start()

        def harvested():
            time.sleep(0.05)
            return srv.get("/stats")["segments"] >= 1

        out["late_submit_s"] = wait_for(harvested, f"{name}: the first harvest")
        late = [threading.Thread(target=send, args=(i,)) for i in range(len(QUERIES), len(reqs))]
        for th in late:
            th.start()
        for th in threads + late:
            th.join(timeout=WAIT_S)
        out["wall_s"] = time.perf_counter() - t0
        bad = [r for r in results if r is None or r[0] != 200 or r[1].get("status") != "ok"]
        if bad:
            raise AssertionError(f"{name}: answers {bad}; {srv.log_tail()}")
        out["chains"] = [r[1]["ids"] for r in results]
        out["rids"] = [r[1]["rid"] for r in results]
        stats = srv.get("/stats")
        out["ttft_s"] = [r[1]["ttft_s"] if "ttft_s" in r[1]
                         else stats["recent"][str(r[1]["rid"])]["ttft_s"] for r in results]
        out["streamed"] = {i: {**results[i][1]["stream"], "ttft_s": out["ttft_s"][i]}
                           for i in TELEMETRY_STREAMED}
        out["stats"] = {k: stats[k] for k in ("decode_s", "decode_steps", "decode_steps_run",
                                              "segments", "dispatches", "prefix_cache",
                                              "lanes_started", "overlap_ratio", "launches",
                                              "memory", "metrics", "alerts", "lock_wait_s",
                                              "admit_gather_s")}
        out["decode_ms_per_step"] = stats["decode_s"] * 1e3 / max(stats["decode_steps"], 1)
        out["metrics_text"] = srv.get("/metrics")
        if armed:
            out["requests"] = srv.get("/requests")["requests"]
            out["journeys"] = [srv.get(f"/request?rid={rid}") for rid in out["rids"]]
            out["debug_equals_route"] = [
                r[1]["debug"]["rid"] == rid for i, (r, rid) in enumerate(zip(results, out["rids"]))
                if i not in TELEMETRY_STREAMED]
            out["trace"] = srv.get("/trace")
            out["memory"] = srv.get("/memory")
            out["series"] = srv.get("/series?n=4")
            out["alerts"] = srv.get("/alerts")
        else:
            out["trace_code"] = srv.request("GET", "/trace")[0]
    finally:
        out["exit_code"] = srv.stop()
        out["stdout_tail"] = srv.lines[-4:]
    if out["exit_code"] != 0:
        raise AssertionError(f"{name}: the server exited {out['exit_code']}: {srv.log_tail()}")
    if armed:
        out["trace_out_events"] = len(trace_events(trace_out))
    return out


def http_stream(port: int, obj, timeout: float = WAIT_S) -> tuple:
    """POST /v1/generate with "stream": true to a local server: (status, the
    NDJSON events, seconds from the request to the first event and to the
    first delta as the client reads them; None for an answer with no
    text)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/generate", body=json.dumps({**obj, "stream": True}))
    res = conn.getresponse()
    events, first_event, first_delta = [], None, None
    for line in res:
        if not line.strip():
            continue
        ev = json.loads(line)
        now = time.perf_counter() - t0
        if first_event is None:
            first_event = now
        if first_delta is None and ("delta" in ev or "restart" in ev):
            first_delta = now
        events.append(ev)
    return res.status, events, first_event, first_delta


def stream_text(events) -> str:
    """The text a streaming client builds from its deltas and restarts."""
    text = ""
    for ev in events:
        if "delta" in ev:
            text += ev["delta"]
        elif "restart" in ev:
            text = ev["restart"]
    return text


def trace_events(path: str) -> list:
    """A Chrome trace written by ``obs.trace`` (one event a line)."""
    from eventgpt_tpu_torch.obs.trace import load_trace

    return load_trace(path)


def metric_value(text: str, sample: str) -> float:
    """The value of one sample line (``name{labels}``) of a Prometheus text."""
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.split()[-1])
    raise AssertionError(f"no sample {sample} in /metrics")


def serve_telemetry_7b(eventchat, llama, params, cfg, tokenizer, requests, oracle_chains,
                       ckpt: str, work: str, n_layers: int, smi: str, ties=None) -> dict:
    """The port's telemetry on the served 7B path, through the real entry
    point: two ``cli/serve`` processes over the 7B checkpoint with the
    JAX CLI's defaults (paged int8 KV, 4 rows, chunk 32), one at a time, on
    ``serve_defaults``' traffic. Armed at the defaults; armed with the
    headroom guard set below the ledger's total (admissions while rows
    decode defer until they drain), ``--warmup`` and a profile capture over
    its first requests. (The ``--no_telemetry`` server left the run to
    pay for the serving mesh's phases; the CPU tests hold disarmed
    telemetry.) Every run's chains held to ``serve_defaults``' oracle
    (``hold_to_oracle``); the armed run's metrics, journeys, trace, trace
    file and ledger reconciliation; the guard's deferrals; the capture
    names K1.
    ``ties``: {(row, first divergent step): report} already verified on the
    same oracle (``serve_defaults``'), not replayed again. Returns {run: K1
    launches}."""
    reqs = serve_defaults_requests(requests)
    runs = {"armed": telemetry_run(ckpt, work, "telemetry_armed")}
    total_mib = runs["armed"]["stats"]["memory"]["total_bytes"] / 2 ** 20
    guard = ["--mem_capacity_mb", str(math.ceil(total_mib) + 64), "--mem_headroom_mb", "128"]
    runs["guarded"] = telemetry_run(ckpt, work, "telemetry_guard", guard + ["--warmup"],
                                    profile=True)
    k1 = {n: r["stats"]["launches"]["flash_attention.cu"] for n, r in runs.items()}
    armed, guarded = runs["armed"], runs["guarded"]
    n = len(reqs)
    problems = []
    # Over HTTP the admission paths follow the arrival times (which lanes
    # ride which decode steps, the first wave's size), and bf16 chains
    # follow the paths at rounding ties: every run is held to the oracle
    # (identical, or a divergence at a measured tie). Exact equality armed
    # against disarmed at one schedule is the CPU tests' (bytes equal).
    if k1["armed"] % n_layers or not k1["armed"]:
        problems.append(f"K1 launches {k1}")
    text = armed["metrics_text"]
    counts = {"requests_ok": metric_value(text, 'egpt_serve_requests_total{status="ok"}'),
              "ttft_count": metric_value(text, "egpt_serve_ttft_seconds_count")}
    if counts != {"requests_ok": n, "ttft_count": n}:
        problems.append(f"/metrics counts {counts}, want {n}")
    statuses = sorted((r["rid"], r["status"]) for r in armed["requests"])
    if statuses != sorted((rid, "ok") for rid in armed["rids"]):
        problems.append(f"/requests {statuses}")
    phase_gaps = [abs(sum(j["phases"].values()) - j["e2e_s"]) for j in armed["journeys"]]
    if max(phase_gaps) > 1e-9 or not all(armed["debug_equals_route"]):
        problems.append(f"journey phases off their latency by {phase_gaps}")
    pairs = {}
    for e in armed["trace"]["traceEvents"]:
        if e.get("cat") == "request":
            pairs.setdefault(e["id"], []).append((e["name"], e["ph"]))
    want_pairs = [("queued", "b"), ("queued", "e"), ("active", "b"), ("active", "e")]
    if sorted(pairs) != sorted(armed["rids"]) or any(p != want_pairs for p in pairs.values()):
        problems.append(f"/trace request events {pairs}")
    if not armed["trace_out_events"]:
        problems.append("--trace_out wrote no events")
    rec = armed["memory"]["reconcile"]
    if rec["accounted_ratio"] < RECONCILE_MIN:
        problems.append(f"the ledger accounts {rec['accounted_ratio']} of the live bytes")
    for r in ("armed",):
        # The random 7B weights' answers are mostly empty text (token ids
        # past the byte range decode to nothing), and an empty answer sends
        # no delta: the first event is then the done record.
        bad = {i: st for i, st in runs[r]["streamed"].items()
               if not st["deltas_equal_answer"] or st["first_event_s"] is None
               or (st["answer_chars"] > 0) != (st["first_delta_s"] is not None)}
        if bad:
            problems.append(f"{r}: streamed requests {bad}")
    submits = [j["t_submit"] for j in armed["journeys"]]
    first_wave = sorted(submits[:len(QUERIES)])
    # The four posted at once are admitted as one wave of four rows: the
    # idle engine holds its first admission while their handlers preprocess.
    paths = {r: [[e.get("path") for e in j["events"] if e["kind"] == "admit"]
                 for j in runs[r]["journeys"][:len(QUERIES)]] for r in ("armed", "guarded")}
    one_wave = {r: runs[r]["stats"]["dispatches"].get("wave") == 1
                and not runs[r]["stats"]["dispatches"].get("full") for r in runs}
    if not one_wave["armed"] or paths["armed"] != [["wave"]] * len(QUERIES) \
            or k1["armed"] != n_layers:
        problems.append(f"the first four were not one admission wave: dispatches "
                        f"{armed['stats']['dispatches']}, admit paths {paths['armed']}, "
                        f"K1 {k1['armed']}")
    deferrals = metric_value(guarded["metrics_text"], "egpt_mem_guard_deferrals_total")
    if deferrals < 1 or guarded["stats"]["memory"]["guard"]["deferrals"] < 1:
        problems.append(f"the guard deferred {deferrals} times")
    code, prof = guarded["profile"]
    names, ranges = set(), {}
    if code == 200:
        with open(prof["trace_file"]) as f:
            evs = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in evs}
        for key in ("flash_fwd_kernel", "serve.segment_dispatch"):
            ranges[key] = sum(key in e.get("name", "") for e in evs)
    if code != 200 or not any("flash_fwd_kernel" in x for x in names):
        problems.append(f"POST /profile answered {code}: {prof}; K1 in the capture: "
                        f"{ranges.get('flash_fwd_kernel')}")
    # A divergence's margin and gap depend on the oracle's row and the first
    # divergent step only: each (row, step) is replayed once across the runs.
    hold, seen = {}, dict(ties or {})
    for r, run in runs.items():
        first = {i: next(k for k, (a, b) in enumerate(zip(o + [None], c + [None])) if a != b)
                 for i, (o, c) in enumerate(zip(oracle_chains, run["chains"])) if o != c}
        got = [oracle_chains[i] if (i, first.get(i)) in seen else c
               for i, c in enumerate(run["chains"])]
        hold[r] = hold_to_oracle(f"serve_telemetry_7b {r}", eventchat, llama, params, cfg,
                                 tokenizer, reqs, oracle_chains, got, SERVE_DEFAULTS_BUDGETS[0])
        seen.update({(d["row"], d["first_divergent_step"]): d for d in hold[r]["divergences"]})
        hold[r] = {"rows_identical": [i not in first for i in range(len(reqs))],
                   "divergences": [seen[i, k] for i, k in sorted(first.items())]}
    summary = {
        "config": "python -m eventgpt_tpu_torch.cli.serve over checkpoint_7b: EventGPT-7B bf16, "
                  "paged int8 KV, 4 rows, max_len 1024, chunk 32, the JAX CLI's defaults "
                  "(pipelined, prefix cache 512 MiB, lanes of 32); serve_defaults' six requests "
                  "over HTTP (event_path under --event_root)",
        "k1_launches": k1,
        "chains_equal_guarded_armed": guarded["chains"] == armed["chains"],
        "vs_oracle": hold, "metrics": counts,
        "wall_s": {r: runs[r]["wall_s"] for r in runs},
        "decode_ms_per_step": {r: runs[r]["decode_ms_per_step"] for r in runs},
        "decode_steps": {r: runs[r]["stats"]["decode_steps"] for r in runs},
        "decode_steps_run": {r: runs[r]["stats"]["decode_steps_run"] for r in runs},
        "ttft_s": {r: runs[r]["ttft_s"] for r in runs},
        "streamed": {r: runs[r]["streamed"] for r in runs},
        "first_wave_submit_spread_s": first_wave[-1] - first_wave[0],
        "armed_submit_offsets_s": [t - min(submits) for t in submits],
        "lock_wait_s": {r: runs[r]["stats"]["lock_wait_s"] for r in runs},
        "admit_gather_s": {r: runs[r]["stats"]["admit_gather_s"] for r in runs},
        "first_four_one_wave": one_wave, "first_four_admit_paths": paths,
        "boot_s": {r: runs[r]["boot_s"] for r in runs},
        "late_submit_s": {r: runs[r]["late_submit_s"] for r in runs},
        "dispatches": {r: runs[r]["stats"]["dispatches"] for r in runs},
        "journey_phases": [j["phases"] for j in armed["journeys"]],
        "journey_causes": [j.get("cause") for j in armed["journeys"]],
        "journey_event_kinds": [[e["kind"] for e in j["events"]] for j in armed["journeys"]],
        "trace_events": len(armed["trace"]["traceEvents"]),
        "trace_dropped": armed["trace"]["droppedEvents"],
        "trace_out_events": armed["trace_out_events"],
        "memory": {"components": armed["memory"]["components"],
                   "owner": armed["memory"]["owner"], "total_bytes":
                       armed["memory"]["total_bytes"], "reconcile": rec,
                   "estimate": armed["memory"]["estimate"]["components"],
                   "compiled": armed["memory"]["compiled"]},
        "series_samples": armed["series"].get("samples"),
        "alerts_active": armed["alerts"].get("active"),
        "guard": {"argv": guard, "deferrals_metric": deferrals,
                  "stats": guarded["stats"]["memory"]["guard"]},
        "profile": {"code": code, "seconds": PROFILE_SECONDS,
                    "all_threads": prof.get("all_threads") if code == 200 else None,
                    "events_by_name": ranges,
                    "engine_thread_ranges_in_capture": ranges.get("serve.segment_dispatch", 0) > 0},
        "nvidia_smi": smi}
    emit("serve_telemetry_7b", summary)
    if problems:
        raise AssertionError(f"serve_telemetry_7b: {problems}")
    return k1


def tiny_telemetry_card_vs_cpu(work: str) -> dict:
    """The tiny f32 server at the JAX CLI's defaults with the flight
    recorder armed, on the card and on the CPU, on
    ``tiny_serve_defaults_card_vs_cpu``'s traffic: the same chains, the same
    journey event kinds per request, and the same serving counters of the
    registry (its times aside)."""
    import numpy as np
    import torch

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer, tokenize_with_event
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.obs import journey as obs_journey
    from eventgpt_tpu_torch.obs import metrics as obs_metrics
    from eventgpt_tpu_torch.ops.image import process_event_file
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    cfg = EventChatConfig.tiny(vocab_size=260)
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(3), torch.float32, "cpu")
    trees = {"cpu": cpu, "cuda": _to(cpu, "cuda")}
    px = [np.asarray(process_event_file(os.path.join(work, f"events_{i}.npy"),
                                        cfg.num_event_frames, cfg.vision.image_size)[1])
          for i in range(3)]
    ids = [tokenize_with_event(prepare_event_prompt(q), ByteTokenizer()) for q in QUERIES]
    first = [(ids[0], px[0], 40), (ids[1], px[1], 6)]
    late = [(ids[3], px[0], 10), (ids[2], px[2], 8)]
    counters = ("egpt_serve_requests_total", "egpt_serve_tokens_total",
                "egpt_serve_segments_total", "egpt_serve_prefill_dispatches_total",
                "egpt_serve_prefix_cache_hits_total", "egpt_serve_mixed_segments_total")
    prev = obs_journey.active()
    obs_journey.configure(64)
    res = {}
    try:
        for dev, params in trees.items():
            obs_metrics.REGISTRY.reset()
            srv = ContinuousBatcher(params, cfg, max_batch=2, max_len=512, chunk=8,
                                    eos_token_id=None, kv_quant=True, kv_layout="paged",
                                    prefill_budget=8, device=dev)
            rids = [srv.submit(*r) for r in first]
            srv.step()
            srv.step()
            rids += [srv.submit(*r) for r in late]
            done = srv.run_until_drained()
            summary = obs_metrics.REGISTRY.summary(("egpt_serve_",))
            res[dev] = {"chains": [done[r] for r in rids],
                        "kinds": [[e["kind"] for e in srv.journey(r)["events"]] for r in rids],
                        "statuses": [srv.journey(r)["status"] for r in rids],
                        "counters": {k: summary[k] for k in counters}}
    finally:
        obs_journey._recorder = prev
    if res["cpu"] != res["cuda"]:
        raise AssertionError(f"tiny telemetry differs: cpu {res['cpu']} vs cuda {res['cuda']}")
    return {"config": "tiny f32, 2 rows, chunk 8, paged int8 KV, prefill_budget 8, pipelined, "
                      "prefix cache; journeys armed", "identical": True,
            "kinds": res["cuda"]["kinds"], "counters": res["cuda"]["counters"],
            "tokens": [len(c) for c in res["cuda"]["chains"]]}


def tiny_stream_card_vs_cpu(work: str) -> dict:
    """A streamed request through the tiny f32 server's HTTP handler on the
    card and on the CPU (the byte vocabulary, so the answer has text): the
    same NDJSON events, the deltas concatenating to the ``done`` answer, and
    the time to the first delta beside the request's TTFT on each."""
    import base64
    import threading
    from http.server import ThreadingHTTPServer

    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    cfg = EventChatConfig.tiny(vocab_size=260)
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(3), torch.float32, "cpu")
    with open(os.path.join(work, "events_0.npy"), "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    res = {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        engine = cli_serve.ServingEngine(
            ContinuousBatcher(params, cfg, max_batch=2, max_len=512, chunk=8, eos_token_id=None,
                              device=dev), ByteTokenizer())
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), cli_serve.make_handler(engine, cfg))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            code, events, first_event, first_delta = http_stream(
                httpd.server_address[1], {"query": QUERIES[0], "event_b64": b64,
                                          "max_new_tokens": 40, "return_ids": True})
            done = events[-1]
            res[dev] = {"code": code, "events": events, "first_event_s": first_event,
                        "first_delta_s": first_delta,
                        "ttft_s": engine.batcher.request_stats[done["rid"]]["ttft_s"],
                        "deltas_equal_answer": stream_text(events).strip() == done["answer"]}
        finally:
            httpd.shutdown()
            engine.shutdown()
            httpd.server_close()
    card, host = res["cuda"], res["cpu"]
    if (card["events"] != host["events"] or card["code"] != 200 or not card["deltas_equal_answer"]
            or card["first_delta_s"] is None or card["events"][-1].get("status") != "ok"):
        raise AssertionError(f"tiny streamed request: card {card}, cpu {host}")
    return {"config": "tiny f32 (vocab 260), 2 rows, chunk 8, one request of 40 tokens over "
                      "HTTP with \"stream\": true", "identical": True,
            "events": len(card["events"]),
            "deltas": sum("delta" in e for e in card["events"]),
            "restarts": sum("restart" in e for e in card["events"]),
            "answer_chars": len(card["events"][-1]["answer"]),
            "first_delta_s": {d: r["first_delta_s"] for d, r in res.items()},
            "ttft_s": {d: r["ttft_s"] for d, r in res.items()}}


def tiny_procfleet_card_vs_cpu(work: str) -> dict:
    """Tiny f32 workers (``--proc_fleet 2``, paged int8 KV, dense attention)
    on the card and on the CPU over one checkpoint the port wrote, with the
    same traffic: four requests, then two repeated sessions. Chains and
    routing must be identical."""
    import numpy as np
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.models.convert import init_eventchat_params, write_hf_checkpoint

    cfg = EventChatConfig.tiny(vocab_size=260)
    ckpt = os.path.join(work, "tiny_procfleet_checkpoint")
    write_hf_checkpoint(init_eventchat_params(cfg, torch.Generator().manual_seed(4),
                                              torch.float32, "cpu"), cfg, ckpt)
    size = cfg.vision.image_size

    def pv(seed):
        rng = np.random.default_rng(seed)
        return rng.normal(size=(cfg.num_event_frames, 3, size, size)).astype(np.float32)

    head = [1, 7, 7, -200, 9, 10, 11]
    first = [(head + [20 + i], pv(i), 10) for i in range(4)]
    later = [(head + [30], pv(0), 6), (head + [31], pv(1), 6)]
    runs = {}
    for dev in ("cpu", "cuda"):
        args = cli_serve.build_parser().parse_args([
            "--model_path", ckpt, "--tokenizer_path", "byte", "--dtype", "float32",
            "--attn_impl", "dense", "--device", dev, "--proc_fleet", "2", "--max_batch", "2",
            "--chunk", "2", "--max_len", "256", "--kv_layout", "paged", "--kv_pool_blocks", "12",
            "--kv_cache", "int8"])
        _, fleet = cli_serve.build_engine(args)
        try:
            frids = [fleet.submit_ids(*r) for r in first]
            chains = [fleet.result(f, timeout=WAIT_S) for f in frids]
            late = [fleet.submit_ids(*r) for r in later]
            chains += [fleet.result(f, timeout=WAIT_S) for f in late]
            runs[dev] = {"chains": chains, "routed_to": [fleet.worker_of(f) for f in frids + late],
                         "k1": [fleet.worker_stats(i)["launches"]["flash_attention.cu"]
                                for i in range(2)]}
        finally:
            fleet.shutdown()
    if runs["cpu"] != runs["cuda"]:
        raise AssertionError(f"tiny process fleet differs: cpu {runs['cpu']} vs cuda "
                             f"{runs['cuda']}")
    return {"config": "tiny f32 checkpoint, --proc_fleet 2, paged int8 KV, 2 rows a worker, "
                      "chunk 2, dense attention", "identical": True,
            "routed_to": runs["cuda"]["routed_to"], "k1": runs["cuda"]["k1"],
            "tokens": [len(c) for c in runs["cuda"]["chains"]]}


def tiny_preempt_card_vs_cpu() -> dict:
    """The tiny preemption scenario of the CPU tests (one batch row on a
    4-block pool, then an interactive arrival that evicts it) on the card
    and on the CPU: spill forced (recompute priced at 1 FLOP/s), f32 and
    with the int8 cache, and the drop arm. Chains and the preemption
    counters must be equal."""
    import numpy as np
    import torch

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.serve import ContinuousBatcher
    from eventgpt_tpu_torch.workload import SLO

    cfg = EventChatConfig.tiny()
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu")
    trees = {"cpu": cpu, "cuda": _to(cpu, "cuda")}
    size = cfg.vision.image_size

    def pv(seed):
        return np.random.default_rng(seed).normal(
            size=(cfg.num_event_frames, 3, size, size)).astype(np.float32)

    out = {}
    for arm, spill_mb, quant in (("spill", 64, False), ("spill_int8", 64, True),
                                 ("drop", 0, False)):
        res = {}
        for dev, params in trees.items():
            srv = ContinuousBatcher(params, cfg, max_batch=2, max_len=256, chunk=4,
                                    eos_token_id=None, kv_layout="paged", kv_pool_blocks=4,
                                    preempt=True, spill_capacity_mb=spill_mb, kv_quant=quant,
                                    device=dev)
            srv._recompute_flops_per_s = 1.0
            rb = srv.submit([1, 5, -200, 9, 9], pv(0), 40, slo=SLO("batch", latency_s=60.0))
            for _ in range(6):
                srv.step()
            ri = srv.submit([3, -200, 11, 4], pv(1), 12, slo=SLO("interactive", ttft_s=30.0))
            done = srv.run_until_drained()
            st = srv.pool_stats()
            res[dev] = {"chains": [done[rb], done[ri]],
                        "counts": [st["preemptions"], st["spills"], st["restores"],
                                   st["deferrals"]],
                        "clean": st["spilled_runs"] == 0
                        and srv.spill_stats()["records"] == 0}
        if res["cpu"] != res["cuda"]:
            raise AssertionError(f"tiny preemption ({arm}) differs: cpu {res['cpu']} vs cuda "
                                 f"{res['cuda']}")
        counts = res["cuda"]["counts"]
        preemptions, spills, restores, _ = counts
        arm_ok = spills >= 1 and restores >= 1 if spill_mb else spills == 0
        if preemptions < 1 or not arm_ok or not res["cuda"]["clean"]:
            raise AssertionError(f"tiny preemption ({arm}): counts {counts}, clean "
                                 f"{res['cuda']['clean']}")
        out[arm] = {"preemptions_spills_restores_deferrals": counts,
                    "tokens": [len(c) for c in res["cuda"]["chains"]]}
    return {"config": "tiny f32, paged, 2 rows, chunk 4, 4 pool blocks, batch 40 tokens then "
                      "interactive 12", **out, "identical": True}


def tiny_serve_defaults_card_vs_cpu(work: str) -> dict:
    """The tiny f32 model served with the JAX CLI's scheduler defaults
    (pipelined, the prefix cache, lanes of prefill_budget = chunk) gives
    the same chains and the same hits, lanes and segments on the card as
    on the CPU: request A decodes long, B finishes fast, then C (A's
    stream again: a prefix hit, a suffix lane) and D (a miss, a full
    lane) join while A decodes; dense f32 and paged int8."""
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
    px = [np.asarray(process_event_file(os.path.join(work, f"events_{i}.npy"),
                                        cfg.num_event_frames, cfg.vision.image_size)[1])
          for i in range(3)]
    ids = [tokenize_with_event(prepare_event_prompt(q), ByteTokenizer()) for q in QUERIES]
    first = [(ids[0], px[0], 40), (ids[1], px[1], 6)]
    late = [(ids[3], px[0], 10), (ids[2], px[2], 8)]
    out = {}
    for layout, quant in (("dense", False), ("paged", True)):
        res = {}
        for dev, params in trees.items():
            srv = ContinuousBatcher(params, cfg, max_batch=2, max_len=512, chunk=8,
                                    eos_token_id=None, kv_quant=quant, kv_layout=layout,
                                    prefill_budget=8, device=dev)
            rids = [srv.submit(*r) for r in first]
            srv.step()
            srv.step()
            rids += [srv.submit(*r) for r in late]
            done = srv.run_until_drained()
            res[dev] = {"chains": [done[r] for r in rids], "hits": srv._prefix_cache.hits,
                        "lanes": dict(srv.lanes_started), "segments": srv.seg_count,
                        "steps_run": srv.decode_steps_run, "dispatches": dict(srv.dispatches)}
        if res["cpu"] != res["cuda"]:
            raise AssertionError(f"tiny served defaults differ ({layout}): cpu {res['cpu']} vs "
                                 f"cuda {res['cuda']}")
        if res["cuda"]["hits"] < 1 or res["cuda"]["lanes"]["suffix"] < 1:
            raise AssertionError(f"tiny served defaults ({layout}): no suffix lane: "
                                 f"{res['cuda']}")
        out[layout] = {k: v for k, v in res["cuda"].items() if k != "chains"}
        out[layout]["tokens"] = [len(c) for c in res["cuda"]["chains"]]
    return {"config": "tiny f32, 2 rows, chunk 8, prefill_budget 8, pipelined, prefix cache; "
                      "dense f32 and paged int8", **out, "identical": True}


def tiny_serve_spec_card_vs_cpu(work: str) -> dict:
    """The tiny f32 model served speculatively (suffix lookup, adaptive
    buckets, Medusa heads) at the JAX CLI's scheduler defaults gives the
    same chains on the card as on the CPU, on tiny_serve_defaults' staged
    traffic; the lookup and adaptive servers also the same verify
    iterations, tokens and windows (their drafts follow from the
    chains)."""
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
    d = cfg.llama.hidden_size
    w = torch.randn((3, d, d), generator=torch.Generator().manual_seed(4)) * 0.5
    heads = {"cpu": {"w": w}, "cuda": {"w": w.cuda()}}
    px = [np.asarray(process_event_file(os.path.join(work, f"events_{i}.npy"),
                                        cfg.num_event_frames, cfg.vision.image_size)[1])
          for i in range(3)]
    ids = [tokenize_with_event(prepare_event_prompt(q), ByteTokenizer()) for q in QUERIES]
    first = [(ids[0], px[0], 40), (ids[1], px[1], 6)]
    late = [(ids[3], px[0], 10), (ids[2], px[2], 8)]
    out = {}
    for kind, kw in (("lookup", {"speculative": 4}), ("adaptive", {"spec_buckets": "0,2,4"}),
                     ("medusa", {"speculative": 4, "draft_head": "heads"})):
        res = {}
        for dev, params in trees.items():
            args = dict(kw, draft_head=heads[dev]) if "draft_head" in kw else kw
            srv = ContinuousBatcher(params, cfg, max_batch=2, max_len=512, chunk=8,
                                    eos_token_id=None, kv_quant=True, kv_layout="paged",
                                    prefill_budget=8, device=dev, **args)
            rids = [srv.submit(*r) for r in first]
            srv.step()
            srv.step()
            rids += [srv.submit(*r) for r in late]
            done = srv.run_until_drained()
            res[dev] = {"chains": [done[r] for r in rids], "iterations": srv.spec_iterations,
                        "tokens": srv.spec_tokens, "windows": list(srv.spec_depth_trace),
                        "lanes": dict(srv.lanes_started)}
        same = (res["cpu"]["chains"] == res["cuda"]["chains"] if kind == "medusa"
                else res["cpu"] == res["cuda"])
        if not same:
            raise AssertionError(f"tiny served speculation differs ({kind}): cpu {res['cpu']} "
                                 f"vs cuda {res['cuda']}")
        out[kind] = {"cuda": {k: v for k, v in res["cuda"].items() if k != "chains"},
                     "cpu_iterations": res["cpu"]["iterations"],
                     "tokens": [len(c) for c in res["cuda"]["chains"]]}
    return {"config": "tiny f32, paged int8 KV, 2 rows, chunk 8, prefill_budget 8, pipelined, "
                      "prefix cache", **out, "identical": True}


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
                                kv_quant=True, kv_layout="paged", device=dev, **SYNC_NO_CACHE)
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
    paged with the int8 cache: three POST /v1/generate answer 200, the
    third with ``slo_class`` interactive, which ``GET /stats`` scores."""
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
        # The third request carries an SLO class: scored in /stats.
        for i, extra in ((0, {}), (1, {}), (0, {"slo_class": "interactive"})):
            with open(os.path.join(work, f"events_{i}.npy"), "rb") as f:
                body = json.dumps({"query": QUERIES[i], **extra,
                                   "event_b64": base64.b64encode(f.read()).decode()})
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
            conn.request("POST", "/v1/generate", body=body)
            res = conn.getresponse()
            obj = json.loads(res.read())
            if res.status != 200 or obj.get("status") != "ok" or (
                    extra and obj.get("slo_class") != "interactive"):
                raise AssertionError(f"POST /v1/generate answered {res.status}: {obj}")
            answers.append({"code": res.status, "tokens": obj["tokens"],
                            "latency_s": obj["latency_s"], "answer": obj["answer"],
                            **({"slo_met": obj.get("slo_met")} if extra else {})})
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("GET", "/stats")
        slo = json.loads(conn.getresponse().read())["slo"]
        if slo["classes"].get("interactive", {}).get("finished") != 1:
            raise AssertionError(f"GET /stats did not score the classed request: {slo}")
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
            "k1_launches": k1, "answers": answers, "slo": slo}


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
    evald = eval_cli_tiny(ckpt, [os.path.join(work, f"events_{i}.npy") for i in range(3)],
                          params, lcfg, tok)
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"model_path": "tiny bf16 checkpoint (vocab 260, LLaMA d=256, 2 heads of 128)",
            **out, "in_process_launches": launches, "eval_cli": evald}


def checkpoint_7b(params, cfg, ckpt: str, ids, pixels, event_paths, counted,
                  digests: dict, slice_ids, smi: str) -> dict:
    """Phase 3's bf16 tree through a checkpoint on disk, as a user runs a
    real one: written by ``write_hf_checkpoint``, loaded by the CLI's
    functions (bf16, then ``--quant int4``); on the loaded bf16 tree,
    ``cli/eval``'s batched evaluation (``eval_7b``, its own line). Every
    check raises."""
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
    emit("eval_7b", eval_7b(loaded, lcfg, tokenizer, event_paths, work, counted, slice_ids,
                            n_layers, smi))
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

    # (The 7B infer CLI subprocess against a batch-1 generate left the run
    # to pay for the serving mesh's phases: eval_mesh_7b and
    # serve_telemetry_7b start 7B CLIs from this directory, and
    # cli_subprocess_tiny holds cli/infer's answer to an in-process one.)
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
               kv_quant: bool, eos: int, new_tokens: int = MAX_NEW_TOKENS) -> dict:
    """Hold speculative chains to the plain greedy ones. A row that differs
    passes only where its first divergent step is a rounding tie: the plain
    path's top-2 logit margin there (replayed on the plain chains) below
    the largest |decode_kstep - decode_step| logit gap on that prefix.
    Anything else raises. ``new_tokens`` is the longest chain's budget (the
    replay cache holds the prompt and that many more)."""
    import torch

    report = []
    for r, (p_row, g_row) in enumerate(zip(plain, got)):
        if p_row == g_row:
            continue
        s = next((i for i, (a, b) in enumerate(zip(p_row, g_row)) if a != b),
                 min(len(p_row), len(g_row)))
        logits, _ = replay_logits(llama, params, cfg, padded, mask, plain, s,
                                  _bucket_len(padded.shape[1], new_tokens), kv_quant, eos)
        top2 = torch.topk(logits[s][r].float(), 2).values
        margin = (top2[0] - top2[1]).item()
        start = max(0, s - window)
        gap = kstep_vs_step(llama, params, cfg, padded, mask, plain, start, window,
                            _bucket_len(padded.shape[1], new_tokens + 2 * window),
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
    tele = [json.loads(line) for line in open(trainer.telemetry.path)]
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


def medusa_gradient_witness(llama_params, hidden, labels) -> dict:
    """The heads' gradient at the zero stack, held against the loss itself,
    and the loss along Adam's first step.

    In f32 (the hidden states and the lm_head cast up): along Adam's first
    direction u = -g / (|g| + 1e-8) and along -g / max|g|, the central
    difference (L(eps u) - L(-eps u)) / 2 eps agrees with autograd's
    <g, u> within MEDUSA_FD_RTOL, or this raises. Then, in the training's
    own dtype, the loss after the first AdamW step of each LR in
    MEDUSA_LINE_LRS (that step moves the zero stack to lr u; the decay of a
    zero stack is zero) on the same batch, and the training dtype's
    gradient beside the f32 one: their cosine must reach MEDUSA_GRAD_COS."""
    import torch

    from eventgpt_tpu_torch.models import medusa as medusa_mod

    d = hidden.shape[-1]
    lp32, h32 = {"lm_head": llama_params["lm_head"].float()}, hidden.float()

    def loss_at(w, lp=lp32, h=h32) -> float:
        with torch.no_grad():
            return float(medusa_mod.medusa_loss(lp, {"w": w}, h, labels)[0])

    w0 = torch.zeros((MEDUSA_HEADS, d, d), dtype=torch.float32, device=hidden.device,
                     requires_grad=True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(medusa_mod.medusa_loss(lp32, {"w": w0}, h32, labels)[0], [w0])
    adam = -g / (g.abs() + 1e-8)
    checks = {}
    for name, u in (("adam_first", adam), ("steepest", -g / g.abs().max())):
        eps = MEDUSA_FD_EPS
        numeric = (loss_at(eps * u) - loss_at(-eps * u)) / (2 * eps)
        autograd = float((g.double() * u.double()).sum())
        checks[name] = {"finite_difference": numeric, "autograd": autograd,
                        "rel_err": abs(numeric - autograd) / abs(autograd)}
    if not all(c["rel_err"] <= MEDUSA_FD_RTOL for c in checks.values()):
        raise AssertionError(f"medusa head gradient disagrees with the loss: {checks}")
    del lp32, h32
    with torch.enable_grad():
        (g_train,) = torch.autograd.grad(
            medusa_mod.medusa_loss(llama_params, {"w": w0}, hidden, labels)[0], [w0])
    train_dtype = {"dtype": str(hidden.dtype),
                   "rel_diff": float((g_train - g).norm() / g.norm()),
                   "cosine": float((g_train.double() * g.double()).sum()
                                   / (g_train.double().norm() * g.double().norm()))}
    if not train_dtype["cosine"] >= MEDUSA_GRAD_COS:
        raise AssertionError(f"medusa head gradient in {hidden.dtype} departs from f32's: "
                             f"{train_dtype}")
    del g_train
    zero = torch.zeros_like(g)
    line = {"0": loss_at(zero, llama_params, hidden)}
    line.update({repr(lr): loss_at(lr * adam, llama_params, hidden) for lr in MEDUSA_LINE_LRS})
    return {"eps": MEDUSA_FD_EPS, "rtol": MEDUSA_FD_RTOL, "directional": checks,
            "train_dtype_gradient": train_dtype,
            "grad_norm": float(g.norm()), "grad_abs_sum": float(g.abs().sum()),
            "loss_after_first_adam_step": line}


def medusa_train_7b(params, cfg, tokenizer, work: str, smi: str) -> dict:
    """Medusa-head training at EventGPT-7B width on the bf16 tree already on
    the card, through ``scripts/train_medusa.train_heads``: the motion
    corpus (MEDUSA_CORPUS) in the work directory, MEDUSA_STEPS head steps
    of MEDUSA_BATCH, MEDUSA_HEADS heads, lr MEDUSA_LR (``optax.adamw``'s
    port). Counted: K1 32 inference launches a step (the hidden forward
    under no_grad), no training launch and no backward call. Only the stack
    moves (sampled frozen leaves by sha256). The step is then split on the
    first batch: the hidden forward, and the heads' loss + backward +
    update. The saved stack serves the held-out requests through
    ``cli/serve.make_batcher`` with ``--speculative 4 --draft_head``,
    against the same call's non-speculative oracle; ``train_medusa`` runs
    as a subprocess for 2 steps on a tiny model on the card, and refuses
    ``--quant int4``."""
    import torch

    from eventgpt_tpu_torch.cli import serve as cli_serve
    from eventgpt_tpu_torch.data.motion_corpus import build_motion_corpus
    from eventgpt_tpu_torch.models import llama
    from eventgpt_tpu_torch.models.eventchat import prepare_prefill
    from eventgpt_tpu_torch.models.medusa import save_medusa
    from eventgpt_tpu_torch.ops import flash_attention as fa
    from eventgpt_tpu_torch.scripts import medusa_acceptance, train_medusa
    from eventgpt_tpu_torch.train import medusa as medusa_train
    from eventgpt_tpu_torch.train.data import EventChatDataset, batch_iterator
    from eventgpt_tpu_torch.train.steps import batch_to_device

    n_layers = cfg.llama.num_layers
    root = os.path.join(work, "motion")
    paths = build_motion_corpus(root, *MEDUSA_CORPUS)
    dataset = EventChatDataset(paths["train"], tokenizer, cfg, event_folder=paths["events"],
                               conv_version="plain")
    first = next(batch_iterator(dataset, MEDUSA_BATCH, cfg, shuffle=True, seed=0))
    # K1 against its plain version at the hidden forward's own shape: the
    # first batch's padded length and right-padded lengths.
    flash_check = check_flash_kernel([int(n) for n in first["attn_mask"].sum(1)], seed=11,
                                     s=int(first["attn_mask"].shape[1]))
    frozen_hash = _sha_leaves(frozen_sample(params))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.FLASH_KERNEL.launches = 0
    for key in fa.LAUNCHES_BY_PATH:
        fa.LAUNCHES_BY_PATH[key] = 0
    step_ms, t_prev = [], [time.perf_counter()]

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - t_prev[0]) * 1e3)
        t_prev[0] = now

    t0 = time.perf_counter()
    heads, last, records = train_medusa.train_heads(
        cfg, params, dataset, MEDUSA_HEADS, MEDUSA_STEPS, MEDUSA_BATCH, MEDUSA_LR, "cuda",
        logging_steps=1, log=lambda line: None, on_step=on_step)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    k1 = {"launches": fa.FLASH_KERNEL.launches, "by_path": dict(fa.LAUNCHES_BY_PATH)}
    want = {"inference": n_layers * MEDUSA_STEPS, "train_forward": 0, "recompute": 0,
            "backward": 0}
    if k1["by_path"] != want or k1["launches"] != n_layers * MEDUSA_STEPS:
        raise AssertionError(f"medusa_train_7b: K1 {k1}, want {want}")
    losses = [r["loss"] for r in records]
    if len(records) != MEDUSA_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"medusa_train_7b: losses {losses}")
    if _sha_leaves(frozen_sample(params)) != frozen_hash:
        raise AssertionError("medusa_train_7b: a frozen leaf changed")
    if not bool(heads["w"].abs().sum() > 0):
        raise AssertionError("medusa_train_7b: the head stack did not move")

    # The same steps at MEDUSA_LR_LOW, from a fresh zero stack.
    _, low_last, low_records = train_medusa.train_heads(
        cfg, params, dataset, MEDUSA_HEADS, MEDUSA_STEPS, MEDUSA_BATCH, MEDUSA_LR_LOW, "cuda",
        logging_steps=1, log=lambda line: None)
    falls = [b < a for a, b in zip(low_records[0]["per_head"], low_last["per_head"])]
    if len(low_records) != MEDUSA_STEPS or not all(falls):
        raise AssertionError(f"medusa_train_7b: at lr {MEDUSA_LR_LOW} the per-head losses "
                             f"did not fall: {low_records[0]['per_head']} -> "
                             f"{low_last['per_head']}")

    # The step split on the first batch, from a fresh stack (the trained one
    # stays as it is): the hidden forward, then loss + backward + update.
    batch = batch_to_device(first, "cuda")
    opt = medusa_train.make_adamw(MEDUSA_LR)
    scratch = medusa_train.init_medusa_state(cfg, params, MEDUSA_HEADS, opt)
    hidden = medusa_train.medusa_hidden_states(params, cfg, batch)
    hidden_ms = cuda_time_ms(lambda: medusa_train.medusa_hidden_states(params, cfg, batch),
                             warmup=1, iters=3)
    update_ms = cuda_time_ms(lambda: medusa_train.medusa_head_update(
        scratch, opt, hidden, batch["labels"]), warmup=1, iters=3)
    witness = medusa_gradient_witness(params["llama"], hidden, batch["labels"])
    del scratch, hidden, batch
    heads_path = os.path.join(work, "medusa_trained_7b.npz")
    save_medusa(heads_path, heads)
    del heads
    torch.cuda.empty_cache()

    # The held-out requests served with the saved stack, against the oracle.
    with open(paths["eval"]) as f:
        entries = json.load(f)
    traffic = medusa_acceptance.eval_traffic(cfg, tokenizer, entries, paths["events"])
    served = {}
    for name, flags in (("oracle", ["--no_pipeline", "--no_prefix_cache", "--prefill_budget",
                                    "0"]),
                        ("medusa", ["--speculative", str(SPEC_WINDOW), "--draft_head",
                                    heads_path])):
        args = cli_serve.build_parser().parse_args(
            ["--max_batch", "4", "--max_len", "1024", "--chunk", "32", "--kv_cache", "int8",
             "--kv_layout", "dense"] + flags)
        batcher = cli_serve.make_batcher(args, params, cfg, tokenizer, "cuda")
        tally = IdleTally(batcher)
        t1 = time.perf_counter()
        rids = [batcher.submit(ids, px, MEDUSA_SERVE_BUDGET) for ids, px in traffic]
        while batcher.queue or any(r is not None for r in batcher.rows):
            tally.step()
        batcher._drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        chains = [batcher.finished[r] for r in rids]
        served[name] = {"chains": chains, "wall_s": wall,
                        "batch_tok_s": sum(len(c) for c in chains) / wall,
                        "ttft_s": [batcher.request_stats[r]["ttft_s"] for r in rids],
                        "no_live_row": tally.numbers(f"medusa_train_7b {name}")}
        if batcher.speculative:
            served[name].update({"spec_iterations": batcher.spec_iterations,
                                 "spec_tokens": batcher.spec_tokens,
                                 "tokens_per_live_verify": batcher.spec_tokens_per_iteration()})
        del batcher
        torch.cuda.empty_cache()
    want_chains, got = served["oracle"]["chains"], served["medusa"]["chains"]
    padded = mask = None
    if got != want_chains:
        padded, mask, _ = prepare_prefill(params, cfg, [t[0] for t in traffic],
                                          [t[1] for t in traffic])
    rule = chain_rule("medusa_train_7b served", llama, params, cfg, padded, mask, want_chains,
                      got, SERVE_KSTEP_WINDOW, True, tokenizer.eos_token_id)
    for run in served.values():
        run["first_ids"] = [c[:8] for c in run.pop("chains")]

    # The script itself, on a tiny model on the card, and its int4 refusal.
    out = os.path.join(work, "medusa_tiny.npz")
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "eventgpt_tpu_torch.scripts.train_medusa", "--model_path",
         "tiny-random", "--data_path", paths["train"], "--event_folder", paths["events"],
         "--conv_version", "plain", "--max_steps", "2", "--batch_size", "2",
         "--logging_steps", "1", "--out", out],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    if (res.returncode != 0 or [x["step"] for x in lines] != [1, 2] or not os.path.exists(out)
            or not all(math.isfinite(x["loss"]) for x in lines)):
        raise AssertionError(f"train_medusa on the card exited {res.returncode}: {lines} "
                             f"{res.stderr[-3000:]}")
    try:
        train_medusa.main(["--data_path", paths["train"], "--quant", "int4"])
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    if refused is None:
        raise AssertionError("train_medusa --quant int4 did not refuse")
    shutil.rmtree(root, ignore_errors=True)
    warm = step_ms[1:]
    return {
        "config": f"EventGPT-7B bf16 tree (random, seed 0), motion corpus {MEDUSA_CORPUS} "
                  f"(train, eval), plain conversations, {MEDUSA_HEADS} heads, "
                  f"{MEDUSA_STEPS} steps of batch {MEDUSA_BATCH}, adamw lr {MEDUSA_LR}",
        "batch": {"T": int(first["attn_mask"].shape[1]),
                  "lengths": [int(x) for x in first["attn_mask"].sum(1)]},
        "train_s": train_s, "step_ms": step_ms, "cold_step_ms": step_ms[0],
        "warm_step_ms": sum(warm) / len(warm),
        "split_ms_first_batch": {"hidden_forward_no_grad": hidden_ms,
                                 "head_loss_backward_update": update_ms},
        "per_head_loss_first": records[0]["per_head"], "per_head_loss_last": last["per_head"],
        "loss_first": records[0]["loss"], "loss_last": last["loss"],
        "losses": losses, "gradient_witness_first_batch": witness,
        "grad_norm_first": records[0]["grad_norm"], "grad_norm_last": last["grad_norm"],
        "lr_low": {"lr": MEDUSA_LR_LOW, "losses": [r["loss"] for r in low_records],
                   "per_head_loss_first": low_records[0]["per_head"],
                   "per_head_loss_last": low_last["per_head"]},
        "k1_launches": k1["launches"], "k1_by_path": k1["by_path"],
        "k1_launches_per_step": k1["launches"] / MEDUSA_STEPS,
        "kernel_flash_medusa_shape": flash_check,
        "peak_mem_bytes": peak, "held_before_bytes": held, "peak_above_held_bytes": peak - held,
        "stack_f32_bytes": MEDUSA_HEADS * cfg.llama.hidden_size ** 2 * 4,
        "frozen_sha256_unchanged": frozen_hash, "stack_moved": True,
        "served": {**served, "vs_oracle": rule,
                   "note": "random 7B weights: acceptance measures the mechanism, not answers"},
        "cli_subprocess_tiny": {"returncode": 0, "seconds": time.perf_counter() - t1,
                                "losses": [x["loss"] for x in lines]},
        "int4_refused": refused[:80], "nvidia_smi": smi,
    }


def tiny_medusa_card_vs_cpu() -> dict:
    """``medusa_loss``, its gradient and one head step (zero stack,
    ``make_adamw``) of a tiny f32 model on the card against the CPU, TF32
    off, within TINY_MEDUSA_ATOL."""
    import numpy as np
    import torch

    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.models import medusa as medusa_mod
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.train import medusa as medusa_train
    from eventgpt_tpu_torch.train.data import synthetic_multimodal_batch
    from eventgpt_tpu_torch.train.steps import batch_to_device

    cfg = EventChatConfig.tiny(vocab_size=260)
    cpu = init_eventchat_params(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu")
    rng = np.random.default_rng(8)
    size = cfg.vision.image_size
    pix = rng.standard_normal((2, cfg.num_event_frames, 3, size, size)).astype(np.float32)
    host = synthetic_multimodal_batch(cfg, 2, 48, event_offset=5, pixel_values=pix,
                                      mask_event_labels=True)
    host["token_ids"] = rng.integers(3, 259, (2, 48)).astype(np.int32)
    host["labels"] = np.where(host["event_pos"], -100, host["token_ids"]).astype(np.int32)
    w0 = torch.from_numpy(rng.standard_normal((MEDUSA_HEADS, 64, 64)).astype(np.float32) * 0.1)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = _to(cpu, dev)
        batch = batch_to_device(host, dev)
        hidden = medusa_train.medusa_hidden_states(params, cfg, batch)
        w = w0.to(dev).requires_grad_(True)
        loss, per_head = medusa_mod.medusa_loss(params["llama"], {"w": w}, hidden,
                                                batch["labels"])
        (grad,) = torch.autograd.grad(loss, [w])
        opt = medusa_train.make_adamw(1e-3)
        state = medusa_train.init_medusa_state(cfg, params, MEDUSA_HEADS, opt)
        _, m = medusa_train.make_medusa_train_step(cfg, opt)(state, batch)
        runs[dev] = [x.detach().cpu() for x in (loss, per_head, grad, m["loss"],
                                                state.trainable["w"])]
    names = ("loss", "per_head_loss", "grad", "step_loss", "stack_after_step")
    diffs = {n: (a - b).abs().max().item() for n, a, b in zip(names, runs["cpu"], runs["cuda"])}
    if not all(d <= TINY_MEDUSA_ATOL for d in diffs.values()):
        raise AssertionError(f"tiny Medusa head step differs on the card: {diffs}")
    return {"config": "EventChatConfig.tiny(vocab 260), f32, batch 2 x 48, 3 heads, lr 1e-3",
            "max_abs_diff": diffs, "bar": TINY_MEDUSA_ATOL,
            "loss_cpu": float(runs["cpu"][0]), "loss_cuda": float(runs["cuda"][0])}


def medusa_acceptance_tiny(work: str) -> dict:
    """The port's acceptance study (``scripts/medusa_acceptance``) at the
    JAX gate's scale (ACCEPTANCE_ARGS: a third of the script's default
    steps, which kept the whole run inside its time limit) on the card,
    f32: the record, then the JAX gate's bars. ``main`` itself raises when
    the three drafts' chains differ."""
    from eventgpt_tpu_torch.scripts import medusa_acceptance

    out = os.path.join(work, "medusa_acceptance")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # main prints the record; it is emitted below
        record = medusa_acceptance.main(["--out_dir", out, "--log_every", "200",
                                         *ACCEPTANCE_ARGS])
    seconds = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    trained = record["medusa_trained"]["tokens_per_iteration"]
    random_ = record["medusa_random"]["tokens_per_iteration"]
    bars = {"random_within": abs(random_ - ACCEPTANCE_RANDOM) <= ACCEPTANCE_RANDOM_TOL,
            "trained_above_min": trained > ACCEPTANCE_TRAINED_MIN,
            "trained_above_random": trained > random_ + ACCEPTANCE_TRAINED_OVER_RANDOM}
    if not all(bars.values()):
        raise AssertionError(f"medusa_acceptance_tiny misses the JAX gate's bars: {bars}, "
                             f"{record}")
    return {**record, "bars": bars, "seconds": seconds}


def _numpy_raster(x, y, p, h: int, w: int):
    """The host's numpy scatter, last write wins: the rasterizers' oracle."""
    import numpy as np

    lin = y.astype(np.int64) * w + x.astype(np.int64)
    last = np.full(h * w, -1, dtype=np.int64)
    np.maximum.at(last, lin, np.arange(lin.size, dtype=np.int64))
    frame = np.full((h * w, 3), 255, dtype=np.uint8)
    hit = last >= 0
    frame[hit] = np.where(np.asarray(p)[last[hit]][:, None] != 0, np.array([255, 0, 0], np.uint8),
                          np.array([0, 0, 255], np.uint8))
    return frame.reshape(h, w, 3)


def native_raster(event_paths, build_s: float, smi: str) -> dict:
    """The native host toolchain, built by the port from ``native/`` with the
    host compiler (``build_s``, beside the kernels' nvcc): over the five
    equal-count slices of each stream, ``rasterize_events_native``,
    ``rasterize_events`` (its native path counted) and
    ``rasterize_events_torch`` on the card all equal the numpy scatter bit
    for bit; host ms per frame (native, numpy) and device ms per frame
    (CUDA events, events already on the card); ``process_event_file`` over
    the four streams, all through the native path."""
    import numpy as np
    import torch

    from eventgpt_tpu_torch import native
    from eventgpt_tpu_torch.ops import raster
    from eventgpt_tpu_torch.ops.image import process_event_file

    slices = []
    for path in event_paths:
        ev = raster.load_event_npy(path)
        for x, y, p in raster.split_events_by_count(ev, 5):
            slices.append((x, y, p, int(y.max()) + 1, int(x.max()) + 1))
    before = raster.RASTER_PATHS["native"]
    for x, y, p, h, w in slices:
        want = _numpy_raster(x, y, p, h, w)
        got = {"native": native.rasterize_events_native(x, y, p, h, w),
               "rasterize_events": raster.rasterize_events(x, y, p),
               "torch_cuda": raster.rasterize_events_torch(x, y, p, h, w, "cuda").cpu().numpy()}
        bad = [k for k, v in got.items() if not np.array_equal(v, want)]
        if bad:
            raise AssertionError(f"native_raster: {bad} differ from the numpy scatter")
    if raster.RASTER_PATHS["native"] - before != len(slices):
        raise AssertionError(f"native_raster: rasterize_events took the native path "
                             f"{raster.RASTER_PATHS['native'] - before} of {len(slices)} times")

    def host_ms(fn):
        t0 = time.perf_counter()
        for x, y, p, h, w in slices:
            fn(x, y, p, h, w)
        return (time.perf_counter() - t0) * 1e3 / len(slices)

    on_card = [tuple(torch.as_tensor(v.astype(np.int32), device="cuda") for v in (x, y, p))
               + (h, w) for x, y, p, h, w in slices]

    def device_all():
        for x, y, p, h, w in on_card:
            raster.rasterize_events_torch(x, y, p, h, w)

    device_all()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        device_all()
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for path in event_paths:
        process_event_file(path)
    process_s = time.perf_counter() - t0
    return {"build_s": build_s, "library": os.path.relpath(native.library_path(), ROOT),
            "frames": len(slices), "events_per_frame": [len(s[0]) for s in slices[:5]],
            "bit_equal": ["native", "rasterize_events (native path)", "torch on cuda"],
            "host_ms_per_frame": {"native": host_ms(native.rasterize_events_native),
                                  "numpy": host_ms(_numpy_raster)},
            "device_ms_per_frame": start.elapsed_time(end) / (5 * len(slices)),
            "process_event_file_s_four_streams": process_s,
            "process_paths": dict(raster.RASTER_PATHS), "nvidia_smi": smi}


def eval_7b(params, cfg, tokenizer, event_paths, work: str, counted, slice_ids,
            n_layers: int, smi: str) -> dict:
    """``cli/eval``'s function over a tree loaded as the CLI loads it: the four
    streams with the four queries (``--queries_json``), ``--max_new_tokens
    32``, greedy, one batched ``generate`` (K1 at batch 4). The chains are
    ``slice``'s, or leave them only at a measured tie (``--context_len
    2048`` gives the cache another length than ``slice``'s)."""
    from eventgpt_tpu_torch.cli import eval as cli_eval
    from eventgpt_tpu_torch.models import eventchat, llama
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL

    qpath = os.path.join(work, "eval_queries.json")
    with open(qpath, "w") as f:
        json.dump(QUERIES, f)
    args = cli_eval.build_parser().parse_args(
        ["--model_path", "checkpoint_7b", "--event_frames", ",".join(event_paths),
         "--queries_json", qpath, "--max_new_tokens", str(MAX_NEW_TOKENS)])
    queries = cli_eval.read_queries(args, len(event_paths))
    res, launches = counted(lambda: cli_eval.evaluate(cfg, params, tokenizer, event_paths,
                                                      queries, args, "cuda"))
    if launches[FLASH_KERNEL.source] != n_layers:
        raise AssertionError(f"eval_7b: launches {launches}, want K1 = {n_layers}")
    held = {"rows_identical": [True] * len(QUERIES), "divergences": []}
    if res["ids"] != slice_ids:
        from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
        from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
        from eventgpt_tpu_torch.ops.image import process_event_file

        import numpy as np

        ids = [tokenize_with_event(prepare_event_prompt(q), tokenizer) for q in QUERIES]
        pixels = np.stack([process_event_file(p)[1] for p in event_paths])
        padded, mask, _ = eventchat.prepare_prefill(params, cfg, ids, pixels)
        held = chain_rule("eval_7b", llama, params, cfg, padded, mask, slice_ids, res["ids"],
                          SERVE_KSTEP_WINDOW, False, tokenizer.eos_token_id)
    return {"argv": ["--event_frames", "events_{0..3}.npy", "--queries_json", "(QUERIES)",
                     "--max_new_tokens", str(MAX_NEW_TOKENS), "--context_len",
                     str(args.context_len)],
            "prep_s": res["prep_s"], "generate_s": res["generate_s"], "launches": launches,
            "greedy_sha256": digest(res["ids"]), "same_digest_as_slice": res["ids"] == slice_ids,
            "vs_slice": held, "answers": res["answers"], "nvidia_smi": smi}


def eval_cli_tiny(ckpt: str, event_paths, params, cfg, tokenizer) -> dict:
    """``python -m eventgpt_tpu_torch.cli.eval`` as a subprocess on the card
    over the tiny checkpoint whose ids decode to one character each: with an
    ``--expected`` file of the in-process answers it prints them and exits
    0; ``main`` in this process, with one answer changed, exits 1."""
    import argparse
    import contextlib
    import io

    from eventgpt_tpu_torch.cli import eval as cli_eval

    args = argparse.Namespace(conv_mode="eventgpt_v1", draft_head=None,
                              max_new_tokens=MAX_NEW_TOKENS, temperature=0.0, top_p=1.0,
                              seed=0, context_len=2048, num_beams=1, kv_cache="bf16",
                              speculative=0)
    want = cli_eval.evaluate(cfg, params, tokenizer, event_paths, QUERIES[:len(event_paths)],
                             args, "cuda")["answers"]
    if not all(want):
        raise AssertionError(f"eval_cli_tiny: an in-process answer is empty: {want}")
    work = os.path.dirname(ckpt)
    qpath = os.path.join(work, "tiny_eval_queries.json")
    with open(qpath, "w") as f:
        json.dump(QUERIES[:len(event_paths)], f)
    argv, paths = [], {}
    for name, expected in (("matching", want), ("one_wrong", want[:-1] + [want[-1] + "?"])):
        paths[name] = os.path.join(work, f"tiny_eval_expected_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(expected, f)
    argv = ["--model_path", ckpt, "--tokenizer_path", "byte", "--event_frames",
            ",".join(event_paths), "--queries_json", qpath, "--max_new_tokens",
            str(MAX_NEW_TOKENS), "--timing"]
    env = dict(os.environ, PYTHONIOENCODING="utf-8",
               PYTHONPATH=os.pathsep.join([ROOT] + [x for x in [os.environ.get("PYTHONPATH")]
                                                    if x]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "eventgpt_tpu_torch.cli.eval", *argv,
                          "--expected", paths["matching"]],
                         capture_output=True, timeout=600, cwd=ROOT, env=env)
    err = res.stderr.decode(errors="replace")
    printed = res.stdout.decode(errors="replace")
    runs = {"matching": {"exit_code": res.returncode, "seconds": time.perf_counter() - t0,
                         "pass": err.count("[PASS]"), "fail": err.count("[FAIL]"),
                         "timing": [ln for ln in err.splitlines() if ln.startswith("[timing]")]}}
    if res.returncode != 0 or not all(f"\n{a}\n" in "\n" + printed for a in want):
        raise AssertionError(f"eval_cli_tiny: the CLI exited {res.returncode} and printed "
                             f"{printed[-600:]!r}; in-process answers {want}; {err[-2000:]}")
    log = io.StringIO()
    try:
        with contextlib.redirect_stderr(log), contextlib.redirect_stdout(io.StringIO()):
            cli_eval.main(argv + ["--expected", paths["one_wrong"]])
        code = 0
    except SystemExit as e:
        code = e.code
    runs["one_wrong"] = {"exit_code": code, "pass": log.getvalue().count("[PASS]"),
                         "fail": log.getvalue().count("[FAIL]")}
    if code != 1 or runs["one_wrong"]["fail"] != 1:
        raise AssertionError(f"eval_cli_tiny: {runs}")
    return {"answers": want, "runs": runs}


def stream_7b(params, cfg, tokenizer, event_paths, work: str, counted, n_layers: int,
              smi: str) -> dict:
    """The port's stream script at 7B over one structured stream: the four
    synthetic streams shifted by 0, 50, 100 and 150 ms from t = 0, so that
    each 50 ms window holds exactly one stream's events. The native reader
    replays it; each window's chain equals a batch-1 ``generate`` on that
    window's events (``chain_rule``); K1 32 a window."""
    import numpy as np

    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
    from eventgpt_tpu_torch.models import eventchat, llama
    from eventgpt_tpu_torch.ops import raster
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.image import clip_preprocess_batch
    from eventgpt_tpu_torch.scripts.stream_demo import stream_answers

    parts = [np.load(p) for p in event_paths]
    for i, a in enumerate(parts):
        a["t"] += np.uint64(STREAM_WINDOW_US * i)
    parts[0]["t"][0] = 0
    path = os.path.join(work, "stream_7b.npy")
    np.save(path, np.concatenate(parts))
    out, launches = counted(lambda: stream_answers(
        cfg, params, tokenizer, path, QUERIES[0], window_ms=STREAM_WINDOW_US / 1e3,
        max_windows=len(parts), max_new_tokens=MAX_NEW_TOKENS, device="cuda"))
    windows = out["windows"]
    got = [(w["start_us"], w["events"]) for w in windows]
    want = [(STREAM_WINDOW_US * i, len(a)) for i, a in enumerate(parts)]
    if got != want or launches[FLASH_KERNEL.source] != n_layers * len(parts):
        raise AssertionError(f"stream_7b: windows (start, events) {got}, want {want}; "
                             f"launches {launches}, want K1 = {n_layers} a window")
    ids = tokenize_with_event(prepare_event_prompt(QUERIES[0]), tokenizer)
    oracle, pixels = [], []
    for a in parts:
        ev = {k: np.ascontiguousarray(a[k]) for k in a.dtype.names}
        pixels.append(clip_preprocess_batch(raster.events_to_frames(ev, cfg.num_event_frames),
                                            cfg.vision.image_size))
        oracle.append(eventchat.generate(params, cfg, [ids], pixels[-1][None],
                                         max_new_tokens=MAX_NEW_TOKENS, temperature=0.0,
                                         eos_token_id=tokenizer.eos_token_id, device="cuda")[0])
    chains = [w["ids"] for w in windows]
    padded = mask = None
    if chains != oracle:
        padded, mask, _ = eventchat.prepare_prefill(params, cfg, [ids] * len(parts),
                                                    np.stack(pixels))
    held = chain_rule("stream_7b", llama, params, cfg, padded, mask, oracle, chains,
                      SERVE_KSTEP_WINDOW, False, tokenizer.eos_token_id)
    return {"stream": "events_{0..3}.npy shifted by 0, 50, 100, 150 ms; first event at t = 0",
            "query": QUERIES[0], "window_ms": STREAM_WINDOW_US / 1e3,
            "windows": [{k: w[k] for k in ("start_us", "events", "ms")} for w in windows],
            "reader_pops": out["pops"], "reader_events": out["popped"], "launches": launches,
            "k1_per_window": launches[FLASH_KERNEL.source] / len(parts),
            "vs_batch_1_generate": held, "nvidia_smi": smi}


def train_remat_7b(params, cfg, tokenizer, paths: dict, work: str, smi: str) -> dict:
    """One stage-2 LoRA micro-step at 7B width (batch 2, ``cli.train``'s
    construction) under each remat policy: the loss and the gradient norm
    equal across them, K1 64 launches a micro-step (32 forward, 32
    recomputed: the kernel is no matmul, so no policy keeps its output);
    peak device memory over what was held, and step ms, which the policies
    trade (nothing is claimed for them)."""
    import torch

    from eventgpt_tpu_torch.cli.train import build_trainer
    from eventgpt_tpu_torch.ops import flash_attention as fa
    from eventgpt_tpu_torch.train.data import batch_iterator
    from eventgpt_tpu_torch.train.steps import batch_to_device

    n_layers = cfg.llama.num_layers
    runs = {}
    for policy in REMAT_POLICIES:
        trainer = build_trainer(*_train_args(2, paths, os.path.join(work, f"remat_{policy}"),
                                             remat_policy=policy),
                                device="cuda", loaded=(cfg, params, tokenizer))
        batch = batch_to_device(next(batch_iterator(
            trainer.dataset, TRAIN_BATCH, trainer.cfg, seed=trainer.targs.seed,
            max_len=trainer.targs.model_max_length)), "cuda")
        for key in fa.LAUNCHES_BY_PATH:
            fa.LAUNCHES_BY_PATH[key] = 0
        fa.FLASH_KERNEL.launches = 0
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, m = trainer.train_step(trainer.state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        step_ms = (time.perf_counter() - t0) * 1e3
        runs[policy] = {"loss": loss, "grad_norm": gnorm, "step_ms": step_ms,
                        "peak_over_held_bytes": torch.cuda.max_memory_allocated() - held,
                        "k1_launches": fa.FLASH_KERNEL.launches,
                        "k1_by_path": dict(fa.LAUNCHES_BY_PATH),
                        "remat_policy": trainer.cfg.llama.remat_policy}
        del trainer, batch, m
        torch.cuda.empty_cache()
    bad = {p: r for p, r in runs.items()
           if (r["loss"], r["grad_norm"]) != (runs["full"]["loss"], runs["full"]["grad_norm"])
           or r["k1_launches"] != 2 * n_layers or r["k1_by_path"]["recompute"] != n_layers
           or r["remat_policy"] != p}
    if bad:
        raise AssertionError(f"train_remat_7b: {bad} against full {runs['full']}")
    return {"config": "stage 2 (LoRA r 64 + projector), batch 2, bf16, one micro-step each",
            "runs": runs, "equal_loss_and_grad_norm": True, "nvidia_smi": smi}


# The serving mesh on the one card: two ranks under ``python -m
# torch.distributed.run``, both on card 0, over gloo (NCCL 2.28.9 answers
# two ranks of one card with "invalid usage"). MESH_TINY_LOGIT_ATOL
# bounds a rank's bf16 prefill logits on the card (K1, K4 on the shards)
# against the same rank on the CPU (the plain versions); MESH_TINY is the
# tiny config whose shards K4's shape gate takes at model 2 (N and K of
# 256 and more a rank).
MESH_RANKS = 2
MESH_BACKEND = "gloo"
MESH_TINY_LOGIT_ATOL = 5e-2
MESH_TINY_NEW = 16
MESH_TINY_MESHES = (("model2", (1, 1, 2)), ("fsdp2", (1, 2, 1)))
# The batcher's features on the tiny mesh: preemption (spill, drop) with a
# planted clock jump on rank 1, roles, a fleet with a replica killed. Chains
# of MESH_TINY_NEW tokens, as the generate cases': at 40 the drop arm's
# re-decoded row left the CPU's chain at token 25 (NVIDIA H100 80GB HBM3 at
# 700 W), a bf16 tie between the card's kernels and the CPU's plain
# versions (PERF.md).
MESH_TINY_SERVE = {"mesh": "model2", "max_len": 1024, "batch": MESH_TINY_NEW,
                   "inter": MESH_TINY_NEW // 2, "roles": MESH_TINY_NEW, "fleet": MESH_TINY_NEW,
                   "steps_before": 2}

MESH_NCCL_RANK = r"""
# One rank of chip_smoke.py's NCCL check on the card: OUT.
import json, os, sys

import torch
import torch.distributed as dist

from eventgpt_tpu_torch.parallel.dist import initialize_distributed

initialize_distributed(backend="nccl", timeout_s=120)
rank, world = dist.get_rank(), dist.get_world_size()
x = torch.arange(8.0, device="cuda")
dist.all_reduce(x)
parts = [torch.empty_like(x) for _ in range(world)]
dist.all_gather(parts, x)
torch.cuda.synchronize()
want = [world * float(i) for i in range(8)]
with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as f:
    json.dump({"rank": rank, "world": world, "backend": dist.get_backend(),
               "world_collectives_ok": x.tolist() == want
               and all(p.tolist() == want for p in parts)}, f)
dist.destroy_process_group()
"""

MESH_TINY_RANK = r"""
# One rank of chip_smoke.py's tiny_mesh_card_vs_cpu: CKPT DEVICE BACKEND OUT JOB.
import argparse, json, os, sys

import numpy as np
import torch
import torch.distributed as dist

from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
from eventgpt_tpu_torch.config import MeshConfig
from eventgpt_tpu_torch.fleet_proc import _reset_kernel_launches, kernel_launches
from eventgpt_tpu_torch.models import eventchat, llama
from eventgpt_tpu_torch.parallel.dist import initialize_distributed
from eventgpt_tpu_torch.parallel.mesh import COLLECTIVES, make_mesh
from eventgpt_tpu_torch.parallel.serving import batch_rows, head_shard

ckpt, device, backend, out, job_path = sys.argv[1:6]
job = json.load(open(job_path))
initialize_distributed(backend=backend, timeout_s=300)
rank, world = dist.get_rank(), dist.get_world_size()
res = {"rank": rank, "world": world, "backend": dist.get_backend()}
pixels = np.stack([np.load(p) for p in job["pixels"]])
ids = job["ids"]
kept = {}
for name, shape in job["meshes"]:
    mesh = make_mesh(MeshConfig(data=shape[0], fsdp=shape[1], model=shape[2]), device)
    args = argparse.Namespace(model_path=ckpt, use_event_qformer=False,
                              pretrain_query_embedder=None, pretrain_attention_layers=None,
                              quant="int4", fuse_params=False, seed=0,
                              spatial_temporal_encoder=True)
    cfg, params, tok = load_model(ckpt, "bfloat16", "flash", "byte", "cpu")
    cfg, params = prepare_model(cfg, params, tok, args, mesh=mesh)
    _reset_kernel_launches()
    COLLECTIVES.update(count=0, bytes=0, seconds=0.0)
    chains = eventchat.generate(params, cfg, ids, pixels, max_new_tokens=job["new"],
                                temperature=0.0, eos_token_id=None, kv_quant=True,
                                device=device, mesh=mesh)
    launches = kernel_launches()
    rows = batch_rows(mesh, len(ids))
    padded, mask, _ = eventchat.prepare_prefill(params, cfg, [ids[i] for i in rows],
                                                pixels[rows.start:rows.stop], mesh=mesh)
    cache = llama.init_kv_cache(cfg.llama, padded.shape[0], padded.shape[1],
                                dtype=padded.dtype, device=device, quant=True, mesh=mesh)
    with torch.inference_mode():
        logits, _ = llama.prefill(params["llama"], cfg.llama, padded, mask, cache,
                                  last_only=True, mesh=mesh)
    res[name] = {"chains": chains, **launches, "rows": list(rows),
                 "logits": logits.float().cpu().tolist(), "collectives": dict(COLLECTIVES),
                 "heads": head_shard(cfg.llama, mesh).heads,
                 "kv_heads": head_shard(cfg.llama, mesh).kv_heads}
    kept[name] = (mesh, cfg, params, tok, args)

# The batcher's features on the model-2 mesh (ROADMAP item 8c).
import time

from eventgpt_tpu_torch.cli import serve as cli_serve
from eventgpt_tpu_torch.parallel.mesh import AGREEMENTS
from eventgpt_tpu_torch.serve import ContinuousBatcher
from eventgpt_tpu_torch.workload import SLO

sv = job["serve"]
mesh, cfg, params, tok, args = kept[sv["mesh"]]
_reset_kernel_launches()
AGREEMENTS.update(count=0, seconds=0.0)


def batcher(tree, m, **kw):
    return ContinuousBatcher(tree, cfg, device=device, mesh=m, eos_token_id=None, max_batch=2,
                             max_len=sv["max_len"], chunk=4, kv_quant=True, kv_layout="paged",
                             **kw)


def drained(b):
    while b.queue or any(r is not None for r in b.rows):
        b.step()
    b._drain()


probe = batcher(params, mesh)
need = []
for i, n in ((0, sv["batch"]), (1, sv["inter"])):
    probe.submit(ids[i], pixels[i], n)
    need.append(probe._blocks_needed(probe.queue[-1].prompt_len, n))
del probe
for arm, spill_mb in (("spill", 64), ("drop", 0)):
    # The batch row holds its reservation; the interactive one needs more
    # than the rest: it preempts. Both carry a far deadline, and after the
    # submits rank 1's clock jumps 10^4 s: rank 0's clock governs.
    b = batcher(params, mesh, preempt=True, kv_pool_blocks=need[0] + need[1],
                spill_capacity_mb=spill_mb)
    b._recompute_flops_per_s = 1.0
    rb = b.submit(ids[0], pixels[0], sv["batch"], deadline_s=3600.0,
                  slo=SLO(name="batch", latency_s=3600.0))
    for _ in range(sv["steps_before"]):
        b.step()
    ri = b.submit(ids[1], pixels[1], sv["inter"], deadline_s=3600.0,
                  slo=SLO(name="interactive", ttft_s=3600.0))
    if rank == 1:
        b._clock = lambda: time.perf_counter() + 1e4
    drained(b)
    res["serve_" + arm] = {"chains": [b.finished[rb], b.finished[ri]],
                           "statuses": [b.finish_status[rb], b.finish_status[ri]],
                           "pool": b.pool_stats(), "spill": b.spill_stats()}
# Roles: prefill on the mesh, each whole record spliced into a one-device
# decode batcher over the whole tree.
_, whole = prepare_model(*load_model(ckpt, "bfloat16", "flash", "byte", device)[:2], tok, args)
pre, dec = batcher(params, mesh, role="prefill"), batcher(whole, None, role="decode")
rids = [pre.submit(ids[i], pixels[i], sv["roles"]) for i in range(2)]
to_dec = {}
while pre.queue or any(r is not None for r in pre.rows):
    pre.step()
    for h in pre.pop_handoffs():
        to_dec[h["rid"]] = dec.import_handoff(h["input_ids"], h["max_new_tokens"], h["rec"],
                                              tokens=h["tokens"], prompt_len=h["prompt_len"])
got = dec.run_until_drained()
res["serve_roles"] = {"chains": [got[to_dec[r]] for r in rids],
                      "handoff_bytes": pre.handoffs_gathered_bytes}
# cli/serve's engine with --fleet 2 on the mesh: replica 0 killed mid-decode.
fargs = cli_serve.build_parser().parse_args(
    ["--model_path", ckpt, "--tokenizer_path", "byte", "--device", device, "--max_batch", "2",
     "--max_len", str(sv["max_len"]), "--chunk", "4", "--kv_layout", "paged", "--kv_cache",
     "int8", "--fleet", "2", "--preempt", "--spill_capacity_mb", "64", "--no_telemetry",
     "--temperature", "0"])
engine = cli_serve.make_engine(fargs, params, cfg, tok, device, mesh=mesh,
                               channel=cli_serve.MeshChannel())
if rank != 0:
    res["serve_fleet"] = {"follower_steps": engine.follow(),
                          "follower_kills": [f.kills for f in engine.followers]}
else:
    try:
        frids = [engine.submit_ids(ids[i], pixels[i], sv["fleet"]) for i in range(2)]
        victim = engine.replicas[0].engine.batcher
        t_end = time.monotonic() + 120
        while not any(r is not None and r.tokens for r in victim.rows) \
                and time.monotonic() < t_end:
            time.sleep(0.002)
        moved = engine.kill_replica(0)
        res["serve_fleet"] = {"chains": [engine.result(f, timeout=300) for f in frids],
                              "statuses": [engine.status(f) for f in frids], "moved": moved}
    finally:
        engine.shutdown()
    # After the shutdown: a loop may take a trailing step after its last answer.
    res["serve_fleet"]["leader_steps"] = [r.engine.batcher.steps for r in engine.replicas]
res["serve_launches"] = kernel_launches()
res["serve_agreements"] = dict(AGREEMENTS)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(nproc: int) -> list:
    """The launcher's command line for ``nproc`` ranks on this host."""
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
            "--master_addr", "127.0.0.1", "--master_port", str(free_port())]


def mesh_env() -> dict:
    """The ranks' environment: the repository on the path, and the host's
    cores split between the ranks (the launcher would give each one
    thread, which slows the ranks' host preprocessing)."""
    return dict(os.environ, PYTHONIOENCODING="utf-8",
                OMP_NUM_THREADS=str(max((os.cpu_count() or 2) // MESH_RANKS, 1)),
                PYTHONPATH=os.pathsep.join([ROOT] + [x for x in [os.environ.get("PYTHONPATH")]
                                                     if x]))


def start_world(argv: list, nproc: int, log_path: str) -> tuple:
    """``argv`` on ``nproc`` ranks under the launcher, its output to
    ``log_path``: (the launcher's process, its log, the start time)."""
    log = open(log_path, "w")
    return (subprocess.Popen(torchrun(nproc) + argv, stdout=log, stderr=subprocess.STDOUT,
                             cwd=ROOT, env=mesh_env()), log, time.perf_counter())


def finish_world(started: tuple, timeout: float) -> tuple:
    """Wait for a ``start_world`` (killed past ``timeout`` seconds from its
    start): (exit code, seconds, the log)."""
    proc, log, t0 = started
    try:
        code = proc.wait(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        code = 124
    secs = time.perf_counter() - t0
    log.close()
    with open(log.name) as f:
        return code, secs, f.read()


def run_world(argv: list, nproc: int, log_path: str, timeout: float) -> tuple:
    """``argv`` on ``nproc`` ranks under the launcher: (exit code, seconds,
    the log)."""
    return finish_world(start_world(argv, nproc, log_path), timeout)


def tagged_lines(text: str, tag: str) -> list:
    """The JSON objects of the lines that begin with ``tag``."""
    return [json.loads(ln[len(tag):]) for ln in text.splitlines() if ln.startswith(tag)]


def tiny_mesh_card_vs_cpu(work: str) -> dict:
    """A world of 2 on the card (gloo, K1 and K4 on each rank's shards)
    against the same world on the CPU (gloo, the plain versions), at meshes
    model 2 and fsdp 2, over a tiny bf16 checkpoint with ``--quant int4``
    and the int8 KV cache: the chains equal and each rank's prefill logits
    within MESH_TINY_LOGIT_ATOL. Beside them one rank over NCCL (an
    all-reduce and an all-gather of the world group on the card). The three
    worlds run at once."""
    import dataclasses

    import numpy as np
    import torch

    from eventgpt_tpu_torch.config import EventChatConfig, LlamaConfig
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import load_tokenizer, tokenize_with_event
    from eventgpt_tpu_torch.models.convert import init_eventchat_params, write_hf_checkpoint
    from eventgpt_tpu_torch.ops.image import process_event_file

    base = EventChatConfig.tiny()
    cfg = dataclasses.replace(
        base, llama=LlamaConfig(vocab_size=260, hidden_size=512, intermediate_size=1024,
                                num_layers=2, num_heads=4, num_kv_heads=4, max_seq_len=2048),
        projector=dataclasses.replace(base.projector, output_dim=512))
    root = os.path.join(work, "tiny_mesh")
    ckpt = os.path.join(root, "checkpoint")
    os.makedirs(root, exist_ok=True)
    write_hf_checkpoint(init_eventchat_params(cfg, torch.Generator().manual_seed(11),
                                              torch.bfloat16, "cpu"), cfg, ckpt)
    tok = load_tokenizer("byte")
    pix = []
    for i in range(2):
        _, px = process_event_file(os.path.join(work, f"events_{i}.npy"), cfg.num_event_frames,
                                   cfg.vision.image_size)
        pix.append(os.path.join(root, f"pixels_{i}.npy"))
        np.save(pix[-1], px)
    job = {"ids": [tokenize_with_event(prepare_event_prompt(QUERIES[i]), tok) for i in range(2)],
           "pixels": pix, "new": MESH_TINY_NEW, "meshes": MESH_TINY_MESHES,
           "serve": MESH_TINY_SERVE}
    script = os.path.join(root, "rank.py")
    with open(script, "w") as f:
        f.write(MESH_TINY_RANK)
    nccl_script = os.path.join(root, "nccl_rank.py")
    with open(nccl_script, "w") as f:
        f.write(MESH_NCCL_RANK)
    with open(os.path.join(root, "job.json"), "w") as f:
        json.dump(job, f)
    # The worlds are independent: they start together.
    started = {}
    for name, nproc, argv in (
            ("card", MESH_RANKS, [script, ckpt, "cuda", MESH_BACKEND]),
            ("cpu", MESH_RANKS, [script, ckpt, "cpu", "gloo"]),
            ("nccl_one_rank", 1, [nccl_script])):
        out = os.path.join(root, name)
        os.makedirs(out, exist_ok=True)
        extra = [out, os.path.join(root, "job.json")] if argv[0] == script else [out]
        started[name] = (nproc, start_world(argv + extra, nproc, os.path.join(out, "log.txt")))
    runs = {}
    for name, (nproc, world) in started.items():
        code, secs, text = finish_world(world, 300)
        out = os.path.join(root, name)
        ranks = []
        for r in range(nproc):
            path = os.path.join(out, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
        runs[name] = {"exit_code": code, "seconds": secs, "ranks": ranks,
                      "errors": [ln for ln in text.splitlines()
                                 if "Error" in ln or "error" in ln][:6]}
    problems = []
    for name in ("card", "cpu", "nccl_one_rank"):
        if runs[name]["exit_code"] != 0 or len(runs[name]["ranks"]) != (1 if "one" in name
                                                                         else MESH_RANKS):
            problems.append(f"{name}: exit {runs[name]['exit_code']}, "
                            f"{runs[name]['errors']}")
    out = {"config": "tiny bf16 checkpoint (vocab 260, LLaMA d=512, 2 layers, 4 heads of 128, "
                     "I=1024), --quant int4 --kv_cache int8, 2 requests, "
                     f"{MESH_TINY_NEW} tokens, greedy",
           "backend": {"card": MESH_BACKEND, "cpu": "gloo"},
           "seconds": {n: r["seconds"] for n, r in runs.items()},
           "tolerance": MESH_TINY_LOGIT_ATOL}
    if not problems:
        card, cpu = runs["card"]["ranks"], runs["cpu"]["ranks"]
        for mesh_name, _ in MESH_TINY_MESHES:
            chains = [[r[mesh_name]["chains"] for r in w] for w in (card, cpu)]
            diff = max(float(np.abs(np.asarray(a[mesh_name]["logits"])
                                    - np.asarray(b[mesh_name]["logits"])).max())
                       for a, b in zip(card, cpu))
            k4 = [r[mesh_name]["launches"]["int4_matmul.cu"] for r in card]
            k1 = [r[mesh_name]["launches"]["flash_attention.cu"] for r in card]
            out[mesh_name] = {"chains_equal": chains[0] == chains[1],
                              "ranks_agree": all(c == chains[0][0] for c in chains[0]),
                              "max_abs_logit_diff": diff, "k4_launches_by_rank": k4,
                              "k4_launched_on_the_shards": all(k4),
                              "k1_launches_by_rank": k1,
                              "heads_by_rank": [r[mesh_name]["heads"] for r in card],
                              "kv_heads_by_rank": [r[mesh_name]["kv_heads"] for r in card],
                              "collectives_rank0": card[0][mesh_name]["collectives"],
                              "first_ids": [c[:8] for c in chains[0][0]]}
            if not (chains[0] == chains[1] and out[mesh_name]["ranks_agree"]
                    and diff <= MESH_TINY_LOGIT_ATOL and all(k1)):
                problems.append(f"{mesh_name}: {out[mesh_name]}")
        out["serve"] = tiny_mesh_serve_numbers(card, cpu, problems)
        one = runs["nccl_one_rank"]["ranks"][0]
        out["nccl_one_rank"] = {"backend": one["backend"],
                                "world_collectives_ok": one["world_collectives_ok"]}
        if one["backend"] != "nccl" or not one["world_collectives_ok"]:
            problems.append(f"nccl_one_rank: {out['nccl_one_rank']}")
    shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError(f"tiny_mesh_card_vs_cpu: {problems}")
    return out


def tiny_mesh_serve_numbers(card: list, cpu: list, problems: list) -> dict:
    """``tiny_mesh_card_vs_cpu``'s batcher cases, card world against CPU
    world: each case's chains equal on every rank of both, preemption
    spilled (restores equal to spills) and dropped, the pools clean, the
    fleet's follower at rank 0's steps per replica with the kill seen, K4
    on each card rank's shards, and decisions agreed."""
    out = {}
    for case in ("serve_spill", "serve_drop", "serve_roles"):
        chains = [[r[case]["chains"] for r in w] for w in (card, cpu)]
        same = all(c == chains[0][0] for w in chains for c in w)
        entry = {"chains_equal_card_cpu_and_ranks": same,
                 "tokens": [len(c) for c in chains[0][0]]}
        if not same:
            # Where each rank's chains leave the card's rank 0's.
            ref = chains[0][0]
            entry["first_divergence"] = [
                [next((k for k, (a, b) in enumerate(zip(x + [None], y + [None])) if a != b),
                      None) for x, y in zip(ref, c)] for w in chains for c in w]
            entry["chains"] = [c for w in chains for c in w]
        if case != "serve_roles":
            pools = [r[case]["pool"] for w in (card, cpu) for r in w]
            counts = [(p["preemptions"], p["spills"], p["restores"]) for p in pools]
            clean = all(p["spilled_runs"] == 0 and p["free_blocks"] + p["used_blocks"]
                        == p["usable_blocks"] for p in pools) and all(
                r[case]["spill"]["records"] == 0 for w in (card, cpu) for r in w)
            spilled = counts[0][1] >= 1 and counts[0][2] == counts[0][1]
            ok = (len(set(counts)) == 1 and counts[0][0] >= 1 and clean
                  and (spilled if case == "serve_spill" else counts[0][1] == 0)
                  and all(r[case]["statuses"] == ["ok", "ok"] for w in (card, cpu) for r in w))
            entry.update({"preemptions_spills_restores": counts[0], "clean": clean})
            same = same and ok
        else:
            entry["handoff_bytes"] = card[0][case]["handoff_bytes"]
        out[case] = entry
        if not same:
            problems.append(f"{case}: {entry}")
    lead = [w[0]["serve_fleet"] for w in (card, cpu)]
    follow = [w[1]["serve_fleet"] for w in (card, cpu)]
    fleet_ok = (lead[0]["chains"] == lead[1]["chains"]
                and all(x["statuses"] == ["ok", "ok"] for x in lead)
                and all(f["follower_steps"] == x["leader_steps"] for f, x in zip(follow, lead))
                and all(f["follower_kills"] == [1, 0] for f in follow))
    out["serve_fleet"] = {"chains_equal": lead[0]["chains"] == lead[1]["chains"],
                          "moved": lead[0]["moved"], "steps_by_replica": lead[0]["leader_steps"],
                          "follower_steps_by_replica": follow[0]["follower_steps"]}
    if not fleet_ok:
        problems.append(f"serve_fleet: {lead} {follow}")
    k4 = [r["serve_launches"]["launches"]["int4_matmul.cu"] for r in card]
    agreed = [r["serve_agreements"]["count"] for r in card]
    out["k4_launches_by_card_rank"] = k4
    out["k1_launches_by_card_rank"] = [r["serve_launches"]["launches"]["flash_attention.cu"]
                                       for r in card]
    out["agreements_by_card_rank"] = agreed
    if not all(k4) or not all(agreed):
        problems.append(f"serve: K4 by rank {k4}, agreements by rank {agreed}")
    return out


def mesh_card_numbers(report: dict) -> dict:
    """The per-rank numbers of a mesh phase worth a line."""
    keep = ("rank", "backend", "device", "heads", "launches", "peak_mem_bytes", "load_s",
            "encode_s", "prefill_s", "decode_s", "decode_steps", "steps", "collectives",
            "agreements",
            "decode_collectives_per_step", "decode_collective_s_per_step")
    return {k: report[k] for k in keep if k in report}


def eval_mesh_7b(params, cfg, tokenizer, ckpt: str, work: str, event_paths, slice_ids,
                 n_layers: int, smi: str) -> dict:
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    eventgpt_tpu_torch.cli.eval --mesh_model 2`` over the 7B checkpoint:
    ``eval_7b``'s four streams and queries, 32 tokens, greedy, each rank on
    the card holding half of every LLaMA matmul (16 of the 32 heads) and
    the replicated vision side. The chains held to ``slice``'s (digest
    ea7ea31e...) by ``chain_rule``; per rank: K1's launches (32, one
    prefill), peak memory, the backend, the collectives a decode step and
    the load, prefill and decode seconds."""
    from eventgpt_tpu_torch.models import eventchat, llama

    qpath = os.path.join(work, "eval_queries.json")
    with open(qpath, "w") as f:
        json.dump(QUERIES, f)
    ids_path = os.path.join(work, "eval_mesh_ids.json")
    argv = ["-m", "eventgpt_tpu_torch.cli.eval", "--model_path", ckpt, "--tokenizer_path",
            "byte", "--event_frames", ",".join(event_paths), "--queries_json", qpath,
            "--max_new_tokens", str(MAX_NEW_TOKENS), "--mesh_model", str(MESH_RANKS),
            "--dist_backend", MESH_BACKEND, "--timing", "--ids_out", ids_path]
    code, secs, text = run_world(argv, MESH_RANKS, os.path.join(work, "eval_mesh.log"), 900)
    ranks = sorted(tagged_lines(text, "[mesh-rank] "), key=lambda r: r["rank"])
    if code != 0 or len(ranks) != MESH_RANKS or not os.path.exists(ids_path):
        raise AssertionError(f"eval_mesh_7b: exit {code}, {len(ranks)} rank reports: "
                             f"{text[-3000:]}")
    with open(ids_path) as f:
        got = json.load(f)
    held = {"rows_identical": [True] * len(QUERIES), "divergences": []}
    if got != slice_ids:
        from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
        from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
        from eventgpt_tpu_torch.ops.image import process_event_file

        import numpy as np

        ids = [tokenize_with_event(prepare_event_prompt(q), tokenizer) for q in QUERIES]
        pixels = np.stack([process_event_file(p)[1] for p in event_paths])
        padded, mask, _ = eventchat.prepare_prefill(params, cfg, ids, pixels)
        held = chain_rule("eval_mesh_7b", llama, params, cfg, padded, mask, slice_ids, got,
                          SERVE_KSTEP_WINDOW, False, tokenizer.eos_token_id)
    k1 = [r["launches"]["flash_attention.cu"] for r in ranks]
    heads = [r["heads"] for r in ranks]
    if k1 != [n_layers] * MESH_RANKS or heads != [cfg.llama.num_heads // MESH_RANKS] * MESH_RANKS:
        raise AssertionError(f"eval_mesh_7b: K1 launches {k1} over heads {heads}, want "
                             f"{n_layers} a rank over {cfg.llama.num_heads // MESH_RANKS}")
    return {"argv": ["torch.distributed.run --nproc_per_node 2", *argv[:2], "--mesh_model",
                     str(MESH_RANKS), "--dist_backend", MESH_BACKEND, "--max_new_tokens",
                     str(MAX_NEW_TOKENS)],
            "seconds": secs, "greedy_sha256": digest(got),
            "same_digest_as_slice": got == slice_ids, "vs_slice": held,
            "ranks": [mesh_card_numbers(r) for r in ranks], "nvidia_smi": smi}


class MeshServer(ServerProcess):
    """``cli/serve`` under ``python -m torch.distributed.run`` with
    ``MESH_RANKS`` ranks: rank 0 listens; ``stop()`` sends SIGTERM to rank 0
    alone (it drains, stops the follower and exits), and the launcher then
    exits with the ranks' code."""

    def __init__(self, argv, log_path: str, threads: int = 0):
        self._launcher = torchrun(MESH_RANKS)
        self._threads = threads
        super().__init__(argv, log_path)

    def _command(self, argv) -> list:
        return self._launcher + ["-m", "eventgpt_tpu_torch.cli.serve", *argv, "--port", "0"]

    def _env(self) -> dict:
        env = mesh_env()
        if self._threads:
            env["OMP_NUM_THREADS"] = str(self._threads)
        return env

    def _rank0_pid(self):
        """The launcher's child with ``RANK=0`` in its environment."""
        for tid in os.listdir(f"/proc/{self.proc.pid}/task"):
            with open(f"/proc/{self.proc.pid}/task/{tid}/children") as f:
                for pid in f.read().split():
                    try:
                        with open(f"/proc/{pid}/environ", "rb") as g:
                            if b"\0RANK=0\0" in b"\0" + g.read():
                                return int(pid)
                    except OSError:
                        continue
        return None

    def stop(self) -> int:
        import signal

        if self.proc.poll() is None:
            pid = self._rank0_pid()
            if pid is not None:
                os.kill(pid, signal.SIGTERM)
                try:
                    self.proc.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    pass
        return super().stop()


def serve_mesh_7b(eventchat, llama, params, cfg, tokenizer, requests, oracle_chains,
                  ckpt: str, work: str, n_layers: int, smi: str, ties=None) -> dict:
    """``cli/serve --mesh_model 2`` under the launcher over the 7B checkpoint
    with the JAX defaults and paged int8 KV (``TELEMETRY_FLAGS``): rank 0's
    HTTP front end and engine, rank 1 following. ``telemetry_requests()``'
    six requests (the first four at once, the two late after the first
    harvest), their chains held to ``serve_telemetry_7b``'s oracle by
    ``chain_rule``; the pool clean after the drain; TTFTs; K1 per rank; the
    follower's steps equal to rank 0's; each rank's peak memory and
    collectives. ``ties``: {(row, first divergent step): report} already
    verified on the same oracle, not replayed again."""
    import threading

    reqs = serve_defaults_requests(requests)
    payloads = telemetry_requests()
    argv = ["--model_path", ckpt, "--tokenizer_path", "byte", "--event_root", work,
            *TELEMETRY_FLAGS, "--mesh_model", str(MESH_RANKS), "--dist_backend", MESH_BACKEND]
    log = os.path.join(work, "serve_mesh.log")
    srv = MeshServer(argv, log)
    out = {"argv": ["torch.distributed.run --nproc_per_node 2 -m eventgpt_tpu_torch.cli.serve",
                    *argv[4:]], "boot_s": srv.boot_s}
    try:
        results = [None] * len(payloads)

        def send(i):
            results[i] = srv.request("POST", "/v1/generate", {**payloads[i], "return_ids": True})

        first = [threading.Thread(target=send, args=(i,)) for i in range(len(QUERIES))]
        t0 = time.perf_counter()
        for th in first:
            th.start()
        wait_for(lambda: time.sleep(0.05) or srv.get("/stats")["segments"] >= 1,
                 "serve_mesh_7b: the first harvest")
        late = [threading.Thread(target=send, args=(i,))
                for i in range(len(QUERIES), len(payloads))]
        for th in late:
            th.start()
        for th in first + late:
            th.join(timeout=WAIT_S)
        out["wall_s"] = time.perf_counter() - t0
        bad = [r for r in results if r is None or r[0] != 200 or r[1].get("status") != "ok"]
        if bad:
            raise AssertionError(f"serve_mesh_7b: answers {bad}; {srv.log_tail()}")
        stats = srv.get("/stats")
        pc = srv.get("/prefix_cache")
    finally:
        out["exit_code"] = srv.stop()
    with open(log) as f:
        text = f.read()
    follower = tagged_lines(text, "[mesh-follower] ")
    chains = [r[1]["ids"] for r in results]
    pool = stats["kv_blocks"]
    held_blocks = pc.get("blocks_held", 0)
    clean = (pool["free_blocks"] + pool["used_blocks"] == pool["usable_blocks"]
             and pool["free_blocks"] == pool["usable_blocks"] - held_blocks
             and not pool["spilled_runs"])
    lead = stats["mesh"]
    k1 = [stats["launches"]["flash_attention.cu"]] + [f["launches"]["flash_attention.cu"]
                                                      for f in follower]
    problems = []
    if out["exit_code"] != 0 or len(follower) != MESH_RANKS - 1:
        problems.append(f"exit {out['exit_code']}, {len(follower)} follower reports: "
                        f"{text[-3000:]}")
    if not clean:
        problems.append(f"the pool is not clean after the drain: {pool}, {held_blocks} held")
    if any(f["steps"] != lead["steps"] for f in follower) or len(set(k1)) != 1 \
            or k1[0] % n_layers or not k1[0]:
        problems.append(f"steps {lead['steps']} vs {[f['steps'] for f in follower]}, "
                        f"K1 by rank {k1}")
    # No feature that agrees a decision is armed: no agreement runs.
    agreed = [r.get("agreements", {}).get("count") for r in [lead] + follower]
    if any(agreed):
        problems.append(f"agreements by rank {agreed}, want none")
    if problems:
        raise AssertionError(f"serve_mesh_7b: {problems}")
    seen = dict(ties or {})
    first = {i: next(k for k, (a, b) in enumerate(zip(o + [None], c + [None])) if a != b)
             for i, (o, c) in enumerate(zip(oracle_chains, chains)) if o != c}
    held = hold_to_oracle("serve_mesh_7b", eventchat, llama, params, cfg, tokenizer, reqs,
                          oracle_chains, [oracle_chains[i] if (i, first.get(i)) in seen else c
                                          for i, c in enumerate(chains)],
                          SERVE_DEFAULTS_BUDGETS[0])
    seen.update({(d["row"], d["first_divergent_step"]): d for d in held["divergences"]})
    held = {"rows_identical": [i not in first for i in range(len(chains))],
            "divergences": [seen[i, k] for i, k in sorted(first.items())]}
    ttft = [r[1].get("ttft_s", stats["recent"].get(str(r[1]["rid"]), {}).get("ttft_s"))
            for r in results]
    return {**out, "config": "EventGPT-7B bf16 from checkpoint_7b, --mesh_model 2 over "
                             f"{MESH_BACKEND}, paged int8 KV, 4 rows, max_len 1024, chunk 32, "
                             "the JAX CLI's defaults; telemetry_requests()' six over HTTP",
            "vs_oracle": held, "ttft_s": ttft, "pool_after_drain": {**pool,
                                                                    "prefix_blocks_held":
                                                                        held_blocks},
            "k1_launches_by_rank": k1, "agreements_by_rank": agreed,
            "steps_by_rank": [lead["steps"]]
            + [f["steps"] for f in follower],
            "decode_steps": stats["decode_steps"], "dispatches": stats["dispatches"],
            "ranks": [mesh_card_numbers(lead)] + [mesh_card_numbers(f) for f in follower],
            "nvidia_smi": smi}



# serve_mesh_preempt_7b: serve_preempt_7b's spill arm on a serving mesh of two
# ranks, as a fleet of two replicas (each on process groups of its own), with
# the headroom guard armed where it defers nothing (1 MiB under the card) and
# a deadline far beyond the run. The router places a request on the replica
# with the fewest queued and active rows while fleet.route trips at every
# submit (the key's pin then gives way): posted one at a time, the two
# sessions of the same three requests land on different replicas. A fleet
# admits each HTTP arrival at once (serve_preempt_7b queues its batch pair
# as one wave), and two settings keep the phase's pressure: without lanes
# (serve_preempt_7b once ran a spill arm without them), else the
# second batch request rides a lane behind the first and the interactive
# head waits behind that lane until the first has finished, and without the
# prefix cache, else the later requests alias the first one's entry and the
# reference's rule drops a victim whose run another reader holds instead of
# spilling it (PERF.md measured both).
MESH_PREEMPT_FLAGS = [*PREEMPT_FLAGS, "--kv_pool_blocks", str(PREEMPT_POOL_BLOCKS), "--preempt",
                      "--spill_capacity_mb", "1024", "--prefill_budget", "0",
                      "--no_prefix_cache", "--mem_headroom_mb", "1",
                      "--default_deadline_s", "3600", "--fleet", "2",
                      "--faults", "fleet.route:every=1"]
# The ranks' CPU threads: they drive the card beside the tiny phases' CPU
# worlds, and only rank 0 preprocesses (six requests).
MESH_PREEMPT_THREADS = 2
MESH_PREEMPT_SESSIONS = 2
# The card room the phase takes beside phase 8's training (two ranks of half
# a 7B tree, the vision side, two replicas' pools and a 3-row prefill each).
MESH_PREEMPT_ROOM = 2 * 13e9
# What phase 8 adds to this process's tree at its peak: remat's dots policy
# held 11.29 GB over the tree on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md),
# with margin.
TRAIN_ROOM_OVER_TREE = 20e9


def serve_mesh_preempt_7b_run(ckpt: str, work: str) -> dict:
    """``serve_mesh_preempt_7b``'s server and traffic; holds nothing of this
    process's tree, so that it can run beside other phases. ``cli/serve``
    over ``checkpoint_7b`` under the launcher, ``--mesh_model 2`` over
    gloo, ``MESH_PREEMPT_FLAGS``: ``serve_preempt_7b``'s two batch requests
    and then its interactive one, each posted for each session in turn
    (each post waits for its routing). Returns the answers, /stats, each
    request's timeline on its replica and each rank's and replica's report
    (its ``[mesh-leader]`` or ``[mesh-follower]`` line)."""
    import threading

    budgets = (PREEMPT_BATCH_BUDGET, PREEMPT_BATCH_BUDGET, PREEMPT_INTER_BUDGET)
    classes = ("batch", "batch", "interactive")
    payloads = [{"query": QUERIES[i], "event_path": f"events_{i}.npy", "max_new_tokens": n,
                 "slo_class": c, "return_ids": True}
                for i, (n, c) in enumerate(zip(budgets, classes))]
    argv = ["--model_path", ckpt, "--tokenizer_path", "byte", "--event_root", work,
            *MESH_PREEMPT_FLAGS, "--mesh_model", str(MESH_RANKS), "--dist_backend", MESH_BACKEND]
    log = os.path.join(work, "serve_mesh_preempt.log")
    t0 = time.perf_counter()
    srv = MeshServer(argv, log, threads=MESH_PREEMPT_THREADS)
    out = {"argv": ["torch.distributed.run --nproc_per_node 2 -m eventgpt_tpu_torch.cli.serve",
                    *argv[4:]], "boot_s": srv.boot_s}
    results, frids, threads = {}, {}, []

    def post(session, i):
        """Post one request and wait until the fleet has routed it (its
        fleet rid is then the count before it)."""
        n = srv.get("/stats")["requests"]
        frids[session, i] = n

        def send():
            results[session, i] = srv.request("POST", "/v1/generate", payloads[i])

        th = threading.Thread(target=send)
        th.start()
        threads.append(th)
        wait_for(lambda: time.sleep(0.01) or srv.get("/stats")["requests"] > n
                 or not th.is_alive(), f"serve_mesh_preempt_7b: request {i} routed")

    def legs(frid):
        """The (replica, its journey) assignments of one fleet request."""
        code, rec = srv.request("GET", f"/request?rid={frid}")
        return [(a["replica"], a["journey"] or {}) for a in rec.get("assignments", [])] \
            if code == 200 else []

    try:
        t1 = time.perf_counter()
        # A submit waits for its replica's step to end (the engine lock is
        # held through a step, a whole 32-step segment on the mesh), and the
        # router's lock is held across it: the second batch request of a
        # session lands after its replica's first harvest and is admitted
        # at the next boundary, and the interactive one lands after that
        # boundary, while the pair decodes.
        for i in range(3):
            for session in range(MESH_PREEMPT_SESSIONS):
                post(session, i)
        for th in threads:
            th.join(timeout=WAIT_S)
        out["wall_s"] = time.perf_counter() - t1
        out["stats"] = srv.get("/stats")
        out["replicas"] = {f"{k[0]},{k[1]}": [r for r, _ in legs(f)] for k, f in frids.items()}
        # Each request's timeline on its replica: event kinds and seconds
        # from its submit there.
        out["timelines"] = {
            f"{k[0]},{k[1]}": [(r, ev.get("kind"), ev.get("t_s")) for r, j in legs(f)
                               for ev in j.get("events", [])]
            for k, f in frids.items()}
    finally:
        out["exit_code"] = srv.stop()
        out["phase_s"] = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    out["results"] = {f"{k[0]},{k[1]}": v for k, v in results.items()}
    out["leaders"] = tagged_lines(text, "[mesh-leader] ")
    out["followers"] = tagged_lines(text, "[mesh-follower] ")
    out["log_tail"] = text[-3000:]
    return out


def hold_serve_mesh_preempt_7b(run: dict, eventchat, llama, params, cfg, tokenizer, ids, pixels,
                               want, n_layers: int, smi: str) -> dict:
    """``serve_mesh_preempt_7b``'s bars: every answer ok, each session's
    three chains held to ``serve_preempt_7b``'s oracle by ``chain_rule``;
    on each replica spills >= 1 and restores equal to spills on both ranks,
    the follower's steps equal to rank 0's, the pool clean after the drain
    with no spilled run and no record; K1 on each rank and replica a
    nonzero multiple of n_layers. Also each rank's peak memory, the
    collectives and the agreed decisions a decode step, and the guard's
    deferrals."""
    problems = []
    res = run.get("results", {})
    keys = [(s, i) for s in range(MESH_PREEMPT_SESSIONS) for i in range(3)]
    bad = {k: res.get(f"{k[0]},{k[1]}") for k in keys
           if res.get(f"{k[0]},{k[1]}") is None or res[f"{k[0]},{k[1]}"][0] != 200
           or res[f"{k[0]},{k[1]}"][1].get("status") != "ok"}
    if run["exit_code"] != 0 or bad:
        raise AssertionError(f"serve_mesh_preempt_7b: exit {run['exit_code']}, answers {bad}: "
                             f"{run['log_tail']}")
    reqs = [(ids[i], pixels[i], n) for i, n in
            enumerate((PREEMPT_BATCH_BUDGET, PREEMPT_BATCH_BUDGET, PREEMPT_INTER_BUDGET))]
    held, seen = [], {}
    for s in range(MESH_PREEMPT_SESSIONS):
        chains = [res[f"{s},{i}"][1]["ids"] for i in range(3)]
        key = json.dumps(chains)
        if key not in seen:  # a session with another's chains replays nothing again
            seen[key] = hold_to_oracle(f"serve_mesh_preempt_7b session {s}", eventchat, llama,
                                       params, cfg, tokenizer, reqs, want, chains,
                                       PREEMPT_BATCH_BUDGET)
        held.append(seen[key])
    lead = sorted(run["leaders"], key=lambda r: r["replica"])
    follow = sorted(run["followers"], key=lambda r: r["replica"])
    if len(lead) != 2 or len(follow) != 2 * (MESH_RANKS - 1):
        raise AssertionError(f"serve_mesh_preempt_7b: {len(lead)} leader and {len(follow)} "
                             f"follower reports: {run['log_tail']}")
    per_replica = []
    for rl, rf in zip(lead, follow):
        pl, pf = rl["pool"], rf["pool"]
        counts = [(p["preemptions"], p["spills"], p["restores"]) for p in (pl, pf)]
        held_blocks = run["stats"]["fleet"]["per_replica"][rl["replica"]].get(
            "prefix_cache_blocks_held", 0)
        clean = all(p["free_blocks"] + p["used_blocks"] == p["usable_blocks"]
                    and p["spilled_runs"] == 0 for p in (pl, pf)) and all(
            r["spill"]["records"] == 0 for r in (rl, rf))
        k1 = [rl["flash_launches_replica"], rf["flash_launches_replica"]]
        entry = {"replica": rl["replica"], "steps_by_rank": [rl["steps"], rf["steps"]],
                 "preemptions_spills_restores_by_rank": counts, "k1_by_rank": k1,
                 "deferrals_by_rank": [p["deferrals"] for p in (pl, pf)],
                 "mem_guard_deferrals_by_rank": [rl["mem_deferrals"], rf["mem_deferrals"]],
                 "decode_steps_run": rl["decode_steps_run"], "clean": clean,
                 "prefix_blocks_held": held_blocks,
                 "free_blocks_by_rank": [pl["free_blocks"], pf["free_blocks"]]}
        per_replica.append(entry)
        if rl["steps"] != rf["steps"] or counts[0] != counts[1] or counts[0][1] < 1 \
                or counts[0][2] != counts[0][1] or not clean \
                or any(k % n_layers or not k for k in k1):
            problems.append(entry)
    if problems:
        emit("serve_mesh_preempt_7b", {"problems": problems, "per_replica": per_replica,
                                       "timelines": run.get("timelines"),
                                       "replicas": run.get("replicas"), "wall_s": run["wall_s"],
                                       "boot_s": run["boot_s"], "nvidia_smi": smi})
        raise AssertionError(f"serve_mesh_preempt_7b: {problems}")
    ranks = []
    for rank_reports in ([lead[0]], [follow[0]]):
        r = rank_reports[0]
        steps = sum(x["decode_steps_run"] for x in (lead if r in lead else follow))
        ranks.append({"rank": r["rank"], "peak_mem_bytes": r["peak_mem_bytes"],
                      "backend": r["backend"], "collectives": r["collectives"],
                      "agreements": r["agreements"], "decode_steps_run_both_replicas": steps,
                      "collectives_per_decode_step": r["collectives"]["count"] / max(steps, 1),
                      "agreements_per_decode_step": r["agreements"]["count"] / max(steps, 1),
                      "launches": r["launches"]})
    return {"argv": run["argv"], "config": "EventGPT-7B bf16 from checkpoint_7b, --mesh_model "
                                           f"2 over {MESH_BACKEND}, --fleet 2, each replica "
                                           "serve_preempt_7b's spill arm without lanes or the "
                                           "prefix cache (3 rows, 40 blocks, paged int8 KV, "
                                           "chunk 32), "
                                           "the guard at 1 MiB of headroom, deadlines 3600 s; "
                                           "streams 100, 101 batch (128 tokens), 102 "
                                           "interactive (16), each posted for two sessions in "
                                           "turn",
            "boot_s": run["boot_s"], "wall_s": run["wall_s"], "phase_s": run["phase_s"],
            "vs_oracle": held, "per_replica": per_replica, "ranks": ranks,
            "ttft_s": {k: v[1].get("ttft_s") for k, v in res.items()},
            "latency_s": {k: v[1].get("latency_s") for k, v in res.items()},
            "route_faults": run["stats"]["fleet"].get("route_faults"),
            "nvidia_smi": smi}


def start_mesh_preempt(ckpt: str, work: str) -> dict:
    """Start ``serve_mesh_preempt_7b_run`` on a thread of its own. ``overlap``
    says whether the card has MESH_PREEMPT_ROOM for its ranks beside what
    phase 8 adds to this process's tree (TRAIN_ROOM_OVER_TREE)."""
    import gc
    import threading

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    box = {"free_bytes": free, "total_bytes": total,
           "overlap": free >= MESH_PREEMPT_ROOM + TRAIN_ROOM_OVER_TREE}

    def run():
        try:
            box["run"] = serve_mesh_preempt_7b_run(ckpt, work)
        except BaseException as e:  # noqa: BLE001 (raised on the main thread)
            box["error"] = e

    box["thread"] = threading.Thread(target=run)
    box["thread"].start()
    return box


def finish_mesh_preempt(box: dict, eventchat, llama, params, cfg, tokenizer, ids, pixels, want,
                        n_layers: int, smi: str) -> dict:
    """Wait for ``start_mesh_preempt``'s thread, hold its run to its bars and
    emit ``serve_mesh_preempt_7b``; returns its K1 launches by replica and
    rank."""
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    out = hold_serve_mesh_preempt_7b(box["run"], eventchat, llama, params, cfg, tokenizer, ids,
                                     pixels, want, n_layers, smi)
    out["beside"] = ("train_*_7b, medusa_train_7b and the tiny phases" if box["overlap"]
                     else "nothing (the card lacked the room)")
    out["card_free_bytes_at_start"] = box["free_bytes"]
    emit("serve_mesh_preempt_7b", out)
    return {f"serve_mesh_preempt_7b_replica{e['replica']}_rank{r}": k
            for e in out["per_replica"] for r, k in enumerate(e["k1_by_rank"])}


# The training mesh. tiny_train_mesh_card_vs_cpu: a world of 2 on
# the card (gloo, bf16, K1 on each rank's heads) against the same world on
# the CPU (gloo, bf16, the plain versions), two steps of each case from one
# seeded state and batch. The card's bf16 products (tensor cores, f32
# accumulation) and the CPU's round differently, about one bf16 step
# (2^-8) of an activation: the loss moves by ~1e-3 of itself, the gradient
# norm by ~1e-2. Each leaf's update (its move over the two steps) is held
# in L2, and reads its gradient: AdamW runs with eps 1, far above every
# element's gradient (at most the clip, 1), so that a step is lr * m/(|m| +
# 1), monotone and near linear in the gradient; at the default eps a first
# step is lr * sign(g), and an element whose gradient nearly cancels flips
# on rounding (each leaf then read up to 0.14 apart, 0.235 with the MLP's
# LoRA b at zero, on an H100). Weight decay is off, so that the update is
# the gradient's alone. Every LoRA b starts at 0.02, not at its zero
# init, so that each LoRA a has a gradient from the first step and is held
# on it (with b at zero, a's first gradient is exactly zero on both sides).
# The bars' control: MESH_TRAIN_PLANTED runs on the card alone with the
# first leaf's reduced gradient scaled by MESH_TRAIN_PLANTED_SCALE, and is
# held to the CPU's run of the case it plants into: it must fail.
MESH_TRAIN_LOSS_RTOL = 3e-3
MESH_TRAIN_NORM_RTOL = 1e-2
MESH_TRAIN_UPDATE_RTOL = 5e-2
MESH_TRAIN_ADAM_EPS = 1.0
MESH_TRAIN_SEQ = 128
MESH_TRAIN_LLAMA = {"vocab_size": 260, "hidden_size": 512, "intermediate_size": 1024,
                    "num_layers": 2, "num_heads": 4, "num_kv_heads": 4, "max_seq_len": 2048}
# (name, (data, fsdp, context, model), attn_impl, stage)
MESH_TRAIN_CASES = (("fsdp2_stage1", (1, 2, 1, 1), "flash", 1),
                    ("fsdp2_stage2", (1, 2, 1, 1), "flash", 2),
                    ("model2_stage2", (1, 1, 1, 2), "flash", 2),
                    ("ring2_stage2", (1, 1, 2, 1), "ring", 2),
                    ("ulysses2_stage2", (1, 1, 2, 1), "ulysses", 2))
# (name, mesh, attn_impl, stage, the case whose CPU run it is held to)
MESH_TRAIN_PLANTED = ("fsdp2_stage2_planted", (1, 2, 1, 1), "flash", 2, "fsdp2_stage2")
MESH_TRAIN_PLANTED_SCALE = 0.8
# train_mesh_7b against train_stage2_7b's one-device run on the same data,
# seed and flags: step 1 is the same bf16 forward over two sequence chunks
# (its loss summed in another order), and every later number carries the
# reordered sums of the gradient (and K1's backward) through AdamW.
MESH_7B_LOSS_RTOL = 1e-3
MESH_7B_NORM_RTOL = 2e-2
# The card's room that serve_fleet_chaos_7b and serve_breaker_7b take
# beside train_mesh_7b's two ranks (two replicas' paged int8 pools and a
# 4-row 7B prefill's transients, a few GB), with margin.
MESH_OVERLAP_ROOM = 8e9

MESH_TRAIN_RANK = r"""
# One rank of chip_smoke.py's tiny_train_mesh_card_vs_cpu: DEVICE BACKEND OUT JOB.
import dataclasses, json, os, sys

import numpy as np
import torch
import torch.distributed as dist

from eventgpt_tpu_torch.config import EventChatConfig, LlamaConfig, MeshConfig
from eventgpt_tpu_torch.models.convert import init_eventchat_params
from eventgpt_tpu_torch.ops import flash_attention as fa
from eventgpt_tpu_torch.parallel import sharding
from eventgpt_tpu_torch.parallel.dist import initialize_distributed
from eventgpt_tpu_torch.parallel.mesh import COLLECTIVES, make_mesh
from eventgpt_tpu_torch.train import steps as steps_mod
from eventgpt_tpu_torch.train.data import synthetic_multimodal_batch
from eventgpt_tpu_torch.train.lora import LoraConfig
from eventgpt_tpu_torch.train.optim import linear_warmup_cosine, make_optimizer, tree_leaves
from eventgpt_tpu_torch.train.trainer import tree_map

device, backend, out, job_path = sys.argv[1:5]
job = json.load(open(job_path))
initialize_distributed(backend=backend, timeout_s=300)
rank = dist.get_rank()
base = EventChatConfig.tiny()
llama = LlamaConfig(**job["llama"])
cfg = dataclasses.replace(base, llama=llama, projector=dataclasses.replace(
    base.projector, output_dim=llama.hidden_size))
params = init_eventchat_params(cfg, torch.Generator().manual_seed(11), torch.bfloat16, "cpu")
seq = job["seq"]
rng = np.random.default_rng(12)
size = cfg.vision.image_size
pix = rng.standard_normal((2, cfg.num_event_frames, 3, size, size)).astype(np.float32)
batch = synthetic_multimodal_batch(cfg, 2, seq, event_offset=5, pixel_values=pix,
                                   mask_event_labels=True)
batch["token_ids"] = rng.integers(3, llama.vocab_size, (2, seq)).astype(np.int32)
batch["labels"] = np.where(batch["event_pos"], -100, batch["token_ids"]).astype(np.int32)
batch["attn_mask"][1, seq - 9:] = False
batch["labels"][1, seq - 9:] = -100
lcfg = LoraConfig(r=4, alpha=8.0)
res = {"rank": rank, "backend": dist.get_backend()}
reduce = steps_mod.GradLayout.reduce


def planted_reduce(self, grads):
    # The control's fault: the first leaf's summed gradient scaled.
    out = reduce(self, grads)
    out[0] = out[0] * job["planted_scale"]
    return out


# The planted control runs on the card alone.
cases = [c[:4] for c in job["cases"] + ([job["planted"]] if device == "cuda" else [])]
for name, shape, attn, stage in cases:
    steps_mod.GradLayout.reduce = planted_reduce if name == job["planted"][0] else reduce
    mesh = make_mesh(MeshConfig(data=shape[0], fsdp=shape[1], context=shape[2],
                                model=shape[3]), device)
    c = dataclasses.replace(cfg, llama=dataclasses.replace(llama, attn_impl=attn))
    if stage == 1:
        tr, fz = steps_mod.split_stage1(params)
        combine = steps_mod.stage1_combine
    else:
        tr, fz = steps_mod.split_stage2(params, c, lcfg, torch.Generator().manual_seed(13))
        for group in ("attn", "mlp"):
            for ab in tr["lora"][group].values():
                ab["b"] = ab["b"] + 0.02
        combine = steps_mod.make_stage2_combine(lcfg, mesh=mesh)
    specs = sharding.trainable_param_specs(tr)
    start = {".".join(map(str, p)): t.float().numpy() for p, t in tree_leaves(tr)}
    trs = sharding.shard_trainable(tr, specs, mesh)
    fzs = sharding.shard_frozen(fz, c, mesh, torch.bfloat16)

    def cast(t, f, step=None, _c=combine):
        return _c(tree_map(lambda x: x.to(torch.bfloat16), t), f, step)

    opt = make_optimizer(linear_warmup_cosine(1e-2, 4), weight_decay=0.0, eps=job["adam_eps"],
                         projector_lr=5e-3 if stage == 2 else None)
    state = steps_mod.init_train_state(trs, fzs, opt)
    step = steps_mod.make_train_step(c, opt, cast, mesh=mesh)
    fa.FLASH_KERNEL.launches = 0
    for key in fa.LAUNCHES_BY_PATH:
        fa.LAUNCHES_BY_PATH[key] = 0
    COLLECTIVES.update(count=0, bytes=0, seconds=0.0)
    losses, norms = [], []
    for _ in range(2):
        state, m = step(state, steps_mod.batch_to_device(batch, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = sharding.gather_trainable(state.trainable, specs, mesh)
    if rank == 0:
        np.savez(os.path.join(out, name + ".npz"),
                 **{"end." + ".".join(map(str, p)): t.float().cpu().numpy()
                    for p, t in tree_leaves(whole)},
                 **{"start." + k: v for k, v in start.items()})
    res[name] = {"losses": losses, "grad_norms": norms, "k1": fa.FLASH_KERNEL.launches,
                 "k1_by_path": dict(fa.LAUNCHES_BY_PATH), "collectives": dict(COLLECTIVES),
                 "first_leaf": ".".join(map(str, tree_leaves(tr)[0][0]))}
with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def tiny_train_mesh_card_vs_cpu(work: str) -> dict:
    """Two ranks on the card against two on the CPU (both over gloo, bf16
    frozen weights, f32 trainables), two training steps of each of
    ``MESH_TRAIN_CASES`` from one seeded state: the losses and gradient
    norms within MESH_TRAIN_{LOSS,NORM}_RTOL, each trainable's update
    within MESH_TRAIN_UPDATE_RTOL in L2, the ranks of a world equal, and
    K1 launched on the card's ranks under flash and Ulysses (4 a step: 2
    layers forward and recompute) with 2 backward calls a step. The
    planted control (MESH_TRAIN_PLANTED, on the card alone) must fail the
    bars against its case's CPU run."""
    import numpy as np

    root = os.path.join(work, "tiny_train_mesh")
    os.makedirs(root, exist_ok=True)
    job = {"llama": MESH_TRAIN_LLAMA, "seq": MESH_TRAIN_SEQ, "cases": MESH_TRAIN_CASES,
           "planted": MESH_TRAIN_PLANTED, "planted_scale": MESH_TRAIN_PLANTED_SCALE,
           "adam_eps": MESH_TRAIN_ADAM_EPS}
    job_path = os.path.join(root, "job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    script = os.path.join(root, "rank.py")
    with open(script, "w") as f:
        f.write(MESH_TRAIN_RANK)
    started = {}
    for name, argv in (("card", [script, "cuda", MESH_BACKEND]), ("cpu", [script, "cpu", "gloo"])):
        out = os.path.join(root, name)
        os.makedirs(out, exist_ok=True)
        started[name] = start_world(argv + [out, job_path], MESH_RANKS,
                                    os.path.join(out, "log.txt"))
    runs, problems = {}, []
    for name, world in started.items():
        code, secs, text = finish_world(world, 300)
        out = os.path.join(root, name)
        ranks = []
        for r in range(MESH_RANKS):
            path = os.path.join(out, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
        runs[name] = {"exit_code": code, "seconds": secs, "ranks": ranks}
        if code != 0 or len(ranks) != MESH_RANKS:
            problems.append(f"{name}: exit {code}, {text[-2000:]}")
    result = {"config": "tiny bf16 (LLaMA d=512, 2 layers, 4 heads of 128, I=1024, vocab 260), "
                        f"T={MESH_TRAIN_SEQ}, batch 2, LoRA r 4, two steps a case",
              "seconds": {n: r["seconds"] for n, r in runs.items()},
              "bars": {"loss_rtol": MESH_TRAIN_LOSS_RTOL, "grad_norm_rtol": MESH_TRAIN_NORM_RTOL,
                       "update_rtol_l2": MESH_TRAIN_UPDATE_RTOL}}
    if not problems:
        card, cpu = runs["card"]["ranks"], runs["cpu"]["ranks"]

        def held(name, ref):
            """The card's run of ``name`` against the CPU's of ``ref``:
            (numbers, the bars it fails)."""
            a, b = card[0][name], cpu[0][ref]
            loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
            norm_rel = max(abs(x - y) / abs(y) for x, y in zip(a["grad_norms"], b["grad_norms"]))
            za = np.load(os.path.join(root, "card", name + ".npz"))
            zb = np.load(os.path.join(root, "cpu", ref + ".npz"))
            upd = {}
            for key in za.files:
                if not key.startswith("end."):
                    continue
                leaf = key[4:]
                ua = za[key] - za["start." + leaf]
                ub = zb[key] - zb["start." + leaf]
                upd[leaf] = float(np.linalg.norm(ua - ub) / max(np.linalg.norm(ub), 1e-30))
            numbers = {"losses_card": a["losses"], "losses_cpu": b["losses"],
                       "grad_norms_card": a["grad_norms"], "grad_norms_cpu": b["grad_norms"],
                       "loss_rel_diff": loss_rel, "grad_norm_rel_diff": norm_rel,
                       "update_rel_l2_max": max(upd.values()),
                       "update_rel_l2_worst_leaf": max(upd, key=upd.get),
                       "update_rel_l2_first_leaf": upd[a["first_leaf"]],
                       "first_leaf": a["first_leaf"],
                       "k1_launches_by_rank": [r[name]["k1"] for r in card],
                       "k1_backward_by_rank": [r[name]["k1_by_path"]["backward"] for r in card],
                       "collectives_rank0": a["collectives"],
                       "ranks_agree": all(r[name]["losses"] == a["losses"] for r in card)}
            failed = [bar for bar, bad in (("loss", loss_rel > MESH_TRAIN_LOSS_RTOL),
                                           ("grad_norm", norm_rel > MESH_TRAIN_NORM_RTOL),
                                           ("update", max(upd.values()) > MESH_TRAIN_UPDATE_RTOL))
                      if bad]
            return numbers, failed

        for name, shape, attn, stage in MESH_TRAIN_CASES:
            numbers, failed = held(name, name)
            want_k1 = 0 if attn == "ring" else 8
            result[name] = {"mesh": shape, "attn": attn, "stage": stage, **numbers}
            if (failed or not numbers["ranks_agree"]
                    or numbers["k1_launches_by_rank"] != [want_k1] * MESH_RANKS
                    or numbers["k1_backward_by_rank"] != [want_k1 // 2] * MESH_RANKS):
                problems.append(f"{name}: bars failed {failed}, {result[name]}")
        name, shape, attn, stage, ref = MESH_TRAIN_PLANTED
        numbers, failed = held(name, ref)
        result[name] = {"mesh": shape, "attn": attn, "stage": stage, "held_to_cpu_run_of": ref,
                        "planted": f"the first leaf's gradient x {MESH_TRAIN_PLANTED_SCALE}",
                        "bars_failed": failed, **numbers}
        if "update" not in failed:
            problems.append(f"{name}: the planted fault passed the update bar: {result[name]}")
    shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError(f"tiny_train_mesh_card_vs_cpu: {problems}")
    return result


def multiproc_dryrun_card(work: str) -> dict:
    """``python -m eventgpt_tpu_torch.parallel.multiproc`` at its defaults:
    two worker processes on the card (one rank each, gloo, the ``EGPT_*``
    contract, fsdp 2) and the single-process reference beside them; the
    launcher holds the losses to the reference's (1e-5 relative), the
    checkpoint written by rank 0 alone and restored bit for bit on every
    rank, and rank 1's preemption agreed by both. Its summary, read from
    its last line."""
    log_path = os.path.join(work, "multiproc.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "eventgpt_tpu_torch.parallel.multiproc"],
                                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=mesh_env())
        try:
            code = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    found = tagged_lines(text, "MPRESULT1")
    if code != 0 or not found:
        raise AssertionError(f"multiproc_dryrun_card: exit {code}: {text[-3000:]}")
    summary = found[-1]
    ranks = sorted(summary["ranks"], key=lambda r: r["rank"])
    devices = summary["devices"] + [summary["device_single_process"]]
    if (not all(d.startswith("cuda") for d in devices)
            or [r["ckpt_written_by_me"] for r in ranks] != [True, False]
            or [r["preempt"]["local_flag"] for r in ranks] != [False, True]):
        raise AssertionError(f"multiproc_dryrun_card: {summary}")
    return {"argv": "python -m eventgpt_tpu_torch.parallel.multiproc", "seconds": secs,
            "devices": summary["devices"], "device_single_process": summary["device_single_process"],
            "mesh": summary["mesh"], "losses_multiproc": summary["losses_multiproc"],
            "losses_single_process": summary["losses_single_process"], "rtol": summary["rtol"],
            "checkpoints": summary["checkpoints"],
            "preempt": [r["preempt"] for r in ranks]}


def train_mesh_argv(ckpt: str, paths: dict, out: str) -> list:
    """``cli.train`` with ``train_stage2_7b``'s flags (``_train_args(2, ...)``)
    on two ranks of a context axis, Ulysses, gloo; the trainer saves
    ``ckpt_last`` at the last step."""
    return ["-m", "eventgpt_tpu_torch.cli.train", "--model_path", ckpt, "--tokenizer_path",
            "byte", "--data_path", paths["data_path"], "--event_folder", paths["event_folder"],
            "--stage", "2", "--lora_r", "64", "--lora_alpha", "16", "--learning_rate", "2e-4",
            "--mm_projector_lr", "2e-5", "--max_steps", str(TRAIN_STEPS),
            "--per_device_train_batch_size", str(TRAIN_BATCH), "--bf16", "true",
            "--logging_steps", "1", "--save_steps", "-1", "--eval_steps", "-1",
            "--mesh_context", str(MESH_RANKS), "--attn_impl", "ulysses",
            "--dist_backend", MESH_BACKEND, "--output_dir", out]


def start_train_mesh_7b(params, ckpt: str, paths: dict, work: str) -> dict:
    """Start ``train_mesh_7b``'s world: ``python -m torch.distributed.run
    --nproc_per_node 2 -m eventgpt_tpu_torch.cli.train`` over
    ``checkpoint_7b`` (stage 2, batch 2, ``TRAIN_STEPS`` steps,
    ``--mesh_context 2 --attn_impl ulysses``, gloo), each rank holding the
    whole bf16 LLaMA, CLIP and the LoRA and its half of each sequence. The
    script's tree moves to the host first when the card lacks room for two
    ranks; ``overlap`` says whether it also has room for this process's own
    phases beside them (MESH_OVERLAP_ROOM). ``finish_train_mesh_7b`` waits."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    room = {"free_bytes": free, "total_bytes": total, "held_bytes": torch.cuda.memory_allocated()}
    moved = free < MESH_RANKS * 26e9
    if moved:
        room.update(card_room(params))
    out = os.path.join(work, "train_mesh")
    return {"world": start_world(train_mesh_argv(ckpt, paths, out), MESH_RANKS,
                                 os.path.join(work, "train_mesh.log")),
            "out": out, "room": room, "moved": moved,
            "overlap": not moved and free >= MESH_RANKS * 26e9 + MESH_OVERLAP_ROOM}


def finish_train_mesh_7b(started: dict, params, n_layers: int, n_heads: int, smi: str) -> dict:
    """Wait for ``start_train_mesh_7b``'s world and read it. Per rank: K1's
    launches by path (a micro-step 32 forward and 32 recomputed, each over
    16 of the 32 heads and the whole gathered sequence, and 32 backward
    calls), the collectives a micro-step, peak memory, step seconds cold
    and warm, losses and gradient norms. Rank 0 alone wrote
    ``metrics.jsonl`` and the checkpoints. The comparison with
    ``train_stage2_7b`` is ``train_mesh_vs_one_device``."""
    out, room, moved = started["out"], started["room"], started["moved"]
    try:
        code, secs, text = finish_world(started["world"], 900)
    finally:
        if moved:
            tree_to_(params, "cuda")
    ranks = sorted(tagged_lines(text, "[mesh-rank] "), key=lambda r: r["rank"])
    if code != 0 or len(ranks) != MESH_RANKS:
        raise AssertionError(f"train_mesh_7b: exit {code}, {len(ranks)} rank reports: "
                             f"{text[-4000:]}")
    records = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    steps = [r for r in records if "loss" in r and "event" not in r]
    files = sorted(os.listdir(out))
    want_files = {"ckpt_last", "lora_last.npz", "projector_last.npz", "metrics.jsonl"}
    problems = []
    if [r["step"] for r in steps] != list(range(1, TRAIN_STEPS + 1)):
        problems.append(f"metrics.jsonl holds steps {[r['step'] for r in steps]}")
    if not want_files <= set(files) or any(".tmp-" in f for f in files):
        problems.append(f"output files {files}")
    micro = TRAIN_STEPS
    for r in ranks:
        by = r["k1_by_path"]
        if (by["train_forward"] != n_layers * micro or by["recompute"] != n_layers * micro
                or by["backward"] != n_layers * micro or by["inference"] != 0
                or r["k1_launches"] != 2 * n_layers * micro):
            problems.append(f"rank {r['rank']}: K1 {r['k1_launches']} by path {by}")
        if r["losses"] != [s["loss"] for s in steps]:
            problems.append(f"rank {r['rank']}: losses {r['losses']} vs rank 0's file")
    k1_heads = n_heads // MESH_RANKS
    shutil.rmtree(out, ignore_errors=True)
    if problems:
        raise AssertionError(f"train_mesh_7b: {problems}")
    per_rank = []
    for r in ranks:
        step_ms = [s * 1e3 for s in r["step_s"]]
        per_rank.append({
            "rank": r["rank"], "backend": r["backend"], "device": r["device"],
            "k1_heads": k1_heads, "k1_launches": r["k1_launches"], "k1_by_path": r["k1_by_path"],
            "k1_launches_per_micro_step": r["k1_launches"] / micro,
            "k1_backward_per_micro_step": r["k1_by_path"]["backward"] / micro,
            "collectives_per_micro_step": r["collectives_per_micro_step"],
            "peak_mem_bytes": r["peak_mem_bytes"], "step_ms": step_ms,
            "cold_step_ms": step_ms[0], "warm_step_ms": sum(step_ms[1:]) / max(len(step_ms) - 1, 1),
            "losses": r["losses"], "grad_norms": r["grad_norms"]})
    return {"argv": ["torch.distributed.run --nproc_per_node 2", "-m eventgpt_tpu_torch.cli.train",
                     "--stage 2 --max_steps", TRAIN_STEPS, "--mesh_context 2 --attn_impl ulysses",
                     "--dist_backend", MESH_BACKEND],
            "seconds": secs, "card_room": room, "tree_moved_to_host": moved,
            "beside": started.get("beside", []),
            "files": files, "rank0_wrote_alone": True,
            "losses": [s["loss"] for s in steps], "grad_norms": [s["grad_norm"] for s in steps],
            "ranks": per_rank, "nvidia_smi": smi}


def train_mesh_vs_one_device(mesh: dict, one: dict) -> dict:
    """``train_mesh_7b`` against ``train_stage2_7b`` on the same batches:
    step 1's loss within MESH_7B_LOSS_RTOL, every gradient norm within
    MESH_7B_NORM_RTOL."""
    ref = one["per_step"][:TRAIN_STEPS]
    loss1 = abs(mesh["losses"][0] - ref[0]["loss"]) / abs(ref[0]["loss"])
    norms = [abs(a - r["grad_norm"]) / abs(r["grad_norm"])
             for a, r in zip(mesh["grad_norms"], ref)]
    out = {"losses_one_device": [r["loss"] for r in ref],
           "grad_norms_one_device": [r["grad_norm"] for r in ref],
           "step1_loss_rel_diff": loss1, "grad_norm_rel_diffs": norms,
           "loss_rel_diffs": [abs(a - r["loss"]) / abs(r["loss"])
                              for a, r in zip(mesh["losses"], ref)],
           "bars": {"step1_loss_rtol": MESH_7B_LOSS_RTOL, "grad_norm_rtol": MESH_7B_NORM_RTOL}}
    if loss1 > MESH_7B_LOSS_RTOL or max(norms) > MESH_7B_NORM_RTOL:
        raise AssertionError(f"train_mesh_7b against train_stage2_7b: {out}")
    return out


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
            k.launches_by_thread.clear()
        LAUNCHES_BY_SHAPE.clear()
        LAUNCHES_BY_M.clear()
        out = run()
        return out, {k.source: k.launches for k in kernels}

    # 1. build: the kernels (one nvcc a source) and, beside them, the native
    # host toolchain (two host compilers), all started together.
    shutil.rmtree(os.path.join(ROOT, "eventgpt_tpu_torch", "csrc", "build"), ignore_errors=True)
    import threading

    from eventgpt_tpu_torch import native

    t0 = time.perf_counter()
    native_build = {}

    def build_native():
        try:
            native.build()
            native_build["s"] = time.perf_counter() - t0
        except Exception as e:  # raised in the main thread below
            native_build["error"] = e

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    built = kernels + [x for x in (baseline, flash_base) if x is not None]
    build_all(built)
    native_thread.join()
    if "error" in native_build:
        raise native_build["error"]
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
    mesh_preempt = None
    try:
        tokenizer, ids, pixels, lengths, host = prepare_requests(cfg, work)
        t0 = time.perf_counter()
        params = init_eventchat_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                       torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        emit("host", {**host, "init_weights_s": time.perf_counter() - t0})
        event_paths = [os.path.join(work, f"events_{i}.npy") for i in range(len(QUERIES))]
        emit("native_raster", native_raster(event_paths, native_build["s"], smi))

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
        # K4 at the speculative server's M, per 7B forward (225 launches).
        spec_forward = {}
        for m in SPEC_K4_M:
            for i, (_, k, n) in enumerate(INT4_DECODE_SHAPES):
                int4_checks[m, k, n] = check_int4_kernel(m, k, n, seed=60 + m + i)
                emit(f"kernel_int4_M{m}_K{k}_N{n}", int4_checks[m, k, n])
            spec_forward[m] = {key: sum(c * int4_checks[m, k, n][key]
                                        for (_, k, n), c in INT4_LAUNCHES_PER_STEP.items())
                               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        emit("kernel_int4_spec_forward", {"launches_per_forward": 225, "by_m": spec_forward,
                                          "nvidia_smi": smi})

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
        # ``_`` is the last prefill's cache (1.8 GB): names left bound
        # after a phase hold the card until the run ends.
        del logits, cache, _
        torch.cuda.empty_cache()
        # Streamed event QA: the native reader's 50 ms windows through the
        # port's stream script.
        emit("stream_7b", stream_7b(params, cfg, tokenizer, event_paths, work, counted,
                                    n_layers, smi))

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

        # The served path at the JAX CLI's defaults, against the
        # synchronous, cache-off, lane-off oracle of the same call; then
        # the speculative server, held to the same oracles.
        serve_defaults_k1, oracles = {}, {}
        for layout in ("paged", "dense"):
            serve_defaults_k1[layout], oracles[layout] = serve_defaults(
                eventchat, llama, params, cfg, tokenizer, requests, layout, counted, n_layers,
                smi)
        serve_spec_launches = serve_spec(eventchat, llama, params, cfg, tokenizer, requests,
                                         oracles, counted, n_layers, smi, work)
        # serve_telemetry_7b's oracle over HTTP, and the ties verified on it.
        defaults_oracle, defaults_ties = oracles["paged"][1], oracles["paged"][0]["verified_ties"]
        del oracles
        torch.cuda.empty_cache()
        # Block-tier preemption with the host spill store, and the
        # prefill-to-decode handoff between two batchers of this process.
        preempt_k1, preempt_flash, preempt_want = serve_preempt_7b(
            eventchat, llama, params, cfg, tokenizer, ids, pixels, counted, n_layers, smi)
        flash_checks += tuple(preempt_flash)
        handoff_k1, handoff_plain = serve_handoff_7b(eventchat, llama, params, cfg, tokenizer,
                                                     ids, pixels, counted, n_layers, smi)
        torch.cuda.empty_cache()
        # Fleets: two replicas over the tree, routed by prefix affinity; the
        # handoff over the wire.
        fleet_k1, fleet_ref = serve_fleet_7b(eventchat, llama, params, cfg, tokenizer, requests,
                                             counted, n_layers, smi)

        def fault_phases_7b():
            # A replica killed mid-decode; the breaker (run beside
            # train_mesh_7b's ranks).
            return (serve_fleet_chaos_7b(eventchat, llama, params, cfg, tokenizer, ids, pixels,
                                         counted, n_layers, smi),
                    serve_breaker_7b(eventchat, llama, params, cfg, tokenizer, ids, pixels, work,
                                     counted, n_layers, smi))

        wire_k1 = handoff_wire_7b(params, cfg, tokenizer, *handoff_plain, counted, smi)
        del handoff_plain
        torch.cuda.empty_cache()
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
        serve_spec_int4_launches, serve_spec_by_m4 = serve_spec_int4(
            eventchat, llama, params_int4, cfg, tokenizer, requests, counted, n_layers, smi)

        # int4 vs the bf16 prefill of the dequantized weights.
        llama_deq = quant.dequantize_llama_params(llama_int4, torch.bfloat16)
        first = {}
        for name, lp in (("int4", llama_int4), ("dequant_bf16", llama_deq)):
            cache = llama.init_kv_cache(cfg.llama, b, t, dtype=padded.dtype, device=padded.device)
            with torch.inference_mode():
                first[name], _ = llama.prefill(lp, cfg.llama, padded, mask, cache, last_only=True)
        del llama_deq, lp, cache, _
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
        del caches, cache, emb, params_int4, llama_int4, padded, mask
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
        # loaded over it; the directory goes when the phases end. The toy
        # QA set first: the training mesh reads it from this checkpoint.
        train_paths = write_train_set(work)
        ckpt = os.path.join(work, "checkpoint_7b")
        try:
            emit("checkpoint_7b", {**checkpoint_7b(
                params, cfg, ckpt, ids, pixels, event_paths, counted,
                {"slice": digest(out_ids), "slice_int4": digest(ids4)}, out_ids, smi),
                "cli_subprocess_tiny": cli_subprocess_tiny(work, counted), "nvidia_smi": smi})
            emit("slice_qformer", {**slice_qformer(cfg, ckpt, ids, pixels, counted),
                                   "nvidia_smi": smi})
            # The telemetry of the served path, through cli/serve processes
            # over this checkpoint, one at a time.
            torch.cuda.empty_cache()
            telemetry_k1 = serve_telemetry_7b(eventchat, llama, params, cfg, tokenizer,
                                              requests, defaults_oracle, ckpt, work, n_layers,
                                              smi, defaults_ties)
            # The serving mesh: two ranks of the one card, each with half of
            # every LLaMA matmul, through cli/eval and cli/serve.
            mesh_runs = {"eval_mesh_7b": eval_mesh_7b(params, cfg, tokenizer, ckpt, work,
                                                      event_paths, out_ids, n_layers, smi)}
            emit("eval_mesh_7b", mesh_runs["eval_mesh_7b"])
            mesh_runs["serve_mesh_7b"] = serve_mesh_7b(eventchat, llama, params, cfg, tokenizer,
                                                       requests, defaults_oracle, ckpt, work,
                                                       n_layers, smi, defaults_ties)
            emit("serve_mesh_7b", mesh_runs["serve_mesh_7b"])
            # The training mesh: cli.train on two ranks of a context axis
            # over this checkpoint (its line follows train_stage2_7b, its
            # one-device oracle). While its ranks load and step, this
            # process drives the in-process fleet's kill and the engine's
            # breaker on the same card, when the card has room for both.
            mesh_world = start_train_mesh_7b(params, ckpt, train_paths, work)
            try:
                if mesh_world["overlap"]:
                    mesh_world["beside"] = ["serve_fleet_chaos_7b", "serve_breaker_7b"]
                    chaos_k1, breaker_k1 = fault_phases_7b()
            finally:
                mesh_train = finish_train_mesh_7b(mesh_world, params, n_layers,
                                                  cfg.llama.num_heads, smi)
            if not mesh_world["overlap"]:
                chaos_k1, breaker_k1 = fault_phases_7b()
            # Process fleets: worker processes loading this checkpoint.
            procfleet_k1 = serve_procfleet_7b(eventchat, llama, params, cfg, tokenizer, ids,
                                              pixels, requests, ckpt, fleet_ref, counted,
                                              n_layers, smi)
            del fleet_ref
            # Preemption, the guard and deadlines on a serving mesh as a
            # fleet: its ranks boot from this checkpoint and serve while
            # phase 8 trains and the tiny phases run, when the card has
            # room beside them; else it runs alone here.
            mesh_preempt = start_mesh_preempt(ckpt, work)
            if not mesh_preempt["overlap"]:
                mesh_preempt["thread"].join()
        finally:
            if mesh_preempt is None:
                shutil.rmtree(ckpt, ignore_errors=True)
            shutil.rmtree(os.path.join(work, "qformer_7b"), ignore_errors=True)

        # 8. training at 7B width on the bf16 tree: K1's gradient at the
        # first training batch's shape, then stage 1 and stage 2 through
        # cli.train's construction.
        from eventgpt_tpu_torch.train.data import EventChatDataset, batch_iterator

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
        emit("train_mesh_7b", {**mesh_train, "vs_train_stage2_7b":
                               train_mesh_vs_one_device(mesh_train, train_runs[2])})
        emit("train_remat_7b", train_remat_7b(params, cfg, tokenizer, train_paths, work, smi))
        medusa_7b = medusa_train_7b(params, cfg, tokenizer, work, smi)
        emit("medusa_train_7b", medusa_7b)
        if not mesh_preempt["overlap"]:
            mesh_preempt_k1 = finish_mesh_preempt(mesh_preempt, eventchat, llama, params, cfg,
                                                  tokenizer, ids, pixels, preempt_want, n_layers,
                                                  smi)
            del params
        torch.cuda.empty_cache()

        # The tiny mesh phase's worlds are processes of their own: they run
        # beside the other tiny phases.
        tiny_mesh_box = {}

        def tiny_mesh_bg():
            try:
                tiny_mesh_box["out"] = tiny_mesh_card_vs_cpu(work)
            except Exception as e:  # raised in the main thread below
                tiny_mesh_box["error"] = e

        tiny_mesh_thread = threading.Thread(target=tiny_mesh_bg)
        tiny_mesh_thread.start()
        tiny_train_mesh_box = {}

        def tiny_train_mesh_bg():
            # The training mesh's tiny world, then the multiprocess dry run.
            try:
                tiny_train_mesh_box["out"] = tiny_train_mesh_card_vs_cpu(work)
                tiny_train_mesh_box["multiproc"] = multiproc_dryrun_card(work)
            except BaseException as e:  # noqa: BLE001 (raised on the main thread)
                tiny_train_mesh_box["error"] = e

        tiny_train_mesh_thread = threading.Thread(target=tiny_train_mesh_bg)
        tiny_train_mesh_thread.start()
        emit("tiny_card_vs_cpu", tiny_card_matches_cpu(os.path.join(work, "events_0.npy")))
        emit("tiny_quant_card_vs_cpu",
             tiny_quant_card_matches_cpu(os.path.join(work, "events_1.npy")))
        emit("tiny_variants_card_vs_cpu",
             tiny_variants_card_vs_cpu(os.path.join(work, "events_2.npy")))
        emit("tiny_serve_card_vs_cpu", tiny_serve_card_matches_cpu(work))
        emit("tiny_serve_defaults_card_vs_cpu", tiny_serve_defaults_card_vs_cpu(work))
        emit("tiny_serve_spec_card_vs_cpu", tiny_serve_spec_card_vs_cpu(work))
        emit("tiny_telemetry_card_vs_cpu", tiny_telemetry_card_vs_cpu(work))
        emit("tiny_stream_card_vs_cpu", tiny_stream_card_vs_cpu(work))
        emit("tiny_preempt_card_vs_cpu", tiny_preempt_card_vs_cpu())
        emit("tiny_fleet_card_vs_cpu", tiny_fleet_card_vs_cpu())
        emit("tiny_procfleet_card_vs_cpu", tiny_procfleet_card_vs_cpu(work))
        emit("tiny_checkpoint_card_vs_cpu", tiny_checkpoint_card_vs_cpu(work))
        emit("serve_http_tiny", serve_http_tiny(work))
        emit("train_tiny_card_vs_cpu", train_tiny_card_vs_cpu(work, train_paths))
        emit("tiny_medusa_card_vs_cpu", tiny_medusa_card_vs_cpu())
        emit("medusa_acceptance_tiny", medusa_acceptance_tiny(work))
        if mesh_preempt["overlap"]:
            mesh_preempt_k1 = finish_mesh_preempt(mesh_preempt, eventchat, llama, params, cfg,
                                                  tokenizer, ids, pixels, preempt_want, n_layers,
                                                  smi)
            del params
            torch.cuda.empty_cache()
        shutil.rmtree(ckpt, ignore_errors=True)
        tiny_mesh_thread.join()
        if "error" in tiny_mesh_box:
            raise tiny_mesh_box["error"]
        tiny_mesh = tiny_mesh_box["out"]
        emit("tiny_mesh_card_vs_cpu", tiny_mesh)
        tiny_train_mesh_thread.join()
        if "error" in tiny_train_mesh_box:
            raise tiny_train_mesh_box["error"]
        tiny_train_mesh = tiny_train_mesh_box["out"]
        emit("tiny_train_mesh_card_vs_cpu", tiny_train_mesh)
        emit("multiproc_dryrun_card", {**tiny_train_mesh_box["multiproc"], "nvidia_smi": smi})
    finally:
        if mesh_preempt is not None:
            # Its waits are bounded and it stops its server: no rank outlives
            # the script.
            mesh_preempt["thread"].join()
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
                             "serve_paged_int8kv": serve_launches[FLASH_KERNEL.source],
                             **{f"serve_defaults_{layout}_{name}": n
                                for layout, by_config in serve_defaults_k1.items()
                                for name, n in by_config.items()},
                             **{name: n[FLASH_KERNEL.source]
                                for name, n in serve_spec_launches.items()},
                             "serve_spec_int4": serve_spec_int4_launches[FLASH_KERNEL.source],
                             **{f"serve_preempt_7b_{arm}": n for arm, n in preempt_k1.items()},
                             **{f"serve_handoff_7b_{run}": n for run, n in handoff_k1.items()},
                             **{f"serve_fleet_7b_{run}": n for run, n in fleet_k1.items()},
                             **{f"serve_fleet_chaos_7b_{arm}": n for arm, n in chaos_k1.items()},
                             **{f"serve_breaker_7b_{run}": n for run, n in breaker_k1.items()},
                             "handoff_wire_7b_decode_role": wire_k1,
                             "serve_procfleet_7b_by_worker": procfleet_k1["colocated"],
                             "serve_procfleet_chaos_7b_survivor_after_kill":
                                 procfleet_k1["chaos"]["survivor_after_kill"],
                             "serve_procfleet_chaos_7b_respawned":
                                 procfleet_k1["chaos"]["respawned"],
                             "serve_disagg_7b_prefill_worker": procfleet_k1["disagg"][0],
                             "serve_disagg_7b_decode_worker": procfleet_k1["disagg"][1],
                             **{f"serve_telemetry_7b_{run}": n
                                for run, n in telemetry_k1.items()},
                             **{f"train_stage{st}": run["k1_launches"]
                                for st, run in train_runs.items()},
                             **{f"train_stage{st}_eval": run["eval"]["k1_inference"]
                                for st, run in train_runs.items()},
                             "medusa_train": medusa_7b["k1_launches"],
                             **{f"eval_mesh_7b_rank{r['rank']}":
                                r["launches"]["flash_attention.cu"]
                                for r in mesh_runs["eval_mesh_7b"]["ranks"]},
                             **{f"serve_mesh_7b_rank{r}": n for r, n in
                                enumerate(mesh_runs["serve_mesh_7b"]["k1_launches_by_rank"])},
                             **mesh_preempt_k1,
                             **{f"train_mesh_7b_rank{r['rank']}": r["k1_launches"]
                                for r in mesh_train["ranks"]},
                             **{f"tiny_train_mesh_card_{name}_rank{r}": n
                                for name, *_ in MESH_TRAIN_CASES
                                for r, n in enumerate(
                                    tiny_train_mesh[name]["k1_launches_by_rank"])}},
        "train_launches_by_path": {**{f"train_stage{st}": run["k1_by_path"]
                                      for st, run in train_runs.items()},
                                   **{f"train_mesh_7b_rank{r['rank']}": r["k1_by_path"]
                                      for r in mesh_train["ranks"]}},
        "train_launches_per_micro_step": {**{f"train_stage{st}": run["k1_launches_per_micro_step"]
                                             for st, run in train_runs.items()},
                                          **{f"train_mesh_7b_rank{r['rank']}":
                                             r["k1_launches_per_micro_step"]
                                             for r in mesh_train["ranks"]}},
        "backward": "plain torch (eventgpt_tpu_torch/ops/flash_attention.py"
                    ":flash_attention_backward)",
        "backward_calls_per_micro_step": {**{f"train_stage{st}": run["k1_backward_per_micro_step"]
                                             for st, run in train_runs.items()},
                                          **{f"train_mesh_7b_rank{r['rank']}":
                                             r["k1_backward_per_micro_step"]
                                             for r in mesh_train["ranks"]}},
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
                                for name, n in variant_launches.items()},
                             "serve_spec_int4": serve_spec_int4_launches[INT4_KERNEL.source],
                             **{f"tiny_mesh_card_{m}_rank{r}": n
                                for m, _ in MESH_TINY_MESHES
                                for r, n in enumerate(tiny_mesh[m]["k4_launches_by_rank"])}},
        "slice_spec_int4_launches_by_path_m": {f"{p} M={m}": c
                                               for (p, m), c in sorted(spec_by_m4.items())},
        "serve_spec_int4_launches_by_path_m": {f"{p} M={m}": c
                                               for (p, m), c in sorted(serve_spec_by_m4.items())},
        "forward_ms_by_m": {m: {"ms": f["ms"], "plain_ms": f["plain_ms"],
                                "bound_ms": f["bound_ms"], "library_ms": f["library_ms"]}
                            for m, f in spec_forward.items()},
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
    if LEDGER_OVER:
        raise AssertionError(f"the memory ledger passed the allocated bytes at {LEDGER_OVER}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
