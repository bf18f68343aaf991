"""Multi-process dry run: the training mesh across real OS processes.

Port of ``eventgpt_tpu/parallel/multiproc.py``. The launcher starts N
worker processes, one rank each, joined through the ``EGPT_*`` contract
(``parallel/dist.initialize_distributed`` over gloo against rank 0's
coordinator), and beside them a single-process reference job that runs the
same global program on one device:

  * the workers' mesh (``EGPT_MP_MESH``, data,fsdp,context,model) spans the
    processes and runs stage-2 train steps of the tiny config, the
    gradients summed over the ranks; rank 0's losses must equal the
    reference's (``rtol``);
  * a checkpoint is written the trainer's way -- the trainables gathered to
    their whole size, the files written by rank 0 alone (``is_primary``),
    then a barrier -- and restored on every rank, whose blocks must equal
    what it holds bit for bit;
  * a preemption requested on rank 1 alone reaches every rank through
    ``GracefulShutdown.globally_requested(mesh)``, and both take the
    coordinated checkpoint at the same step.

``EGPT_FAULTS=multiproc.worker:n=1`` in one rank's environment
(``worker_env``) fails that rank at bootstrap; the launcher's round-robin
poll reports it as that rank's failure and stops the others, where a
sequential wait would hang on a rank blocked in the rendezvous.

Every process runs on the card (a rank on ``cuda:<rank mod the card
count>``, so two ranks may share one card; the ranks talk over gloo, which
stages CUDA tensors through host memory) unless ``--device cpu`` is given.

    python -m eventgpt_tpu_torch.parallel.multiproc                # the dry run
    python -m eventgpt_tpu_torch.parallel.multiproc --device cpu   # on the CPU
    python -m eventgpt_tpu_torch.parallel.multiproc --worker       # one worker
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

DEVICES = ("cuda", "cpu")

# Parsed by the launcher from a worker's stdout; versioned so that a stale
# worker fails loudly rather than mis-parse.
_RESULT_TAG = "MPRESULT1"


def _reserve_port() -> socket.socket:
    """An ephemeral port, held until the workers are spawned (closing it
    earlier would let another process take it)."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s


def _save_whole(path: str, tree, step: int, mesh) -> bool:
    """The trainer's write discipline: every rank gathers, rank 0 writes,
    every rank waits for the write. Returns whether this rank wrote."""
    from eventgpt_tpu_torch import checkpoint as ckpt
    from eventgpt_tpu_torch.parallel.dist import barrier, is_primary

    wrote = is_primary()
    if wrote:
        ckpt.save_checkpoint(path, {"trainable": tree, "step": step}, step=step)
    barrier(f"written {os.path.basename(path)}")
    return wrote


def worker_main() -> None:
    """Entry of the workers and of the single-process reference job (told
    apart by the ``EGPT_*`` contract)."""
    from eventgpt_tpu_torch import faults

    # The process-boundary fault site: a rank that dies at bootstrap must
    # surface as that rank's failure, not as a hang of the others.
    faults.maybe_fail("multiproc.worker")
    import dataclasses

    import torch

    from eventgpt_tpu_torch import checkpoint as ckpt
    from eventgpt_tpu_torch.config import EventChatConfig, MeshConfig
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.obs import metrics as obs_metrics
    from eventgpt_tpu_torch.parallel import sharding
    from eventgpt_tpu_torch.parallel.dist import initialize_distributed, rank_device, shutdown
    from eventgpt_tpu_torch.parallel.mesh import make_mesh
    from eventgpt_tpu_torch.train import steps as steps_mod
    from eventgpt_tpu_torch.train.data import synthetic_multimodal_batch
    from eventgpt_tpu_torch.train.lora import LoraConfig
    from eventgpt_tpu_torch.train.optim import linear_warmup_cosine, make_optimizer, tree_leaves
    from eventgpt_tpu_torch.train.resilience import GracefulShutdown
    from eventgpt_tpu_torch.train.trainer import tree_map

    torch.set_num_threads(1)
    device_type = os.environ.get("EGPT_MP_DEVICE", "cuda")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the multiprocess dry run runs on the card, and no CUDA device "
                               "is available (pass --device cpu)")
        # The losses are held to the reference's in f32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    multi = initialize_distributed(backend="gloo")
    rank = torch.distributed.get_rank() if multi else 0
    nproc = torch.distributed.get_world_size() if multi else 1
    # Every sample a worker exposes carries its rank.
    obs_metrics.REGISTRY.set_common_labels(process=str(rank))

    shape = [int(x) for x in os.environ["EGPT_MP_MESH"].split(",")]
    n_steps = int(os.environ.get("EGPT_MP_STEPS", "2"))
    outdir = os.environ["EGPT_MP_OUTDIR"]
    attn_impl = os.environ.get("EGPT_MP_ATTN", "dense")
    mcfg = MeshConfig(data=shape[0], fsdp=shape[1], context=shape[2], model=shape[3])

    cfg = EventChatConfig.tiny()
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, attn_impl=attn_impl))
    params = init_eventchat_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    lcfg = LoraConfig(r=4)
    trainable, frozen = steps_mod.split_stage2(params, cfg, lcfg, torch.Generator().manual_seed(1))
    mesh = make_mesh(mcfg, device_type) if multi else None
    device = mesh.device if multi else rank_device(device_type)
    specs = sharding.trainable_param_specs(trainable, lcfg.targets)
    if mesh is not None:
        trainable = sharding.shard_trainable(trainable, specs, mesh)
        frozen = sharding.shard_frozen(frozen, cfg, mesh)
    else:
        trainable, frozen = (tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t, tree)
                             for tree in (trainable, frozen))
    opt = make_optimizer(linear_warmup_cosine(1e-3, 10, 0))
    state = steps_mod.init_train_state(trainable, frozen, opt)
    step_fn = steps_mod.make_train_step(cfg, opt, steps_mod.make_stage2_combine(lcfg, mesh=mesh),
                                        mesh=mesh, specs=specs)
    host_batch = synthetic_multimodal_batch(cfg, mcfg.data * mcfg.fsdp, 64, event_offset=8)
    losses: List[float] = []
    for _ in range(n_steps):
        state, metrics = step_fn(state, steps_mod.batch_to_device(host_batch, mesh if multi
                                                                  else device))
        losses.append(float(metrics["loss"]))
    if any(x != x for x in losses):
        raise RuntimeError(f"rank {rank}: NaN loss in the multiprocess dry run: {losses}")

    report = {"rank": rank, "n_processes": nproc, "mesh": dataclasses.asdict(mcfg),
              "attn": attn_impl, "device": str(device), "losses": losses}
    if multi:
        # The checkpoint: gathered whole, written by rank 0, restored on
        # every rank into its blocks.
        ckpt_dir = os.path.join(outdir, "ckpt_mp")
        whole = sharding.gather_trainable(state.trainable, specs, mesh)
        report["ckpt_written_by_me"] = _save_whole(ckpt_dir, whole, state.step, mesh)
        restored = ckpt.load_checkpoint(ckpt_dir, "cpu")
        back = sharding.shard_trainable(restored["trainable"], specs, mesh)
        live = [t for _, t in tree_leaves(state.trainable)]
        got = [t for _, t in tree_leaves(back)]
        report["resumed_ok"] = (int(restored["step"]) == n_steps and len(live) == len(got)
                                and all(torch.equal(a, b) for a, b in zip(live, got)))
        if not report["resumed_ok"]:
            raise RuntimeError(f"rank {rank}: the restored checkpoint differs from the live state")

        # The preemption: requested on rank 1 alone, agreed by every rank.
        stop = GracefulShutdown()
        if rank == 1:
            stop.request("simulated-preemption")
        agreed = stop.globally_requested(mesh)
        if not agreed:
            raise RuntimeError(f"rank {rank}: the agreement missed rank 1's request")
        if rank == 0 and stop.requested:
            raise RuntimeError("rank 0's local flag is set: the test's wiring is broken")
        pre_dir = os.path.join(outdir, f"ckpt_preempt_step{state.step}")
        whole = sharding.gather_trainable(state.trainable, specs, mesh)
        _save_whole(pre_dir, whole, state.step, mesh)
        if not os.path.isdir(pre_dir):
            raise RuntimeError(f"rank {rank}: the coordinated checkpoint is missing")
        report["preempt"] = {"local_flag": stop.requested, "agreed": agreed,
                             "step": state.step, "reason": stop.reason}
        shutdown()
    print(_RESULT_TAG + json.dumps(report), flush=True)


def _worker_env(base: Dict[str, str]) -> Dict[str, str]:
    """A worker's environment: the repository on the path, one thread, and
    no half-set contract or launcher variables from the caller."""
    env = dict(base)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join([repo] + [p for p in [env.get("PYTHONPATH")] if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    for k in ("EGPT_COORDINATOR", "EGPT_NUM_PROCESSES", "EGPT_PROCESS_ID", "EGPT_FAULTS",
              "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    return env


def _parse_result(stdout: str, who: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith(_RESULT_TAG):
            return json.loads(line[len(_RESULT_TAG):])
    raise RuntimeError(f"{who}: no {_RESULT_TAG} line in its output:\n{stdout[-2000:]}")


def _poll(procs, logs, timeout: float) -> None:
    """Wait for every worker, round robin: the first that fails is
    reported as that rank's failure at once (its survivors, blocked in
    collectives that cannot complete, are stopped after a short grace);
    past ``timeout`` every worker is killed and the stuck ranks named."""
    deadline = time.monotonic() + timeout
    pending = set(range(len(procs)))
    failed = None
    while pending:
        for r in sorted(pending):
            rc = procs[r].poll()
            if rc is None:
                continue
            pending.discard(r)
            if rc != 0 and failed is None:
                failed = r
        if failed is not None:
            grace = time.monotonic() + 2.0
            while pending and time.monotonic() < grace:
                pending = {r for r in pending if procs[r].poll() is None}
                time.sleep(0.1)
            break
        if pending and time.monotonic() > deadline:
            stuck = sorted(pending)
            tails = []
            for r in stuck:
                with open(logs[r][1]) as f:
                    tails.append(f"-- rank {r} stderr --\n{f.read()[-1000:]}")
            raise RuntimeError(f"multiprocess ranks {stuck} still running after {timeout}s "
                               f"(coordinator deadlock?)\n" + "\n".join(tails))
        time.sleep(0.1)
    if failed is not None:
        with open(logs[failed][1]) as f:
            err = f.read()
        raise RuntimeError(f"multiprocess worker rank {failed} failed "
                           f"(rc={procs[failed].returncode}):\n{err[-3000:]}")


def launch_multiprocess_dryrun(
    n_processes: int = 2,
    mesh_shape: Sequence[int] = (1, 2, 1, 1),
    n_steps: int = 2,
    attn_impl: str = "dense",
    device: str = "cuda",
    timeout: float = 300.0,
    rtol: float = 1e-5,
    worker_env: Optional[Dict[int, Dict[str, str]]] = None,
) -> dict:
    """Run the dry run on ``n_processes`` workers (one rank each) and the
    single-process reference, on ``device`` ("cuda" or "cpu"); compare.
    ``worker_env`` adds variables to one rank's environment ({rank: {name:
    value}}). Returns the summary; raises on a worker's failure, a loss
    that differs or a missing leg."""
    if device not in DEVICES:
        raise ValueError(f"device {device!r}: one of {DEVICES}")
    if math.prod(mesh_shape) != n_processes:
        raise ValueError(f"mesh {tuple(mesh_shape)} needs {math.prod(mesh_shape)} processes, "
                         f"have {n_processes}")
    from eventgpt_tpu_torch import faults

    faults.maybe_fail("multiproc.launch")
    cmd = [sys.executable, "-m", "eventgpt_tpu_torch.parallel.multiproc", "--worker"]
    port_sock = _reserve_port()
    port = port_sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="egpt_mp_") as outdir:
        common = {"EGPT_MP_MESH": ",".join(str(x) for x in mesh_shape),
                  "EGPT_MP_STEPS": str(n_steps), "EGPT_MP_OUTDIR": outdir,
                  "EGPT_MP_ATTN": attn_impl, "EGPT_MP_DEVICE": device}
        # Worker output goes to files: a rank blocked writing into an
        # undrained pipe would stall out of its collectives.
        procs, logs = [], []
        # The reference job needs no coordinator: it runs beside the workers.
        env = _worker_env(os.environ)
        env.update(common)
        ref_proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        port_sock.close()
        try:
            for rank in range(n_processes):
                env = _worker_env(os.environ)
                env.update(common)
                env.update({"EGPT_COORDINATOR": f"127.0.0.1:{port}",
                            "EGPT_NUM_PROCESSES": str(n_processes),
                            "EGPT_PROCESS_ID": str(rank)})
                env.update((worker_env or {}).get(rank, {}))
                out_path = os.path.join(outdir, f"rank{rank}.out")
                err_path = os.path.join(outdir, f"rank{rank}.err")
                logs.append((out_path, err_path))
                with open(out_path, "w") as fo, open(err_path, "w") as fe:
                    procs.append(subprocess.Popen(cmd, env=env, stdout=fo, stderr=fe))
            _poll(procs, logs, timeout)
            ref_out, ref_err = ref_proc.communicate(timeout=timeout)
        finally:
            for p in procs + [ref_proc]:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for rank in range(n_processes):
            with open(logs[rank][0]) as f:
                results.append(_parse_result(f.read(), f"rank {rank}"))
        ckpts = sorted(d for d in os.listdir(outdir) if d.startswith("ckpt_"))
        state_files = {d: sorted(os.listdir(os.path.join(outdir, d))) for d in ckpts}
        if ref_proc.returncode != 0:
            raise RuntimeError(f"single-process reference failed (rc={ref_proc.returncode}):\n"
                               f"{ref_err[-3000:]}")
        ref = _parse_result(ref_out, "single-process reference")

    by_rank = {r["rank"]: r for r in results}
    for i, (a, b) in enumerate(zip(by_rank[0]["losses"], ref["losses"])):
        if not math.isclose(a, b, rel_tol=rtol, abs_tol=0.0):
            raise RuntimeError(f"multiprocess loss differs from the single process at step "
                               f"{i}: {a!r} vs {b!r} (rtol {rtol})")
    for r in results:
        if r["n_processes"] != n_processes or not r["resumed_ok"]:
            raise RuntimeError(f"bad worker result: {r}")
        if not r["preempt"]["agreed"]:
            raise RuntimeError(f"preemption leg missing on rank {r['rank']}: {r}")
    summary = {"n_processes": n_processes, "mesh": by_rank[0]["mesh"], "attn": attn_impl,
               "devices": [r["device"] for r in results], "device_single_process": ref["device"],
               "losses_multiproc": by_rank[0]["losses"], "losses_single_process": ref["losses"],
               "rtol": rtol, "ranks": results, "checkpoints": state_files}
    print(f"dryrun_multiproc: {n_processes} processes on {summary['devices']}, "
          f"mesh={summary['mesh']} attn={attn_impl}: "
          f"loss {summary['losses_multiproc']} == single-process "
          f"{summary['losses_single_process']} (rtol {rtol})")
    print("dryrun_multiproc: checkpoint gathered, written by rank 0 alone, restored bit for "
          "bit on every rank")
    print("dryrun_multiproc: preemption on rank 1 alone -> agreed on every rank -> one "
          "coordinated checkpoint")
    return summary


def build_parser():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where every process runs (default: the card)")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        worker_main()
        return
    summary = launch_multiprocess_dryrun(device=build_parser().parse_args(argv).device)
    print(_RESULT_TAG + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
