"""Ranks of a CPU world over ``gloo`` for the port's serving-mesh tests.

``run_world`` (called by ``tests/test_torch_sharded_*.py``) writes a job,
starts ``n`` processes of this file, each with its rank, bounds every wait
and kills the children in a ``finally``. A rank joins the group through a
``file://`` store, runs the job's cases in order (every rank the same
ones, so the mesh's groups and collectives line up) and writes what it got.
This module imports no JAX: the ranks run the port alone.

    python tests/torch_mesh_ranks.py JOB RANK WORLD RENDEZVOUS OUT
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(job: dict, n: int, tmp_path, timeout_s: float = 120.0) -> list:
    """Run ``job`` on ``n`` ranks; returns each rank's result, in rank order.
    A rank that fails or outlives ``timeout_s`` fails the call, with its
    error output."""
    tmp = str(tmp_path)
    job_path = os.path.join(tmp, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    rdv = os.path.join(tmp, "rendezvous")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                "EGPT_COORDINATOR", "EGPT_NUM_PROCESSES", "EGPT_PROCESS_ID"):
        env.pop(var, None)
    procs, logs = [], []
    try:
        for r in range(n):
            log = open(os.path.join(tmp, f"rank{r}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job_path, str(r), str(n), rdv,
                 os.path.join(tmp, f"out{r}.pkl")], stdout=log, stderr=subprocess.STDOUT,
                env=env, cwd=ROOT))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(tmp, f"rank{r}.log"), "rb") as f:
                tails.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                             + f.read().decode(errors="replace")[-3000:])
        raise AssertionError("\n".join(tails))
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------- the ranks


def _port_tree(job, case):
    import torch

    from eventgpt_tpu_torch.models import llama
    from eventgpt_tpu_torch.models.convert import params_from_jax
    from eventgpt_tpu_torch.ops import quant

    cfg = _cfg(job, case)
    tp = params_from_jax(job["trees"][case.get("tree", "base")], cfg, torch.float32, "cpu")
    if case.get("fuse"):
        llama.fuse_llama_params(tp["llama"])
    if case.get("quant"):
        quant.quantize_llama_params(tp["llama"], bits=case["quant"],
                                    group=case.get("group", 128))
    return tp


def _cfg(job, case):
    from eventgpt_tpu_torch.config import EventChatConfig

    return EventChatConfig.tiny(vocab_size=job["vocab"][case.get("tree", "base")])


def _generate_case(job, case, mesh):
    import torch

    from eventgpt_tpu_torch.models import eventchat, llama
    from eventgpt_tpu_torch.parallel import serving

    cfg = _cfg(job, case)
    sp = serving.shard_params_for_serving(_port_tree(job, case), cfg, mesh)
    b = case.get("batch", len(job["ids"]))
    ids, pixels = job["ids"][:b], job["pixels"][:b]
    kw = dict(case.get("gen", {}))
    if kw.pop("medusa", False):
        kw["draft_head"] = {"w": torch.from_numpy(job["medusa"])}
    if case.get("logits"):
        rows = serving.batch_rows(mesh, b)
        padded, mask, _ = eventchat.prepare_prefill(
            sp, cfg, [ids[i] for i in rows], pixels[rows.start:rows.stop], mesh=mesh)
        cache = llama.init_kv_cache(cfg.llama, padded.shape[0], padded.shape[1],
                                    dtype=padded.dtype, device="cpu", mesh=mesh)
        with torch.inference_mode():
            logits, _ = llama.prefill(sp["llama"], cfg.llama, padded, mask, cache,
                                      last_only=True, mesh=mesh)
        return {"rows": list(rows), "logits": logits.numpy()}
    stats = {}
    out = eventchat.generate(sp, cfg, ids, pixels, max_new_tokens=job["new"], eos_token_id=None,
                             device="cpu", mesh=mesh,
                             spec_stats=stats if kw.get("speculative") else None, **kw)
    return {"ids": out, "stats": stats}


def main(argv) -> int:
    job_path, rank, world, rdv, out_path = argv
    import torch

    torch.set_num_threads(1)
    from eventgpt_tpu_torch.config import MeshConfig
    from eventgpt_tpu_torch.parallel.dist import initialize_distributed, shutdown
    from eventgpt_tpu_torch.parallel.mesh import make_mesh

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    initialize_distributed(num_processes=int(world), process_id=int(rank), backend="gloo",
                           init_method=f"file://{rdv}", timeout_s=job.get("timeout_s", 90))
    meshes, results = {}, {}
    try:
        for case in job["cases"]:
            shape = tuple(case["mesh"])
            if shape not in meshes:
                data, fsdp, model = shape
                meshes[shape] = make_mesh(MeshConfig(data=data, fsdp=fsdp, model=model), "cpu")
            mesh = meshes[shape]
            t0 = time.perf_counter()
            if job["kind"] == "generate":
                results[case["name"]] = _generate_case(job, case, mesh)
            else:
                from torch_mesh_serve import serve_case

                results[case["name"]] = serve_case(job, case, mesh, _port_tree, _cfg)
            print(f"{case['name']}: {time.perf_counter() - t0:.2f}s", flush=True)
    finally:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
        shutdown()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
