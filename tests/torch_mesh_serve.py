"""The serve cases of a rank of ``tests/torch_mesh_ranks.py``: a
``ContinuousBatcher`` on the serving mesh, and ``cli/serve``'s engine on
rank 0 with a follower on the other ranks (one a replica with ``--fleet``).
The functions here also run the test process's unsharded and JAX references
on the same traffic. Imports no JAX."""

from __future__ import annotations

import time

import numpy as np

# A far deadline and SLO target: a slow machine changes no status.
LONG_S = 3600.0
# A fake clock's tick a step (``run_deadline``).
TICK_S = 1.0


def serving_requests(job, budgets=None):
    """(ids, pixels, budget) of the job's requests, in order."""
    return [(ids, pv, n) for ids, pv, n in zip(job["ids"], job["pixels"],
                                               budgets or job["budgets"])]


def run_batcher(srv, job, case, warmup: bool = True):
    """``warmup()`` when the case asks (and ``warmup``), then submit the
    first ``case["first"]`` requests, step ``case["steps_before"]`` times,
    submit the rest (mid-flight admission) and drain. Returns the chains in
    submit order."""
    reqs = serving_requests(job, case.get("budgets"))
    first = case.get("first", len(reqs))
    if case.get("warmup") and warmup:
        srv.warmup()
    if case.get("prefix"):
        srv.set_prefix(job["prefix_ids"])
    rids = [srv.submit(*r) for r in reqs[:first]]
    for _ in range(case.get("steps_before", 0)):
        srv.step()
    rids += [srv.submit(*r) for r in reqs[first:]]
    out = srv.run_until_drained()
    return [out[r] for r in rids]


def planes(x):
    """A record's planes as numpy (tensors, arrays, {"q", "s"} dicts)."""
    if isinstance(x, dict):
        return {k: planes(v) for k, v in x.items()}
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def scheduler_state(srv) -> tuple:
    """What the preemption tests hold equal after every step: the host
    mirror, the queue and the rows, the counters, the pool and the store."""
    return (np.asarray(srv.frozen).tolist(), np.asarray(srv.n_rem).tolist(),
            [q.rid for q in srv.queue], [r.rid if r else None for r in srv.rows],
            srv.preemptions, srv.block_deferrals, srv._pool.stats(),
            srv._spill_store.stats())


def watch_runs(srv) -> list:
    """The block ids of every spilled run and of every restore, in order."""
    runs, pool = [], srv._pool
    spill_out, restore = pool.spill_out, pool.restore

    def spill(blocks):
        runs.append(("spill", [int(b) for b in blocks]))
        return spill_out(blocks)

    def back(run_id, n):
        out = restore(run_id, n)
        runs.append(("restore", None if out is None else [int(b) for b in out]))
        return out

    pool.spill_out, pool.restore = spill, back
    return runs


def run_preempt(srv, job, slo_cls, steps_before: int = 6) -> dict:
    """``tests/test_torch_preempt_spill.py``'s scenario on any batcher: the
    batch request decodes alone for ``steps_before`` steps, then an
    interactive one that the 4-block pool cannot cover arrives. Returns the
    chains (batch, interactive), the state after every step and each spill
    record (numpy planes) with the step it was first seen at."""
    (bids, bpv, bn), (iids, ipv, i_n) = job["preempt_reqs"]
    rids = [srv.submit(bids, bpv, bn, slo=slo_cls(name="batch", latency_s=LONG_S))]
    trace, records = [], {}
    for _ in range(steps_before):
        srv.step()
        trace.append(scheduler_state(srv))
    rids.append(srv.submit(iids, ipv, i_n, slo=slo_cls(name="interactive", ttft_s=LONG_S)))
    while srv.queue or any(r is not None for r in srv.rows):
        srv.step()
        trace.append(scheduler_state(srv))
        for q in srv.queue:
            rec = srv._spill_store.peek(q.rid)
            if rec is not None and q.rid not in records:
                records[q.rid] = (len(trace), {k: planes(rec[k]) if k in ("k", "v", "logits")
                                               else int(rec[k])
                                               for k in ("k", "v", "logits", "length",
                                                         "n_blocks", "nbytes_kv", "base_pos")})
        if len(trace) > 300:
            raise AssertionError("the preemption scenario does not drain")
    srv._drain()
    trace.append(scheduler_state(srv))
    return {"chains": [srv.finished[r] for r in rids], "trace": trace, "records": records}


def run_deadline(srv, job, clock: dict) -> dict:
    """The job's requests, request ``deadline_row`` with a deadline of
    ``deadline_s`` on a fake clock that ``clock["t"]`` holds and each step
    advances by TICK_S: it expires mid-decode at a fixed step. Returns the
    chains, the statuses and the step at which each finished."""
    reqs = serving_requests(job, job["deadline_budgets"])
    rids = [srv.submit(ids, pv, n, deadline_s=job["deadline_s"] if i == job["deadline_row"]
                       else None) for i, (ids, pv, n) in enumerate(reqs)]
    done, n = {}, 0
    while srv.queue or any(r is not None for r in srv.rows):
        clock["t"] += TICK_S
        srv.step()
        n += 1
        for rid in rids:
            if rid in srv.finish_status and rid not in done:
                done[rid] = n
    srv._drain()
    return {"chains": [srv.finished[r] for r in rids],
            "statuses": [srv.finish_status[r] for r in rids], "done_step": [done[r] for r in rids]}


def run_roles(pre, dec, job) -> dict:
    """The job's requests through a prefill-role batcher, each record popped
    as it is gathered and spliced into a decode-role batcher (the import
    order is the gather order). Returns the chains in submit order and the
    records (numpy planes) in gather order."""
    rids = [pre.submit(*r) for r in serving_requests(job)]
    to_dec, records = {}, []
    while pre.queue or any(r is not None for r in pre.rows):
        pre.step()
        for out in pre.pop_handoffs():
            records.append({**out, "rec": {k: planes(v) if k in ("k", "v", "logits", "length")
                                           else v for k, v in out["rec"].items()},
                            "journey": None})
            to_dec[out["rid"]] = splice(dec, out)
    got = dec.run_until_drained()
    return {"chains": [got[to_dec[r]] for r in rids], "records": records}


def splice(dec, out, rec=None) -> int:
    """``import_handoff`` of one outbox entry (its record, or ``rec``)."""
    return dec.import_handoff(out["input_ids"], out["max_new_tokens"],
                              out["rec"] if rec is None else rec, tokens=out["tokens"],
                              prompt_len=out["prompt_len"], deadline_s=out["deadline_s"],
                              slo=out["slo"])


def serve_case(job, case, mesh, port_tree, cfg_of):
    from eventgpt_tpu_torch.parallel import serving
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    if case.get("engine"):
        return _engine_case(job, case, mesh)
    cfg = cfg_of(job, case)
    sp = serving.shard_params_for_serving(port_tree(job, case), cfg, mesh)
    if case.get("kind"):
        return _KINDS[case["kind"]](job, case, mesh, sp, cfg, port_tree)
    srv = ContinuousBatcher(sp, cfg, device="cpu", mesh=mesh, eos_token_id=None,
                            **case["batcher"])
    chains = run_batcher(srv, job, case)
    return {"chains": chains, "kv_heads": int((srv.cache["k"]["q"] if srv.kv_quant
                                               else srv.cache["k"]).shape[3])}


def _preempt_case(job, case, mesh, sp, cfg, port_tree):
    """Preemption on the mesh. Rank 1's price is planted on the other arm
    (recompute at 1e30 FLOP/s, the gather at 1 B/s): rank 0's choice, the
    spill, must win."""
    from eventgpt_tpu_torch.serve import ContinuousBatcher
    from eventgpt_tpu_torch.workload import SLO

    srv = ContinuousBatcher(sp, cfg, device="cpu", mesh=mesh, eos_token_id=None,
                            **case["batcher"])
    srv._recompute_flops_per_s = 1.0  # recompute priced out, as the tests do
    if mesh.rank == 1:
        srv._recompute_flops_per_s, srv._spill_bw_Bps = 1e30, 1.0
    runs = watch_runs(srv)
    out = run_preempt(srv, job, SLO)
    return {**out, "runs": runs, "param_count": srv._spill_param_count}


def _deadline_case(job, case, mesh, sp, cfg, port_tree):
    """A deadline that expires mid-decode on rank 0's fake clock, while
    rank 1's clock reads 1000 s ahead of its own: rank 0's clock governs."""
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    srv = ContinuousBatcher(sp, cfg, device="cpu", mesh=mesh, eos_token_id=None,
                            **case["batcher"])
    clock = {"t": 0.0}
    if mesh.rank == 0:
        srv._clock = lambda: clock["t"]
    else:
        srv._clock = lambda: time.perf_counter() + 1000.0
    return run_deadline(srv, job, clock)


def _guard_case(job, case, mesh, sp, cfg, port_tree):
    """The headroom guard with rank 1's ledger inflated past its budget: the
    waves defer on every rank, at the same boundaries."""
    from eventgpt_tpu_torch.obs import memory as obs_memory
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    srv = ContinuousBatcher(sp, cfg, device="cpu", mesh=mesh, eos_token_id=None,
                            **case["batcher"])
    if mesh.rank == 1:
        obs_memory.LEDGER.register("other", "planted/rank1", 1 << 60)
    deferrals = []
    step = srv.step

    def counted():
        step()
        deferrals.append(srv.mem_deferrals)

    srv.step = counted
    try:
        chains = run_batcher(srv, job, case)
    finally:
        obs_memory.LEDGER.release("other", "planted/rank1")
    return {"chains": chains, "deferrals": deferrals}


def _roles_case(job, case, mesh, sp, cfg, port_tree):
    """Prefill on the mesh spliced into decode on the mesh (the records
    gathered whole), and a one-device prefill's records spliced into the
    mesh's decode."""
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    def batcher(params, role, m):
        return ContinuousBatcher(params, cfg, device="cpu", mesh=m, eos_token_id=None,
                                 role=role, **case["batcher"])

    mesh_run = run_roles(batcher(sp, "prefill", mesh), batcher(sp, "decode", mesh), job)
    tree = port_tree(job, case)
    one = run_roles(batcher(tree, "prefill", None), batcher(tree, "decode", None), job)
    dec = batcher(sp, "decode", mesh)
    rids = [splice(dec, out) for out in one["records"]]
    got = dec.run_until_drained()
    into = {out["rid"]: got[r] for out, r in zip(one["records"], rids)}
    return {"chains": mesh_run["chains"], "records": mesh_run["records"],
            "one_device_into_mesh": [into[i] for i in sorted(into)]}


_KINDS = {"preempt": _preempt_case, "deadline": _deadline_case, "guard": _guard_case,
          "roles": _roles_case}


def _engine_case(job, case, mesh):
    """``cli/serve``'s own build path over tiny-random weights on the mesh:
    rank 0 submits while the engine steps, cancels one request mid-flight,
    waits for the answers and shuts down, which stops the followers."""
    from eventgpt_tpu_torch.cli import serve as cli_serve

    args = cli_serve.build_parser().parse_args(case["argv"])
    _, engine = cli_serve.build_engine(args)
    if isinstance(engine, cli_serve.MeshFollowers):
        return {"follower_steps": engine.follow(),
                "follower_kills": [f.kills for f in engine.followers]}
    if isinstance(engine, cli_serve.MeshFollower):
        return {"follower_steps": engine.follow()}
    if case.get("kill") is not None:
        return _fleet_kill(job, case, engine)
    reqs = serving_requests(job, case["budgets"])
    try:
        rids = []
        for i, (ids, pv, n) in enumerate(reqs):
            rids.append(engine.submit_ids(ids, pv, n))
            if i == 0:
                # The rest arrive while the first request decodes.
                deadline = time.monotonic() + 30
                while engine.batcher.rows[0] is None and time.monotonic() < deadline:
                    time.sleep(0.005)
        cancel = rids[case["cancel"]]
        deadline = time.monotonic() + 30
        while not any(r is not None and r.rid == cancel and r.tokens
                      for r in engine.batcher.rows) and time.monotonic() < deadline:
            time.sleep(0.002)
        engine.cancel(cancel)
        chains = []
        for rid in rids:
            try:
                chains.append(engine.result(rid, timeout=60))
            except Exception:
                chains.append(None)
        statuses = [engine.status(rid) for rid in rids]
    finally:
        engine.shutdown()
    # After the shutdown, as the followers count: the loop may take a
    # trailing step after the last answer.
    return {"chains": chains, "statuses": statuses, "leader_steps": engine.batcher.steps}


def _fleet_kill(job, case, fleet) -> dict:
    """Rank 0's ``--fleet`` on the mesh: the requests are routed over the
    replicas, replica ``case["kill"]`` is killed once a row of it decodes,
    its requests move to the survivor, and shutdown stops every replica's
    followers. Returns the chains, the statuses, each request's final
    replica and each replica's steps."""
    reqs = serving_requests(job, case["budgets"])
    try:
        frids = [fleet.submit_ids(ids, pv, n) for ids, pv, n in reqs]
        victim = fleet.replicas[case["kill"]].engine.batcher
        deadline = time.monotonic() + 30
        while not any(r is not None and r.tokens for r in victim.rows) \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        moved = fleet.kill_replica(case["kill"])
        chains = []
        for frid in frids:
            try:
                chains.append(fleet.result(frid, timeout=60))
            except Exception:
                chains.append(None)
        out = {"chains": chains, "statuses": [fleet.status(f) for f in frids],
               "replicas": [fleet.replica_of(f) for f in frids], "moved": moved}
    finally:
        fleet.shutdown()
    # Read after the shutdown: a replica's loop may take a trailing step
    # after its last answer.
    out["leader_steps"] = [rep.engine.batcher.steps for rep in fleet.replicas]
    return out
