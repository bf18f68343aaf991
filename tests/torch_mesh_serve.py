"""The serve cases of a rank of ``tests/torch_mesh_ranks.py``: a
``ContinuousBatcher`` on the serving mesh, and ``cli/serve``'s engine on
rank 0 with a follower on the other ranks. Imports no JAX."""

from __future__ import annotations

import time


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


def serve_case(job, case, mesh, port_tree, cfg_of):
    from eventgpt_tpu_torch.parallel import serving
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    if case.get("engine"):
        return _engine_case(job, case, mesh)
    cfg = cfg_of(job, case)
    sp = serving.shard_params_for_serving(port_tree(job, case), cfg, mesh)
    srv = ContinuousBatcher(sp, cfg, device="cpu", mesh=mesh, eos_token_id=None,
                            **case["batcher"])
    chains = run_batcher(srv, job, case)
    return {"chains": chains, "kv_heads": int((srv.cache["k"]["q"] if srv.kv_quant
                                               else srv.cache["k"]).shape[3])}


def _engine_case(job, case, mesh):
    """``cli/serve``'s own build path over tiny-random weights on the mesh:
    rank 0 submits while the engine steps, cancels one request mid-flight,
    waits for the answers and shuts down, which stops the followers."""
    from eventgpt_tpu_torch.cli import serve as cli_serve

    args = cli_serve.build_parser().parse_args(case["argv"])
    _, engine = cli_serve.build_engine(args)
    if isinstance(engine, cli_serve.MeshFollower):
        return {"follower_steps": engine.follow()}
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
        steps = engine.batcher.steps
    finally:
        engine.shutdown()
    return {"chains": chains, "statuses": statuses, "leader_steps": steps}
