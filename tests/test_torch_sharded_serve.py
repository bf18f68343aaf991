"""The port's continuous batcher on a serving mesh: one spawned world of 2
CPU ranks over ``gloo`` at mesh (model 2) (``tests/torch_mesh_ranks.py``,
``tests/torch_mesh_serve.py``).

``ContinuousBatcher(mesh=)`` runs every row on every rank over the rank's
heads. Its greedy chains at f32 with the int8 KV cache equal the unsharded
port's batcher of the same settings token for token: dense and paged, the
JAX defaults (the pipelined scheduler, the prefix cache with a
``set_prefix`` entry and wave admission, lanes), speculation, and chunked
prefill after ``warmup()``, with requests admitted mid-flight. The dense,
defaults and speculative cases also equal the JAX server's (the pattern of
``tests/test_sharded_serve.py``). The rank's cache holds its KV head (1 of 2).

``cli/serve``'s engine runs on rank 0 over a ``MeshLeader`` with rank 1
following: requests submitted while the engine steps and one cancelled
mid-decode give the unsharded server's chains (the cancelled one a prefix
of its chain), the follower runs as many steps as rank 0, and shutdown ends
both ranks.

The features whose decisions read one process's state run on the mesh
with those decisions agreed (f32, int8 KV; chains token for token):
- preemption, spilled (the price pinned as ``tests/test_torch_preempt_spill.py``
  pins it) and dropped: chains, the state after every step (host mirror,
  queue, rows, counters, ``pool.stats()``, the store's stats) equal the
  unsharded port's and the JAX batcher's; each rank's spill record holds
  its KV heads of the unsharded record (int8 payloads bit-equal, f32 planes
  within 1e-5, the bars of that file), and the ranks spill and restore the
  same block ids. Rank 1's price is planted on the drop side: rank 0's
  spill wins;
- a deadline on rank 0's fake clock expires mid-decode at the same step on
  both ranks and on the unsharded batcher, while rank 1's clock reads
  1000 s ahead; its tokens are a prefix of its chain;
- the headroom guard with rank 1's ledger inflated defers on both ranks at
  the same boundaries, and the chains are unchanged;
- roles: a mesh prefill batcher's records (gathered whole) spliced into a
  mesh decode batcher, a one-device port one and the JAX one give the
  unsharded and the JAX chains, and a one-device record spliced into the
  mesh's decode does too;
- ``cli/serve --fleet 2 --preempt --spill_capacity_mb`` on the mesh: one
  replica killed mid-decode, the chains equal the unsharded server's, and
  each replica's follower ran rank 0's steps and saw the kill.
"""

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import workload as jwork
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.obs import memory as jmemory
from eventgpt_tpu.serve import ContinuousBatcher as JaxBatcher
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.cli import infer
from eventgpt_tpu_torch.cli import serve as cli_serve
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.obs import memory as tmemory
from eventgpt_tpu_torch.serve import STATUS_DEADLINE, ContinuousBatcher
from torch_mesh_ranks import finish_world, start_world
from torch_mesh_serve import (planes, run_batcher, run_deadline, run_preempt, run_roles, splice,
                              watch_runs)

JCFG = jcfg.EventChatConfig.tiny()
PREFIX = [1, 7, 11, 13, 17, 19, 23, 29]
SYNC = dict(max_batch=2, max_len=256, chunk=4, kv_quant=True, prefix_cache=False,
            pipeline=False, prefill_budget=0)
DEFAULTS = dict(max_batch=2, max_len=256, chunk=4, kv_quant=True, prefill_budget=4)
CASES = {
    "dense_kv8": {"batcher": dict(SYNC, kv_layout="dense")},
    "paged_kv8": {"batcher": dict(SYNC, kv_layout="paged")},
    "defaults_paged": {"batcher": dict(DEFAULTS, kv_layout="paged"), "prefix": True,
                       "first": 2, "steps_before": 2},
    "spec_dense": {"batcher": dict(DEFAULTS, kv_layout="dense", speculative=3),
                   "prefix": True, "first": 2, "steps_before": 2},
    "chunked_warmup": {"batcher": dict(DEFAULTS, kv_layout="paged", prefill_budget=0,
                                       prefill_chunk=8),
                       "warmup": True, "first": 2, "steps_before": 1},
}
# The cases the JAX server also runs (the unsharded port's batcher is held to
# it on the others by tests/test_torch_serve*.py and test_torch_paged.py).
JAX_CASES = ("dense_kv8", "defaults_paged", "spec_dense")
ENGINE_ARGV = ["--model_path", "tiny-random", "--device", "cpu", "--dtype", "float32",
               "--max_batch", "2", "--max_len", "256", "--chunk", "4", "--kv_layout", "paged",
               "--kv_cache", "int8", "--temperature", "0", "--port", "0", "--no_telemetry"]
CANCEL = 1
# The cancelled request's budget outlasts the cancel.
ENGINE_BUDGETS = [8, 200, 9, 6]
# tests/test_torch_preempt_spill.py's scenario (4 pool blocks) at int8 KV.
PREEMPT = dict(max_batch=2, max_len=256, chunk=4, kv_layout="paged", preempt=True,
               kv_pool_blocks=4, kv_quant=True)
PREEMPT_ARMS = {"spill": 64, "drop": 0}
F32_ATOL = 1e-5
PAGED = dict(SYNC, kv_layout="paged")
FEATURE_CASES = {
    **{f"preempt_{arm}": {"kind": "preempt", "batcher": dict(PREEMPT, spill_capacity_mb=mb)}
       for arm, mb in PREEMPT_ARMS.items()},
    "deadline": {"kind": "deadline", "batcher": PAGED},
    "guard": {"kind": "guard", "batcher": dict(PAGED, mem_headroom_bytes=1,
                                               mem_capacity_bytes=1 << 50),
              "first": 2, "steps_before": 2, "budgets": [24, 24, 9, 6]},
    "roles": {"kind": "roles", "batcher": dict(PAGED, kv_pool_blocks=12)},
}
# Request 1 expires mid-decode: at fake second 3.5 of 40 tokens at 4 a step.
DEADLINE = {"deadline_budgets": [8, 40, 9, 6], "deadline_row": 1, "deadline_s": 3.5}
FLEET_ARGV = ENGINE_ARGV + ["--mesh_model", "2", "--fleet", "2", "--preempt",
                            "--spill_capacity_mb", "64"]
FLEET_BUDGETS = [40, 40, 9, 6]
KILL = 0


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def job():
    jp = jax.tree_util.tree_map(np.asarray, jchat.init_eventchat_params(JCFG,
                                                                        jax.random.PRNGKey(5)))
    job = {"kind": "serve", "trees": {"base": jp}, "vocab": {"base": JCFG.llama.vocab_size},
           "ids": [PREFIX + [-200, 9, 9], PREFIX + [-200, 7, 7, 8, 14], PREFIX + [-200, 11],
                   [3, -200, 12, 40]],
           "pixels": [_pv(i) for i in range(4)], "budgets": [8, 7, 9, 6],
           "prefix_ids": PREFIX, **DEADLINE,
           "preempt_reqs": [([1, 5, -200, 9, 9], _pv(0), 40), ([3, -200, 11, 4], _pv(1), 12)]}
    job["cases"] = ([{"name": n, "mesh": (1, 1, 2), **c} for n, c in CASES.items()]
                    + [{"name": "engine", "mesh": (1, 1, 2), "engine": True, "cancel": CANCEL,
                        "budgets": ENGINE_BUDGETS, "argv": ENGINE_ARGV + ["--mesh_model", "2"]}]
                    + [{"name": n, "mesh": (1, 1, 2), **c} for n, c in FEATURE_CASES.items()]
                    + [{"name": "fleet_engine", "mesh": (1, 1, 2), "engine": True, "kill": KILL,
                        "budgets": FLEET_BUDGETS, "argv": FLEET_ARGV}])
    return job


@pytest.fixture(scope="module")
def started(job, tmp_path_factory):
    """The world starts at once; the test process computes its references
    while the ranks run."""
    return start_world(job, 2, tmp_path_factory.mktemp("mesh_serve"))


@pytest.fixture(scope="module")
def tree(job, started):
    return params_from_jax(job["trees"]["base"], tcfg.EventChatConfig.tiny(), torch.float32,
                           "cpu")


@pytest.fixture(scope="module")
def references(job, tree, started):
    """The unsharded port's and the JAX batcher's runs of the feature cases,
    computed while the world runs."""
    cfg = tcfg.EventChatConfig.tiny()

    def port(**kw):
        return ContinuousBatcher(tree, cfg, device="cpu", eos_token_id=None, **kw)

    def jax_srv(**kw):
        return JaxBatcher(job["trees"]["base"], JCFG, eos_token_id=None, **kw)

    ref = {}
    for arm in PREEMPT_ARMS:
        kw = FEATURE_CASES[f"preempt_{arm}"]["batcher"]
        srv, jsrv = port(**kw), jax_srv(**kw)
        srv._recompute_flops_per_s = jsrv._recompute_flops_per_s = 1.0
        runs = watch_runs(srv)
        ref[f"preempt_{arm}"] = {"port": {**run_preempt(srv, job, twork.SLO), "runs": runs,
                                          "param_count": srv._spill_param_count},
                                 "jax": run_preempt(jsrv, job, jwork.SLO)}
    clock = {"t": 0.0}
    srv = port(**PAGED)
    srv._clock = lambda: clock["t"]
    full = port(**PAGED)
    ref["deadline"] = {"port": run_deadline(srv, job, clock),
                       "full": run_batcher(full, job, {"budgets": job["deadline_budgets"]})}
    ref["guard"] = {"port": run_batcher(port(**PAGED), job, FEATURE_CASES["guard"])}
    kw = FEATURE_CASES["roles"]["batcher"]
    ref["roles"] = {"port": run_roles(port(role="prefill", **kw), port(role="decode", **kw), job),
                    "jax": run_roles(jax_srv(role="prefill", **kw), jax_srv(role="decode", **kw),
                                     job)}
    args = cli_serve.build_parser().parse_args(ENGINE_ARGV)
    tcfg_, params, tok = infer.load_model("tiny-random", "float32", None, None, "cpu")
    tcfg_, params = infer.prepare_model(tcfg_, params, tok, args)
    ref["fleet_engine"] = run_batcher(cli_serve.make_batcher(args, params, tcfg_, tok, "cpu"),
                                      job, {"budgets": FLEET_BUDGETS})
    return ref


@pytest.fixture(scope="module")
def world(job, started, references):
    return job, finish_world(started, 240)


@pytest.fixture(scope="module")
def jax_chains(world):
    """The JAX server's chains of every case, at the same settings and in
    the same order of submits and steps."""
    job, _ = world
    return {name: run_batcher(JaxBatcher(job["trees"]["base"], JCFG, eos_token_id=None,
                                         **CASES[name]["batcher"]), job, CASES[name],
                              warmup=False)
            for name in JAX_CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_batcher_equals_jax_and_unsharded_port(world, jax_chains, name):
    job, ranks = world
    case = CASES[name]
    got = [r[name]["chains"] for r in ranks]
    assert got[0] == got[1]
    assert [r[name]["kv_heads"] for r in ranks] == [1, 1]
    cfg = tcfg.EventChatConfig.tiny()
    tp = params_from_jax(job["trees"]["base"], cfg, torch.float32, "cpu")
    srv = ContinuousBatcher(tp, cfg, device="cpu", eos_token_id=None, **case["batcher"])
    assert got[0] == run_batcher(srv, job, case)
    if name in JAX_CASES:
        assert got[0] == jax_chains[name]


def test_cli_engine_with_a_follower_rank(world):
    job, ranks = world
    lead, follow = ranks[0]["engine"], ranks[1]["engine"]
    args = cli_serve.build_parser().parse_args(ENGINE_ARGV)
    cfg, params, tok = infer.load_model("tiny-random", "float32", None, None, "cpu")
    cfg, params = infer.prepare_model(cfg, params, tok, args)
    srv = cli_serve.make_batcher(args, params, cfg, tok, "cpu")
    want = run_batcher(srv, job, {"budgets": ENGINE_BUDGETS})
    for i, (chain, status) in enumerate(zip(lead["chains"], lead["statuses"])):
        if i == CANCEL:
            assert status == "cancelled" and chain == want[i][:len(chain)]
        else:
            assert status == "ok" and chain == want[i], i
    assert follow["follower_steps"] == lead["leader_steps"] > 0


def test_mesh_refusals_name_the_roadmap_item():
    from eventgpt_tpu_torch.config import MeshConfig
    from eventgpt_tpu_torch.parallel.mesh import Mesh

    cfg = tcfg.EventChatConfig.tiny()
    mesh = Mesh(MeshConfig(), torch.device("cpu"))
    tp = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5))), cfg,
        torch.float32, "cpu")
    srv = ContinuousBatcher(tp, cfg, device="cpu", mesh=mesh, kv_layout="paged", preempt=True,
                            spill_capacity_mb=8, role="decode", mem_headroom_bytes=1 << 20)
    rid = srv.submit([1, -200, 3], _pv(0), 4, deadline_s=1.0)
    assert srv.queue[-1].rid == rid and srv.queue[-1].deadline is not None
    with pytest.raises(ValueError, match="context=1"):
        ContinuousBatcher(tp, cfg, device="cpu", mesh=Mesh(MeshConfig(context=2),
                                                           torch.device("cpu")))


def _heads(x, rank: int):
    """Rank ``rank``'s KV heads (1 of 2, axis 3) of a whole record plane."""
    if isinstance(x, dict):
        return {k: _heads(v, rank) for k, v in x.items()}
    n = x.shape[3] // 2
    return x[:, :, :, rank * n:(rank + 1) * n]


def _assert_same_planes(got, want, where):
    """The record bars of tests/test_torch_preempt_spill.py: int8 payloads
    bit-equal, f32 planes within F32_ATOL."""
    if isinstance(want, dict):
        np.testing.assert_array_equal(got["q"], want["q"], err_msg=where)
        np.testing.assert_allclose(got["s"], want["s"], rtol=0, atol=F32_ATOL, err_msg=where)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL, err_msg=where)


@pytest.mark.parametrize("arm", list(PREEMPT_ARMS))
def test_mesh_preemption_equals_unsharded_and_jax(world, references, arm):
    """Chains and the state after every step on both ranks equal the
    unsharded port's and the JAX batcher's; rank 1's planted price loses."""
    _, ranks = world
    name = f"preempt_{arm}"
    port, jx = references[name]["port"], references[name]["jax"]
    got = [r[name] for r in ranks]
    assert got[0]["chains"] == got[1]["chains"] == port["chains"] == jx["chains"]
    assert got[0]["trace"] == got[1]["trace"] == port["trace"] == jx["trace"]
    assert got[0]["param_count"] == got[1]["param_count"] == port["param_count"]
    pool = port["trace"][-1][6]
    assert port["trace"][-1][4] >= 1
    if arm == "spill":
        assert pool["spills"] >= 1 and pool["restores"] == pool["spills"]
        assert pool["spilled_runs"] == 0 and port["trace"][-1][7]["records"] == 0
    else:
        assert pool["spills"] == 0


def test_mesh_spill_records_hold_each_ranks_heads(world, references):
    """Each rank's spill record is its KV heads of the unsharded record, the
    store counts the whole row's bytes, and the ranks spill and restore the
    same block ids as the unsharded pool."""
    _, ranks = world
    port = references["preempt_spill"]["port"]
    assert port["records"] and port["runs"]
    for r, rank in enumerate(ranks):
        got = rank["preempt_spill"]
        assert got["runs"] == port["runs"]
        assert sorted(got["records"]) == sorted(port["records"])
        for rid, (step, want) in port["records"].items():
            gstep, rec = got["records"][rid]
            where = f"rank {r} rid {rid}"
            assert gstep == step, where
            for key in ("length", "n_blocks", "nbytes_kv", "base_pos"):
                assert rec[key] == want[key], (where, key)
            for key in ("k", "v"):
                _assert_same_planes(rec[key], _heads(want[key], r), where)
            np.testing.assert_allclose(rec["logits"], want["logits"], rtol=0, atol=F32_ATOL,
                                       err_msg=where)


def test_mesh_deadline_expires_on_rank0s_clock(world, references):
    _, ranks = world
    port, full = references["deadline"]["port"], references["deadline"]["full"]
    row = DEADLINE["deadline_row"]
    for got in (ranks[0]["deadline"], ranks[1]["deadline"]):
        assert got == port
    assert port["statuses"][row] == STATUS_DEADLINE
    assert [s for i, s in enumerate(port["statuses"]) if i != row] == ["ok"] * 3
    chain = port["chains"][row]
    assert 0 < len(chain) < DEADLINE["deadline_budgets"][row]
    assert chain == full[row][:len(chain)]
    assert [c for i, c in enumerate(port["chains"]) if i != row] == \
        [c for i, c in enumerate(full) if i != row]


def test_mesh_guard_defers_on_every_rank(world, references):
    """Rank 1's inflated ledger defers the waves on both ranks at the same
    boundaries; the chains are the unsharded ones."""
    _, ranks = world
    a, b = ranks[0]["guard"], ranks[1]["guard"]
    assert a["deferrals"] == b["deferrals"] and a["deferrals"][-1] > 0
    assert a["chains"] == b["chains"] == references["guard"]["port"]


def test_mesh_roles_equal_unsharded(world, references):
    """Mesh prefill into mesh decode, and a one-device prefill's records into
    the mesh's decode, give the unsharded roles' chains; the mesh's records
    are the one-device records, whole."""
    _, ranks = world
    port = references["roles"]["port"]
    for got in (ranks[0]["roles"], ranks[1]["roles"]):
        assert got["chains"] == got["one_device_into_mesh"] == port["chains"]
    mesh_recs, one_recs = ranks[0]["roles"]["records"], port["records"]
    assert [r["rid"] for r in mesh_recs] == [r["rid"] for r in one_recs]
    for m, o in zip(mesh_recs, one_recs):
        for key in ("n_blocks", "n_total", "nbytes_kv", "base_pos"):
            assert m["rec"][key] == o["rec"][key], key
        for key in ("k", "v"):
            _assert_same_planes(m["rec"][key], o["rec"][key], f"rid {m['rid']} {key}")
        assert m["tokens"] == o["tokens"]


def test_mesh_records_splice_into_one_device_and_jax(world, job, tree, references):
    """The mesh prefill's whole records give the port's one-device decode
    batcher the unsharded chains and the JAX decode batcher the JAX
    chains."""
    _, ranks = world
    kw = dict(FEATURE_CASES["roles"]["batcher"], role="decode", eos_token_id=None)
    port_dec = ContinuousBatcher(tree, tcfg.EventChatConfig.tiny(), device="cpu", **kw)
    jax_dec = JaxBatcher(job["trees"]["base"], JCFG, **kw)
    recs = ranks[0]["roles"]["records"]
    for dec, want in ((port_dec, references["roles"]["port"]["chains"]),
                      (jax_dec, references["roles"]["jax"]["chains"])):
        rids = {out["rid"]: splice(dec, out) for out in recs}
        got = dec.run_until_drained()
        assert [got[rids[i]] for i in sorted(rids)] == want
    assert references["roles"]["jax"]["chains"] == references["roles"]["port"]["chains"]


def test_mesh_fleet_engine_kill(world, references):
    """``cli/serve --fleet 2`` on the mesh: a replica killed mid-decode, its
    requests re-decoded on the survivor; each replica's follower ran rank
    0's steps and saw the kill."""
    _, ranks = world
    lead, follow = ranks[0]["fleet_engine"], ranks[1]["fleet_engine"]
    assert lead["statuses"] == ["ok"] * len(FLEET_BUDGETS)
    assert lead["chains"] == references["fleet_engine"]
    assert lead["moved"] >= 1 and set(lead["replicas"]) == {1 - KILL}
    assert follow["follower_steps"] == lead["leader_steps"] and min(lead["leader_steps"]) > 0
    assert follow["follower_kills"] == [int(i == KILL) for i in range(2)]


def test_mesh_estimate_equals_jax():
    """The static model at mesh (model 2) with the spill store: every
    component the JAX estimate counts is equal, whole and per device; the
    spill budget splits like the pool."""
    kw = dict(max_batch=2, max_len=256, kv_quant=True, dtype_bytes=4, kv_layout="paged",
              kv_pool_blocks=9, mesh_shape={"data": 1, "fsdp": 1, "model": 2},
              weights_bytes=1 << 20)
    got = tmemory.estimate(tcfg.EventChatConfig.tiny(), spill_capacity_bytes=64 << 20, **kw)
    want = jmemory.estimate(JCFG, **kw)
    for view in ("components", "per_device"):
        assert {k: v for k, v in got[view].items() if k != "spill"} == want[view]
    assert got["per_device"]["spill"] == (64 << 20) // got["divisors"]["kv_heads"] == 32 << 20


def test_agreements_on_one_device_run_no_collective():
    from eventgpt_tpu_torch.config import MeshConfig
    from eventgpt_tpu_torch.parallel.mesh import AGREEMENTS, Mesh

    mesh = Mesh(MeshConfig(), torch.device("cpu"))
    n = AGREEMENTS["count"]
    assert mesh.agree(2.5) == 2.5 and mesh.agree_max(3) == 3 and mesh.agree({"a": 1}) == {"a": 1}
    rep = mesh.replica()
    assert rep is not mesh and rep.shape == mesh.shape and rep.control is None
    assert AGREEMENTS["count"] == n
