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
"""

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.serve import ContinuousBatcher as JaxBatcher
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer
from eventgpt_tpu_torch.cli import serve as cli_serve
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import ContinuousBatcher
from torch_mesh_ranks import run_world
from torch_mesh_serve import run_batcher

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


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jp = jax.tree_util.tree_map(np.asarray, jchat.init_eventchat_params(JCFG,
                                                                        jax.random.PRNGKey(5)))
    job = {"kind": "serve", "trees": {"base": jp}, "vocab": {"base": JCFG.llama.vocab_size},
           "ids": [PREFIX + [-200, 9, 9], PREFIX + [-200, 7, 7, 8, 14], PREFIX + [-200, 11],
                   [3, -200, 12, 40]],
           "pixels": [_pv(i) for i in range(4)], "budgets": [8, 7, 9, 6],
           "prefix_ids": PREFIX}
    job["cases"] = ([{"name": n, "mesh": (1, 1, 2), **c} for n, c in CASES.items()]
                    + [{"name": "engine", "mesh": (1, 1, 2), "engine": True, "cancel": CANCEL,
                        "budgets": ENGINE_BUDGETS, "argv": ENGINE_ARGV + ["--mesh_model", "2"]}])
    ranks = run_world(job, 2, tmp_path_factory.mktemp("mesh_serve"), timeout_s=120)
    return job, ranks


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
    srv = ContinuousBatcher(tp, cfg, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 8c"):
        srv.submit([1, -200, 3], _pv(0), 4, deadline_s=1.0)
    with pytest.raises(ValueError, match="context=1"):
        ContinuousBatcher(tp, cfg, device="cpu", mesh=Mesh(MeshConfig(context=2),
                                                           torch.device("cpu")))
