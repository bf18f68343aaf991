"""The port's ``generate`` on a serving mesh: one spawned world of 4 CPU
ranks over ``gloo`` (``tests/torch_mesh_ranks.py``).

At ``EventChatConfig.tiny()`` in f32, on the meshes (data 2, model 2),
(fsdp 2, model 2) and (model 4) -- 4 does not divide the 2 KV heads, so
the cache replicates and each rank maps its q head onto its KV head --
greedy chains equal the unsharded port's token for token, and the JAX
package's (``tests/test_torch_generate.py`` and the other parity files
hold the unsharded port to the JAX package on every variant; here the
JAX side runs the base variants itself). Variants: batch 4 and batch 1
(pure tensor parallelism), int8 weights with the int8 KV cache, int4 (a
group of 16, so a rank of model 2 takes 2 of the 4 groups of a
row-parallel leaf), fused leaves, beam search, speculative lookup and
Medusa drafts, an odd vocab (its vocab dim replicates), and sampled decode,
which every rank draws alike (``serving.gather_batch`` raises when ranks
holding the same rows disagree). Prefill logits agree with the unsharded
port's within ``LOGIT_ATOL``. Once, the JAX side runs sharded on 4 of the
conftest's virtual CPU devices, as ``tests/test_sharded_generate.py``
does.
"""

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.ops.quant import quantize_llama_params as jquant
from eventgpt_tpu.parallel.mesh import make_mesh as jmake_mesh
from eventgpt_tpu.parallel.serving import shard_params_for_serving as jshard
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.ops import quant as tquant
from torch_mesh_ranks import run_world

VOCAB = {"base": 256, "odd": 259}
NEW = 8
# f32 prefill logits of a rank against the unsharded port's: the all-reduce
# over ``model`` only reorders f32 sums.
LOGIT_ATOL = 1e-4
MESHES = {"dm": (2, 1, 2), "fm": (1, 2, 2), "m4": (1, 1, 4)}
MEDUSA_HEADS = 3

CASES = [
    ("greedy_b4", {}),
    ("greedy_b1", {"batch": 1}),
    ("int8_kv8", {"quant": 8, "gen": {"kv_quant": True}}),
    ("int4", {"quant": 4, "group": 16}),
    ("fused", {"fuse": True}),
    ("beam", {"batch": 2, "gen": {"num_beams": 3}}),
    ("spec_lookup", {"gen": {"speculative": 3}}),
    ("spec_medusa", {"gen": {"speculative": 3, "medusa": True}}),
    ("odd_vocab", {"tree": "odd"}),
    ("sampled", {"gen": {"temperature": 0.8, "top_p": 0.9, "seed": 5}}),
]
JAX_CASES = ("greedy_b4", "greedy_b1", "odd_vocab", "beam")


def _inputs(batch=4, seed=0):
    rng = np.random.default_rng(seed)
    size = 28
    pixels = rng.standard_normal((batch, 5, 3, size, size)).astype(np.float32)
    ids = [[1, 5 + i, 9, -200, 17, 23 + i, 40 + 2 * i][: 7 - (i % 2)] + [60 + i] * (i + 1)
           for i in range(batch)]
    return ids, pixels


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    trees = {}
    for name, v in VOCAB.items():
        cfg = jcfg.EventChatConfig.tiny(vocab_size=v)
        trees[name] = jax.tree_util.tree_map(
            np.asarray, jchat.init_eventchat_params(cfg, jax.random.PRNGKey(1)))
    ids, pixels = _inputs()
    medusa = (np.random.default_rng(2).standard_normal((MEDUSA_HEADS, 64, 64)) * 0.05
              ).astype(np.float32)
    cases = []
    for mesh_name, shape in MESHES.items():
        for name, case in CASES:
            cases.append({"name": f"{mesh_name}/{name}", "mesh": shape, "gen": {}, **case})
        cases.append({"name": f"{mesh_name}/logits", "mesh": shape, "logits": True})
    job = {"kind": "generate", "trees": trees, "vocab": VOCAB, "ids": ids, "pixels": pixels,
           "medusa": medusa, "cases": cases, "new": NEW}
    ranks = run_world(job, 4, tmp_path_factory.mktemp("mesh_generate"), timeout_s=150)
    return job, ranks


def _port(job, case):
    cfg = tcfg.EventChatConfig.tiny(vocab_size=VOCAB[case.get("tree", "base")])
    tp = params_from_jax(job["trees"][case.get("tree", "base")], cfg, torch.float32, "cpu")
    if case.get("fuse"):
        tllama.fuse_llama_params(tp["llama"])
    if case.get("quant"):
        tquant.quantize_llama_params(tp["llama"], bits=case["quant"],
                                     group=case.get("group", 128))
    return cfg, tp


def _gen_kwargs(job, case):
    kw = dict(case.get("gen", {}))
    if kw.pop("medusa", False):
        kw["draft_head"] = {"w": torch.from_numpy(job["medusa"])}
    return kw


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_sharded_chains_equal_unsharded_port(world, name):
    job, ranks = world
    case = dict(CASES)[name]
    b = case.get("batch", 4)
    ids, pixels = job["ids"][:b], job["pixels"][:b]
    cfg, tp = _port(job, case)
    want = tchat.generate(tp, cfg, ids, pixels, max_new_tokens=NEW, eos_token_id=None,
                          device="cpu", **_gen_kwargs(job, case))
    for mesh_name in MESHES:
        got = [r[f"{mesh_name}/{name}"]["ids"] for r in ranks]
        assert all(g == got[0] for g in got), f"{mesh_name}: ranks disagree"
        if name == "sampled":
            # The batch split draws each part's rows from its own stream.
            assert [len(row) for row in got[0]] == [NEW] * b
            continue
        assert got[0] == want, mesh_name


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_chains_equal_jax(world, name):
    job, ranks = world
    case = dict(CASES)[name]
    b = case.get("batch", 4)
    jc = jcfg.EventChatConfig.tiny(vocab_size=VOCAB[case.get("tree", "base")])
    kw = {k: v for k, v in case.get("gen", {}).items()}
    want = jchat.generate(job["trees"][case.get("tree", "base")], jc, job["ids"][:b],
                          job["pixels"][:b], max_new_tokens=NEW, eos_token_id=None, **kw)
    for mesh_name in MESHES:
        assert ranks[0][f"{mesh_name}/{name}"]["ids"] == want, mesh_name


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_prefill_logits_within_tolerance(world, mesh_name):
    job, ranks = world
    cfg, tp = _port(job, {})
    padded, mask, _ = tchat.prepare_prefill(tp, cfg, job["ids"], job["pixels"])
    cache = tllama.init_kv_cache(cfg.llama, padded.shape[0], padded.shape[1],
                                 dtype=padded.dtype, device="cpu")
    with torch.inference_mode():
        want, _ = tllama.prefill(tp["llama"], cfg.llama, padded, mask, cache, last_only=True)
    for r in ranks:
        got = r[f"{mesh_name}/logits"]
        np.testing.assert_allclose(got["logits"], want.numpy()[got["rows"]], atol=LOGIT_ATOL,
                                   rtol=0)


def test_jax_sharded_on_four_virtual_devices_equals_port(world):
    """The JAX package's own sharded path on 4 of the 8 virtual devices, at
    (data 2, model 2) with int8 weights: the port's (data 2, model 2) world
    gives its chains."""
    from eventgpt_tpu.config import MeshConfig

    job, ranks = world
    jc = jcfg.EventChatConfig.tiny(vocab_size=VOCAB["base"])
    tree = dict(job["trees"]["base"])
    tree["llama"] = jquant(tree["llama"], bits=8)
    mesh = jmake_mesh(MeshConfig(data=2, fsdp=1, context=1, model=2), devices=jax.devices()[:4])
    got = jchat.generate(jshard(tree, jc, mesh), jc, job["ids"], job["pixels"],
                         max_new_tokens=NEW, eos_token_id=None, kv_quant=True, mesh=mesh)
    assert ranks[0]["dm/int8_kv8"]["ids"] == got
