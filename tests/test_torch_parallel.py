"""The port's parallel layer (``eventgpt_tpu_torch/parallel``) against the
JAX package's, on the CPU, with no process spawned.

- ``AXES``, ``make_mesh``'s errors, and ``best_mesh_config`` equal to the
  JAX arithmetic over a sweep of device counts.
- Each spec tree mirrors the port's parameter tree: dense, int8, int4,
  fused, LoRA and Q-Former.
- ``serving_divisors`` and ``serving_batch_axes`` equal the JAX ones over a
  sweep of mesh shapes and batches, and so does
  ``obs/memory.estimate(mesh_shape=)``.
- ``initialize_distributed``: a half-configured launch raises and a single
  process is a no-op.
- The local blocks that ``shard_params_for_serving`` gives every rank
  coordinate, concatenated back, equal the whole tree (fused and int4 leaves
  included); an int4 leaf's scale rows follow its rows.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.obs import memory as jmemory
from eventgpt_tpu.parallel import mesh as jmesh
from eventgpt_tpu.parallel import serving as jserving
from eventgpt_tpu.parallel import sharding as jsharding
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models.convert import init_eventchat_params
from eventgpt_tpu_torch.obs import memory as tmemory
from eventgpt_tpu_torch.ops import quant as tquant
from eventgpt_tpu_torch.parallel import dist as tdist
from eventgpt_tpu_torch.parallel import mesh as tmesh
from eventgpt_tpu_torch.parallel import serving as tserving
from eventgpt_tpu_torch.parallel import sharding as tsharding
from eventgpt_tpu_torch.train import lora as tlora

CPU = torch.device("cpu")


def test_axes_and_make_mesh_errors():
    assert tmesh.AXES == jmesh.AXES
    with pytest.raises(ValueError, match="needs 2 ranks, have 1.*torch.distributed.run"):
        tmesh.make_mesh(tcfg.MeshConfig(model=2), "cpu")
    one = tmesh.make_mesh(tcfg.MeshConfig(), "cpu")
    assert one.shape == {"data": 1, "fsdp": 1, "context": 1, "model": 1}
    assert one.backend is None and one.rank == 0 and one.device_mesh is None
    assert tmesh.single_device_mesh("cpu").shape == one.shape
    assert tserving.build_serving_mesh(1, 1, 1, "cpu") is None
    with pytest.raises(ValueError, match="context=1"):
        tserving._require_serving_mesh(tmesh.Mesh(tcfg.MeshConfig(context=2), CPU))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32, 64, 256])
def test_best_mesh_config_equals_jax(n):
    for model in (1, 2, 4):
        for context in (1, 2):
            for pref in (8, 4, 1):
                kw = dict(fsdp_pref=pref, model=model, context=context)
                try:
                    want = dataclasses.asdict(jmesh.best_mesh_config(n, **kw))
                except ValueError:
                    with pytest.raises(ValueError):
                        tmesh.best_mesh_config(n, **kw)
                    continue
                assert dataclasses.asdict(tmesh.best_mesh_config(n, **kw)) == want


def _tree(cfg, qformer=False):
    cfg = dataclasses.replace(cfg, use_event_qformer=qformer,
                              qformer=tcfg.QFormerConfig(num_queries=4, num_layers=2,
                                                         num_heads=2, hidden_size=64,
                                                         mlp_ratio=2))
    return cfg, init_eventchat_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")


def _mirrors(params, specs, path="params"):
    """The spec tree has the parameter tree's structure; each tensor leaf
    has a spec of its rank; a composite leaf (int8, int4, LoRA) has one
    two-entry spec."""
    if tquant.is_quantized(params) or tquant.is_quantized4(params) or tquant.is_lora(params):
        assert isinstance(specs, tsharding.P) and len(specs) == 2, path
        return
    if isinstance(params, dict):
        assert isinstance(specs, dict) and set(specs) == set(params), (path, set(specs),
                                                                       set(params))
        for k in params:
            _mirrors(params[k], specs[k], f"{path}.{k}")
    elif isinstance(params, list):
        assert isinstance(specs, list) and len(specs) == len(params), path
        for i, (p, s) in enumerate(zip(params, specs)):
            _mirrors(p, s, f"{path}[{i}]")
    else:
        assert isinstance(specs, tsharding.P) and len(specs) == params.ndim, (path, specs,
                                                                             params.shape)


@pytest.mark.parametrize("variant", ["dense", "int8", "int4", "fused", "lora", "qformer"])
def test_spec_trees_mirror_the_param_trees(variant):
    cfg, tree = _tree(tcfg.EventChatConfig.tiny(), qformer=variant == "qformer")
    lp = tree["llama"]
    if variant == "fused":
        tllama.fuse_llama_params(lp)
    if variant in ("int8", "int4"):
        tquant.quantize_llama_params(lp, bits=8 if variant == "int8" else 4)
    if variant == "lora":
        lc = tlora.LoraConfig(r=4)
        tree["llama"] = lp = tlora.apply_lora(
            lp, tlora.init_lora_params(cfg.llama, lc, torch.Generator().manual_seed(1)), lc)
    specs = tsharding.eventchat_param_specs(cfg)
    assert ("qformer" in specs) == (variant == "qformer")
    specs["llama"] = tserving.serving_llama_specs(lp, cfg.llama, {"model": 2, "fsdp": 2})
    _mirrors(tree, specs)
    # The spec of a dense leaf is the JAX spec transposed, less the layer axis.
    jspec = jax.tree_util.tree_map(tuple, jsharding.llama_param_specs(),
                                   is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    port = tsharding.llama_param_specs(cfg.llama.num_layers)
    assert tuple(port["layers"][0]["q_proj"]) == jspec["layers"]["attn"]["q"][1:][::-1]
    assert tuple(port["layers"][0]["down_proj"]) == jspec["layers"]["mlp"]["down"][1:][::-1]
    assert tuple(port["lm_head"]) == jspec["lm_head"][::-1]
    assert tuple(port["embed_tokens"]) == jspec["embed_tokens"]


MESH_SHAPES = [{"data": d, "fsdp": f, "model": m} for d in (1, 2, 4) for f in (1, 2, 8)
               for m in (1, 2, 4)]


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: "d{data}f{fsdp}m{model}".format(**s))
def test_serving_divisors_and_batch_axes_equal_jax(shape):
    fake = types.SimpleNamespace(shape=dict(shape, context=1))
    for batch in (1, 2, 3, 4, 6, 8, 16):
        assert tserving.serving_batch_axes(shape, batch) == jserving.serving_batch_axes(fake,
                                                                                        batch)
        for kv in (1, 2, 4, 8, 32, 40):
            assert (tserving.serving_divisors(kv, shape, batch)
                    == jserving.serving_divisors(kv, shape, batch))


@pytest.mark.parametrize("preset", ["tiny", "7b"])
def test_memory_estimate_with_a_mesh_equals_jax(preset):
    tc = tcfg.EventChatConfig.tiny() if preset == "tiny" else tcfg.EventChatConfig.eventgpt_7b()
    jc = jcfg.EventChatConfig.tiny() if preset == "tiny" else jcfg.EventChatConfig.eventgpt_7b()
    for shape in ({"model": 2}, {"data": 2, "fsdp": 2, "model": 2}, {"fsdp": 4}):
        for kw in (dict(kv_layout="dense"), dict(kv_layout="paged", kv_quant=True),
                   dict(speculative=4, prefix_cache_bytes=1 << 20, weights_bytes=1 << 30)):
            args = dict(max_batch=4, max_len=1024, mesh_shape=shape, **kw)
            want, got = jmemory.estimate(jc, **args), tmemory.estimate(tc, **args)
            for key in ("divisors", "per_device", "per_device_total_bytes", "components"):
                assert got[key] == want[key], (shape, kw, key)


def test_initialize_distributed_refuses_half_launches(monkeypatch):
    for var in tdist.LAUNCHER_VARS + ("EGPT_COORDINATOR", "EGPT_NUM_PROCESSES",
                                      "EGPT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize_distributed(backend="gloo") is False
    assert tdist.is_primary()
    tdist.barrier()
    monkeypatch.setenv("EGPT_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="EGPT_COORDINATOR"):
        tdist.initialize_distributed(backend="gloo")
    monkeypatch.delenv("EGPT_NUM_PROCESSES")
    monkeypatch.setenv("EGPT_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="EGPT_NUM_PROCESSES"):
        tdist.initialize_distributed(backend="gloo")
    assert tdist.default_backend("cuda") == "nccl" and tdist.default_backend("cpu") == "gloo"


# ---------------------------------------------------------- shard and back


def _ranks(shape):
    """A Mesh per rank coordinate of ``shape`` (no process group: slicing
    reads only the coordinates)."""
    out = []
    mc = tcfg.MeshConfig(data=shape.get("data", 1), fsdp=shape.get("fsdp", 1),
                         model=shape.get("model", 1))
    for f in range(mc.fsdp):
        for m in range(mc.model):
            mesh = tmesh.Mesh(mc, CPU)
            mesh.coord = {"data": 0, "fsdp": f, "context": 0, "model": m}
            out.append(mesh)
    return out


def _cat(parts, dim, blocks, n):
    """Concatenate the ranks' blocks of one dimension back: block by block
    for a fused leaf, a replicated block taken once (all equal)."""
    if n == 1:
        return parts[0]
    if blocks is None:
        return torch.cat(parts, dim)
    out, off = [], 0
    for rows, ax in blocks:
        local = rows // n if ax == "model" else rows
        pieces = [p.narrow(dim, off, local) for p in parts]
        if ax == "model":
            out.append(torch.cat(pieces, dim))
        else:
            assert all(torch.equal(p, pieces[0]) for p in pieces)
            out.append(pieces[0])
        off += local
    return torch.cat(out, dim)


def _whole(local_by_rank, ranks, spec, dims):
    """One tensor of a leaf back from every rank's block: ``dims`` maps the
    dense spec's (out, in) entries onto the tensor's dimensions (None: the
    entry splits no dimension of this tensor)."""
    nf, nm = ranks[0].shape["fsdp"], ranks[0].shape["model"]
    grid = {(r.coord["fsdp"], r.coord["model"]): t for r, t in zip(ranks, local_by_rank)}
    blocks = getattr(spec, "blocks", None)

    def split_axes(entry):
        return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))

    out_ax, in_ax = split_axes(spec[0]), split_axes(spec[1])
    rows = []
    for m in range(nm):
        cols = [grid[f, m] for f in range(nf)]
        dim = dims[1] if "fsdp" in in_ax else dims[0] if "fsdp" in out_ax else None
        rows.append(torch.cat(cols, dim) if dim is not None and nf > 1 else cols[0])
    if "model" in out_ax or blocks is not None:
        return _cat(rows, dims[0], blocks, nm)
    if "model" in in_ax and dims[1] is not None:
        return torch.cat(rows, dims[1])
    assert all(torch.equal(r, rows[0]) for r in rows)
    return rows[0]


@pytest.mark.parametrize("variant", ["dense", "fused", "int8", "int4", "int4_g16",
                                     "fused_int4", "lora"])
@pytest.mark.parametrize("shape", [{"fsdp": 2, "model": 2}, {"model": 4}], ids=["f2m2", "m4"])
def test_local_shards_concatenate_back_to_the_tree(variant, shape):
    cfg, tree = _tree(tcfg.EventChatConfig.tiny())
    lp = tree["llama"]
    if variant.startswith("fused"):
        tllama.fuse_llama_params(lp)
    if "int4" in variant or variant == "int8":
        tquant.quantize_llama_params(lp, bits=8 if variant == "int8" else 4,
                                     group=16 if variant == "int4_g16" else 128)
    if variant == "lora":
        lc = tlora.LoraConfig(r=4)
        tree["llama"] = lp = tlora.apply_lora(
            lp, tlora.init_lora_params(cfg.llama, lc, torch.Generator().manual_seed(1)), lc)
    ranks = _ranks(shape)
    shards = [tserving.shard_params_for_serving(tree, cfg, mesh) for mesh in ranks]
    assert all(s["llama"]["vocab_size"] == cfg.llama.vocab_size for s in shards)
    specs = tserving.serving_llama_specs(lp, cfg.llama, ranks[0].shape)
    for s in shards:  # the vision side replicates
        torch.testing.assert_close(s["clip"]["patch_embedding"], tree["clip"]["patch_embedding"],
                                   rtol=0, atol=0)

    def check(whole, locals_, spec, where):
        if tquant.is_quantized(whole) or tquant.is_quantized4(whole):
            key = "q4" if "q4" in whole else "q"
            got = _whole([x[key] for x in locals_], ranks, spec, (1, 0))
            assert torch.equal(got, whole[key]), where
            # A scale's output channels split as the payload's; over K it
            # replicates, but for the groups of a rank's rows where model
            # splits K (one row each where a single group covers them).
            in_entry = "model" if spec[1] == "model" else None
            sspec = (tserving.Fused(tsharding.P(spec[0], in_entry), spec.blocks)
                     if isinstance(spec, tserving.Fused) else tsharding.P(spec[0], in_entry))
            got_s = _whole([x["s"] for x in locals_], ranks, sspec, (1, 0))
            if got_s.shape[0] != whole["s"].shape[0]:
                got_s = got_s[::got_s.shape[0] // whole["s"].shape[0]]
            assert torch.equal(got_s, whole["s"]), where
        elif tquant.is_lora(whole):
            check(whole["w"], [x["w"] for x in locals_], spec, where + ".w")
            assert all(x["a"].shape[1] == x["b"].shape[0] for x in locals_)
        else:
            assert torch.equal(_whole(locals_, ranks, spec, (0, 1)), whole), where

    for i, (layer, lspec) in enumerate(zip(lp["layers"], specs["layers"])):
        for name, leaf in layer.items():
            if name.endswith("layernorm"):
                continue
            check(leaf, [s["llama"]["layers"][i][name] for s in shards], lspec[name],
                  f"layers[{i}].{name}")
    for name in ("embed_tokens", "lm_head"):
        check(lp[name], [s["llama"][name] for s in shards], specs[name], name)


def test_int4_scale_rows_follow_the_rank_rows():
    """Row-parallel int4 (o, down: model splits K): with a group that
    divides the rank's K each rank holds its own groups; with one group
    over all of K each holds that group."""
    k, n = 64, 32
    w = torch.randn(n, k, generator=torch.Generator().manual_seed(3))
    for group, want_rows in ((16, 2), (64, 1)):
        leaf = tquant.quantize_tensor4(w.T, group)
        ranks = _ranks({"model": 2})
        got = [tserving._shard_leaf(leaf, tsharding.P("fsdp", "model"), m, None) for m in ranks]
        for r, g in enumerate(got):
            assert g["s"].shape == (want_rows, n)
            lo = r * (k // 2) // group
            assert torch.equal(g["s"], leaf["s"][lo:lo + want_rows])


def test_kv_cache_and_batch_placement_concatenate_back():
    """``shard_kv_cache`` splits a dense cache's rows over the serving batch
    axes and its KV heads over ``model`` (a paged arena only its heads; its
    table and lengths every rank keeps); ``shard_batch_array`` and
    ``batch_rows`` give each rank its rows; ``place_carry`` replicates the
    scheduler's carry (the port's batcher runs every row on every rank)."""
    cfg = tcfg.EventChatConfig.tiny().llama
    dense = tllama.init_kv_cache(cfg, 4, 8, dtype=torch.float32, device="cpu", quant=True)
    for name in ("k", "v"):
        dense[name]["q"].random_(-100, 100)
        dense[name]["s"].uniform_()
    dense["length"].copy_(torch.arange(4))
    paged = tllama.init_paged_kv_cache(cfg, 2, 128, 5, 64, dtype=torch.float32, device="cpu")
    paged["k"].normal_()
    shape = {"data": 2, "model": 2}
    mc = tcfg.MeshConfig(data=2, model=2)
    meshes = []
    for d in range(2):
        for m in range(2):
            mesh = tmesh.Mesh(mc, CPU)
            mesh.coord = {"data": d, "fsdp": 0, "context": 0, "model": m}
            meshes.append(mesh)
    local = [tserving.shard_kv_cache(dense, cfg, mesh) for mesh in meshes]
    assert tserving.serving_batch_axes(shape, 4) == ("data",)
    rows = [torch.cat([local[2 * d + m]["k"]["q"] for m in range(2)], dim=3) for d in range(2)]
    assert torch.equal(torch.cat(rows, dim=1), dense["k"]["q"])
    assert torch.equal(torch.cat([local[0]["length"], local[2]["length"]]), dense["length"])
    lp = [tserving.shard_kv_cache(paged, cfg, mesh) for mesh in meshes]
    assert torch.equal(torch.cat([lp[0]["k"], lp[1]["k"]], dim=3), paged["k"])
    assert all(torch.equal(x["bt"], paged["bt"]) for x in lp)
    assert tserving.prefix_block_sharding(meshes[0], cfg)[3] == "model"
    x = np.arange(12).reshape(4, 3)
    got = [tserving.shard_batch_array(x, mesh) for mesh in meshes]
    assert [list(tserving.batch_rows(mesh, 4)) for mesh in meshes] == [[0, 1]] * 2 + [[2, 3]] * 2
    assert torch.equal(torch.cat([got[0], got[2]]), torch.as_tensor(x))
    frozen, n_rem, base = tserving.place_carry(meshes[3], 4, np.zeros(4, bool), np.ones(4), None)
    assert frozen.shape == (4,) and n_rem.shape == (4,) and base is None
    assert tserving.replicate({"a": [np.ones(2)]}, meshes[0])["a"][0].device == CPU
