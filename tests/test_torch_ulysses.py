"""Ulysses attention of the port (``parallel/ulysses.py``) against the JAX package.

One spawned world of 4 CPU ranks over gloo runs every case; the inputs are
made from a seed with numpy. Each rank runs Ulysses on its blocks of the
global q/k/v (k/v with their own GQA head count) and backpropagates a
seeded cotangent; the gathered output and the rank's dq/dk/dv are held, in
f32 within 1e-5, to the JAX package's ``dense_reference_attention`` (k/v
repeated to the q heads) and its ``jax.vjp``:

- causal at (context 4), K1's plain version inside (``inner="flash"``);
- the GQA post-repeat branch at (context 2, model 2): 8 q heads, 4 KV heads;
- the pre-repeat fallback at (context 2): 4 q heads, 1 KV head;
- non-causal with padding at (data 2, context 2), ``inner="dense"``.

The (context 4) case is also held to JAX's own sharded
``ulysses_self_attention`` on its virtual CPU mesh, and a head count that
does not divide the context size raises the JAX package's ``ValueError``
text, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu.config import MeshConfig
from eventgpt_tpu.models.llama import _repeat_kv
from eventgpt_tpu.parallel import make_mesh
from eventgpt_tpu.parallel.ring import dense_reference_attention
from eventgpt_tpu.parallel.ulysses import ulysses_attention_shard_map, ulysses_self_attention
from eventgpt_tpu_torch.config import MeshConfig as TMeshConfig
from eventgpt_tpu_torch.parallel import ulysses as tulysses
from eventgpt_tpu_torch.parallel.mesh import Mesh
from torch_mesh_ranks import finish_world, start_world

ATOL = 1e-5
# name: (q shape, KV heads, valid lengths)
INPUTS = {"c4": ((1, 32, 8, 8), 8, None), "post": ((2, 16, 8, 8), 4, (9, 16)),
          "pre": ((2, 16, 4, 8), 1, None), "pad": ((2, 32, 4, 8), 4, (20, 32))}
CASES = [
    {"name": "context4_causal_flash", "mesh": (1, 1, 4, 1), "impl": "ulysses", "inputs": "c4"},
    {"name": "context2_model2_gqa_post_repeat", "mesh": (1, 1, 2, 2), "impl": "ulysses",
     "inputs": "post"},
    {"name": "context2_gqa_pre_repeat", "mesh": (1, 1, 2, 1), "impl": "ulysses",
     "inputs": "pre"},
    {"name": "data2_context2_noncausal_padding_dense", "mesh": (2, 1, 2, 1),
     "impl": "ulysses", "inputs": "pad", "causal": False, "inner": "dense"},
]


def _inputs(shape, kv_heads, lengths, seed):
    rng = np.random.default_rng(seed)
    b, s, h, hd = shape
    q, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kv_heads, hd)).astype(np.float32) for _ in range(2))
    lengths = lengths or (s,) * b
    valid = np.arange(s)[None, :] < np.array(lengths)[:, None]
    return {"q": q, "k": k, "v": v, "cot": cot, "valid": valid}


def _jax_reference(a, causal):
    rep = a["q"].shape[2] // a["k"].shape[2]

    def f(q, k, v):
        return dense_reference_attention(q, _repeat_kv(k, rep), _repeat_kv(v, rep),
                                         valid=jnp.asarray(a["valid"]), causal=causal)

    out, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(a["cot"]))
    return {"out": np.asarray(out), "dq": np.asarray(dq), "dk": np.asarray(dk),
            "dv": np.asarray(dv)}


def _block(x, block):
    for d, (i, n) in enumerate(block):
        step = x.shape[d] // n
        x = x[(slice(None),) * d + (slice(i * step, (i + 1) * step),)]
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    arrays = {name: _inputs(shape, kv, lengths, seed)
              for seed, (name, (shape, kv, lengths)) in enumerate(INPUTS.items())}
    job = {"kind": "train_mesh", "attention": arrays, "cases": CASES, "timeout_s": 90}
    started = start_world(job, 4, tmp_path_factory.mktemp("ulysses"))
    try:
        refs = {c["name"]: _jax_reference(arrays[c["inputs"]], c.get("causal", True))
                for c in CASES}
        mesh = make_mesh(MeshConfig(data=1, fsdp=1, context=4, model=1),
                         devices=jax.devices()[:4])
        a = arrays["c4"]
        refs["jax_sharded"] = np.asarray(ulysses_self_attention(
            *(jnp.asarray(a[n]) for n in "qkv"), mesh, valid=jnp.asarray(a["valid"]),
            causal=True))
    finally:
        ranks = finish_world(started, 120)
    return refs, ranks


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_ulysses_output_and_gradients_match_jax_dense_reference(world, case):
    refs, ranks = world
    want = refs[case]
    for r, rank in enumerate(ranks):
        got = rank[case]
        np.testing.assert_allclose(got["out"], want["out"], atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], _block(want[name], got["block"]), atol=ATOL,
                                       rtol=0, err_msg=f"rank {r} {name}")


def test_ulysses_matches_jax_sharded_ulysses_on_its_mesh(world):
    refs, ranks = world
    for rank in ranks:
        np.testing.assert_allclose(rank["context4_causal_flash"]["out"], refs["jax_sharded"],
                                   atol=ATOL, rtol=0)


def test_head_divisibility_raises_the_jax_error():
    """2 heads on a context of 4: both packages raise before any exchange,
    with one text."""
    q = np.zeros((1, 8, 2, 8), np.float32)
    valid = np.ones((1, 8), bool)
    jmesh = make_mesh(MeshConfig(data=1, fsdp=1, context=4, model=1), devices=jax.devices()[:4])
    with pytest.raises(ValueError) as jerr:
        ulysses_attention_shard_map(jmesh)(*(jnp.asarray(q),) * 3, valid, valid)
    tmesh = Mesh(TMeshConfig(context=4), torch.device("cpu"))
    t = torch.from_numpy(q[:, :2])
    tv = torch.ones((1, 2), dtype=torch.bool)
    with pytest.raises(ValueError) as terr:
        tulysses.ulysses_attention_shard_map(tmesh)(t, t, t, tv, tv)
    assert str(terr.value) == str(jerr.value)
    assert "must divide by context=4 (use ring attention otherwise)" in str(terr.value)
    assert tulysses.ulysses_attention_shard_map(tmesh).accepts_unrepeated_kv
