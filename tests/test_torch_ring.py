"""Ring attention of the port (``parallel/ring.py``) against the JAX package.

One spawned world of 4 CPU ranks over gloo runs every case; the inputs are
made from a seed with numpy. Each rank runs the ring on its blocks of the
global q/k/v (batch over (data, fsdp), sequence over ``context``, heads over
``model``) and backpropagates a seeded cotangent; the gathered output and
the rank's dq/dk/dv are held, in f32 within 1e-5, to the JAX package's
``dense_reference_attention`` and its ``jax.vjp`` at the same inputs:
causal at (context 4), causal with padding at (data 2, context 2), heads
over ``model`` at (context 2, model 2), and non-causal with padding at
(context 2). One case is held to JAX's own sharded ``ring_self_attention``
on its virtual CPU mesh (context 4). The port's ``dense_reference_attention``
equals the JAX one on the same inputs. Beside them, the training
collectives (``Mesh.all_to_all``, ``ppermute``, ``reduce_scatter`` and the
autograd forms of ``parallel/autograd.py``) on a context axis of 4, each
value and gradient against what numpy computes from every rank's inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu.config import MeshConfig
from eventgpt_tpu.parallel import make_mesh
from eventgpt_tpu.parallel.ring import dense_reference_attention, ring_self_attention
from eventgpt_tpu_torch.parallel import ring as tring
from torch_mesh_ranks import finish_world, start_world

ATOL = 1e-5
INPUTS = {"c4": ((2, 32, 4, 8), None), "pad": ((2, 32, 2, 8), (20, 32)),
          "heads": ((2, 16, 4, 8), (11, 16))}
CASES = [
    {"name": "context4_causal", "mesh": (1, 1, 4, 1), "impl": "ring", "inputs": "c4"},
    {"name": "data2_context2_padding", "mesh": (2, 1, 2, 1), "impl": "ring", "inputs": "pad"},
    {"name": "context2_model2", "mesh": (1, 1, 2, 2), "impl": "ring", "inputs": "heads"},
    {"name": "context2_noncausal_padding", "mesh": (1, 1, 2, 1), "impl": "ring",
     "inputs": "pad", "causal": False},
    {"name": "collectives_context4", "mesh": (1, 1, 4, 1), "axis": "context"},
]


def _inputs(shape, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    b, s = shape[:2]
    lengths = lengths or (s,) * b
    valid = np.arange(s)[None, :] < np.array(lengths)[:, None]
    return {"q": q, "k": k, "v": v, "cot": cot, "valid": valid}


def _jax_reference(a, causal):
    def f(q, k, v):
        return dense_reference_attention(q, k, v, valid=jnp.asarray(a["valid"]), causal=causal)

    out, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(a["cot"]))
    return {"out": np.asarray(out), "dq": np.asarray(dq), "dk": np.asarray(dk),
            "dv": np.asarray(dv)}


def _block(x, block):
    """The rank's block of a (B, S, H, hd) array: ``block`` holds (index,
    parts) for the batch, sequence and head dims."""
    for d, (i, n) in enumerate(block):
        step = x.shape[d] // n
        x = x[(slice(None),) * d + (slice(i * step, (i + 1) * step),)]
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    arrays = {name: _inputs(shape, lengths, seed)
              for seed, (name, (shape, lengths)) in enumerate(INPUTS.items())}
    job = {"kind": "train_mesh", "attention": arrays, "cases": CASES, "timeout_s": 90}
    started = start_world(job, 4, tmp_path_factory.mktemp("ring"))
    try:
        refs = {c["name"]: _jax_reference(arrays[c["inputs"]], c.get("causal", True))
                for c in CASES if "impl" in c}
        mesh = make_mesh(MeshConfig(data=1, fsdp=1, context=4, model=1),
                         devices=jax.devices()[:4])
        a = arrays["c4"]
        refs["jax_sharded"] = np.asarray(ring_self_attention(
            *(jnp.asarray(a[n]) for n in "qkv"), mesh, valid=jnp.asarray(a["valid"]),
            causal=True))
    finally:
        ranks = finish_world(started, 120)
    return arrays, refs, ranks


@pytest.mark.parametrize("case", [c["name"] for c in CASES if "impl" in c])
def test_ring_output_and_gradients_match_jax_dense_reference(world, case):
    arrays, refs, ranks = world
    want = refs[case]
    for r, rank in enumerate(ranks):
        got = rank[case]
        np.testing.assert_allclose(got["out"], want["out"], atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], _block(want[name], got["block"]), atol=ATOL,
                                       rtol=0, err_msg=f"rank {r} {name}")


def test_ring_matches_jax_sharded_ring_on_its_mesh(world):
    _, refs, ranks = world
    for rank in ranks:
        np.testing.assert_allclose(rank["context4_causal"]["out"], refs["jax_sharded"],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_reference_equals_jax(causal):
    a = _inputs((2, 12, 2, 8), (7, 12), 9)
    want = np.asarray(dense_reference_attention(*(jnp.asarray(a[n]) for n in "qkv"),
                                                valid=jnp.asarray(a["valid"]), causal=causal))
    got = tring.dense_reference_attention(*(torch.from_numpy(a[n]) for n in "qkv"),
                                          valid=torch.from_numpy(a["valid"]), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert (got.numpy()[0, 7:] == 0).all()


def _collectives(ranks):
    return [r["collectives_context4"] for r in ranks]


def test_all_to_all_ppermute_reduce_scatter_values(world):
    """Against numpy over every rank's input: rank c's all_to_all is block c
    of each rank's features, in rank order along the sequence; ppermute(+1)
    receives rank c-1's input; reduce_scatter keeps block c of the sum."""
    _, _, ranks = world
    got = _collectives(ranks)
    n = got[0]["n"]
    xs = [g["x"] for g in got]
    total = sum(xs)
    for c, g in enumerate(got):
        want = np.concatenate([np.split(x, n, axis=2)[c] for x in xs], axis=1)
        np.testing.assert_array_equal(g["all_to_all"], want)
        np.testing.assert_array_equal(g["ppermute"], xs[(c - 1) % n])
        np.testing.assert_array_equal(g["ppermute_back"], xs[(c + 1) % n])
        np.testing.assert_allclose(g["reduce_scatter"], np.split(total, n, axis=2)[c],
                                   atol=1e-6, rtol=0)


def test_autograd_collectives_give_the_transposed_gradients(world):
    """d/dx of sum(w * f(x)) over every rank: all_to_all's is the inverse
    exchange of w, ppermute(+1)'s the next rank's w, copy_to's the sum of
    w, reduce_from's w itself, gather_from's its own block of w."""
    _, _, ranks = world
    got = _collectives(ranks)
    n = got[0]["n"]
    for c, g in enumerate(got):
        want = np.concatenate([np.split(h["w_a2a"], n, axis=1)[c] for h in got], axis=2)
        np.testing.assert_array_equal(g["grad_a2a"], want)
        np.testing.assert_array_equal(g["grad_ppermute"], got[(c + 1) % n]["w2"])
        np.testing.assert_allclose(g["grad_copy_to"], sum(h["w2"] for h in got), atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(g["grad_reduce_from"], g["w2"])
        np.testing.assert_array_equal(g["grad_gather_from"], np.split(g["w3"], n, axis=1)[c])
