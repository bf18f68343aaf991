"""The paged KV layout of the PyTorch port against the JAX package: the
block allocator, the paged cache and one decode step over it, and K3's
plain version (int8 decode attention over the paged arena).

Inputs are made with numpy from seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve_blocks as jblocks
from eventgpt_tpu.models import llama as jllama
from eventgpt_tpu.ops.decode_attention import decode_attention_int8_paged as j_paged
from eventgpt_tpu.ops.decode_attention import \
    decode_attention_int8_paged_reference as j_paged_ref
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import serve_blocks as tblocks
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models.convert import kv_cache_from_jax, llama_params_from_jax
from eventgpt_tpu_torch.ops import decode_attention as da

JL = jcfg.EventChatConfig.tiny().llama
TL = tcfg.EventChatConfig.tiny().llama


# -- the block allocator -----------------------------------------------------


def test_block_pool_hands_out_the_jax_pools_ids():
    """A seeded random sequence of alloc / incref / decref gets the same
    block ids, the same refusals and the same free list from both pools."""
    rng = np.random.default_rng(11)
    jp, tp = jblocks.BlockPool(33, 64), tblocks.BlockPool(33, 64)
    held = []
    for _ in range(1500):
        op = int(rng.integers(0, 3))
        if op == 0:
            n = int(rng.integers(1, 6))
            got = jp.alloc(n)
            assert tp.alloc(n) == got
            held += got or []
        elif op == 1 and held:
            b = held[int(rng.integers(len(held)))]
            jp.incref([b])
            tp.incref([b])
            held.append(b)
        elif op == 2 and held:
            b = held.pop(int(rng.integers(len(held))))
            assert tp.decref([b]) == jp.decref([b])
        assert tp.free_blocks() == jp.free_blocks()
        assert tp._free == jp._free
    js, ts = jp.stats(), tp.stats()
    assert {k: js[k] for k in ts} == ts
    for b in list(held):
        tp.decref([b])
    assert tp.free_blocks() == tp.usable


@pytest.mark.parametrize("mod", [jblocks, tblocks], ids=["jax", "port"])
def test_block_pool_misuse_raises(mod):
    """The port's pool refuses what the JAX pool refuses
    (tests/test_paged_blocks.py::test_block_pool_misuse_raises)."""
    pool = mod.BlockPool(5, 64)
    blocks = pool.alloc(2)
    pool.decref([blocks[0]])
    with pytest.raises(mod.BlockPoolError):  # double free
        pool.decref([blocks[0]])
    with pytest.raises(mod.BlockPoolError):  # scratch is not refcounted
        pool.incref([mod.SCRATCH_BLOCK])
    with pytest.raises(mod.BlockPoolError):  # out of range
        pool.decref([99])
    assert pool.alloc(100) is None  # over-ask: refusal, not a partial grant
    assert pool.stats()["alloc_failures"] == 1
    with pytest.raises(ValueError):
        mod.BlockPool(1, 64)


# -- K3's plain version ------------------------------------------------------


def _paged_case(L=2, B=3, N=9, bs=32, nbpr=4, KV=4, G=2, hd=32, seed=0):
    """tests/test_decode_attention.py::_paged_case's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, KV, G, hd)).astype(np.float32),
            rng.integers(-127, 128, (L, N, bs, KV, hd)).astype(np.int8),
            rng.uniform(0.001, 0.02, (L, N, bs, KV, 1)).astype(np.float32),
            rng.integers(-127, 128, (L, N, bs, KV, hd)).astype(np.int8),
            rng.uniform(0.001, 0.02, (L, N, bs, KV, 1)).astype(np.float32),
            rng.integers(0, N, (B, nbpr)).astype(np.int32))


def _both(case, li, nv):
    """(JAX Pallas kernel in interpret mode, JAX dequantize-then-attend
    reference, the port's plain version), each as f32 numpy."""
    j_args = [jnp.asarray(x) for x in case]
    j_nv = jnp.asarray(nv, jnp.int32)
    kernel = np.asarray(j_paged(*j_args[:5], li, j_args[5], j_nv), np.float32)
    ref = np.asarray(j_paged_ref(*j_args[:5], li, j_args[5], j_nv), np.float32)
    t_args = [torch.from_numpy(x) for x in case]
    plain = da.decode_attention_int8_paged_plain(*t_args[:5], li, t_args[5],
                                                 torch.tensor(nv, dtype=torch.int32))
    return kernel, ref, plain.float().numpy()


# The plain version follows the Pallas kernel's order: the same bf16
# roundings, sums in another order (the bar of K2's plain version against
# its Pallas kernel, tests/test_torch_quant.py). Against the
# dequantize-then-attend reference the roundings differ (the JAX
# package's own bar, tests/test_decode_attention.py).
KERNEL_ATOL = 2e-3
REF_TOL = 2e-2


@pytest.mark.parametrize("li", [0, 1])
def test_paged_plain_matches_the_pallas_kernel(li):
    kernel, ref, plain = _both(_paged_case(), li, [5, 67, 128])
    np.testing.assert_allclose(plain, kernel, rtol=0, atol=KERNEL_ATOL)
    np.testing.assert_allclose(plain, ref, rtol=REF_TOL, atol=REF_TOL)


def test_paged_plain_with_no_visible_slot_matches_the_pallas_kernel():
    """n_valid = 0: every slot of every table entry counts with weight 1,
    scratch and past-reservation entries included."""
    kernel, _, plain = _both(_paged_case(seed=4), 1, [0, 67, 0])
    np.testing.assert_allclose(plain, kernel, rtol=0, atol=KERNEL_ATOL)


def test_paged_plain_masks_beyond_n_valid():
    """Blocks past a row's length and the masked tail of its last block
    change nothing, even when the table points them at poisoned blocks
    (tests/test_decode_attention.py::test_paged_kernel_masks_beyond_n_valid)."""
    q, kq, ks, vq, vs, bt = (torch.from_numpy(x) for x in _paged_case(B=1, nbpr=3))
    nv = torch.tensor([40], dtype=torch.int32)
    out = da.decode_attention_int8_paged_plain(q, kq, ks, vq, vs, 0, bt, nv)
    kq2, vs2 = kq.clone(), vs.clone()
    kq2[:, int(bt[0, 2])] = 127
    vs2[:, int(bt[0, 2])] = 1e3
    kq2[:, int(bt[0, 1]), 8:] = 127
    out2 = da.decode_attention_int8_paged_plain(q, kq2, ks, vq, vs2, 0, bt, nv)
    assert torch.equal(out, out2)


def test_paged_plain_refuses_entries_outside_the_pool():
    q, kq, ks, vq, vs, bt = (torch.from_numpy(x) for x in _paged_case())
    bt[1, 2] = 9
    with pytest.raises(ValueError, match="block table"):
        da.decode_attention_int8_paged(q, kq, ks, vq, vs, 0, bt, torch.tensor([5, 67, 128]))


# -- the paged cache ---------------------------------------------------------


def _tree(cache):
    """{path: (shape, dtype name)} of a cache, for either package."""
    out = {}
    for k, v in cache.items():
        for kk, leaf in (v.items() if isinstance(v, dict) else [("", v)]):
            out[f"{k}/{kk}"] = (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_init_paged_kv_cache_matches_jax(quant):
    j = jllama.init_paged_kv_cache(JL, 2, 256, 9, 64, dtype=jnp.float32, quant=quant)
    t = tllama.init_paged_kv_cache(TL, 2, 256, 9, 64, dtype=torch.float32,
                                   device=torch.device("cpu"), quant=quant)
    assert _tree(t) == _tree(j)
    assert tllama._kv_is_paged(t) and tllama._kv_max_len(t) == 256
    assert int(t["bt"].abs().sum()) == 0
    with pytest.raises(ValueError, match="multiple"):
        tllama.init_paged_kv_cache(TL, 2, 200, 9, 64, device=torch.device("cpu"))


def _filled_paged_cache(quant: bool, seed: int):
    """A JAX paged cache whose arena holds random values, with two rows at
    lengths 70 and 5 over distinct block runs (scratch 0 above them)."""
    rng = np.random.default_rng(seed)
    cache = jax.tree_util.tree_map(
        np.asarray, jllama.init_paged_kv_cache(JL, 2, 256, 9, 64, dtype=jnp.float32,
                                               quant=quant))
    for plane in ("k", "v"):
        if quant:
            shape = cache[plane]["q"].shape
            cache[plane] = {
                "q": rng.integers(-127, 128, shape).astype(np.int8),
                "s": rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(np.float32)}
        else:
            cache[plane] = rng.normal(size=cache[plane].shape).astype(np.float32)
    cache["bt"] = np.array([[3, 7, 1, 0], [5, 0, 0, 0]], np.int32)
    cache["length"] = np.array([70, 5], np.int32)
    return cache


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_decode_step_matches_jax(quant):
    """One decode step over the same arena and tables gives the JAX logits,
    writes the new K/V at the same (block, offset) of each layer, and keeps
    the table."""
    jp = jax.tree_util.tree_map(np.asarray, jllama.init_llama_params(JL, jax.random.PRNGKey(3)))
    tp = llama_params_from_jax(jp, TL, torch.float32, torch.device("cpu"))
    cache = _filled_paged_cache(quant, seed=1)
    emb = np.random.default_rng(2).normal(size=(2, 1, JL.hidden_size)).astype(np.float32)
    j_logits, j_new = jllama.decode_step(jp, JL, jnp.asarray(emb),
                                         jax.tree_util.tree_map(jnp.asarray, cache))
    t_cache = kv_cache_from_jax(cache, device="cpu")
    # The plane whose change marks a written slot: the scales of an int8
    # arena, the values of an f32 one.
    def plane(c):
        return c["k"]["s"] if quant else c["k"]

    t_old = plane(t_cache).clone()
    with torch.inference_mode():
        t_logits, t_new = tllama.decode_step(tp, TL, torch.from_numpy(emb), t_cache)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4)
    assert t_new is t_cache and torch.equal(t_new["bt"], torch.from_numpy(cache["bt"]))
    np.testing.assert_array_equal(t_new["length"].numpy(), np.asarray(j_new["length"]))
    t_k, j_k, j_old = plane(t_new), np.asarray(plane(j_new)), plane(cache)
    changed = (t_k != t_old).reshape(t_k.shape[:3] + (-1,)).any(-1).numpy()
    j_changed = (j_k != j_old).reshape(j_k.shape[:3] + (-1,)).any(-1)
    np.testing.assert_array_equal(changed, j_changed)
    # Row 0 writes logical slot 70 -> (block 7, offset 6), row 1 slot 5 ->
    # (block 5, offset 5), in every layer.
    for layer in changed:
        assert sorted(zip(*np.nonzero(layer))) == [(5, 5), (7, 6)]
    np.testing.assert_allclose(t_k.numpy(), j_k, rtol=0, atol=1e-5)


def test_prefill_refuses_a_paged_cache():
    cache = tllama.init_paged_kv_cache(TL, 1, 128, 3, 64, dtype=torch.float32,
                                       device=torch.device("cpu"))
    with pytest.raises(ValueError, match="prefill writes dense caches"):
        tllama.prefill(None, TL, torch.zeros((1, 4, TL.hidden_size)),
                       torch.ones((1, 4), dtype=torch.bool), cache)
