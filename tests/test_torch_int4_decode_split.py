"""The split-K order of K4's decode path (M <= 16) on the CPU.

The card kernel (``int4_mm_decode_kernel`` in
``eventgpt_tpu_torch/csrc/int4_matmul.cu``) cuts the groups of K into
``decode_plan(...)["n_split"]`` splits, the blocks of one cluster per
column tile: split s takes groups s, s + n_split, ... (``split_groups``)
and folds each group's f32 partial dot, times the f32 group scale, into
its own f32 accumulator in ascending order; the cluster then sums the
splits' accumulators in split order, starting from 0. Here that order is
emulated in torch and held against the JAX package's Pallas kernel in
interpret mode and against the port's plain version, and the plan is
checked to cover every group exactly once. Inputs are made with numpy
from seeds.

Tolerances: the emulation, the Pallas kernel and the plain version sum the
same exact products (bf16 x times a small integer, times the f32 scale)
in f32 in other orders, on outputs of O(30): atol 1e-4 with rtol 1e-5,
the bar of tests/test_torch_quant.py::test_int4_plain_matches_jax_kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu.ops import quant as jquant
from eventgpt_tpu.ops.int4_matmul import int4_matmul as j_int4
from eventgpt_tpu.ops.int4_matmul import supported as j_supported
from eventgpt_tpu_torch.ops import int4_matmul as ti4

ATOL, RTOL = 1e-4, 1e-5
H100_SMS = 132

# (m, k, n, group) across the decode path's contract: the 7B decode
# shapes, N past the last 128-column tile, fewer groups than splits,
# G = K, G = 16, M = 1 and 16.
PLAN_CASES = [
    (4, 4096, 4096, 128),
    (4, 4096, 11008, 128),
    (4, 11008, 4096, 128),
    (4, 4096, 32000, 128),
    (4, 512, 96, 128),
    (9, 768, 4128, 64),
    (4, 384, 256, 128),
    (16, 256, 256, 256),
    (16, 512, 128, 16),
    (1, 256, 32, 32),
    (16, 2048, 512, 128),
]


def split_k_emulation(x, q4, s):
    """x (M, K) @ packed-int4 weight in the decode kernel's order."""
    m, k = x.shape
    hk, n = q4.shape
    gc = s.shape[0]
    hg = hk // gc  # packed rows per group
    plan = ti4.decode_plan(m, k, n, k // gc)
    xb = x.to(torch.bfloat16).float().reshape(m, hk, 2)
    hi = ((q4 >> 4).to(torch.int32) - 8).float()
    lo = ((q4 & 0xF).to(torch.int32) - 8).float()
    out = torch.zeros((m, n), dtype=torch.float32)
    for groups in ti4.split_groups(gc, plan["n_split"]):
        acc = torch.zeros((m, n), dtype=torch.float32)
        for g in groups:
            rows = slice(g * hg, (g + 1) * hg)
            part = xb[:, rows, 0] @ hi[rows] + xb[:, rows, 1] @ lo[rows]
            acc = acc + part * s[g]
        out = out + acc
    return out


def _case(m, k, n, group, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    leaf = jquant.quantize_tensor4_host(rng.standard_normal((k, n)).astype(np.float32), group)
    return x, leaf["q4"], leaf["s"]


@pytest.mark.parametrize("m,k,n,group", PLAN_CASES)
def test_decode_plan_covers_every_group_once(m, k, n, group):
    plan = ti4.decode_plan(m, k, n, group)
    n_groups = k // group
    splits = ti4.split_groups(n_groups, plan["n_split"])
    assert len(splits) == plan["n_split"] == plan["cluster"]
    assert sorted(g for sp in splits for g in sp) == list(range(n_groups))
    for sp, groups in enumerate(splits):
        assert groups == sorted(groups) and all(g % plan["n_split"] == sp for g in groups)
    assert plan["blocks"] == -(-n // plan["tile_n"]) * plan["n_split"]
    assert plan["tile_n"] % 32 == 0


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)])
def test_decode_plan_gives_every_7b_shape_two_blocks_an_sm(k, n):
    """The 7B decode shapes launch ~2 blocks an SM or more on an H100."""
    assert ti4.decode_plan(4, k, n, 128)["blocks"] >= 1.9 * H100_SMS


def test_prefill_rows_take_no_decode_plan():
    assert ti4.decode_plan(ti4.DECODE_MAX_M + 1, 512, 256, 128) is None
    assert ti4.decode_plan(ti4.DECODE_MAX_M, 512, 256, 128) is not None


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n,group", [
    (512, 256, 128),   # 4 groups: splits 4-7 empty
    (2048, 512, 128),  # 16 groups: two a split
    (256, 256, 16),    # G = 16: every k16 step ends a group
    (256, 256, 256),   # G = K: one group
])
def test_split_order_matches_jax_kernel(m, k, n, group):
    assert j_supported(k, n, group)
    x, q4, s = _case(m, k, n, group, seed=m * 7 + k + group)
    want = np.asarray(j_int4(jnp.asarray(x), jnp.asarray(q4), jnp.asarray(s)))
    got = split_k_emulation(torch.from_numpy(x), torch.from_numpy(q4), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("m,k,n,group", PLAN_CASES)
def test_split_order_matches_plain(m, k, n, group):
    x, q4, s = (torch.from_numpy(a) for a in _case(m, k, n, group, seed=m + k + n))
    want = ti4.int4_matmul_reference(x, q4, s)
    np.testing.assert_allclose(split_k_emulation(x, q4, s).numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)
