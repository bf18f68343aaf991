"""The split-sequence algebra of K2 and K3 on the CPU.

A row's sequence is cut into splits; each split makes a partial
(m_i, l_i, acc_i), and the partials combine in split order: m* = max m_i,
w_i = exp(m_i - m*), out = sum w_i acc_i / max(sum w_i l_i, 1e-30). A
split wholly past the last slot a row reads writes nothing. Two orders are
emulated in torch:
  * ``split_then_combine``: each split with its own running max, the
    general algebra; its bf16 roundings of p * v_s fall at other scales
    than the Pallas kernels';
  * ``reference_max_splits``: the card kernels' order
    (``eventgpt_tpu_torch/csrc/decode_split.cuh``): scores first, then each
    split rounds p * v_s against the max the Pallas kernel uses there.
Both are held against the JAX package's Pallas kernels in interpret mode
and against the port's plain versions, across every split count a table
allows and n_valid of 0, 1, on a split boundary, one past it and past the
end. Inputs are made with numpy from seeds.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu.ops.decode_attention import decode_attention_int8 as j_dense
from eventgpt_tpu.ops.decode_attention import decode_attention_int8_paged as j_paged
from eventgpt_tpu_torch.ops import decode_attention as da

NEG_INF = da.NEG_INF
# The emulation rounds p * v_s to bf16 against each split's own max, the
# Pallas kernels against one max (K2) or each entry's (K3): the same
# roundings at other scales, summed in another order. The JAX package's
# bar between its paged kernel (per-entry max) and its dense kernel (one
# max) on the same view, tests/test_decode_attention.py::
# test_paged_kernel_matches_dense_kernel_on_gathered_view.
SPLIT_ATOL = 2e-3
# The kernels' own order rounds p * v_s against the Pallas kernels' max,
# so the bf16 roundings are the same and only f32 sums of O(1) terms
# differ (2e-7 measured here).
SUM_ATOL = 1e-5


def _partial(qb, k, ks, v, vs, lo, hi, n_vis, step):
    """One split's (m, l, acc) over logical slots [lo, hi) of one row:
    qb (KV, G, hd) f32 of bf16; k/v (T, KV, hd) int8; ks/vs (T, KV, 1).
    The running max moves every ``step`` slots."""
    kv, g, hd = qb.shape
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((kv, g), NEG_INF)
    l = torch.zeros((kv, g))
    acc = torch.zeros((kv, g, hd))
    for c in range(lo, hi, step):
        e = min(c + step, hi)
        s = torch.einsum("kgd,skd->kgs", qb, k[c:e].float()) * (ks[c:e, :, 0] * scale).T[:, None]
        vis = torch.arange(c, e) < n_vis
        s = torch.where(vis, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = (p * vs[c:e, :, 0].T[:, None]).to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.einsum("kgs,skd->kgd", pv, v[c:e].float())
        m = m_new
    return m, l, acc


def split_then_combine(q, k, ks, v, vs, n_valid, split, step, keep_empty=False):
    """(B, KV, G, hd) attention over logical views k/v (B, T, KV, hd) and
    ks/vs (B, T, KV, 1), the sequence cut into splits of ``split`` slots.
    ``keep_empty`` gives a split past the last slot read the partial
    (NEG_INF, 0, 0) instead of leaving it out."""
    qb = q.to(torch.bfloat16).float()
    t = k.shape[1]
    out = []
    for b, nv in enumerate(int(x) for x in n_valid):
        n_vis = min(max(nv, 0), t)
        n_read = n_vis if nv > 0 else t
        parts = []
        for s0 in range(0, t, split):
            hi = min(s0 + split, n_read)
            if s0 < hi:
                parts.append(_partial(qb[b], k[b], ks[b], v[b], vs[b], s0, hi, n_vis, step))
            elif keep_empty:
                kv, g, hd = qb[b].shape
                parts.append((torch.full((kv, g), NEG_INF), torch.zeros((kv, g)),
                              torch.zeros((kv, g, hd))))
        m_star = functools.reduce(torch.maximum, [m for m, _, _ in parts])
        acc = torch.zeros_like(parts[0][2])
        l = torch.zeros_like(parts[0][1])
        for m, li, ai in parts:  # in split order
            w = torch.exp(m - m_star)
            acc = acc + w[..., None] * ai
            l = l + w * li
        out.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.stack(out).to(q.dtype)


def reference_max_splits(q, k, ks, v, vs, n_valid, split, munit, running):
    """What the card kernels compute, over the same logical views: the
    scores; the max of each unit of ``munit`` slots; each unit's reference
    max, the running max up to it (``running``, K3's per-entry walk) or
    the row's max (K2's one-shot softmax); then per split
    acc_i = sum c_u bf16(p v_s) v8 and l_i = sum c_u p, with
    p = exp(s - m_u) and c_u = exp(m_u - m*), combined in split order."""
    qb = q.to(torch.bfloat16).float()
    t, hd = k.shape[1], k.shape[-1]
    out = []
    for b, nv in enumerate(int(x) for x in n_valid):
        n_vis = min(max(nv, 0), t)
        n_read = n_vis if nv > 0 else t
        s = torch.einsum("kgd,skd->kgs", qb[b], k[b, :n_read].float()) \
            * (ks[b, :n_read, :, 0] / math.sqrt(hd)).T[:, None]
        s = torch.where(torch.arange(n_read) < n_vis, s, torch.tensor(NEG_INF))
        umax = torch.stack([s[..., u:u + munit].amax(-1) for u in range(0, n_read, munit)], -1)
        m_ref = umax.cummax(-1).values if running else umax.amax(-1, keepdim=True).expand_as(umax)
        m_star = m_ref[..., -1]
        carry = torch.exp(m_ref - m_star[..., None])
        acc, l = 0.0, 0.0
        for s0 in range(0, n_read, split):  # the splits that read a slot, in order
            idx = torch.arange(s0, min(s0 + split, n_read))
            p = torch.exp(s[..., idx] - m_ref[..., idx // munit])
            c = carry[..., idx // munit]
            pv = (p * vs[b, idx, :, 0].T[:, None]).to(torch.bfloat16).float() * c
            acc = acc + torch.einsum("kgs,skd->kgd", pv, v[b, idx].float())
            l = l + (p * c).sum(-1)
        out.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.stack(out).to(q.dtype)


# -- K3: the paged arena ------------------------------------------------------

BS, NBPR = 32, 4


def _paged_case(seed=0, L=2, B=3, N=9, KV=4, G=2, hd=32):
    """tests/test_decode_attention.py::_paged_case's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, KV, G, hd)).astype(np.float32),
            rng.integers(-127, 128, (L, N, BS, KV, hd)).astype(np.int8),
            rng.uniform(0.001, 0.02, (L, N, BS, KV, 1)).astype(np.float32),
            rng.integers(-127, 128, (L, N, BS, KV, hd)).astype(np.int8),
            rng.uniform(0.001, 0.02, (L, N, BS, KV, 1)).astype(np.float32),
            rng.integers(0, N, (B, NBPR)).astype(np.int32))


# Per row: none visible, one, an entry boundary and one past it, two
# entries and one past, three entries, the whole table, past the end.
PAGED_NV = [(0, 1, 32), (33, 64, 65), (96, 128, 500)]
LI = 1


@functools.lru_cache(maxsize=None)
def _paged_refs(nv):
    """(Pallas kernel in interpret mode, the port's plain version) at
    n_valid ``nv``, each as f32 torch."""
    case = _paged_case(seed=sum(nv))
    j_args = [jnp.asarray(x) for x in case]
    pallas = np.asarray(j_paged(*j_args[:5], LI, j_args[5], jnp.asarray(nv, jnp.int32)),
                        np.float32)
    t = [torch.from_numpy(x) for x in case]
    plain = da.decode_attention_int8_paged_plain(*t[:5], LI, t[5], torch.tensor(nv))
    return torch.tensor(pallas), plain.float()


def _paged_views(nv):
    """q and the rows' logical slots, gathered through their tables."""
    q, kq, ks, vq, vs, bt = (torch.from_numpy(x) for x in _paged_case(seed=sum(nv)))
    b = bt.shape[0]

    def view(x):
        return x[LI][bt.long()].reshape((b, NBPR * BS) + tuple(x.shape[3:]))

    return q, view(kq), view(ks), view(vq), view(vs)


def _paged_emulated(nv, entries, keep_empty=False):
    return split_then_combine(*_paged_views(nv), nv, entries * BS, BS, keep_empty)


@pytest.mark.parametrize("nv", PAGED_NV)
@pytest.mark.parametrize("entries", range(1, NBPR + 1))
def test_paged_split_combine_matches_pallas_and_plain(entries, nv):
    """n_split from NBPR (one entry a split) down to 1 (the whole table)."""
    pallas, plain = _paged_refs(nv)
    got = _paged_emulated(nv, entries)
    torch.testing.assert_close(got, pallas, rtol=0, atol=SPLIT_ATOL)
    torch.testing.assert_close(got, plain, rtol=0, atol=SPLIT_ATOL)


@pytest.mark.parametrize("nv", PAGED_NV)
@pytest.mark.parametrize("entries", range(1, NBPR + 1))
def test_paged_kernel_algebra_matches_plain(entries, nv):
    """The card kernel's order: every split rounds p * v_s against the
    running max of its entry, as the Pallas walk does, so only f32 sums
    differ from the Pallas kernel and the plain version."""
    got = reference_max_splits(*_paged_views(nv), nv, entries * BS, BS, running=True)
    pallas, plain = _paged_refs(nv)
    torch.testing.assert_close(got, plain, rtol=0, atol=SUM_ATOL)
    torch.testing.assert_close(got, pallas, rtol=0, atol=SUM_ATOL)


@pytest.mark.parametrize("nv", PAGED_NV)
def test_empty_splits_add_nothing(nv):
    """A split past the last slot read may be left out: as the partial
    (NEG_INF, 0, 0) it gets weight exp(NEG_INF - m*) = 0 (n_valid > 0) or
    adds l = 0 and acc = 0 (n_valid = 0, where no split is empty)."""
    assert torch.equal(_paged_emulated(nv, 1), _paged_emulated(nv, 1, keep_empty=True))


def test_no_visible_slot_weighs_every_slot_one():
    """n_valid = 0: every split's m stays NEG_INF, every w_i = 1, and the
    output is the v_s-weighted mean of all V rows of the table."""
    nv = (0, 0, 0)
    q, kq, ks, vq, vs, bt = (torch.from_numpy(x) for x in _paged_case(seed=sum(nv)))
    b = bt.shape[0]
    v = vq[LI][bt.long()].reshape(b, NBPR * BS, *vq.shape[3:]).float()
    s = vs[LI][bt.long()].reshape(b, NBPR * BS, vs.shape[3])
    pv = s.to(torch.bfloat16).float()  # p = 1, rounded after the v_s scale
    mean = torch.einsum("bsk,bskd->bkd", pv, v) / (NBPR * BS)
    for entries in range(1, NBPR + 1):
        got = _paged_emulated(nv, entries)
        torch.testing.assert_close(got, mean[:, :, None].expand_as(got), rtol=1e-6, atol=1e-6)


# -- K2: the stacked cache -----------------------------------------------------

S = 192


def _decode_case(seed=0, L=3, B=3, KV=4, G=2, hd=64):
    """tests/test_decode_attention.py::_case's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, KV, G, hd)).astype(np.float32),
            rng.integers(-127, 128, (L, B, S, KV, hd)).astype(np.int8),
            rng.uniform(0.001, 0.02, (L, B, S, KV, 1)).astype(np.float32),
            rng.integers(-127, 128, (L, B, S, KV, hd)).astype(np.int8),
            rng.uniform(0.001, 0.02, (L, B, S, KV, 1)).astype(np.float32))


DENSE_NV = [(0, 1, 64), (65, 128, 129), (191, 192, 500)]


@functools.lru_cache(maxsize=None)
def _dense_refs(nv):
    case = _decode_case(seed=sum(nv))
    j_args = [jnp.asarray(x) for x in case]
    pallas = np.asarray(j_dense(*j_args, 2, jnp.asarray(nv, jnp.int32)), np.float32)
    plain = da.decode_attention_int8_plain(*map(torch.from_numpy, case), 2, torch.tensor(nv))
    return torch.tensor(pallas), plain.float()


@pytest.mark.parametrize("nv", DENSE_NV)
@pytest.mark.parametrize("split", [64, 128, 192])
def test_dense_split_combine_matches_pallas_and_plain(split, nv):
    """Splits of whole 64-slot units, as ``decode_split`` cuts them, with
    one running max per split."""
    q, kq, ks, vq, vs = (torch.from_numpy(x) for x in _decode_case(seed=sum(nv)))
    got = split_then_combine(q, kq[2], ks[2], vq[2], vs[2], nv, split, split)
    pallas, plain = _dense_refs(nv)
    torch.testing.assert_close(got, pallas, rtol=0, atol=SPLIT_ATOL)
    torch.testing.assert_close(got, plain, rtol=0, atol=SPLIT_ATOL)
    # The card kernel's order: one max for the row, as the Pallas kernel.
    kernel = reference_max_splits(q, kq[2], ks[2], vq[2], vs[2], nv, split, split, running=False)
    torch.testing.assert_close(kernel, plain, rtol=0, atol=SUM_ATOL)
    torch.testing.assert_close(kernel, pallas, rtol=0, atol=SUM_ATOL)


# -- the wrapper's choice of split ---------------------------------------------


def test_split_plans_at_the_7b_shapes():
    """On 132 SMs: K2's 7B check (S = 896, B * KV = 128) takes 7 splits of
    128 slots, K3's serving arena (16 entries of 64) 8 splits of 2."""
    assert da.decode_split(896, 128, 132) == (128, 7)
    assert da.paged_split(64, 16, 128, 132) == (128, 8)


@pytest.mark.parametrize("pairs", [1, 4, 128, 2048])
def test_split_plans_cover_the_sequence_in_whole_units(pairs):
    for s_len in (1, 33, 64, 65, 896, 65536):
        split, n = da.decode_split(s_len, pairs, 132)
        assert split % da.SPLIT_MIN_SLOTS == 0 and (n - 1) * split < s_len <= n * split
    for bs, nbpr in ((16, 5), (32, 4), (64, 1), (64, 16), (8, 4096)):
        split, n = da.paged_split(bs, nbpr, pairs, 132)
        assert split % bs == 0 and split // bs <= da.MAX_SPLIT_ENTRIES
        assert split >= min(da.SPLIT_MIN_SLOTS, nbpr * bs)
        assert (n - 1) * split < nbpr * bs <= n * split
