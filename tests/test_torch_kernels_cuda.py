"""The port's hand-written CUDA kernels against their plain versions, on the card.

This file imports torch and the port only, so it runs on a machine without
JAX:  python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda
Without a card the ``cuda`` tests skip; a CUDA kernel has no CPU mode.
"""

import math

import pytest
import torch

from eventgpt_tpu_torch.ops import decode_attention as da
from eventgpt_tpu_torch.ops import flash_attention as fa
from eventgpt_tpu_torch.ops import int4_matmul as i4
from eventgpt_tpu_torch.ops.quant import quantize_tensor4

# bf16 kernel vs its f32 plain version: the bf16 output rounding (2^-8
# relative, |out| <= ~3) plus P rounded to bf16 before the P.V product.
ATOL = 2e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,lengths,causal", [
    (1, 64, 1, None, True),           # one tile
    (2, 333, 4, [333, 200], True),    # S no tile multiple, right padding
    (3, 130, 2, [130, 65, 1], True),  # a one-token row
    (2, 200, 2, [150, 200], False),   # non-causal with padding
    # The 64-row q tile and 64-key KV tile edges: one token, one short of a
    # tile, one tile, one past it, two tiles either side.
    (1, 1, 2, None, True),
    (2, 63, 2, [63, 17], True),
    (2, 64, 2, [64, 63], False),
    (2, 65, 2, [65, 64], True),
    (2, 127, 2, [127, 65], True),
    (2, 128, 2, [128, 127], True),
    (4, 129, 2, [129, 128, 64, 1], True),
    (3, 96, 2, [96, 0, 40], True),    # a row whose every key is padding
    (2, 96, 2, [0, 96], False),       # the same, non-causal
    (4, 849, 32, [849, 830, 815, 808], True),  # the 7B prefill shape
])
def test_flash_kernel_matches_plain(b, s, h, lengths, causal):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn((b, s, h, 128), generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor(lengths or [s] * b, device=dev)
    valid = torch.arange(s, device=dev)[None, :] < lens[:, None]
    before = fa.FLASH_KERNEL.launches
    out = fa.flash_attention(q, k, v, valid=valid, causal=causal)
    torch.cuda.synchronize()
    assert fa.FLASH_KERNEL.launches == before + 1
    ref = fa.flash_attention_reference(q, k, v, valid, causal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() < ATOL
    for row, n in enumerate(lens.tolist()):
        assert (out[row, n:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_two_launches_are_bit_equal(causal):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((3, 333, 8, 128), generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([333, 200, 65], device=dev)
    valid = torch.arange(333, device=dev)[None, :] < lens[:, None]
    _two_calls_equal(lambda: fa.flash_attention(q, k, v, valid=valid, causal=causal),
                     fa.FLASH_KERNEL)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q = torch.randn((1, 64, 2, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), q.float(), q.float())
    q64 = torch.randn((1, 64, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q64, q64, q64)
    qt = q.transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(qt, qt, qt)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q = torch.randn((1, 20, 2, 128))
    before = fa.FLASH_KERNEL.launches
    out = fa.flash_attention(q, q, q)
    assert fa.FLASH_KERNEL.launches == before
    torch.testing.assert_close(out, fa.flash_attention_reference(q, q, q), rtol=0, atol=0)


# K1's gradient (the autograd Function: the kernel forward, the plain f32
# backward cast to bf16) vs autograd through the plain version on the same
# bf16 inputs: both are f32 sums of the same products rounded once to bf16,
# so they differ by at most about one bf16 rounding of the largest gradient.
GRAD_RTOL = 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,lengths", [
    (2, 130, 4, [130, 77]),
    (2, 896, 32, [896, 801]),   # the 7B training shape of chip_smoke.py
])
def test_flash_kernel_gradient_matches_plain(b, s, h, lengths):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(s + 1)
    q, k, v, cot = (torch.randn((b, s, h, 128), generator=g, device=dev, dtype=torch.bfloat16)
                    for _ in range(4))
    valid = torch.arange(s, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    launches, paths = fa.FLASH_KERNEL.launches, dict(fa.LAUNCHES_BY_PATH)
    out = fa.flash_attention(*leaves, valid=valid, causal=True)
    (out.float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    assert fa.FLASH_KERNEL.launches == launches + 1
    assert fa.LAUNCHES_BY_PATH["train_forward"] == paths["train_forward"] + 1
    assert fa.LAUNCHES_BY_PATH["backward"] == paths["backward"] + 1
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = fa.flash_attention_reference(*refs, valid, causal=True)
    (ref.float() * cot.float()).sum().backward()
    for name, got, want in zip("qkv", leaves, refs):
        assert got.grad.dtype == torch.bfloat16 and bool(torch.isfinite(got.grad).all())
        bar = GRAD_RTOL * want.grad.float().abs().max().item()
        err = (got.grad.float() - want.grad.float()).abs().max().item()
        assert err <= bar, (name, err, bar)
    for row, n in enumerate(lengths):
        assert (leaves[0].grad[row, n:] == 0).all()


@pytest.mark.cuda
def test_f32_flash_training_on_the_card_raises(tmp_path):
    from eventgpt_tpu_torch.config import EventChatConfig
    from eventgpt_tpu_torch.data.tokenizer import ByteTokenizer
    from eventgpt_tpu_torch.models.convert import init_eventchat_params
    from eventgpt_tpu_torch.train.args import DataArguments, ModelArguments, TrainingArguments
    from eventgpt_tpu_torch.train.trainer import Trainer

    dev = _card()
    cfg = EventChatConfig.tiny()
    params = init_eventchat_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                   torch.float32, dev)
    with pytest.raises(ValueError, match="bf16 only"):
        Trainer(cfg, params, ByteTokenizer(), ModelArguments(), DataArguments(),
                TrainingArguments(output_dir=str(tmp_path), bf16=False, attn_impl="flash"),
                device=dev)


# K4 vs its plain version: both sum exact products (bf16 x times a small
# integer, then the f32 group scale) in f32, in another order; outputs are
# O(sqrt(K)) ~ 30.
I4_ATOL, I4_RTOL = 2e-3, 1e-4


def _int4_case(m, k, n, group, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=dev)
    leaf = quantize_tensor4(w, group)
    return x, leaf["q4"], leaf["s"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", [
    (1, 256, 256, 128),     # one row, one group per warp
    (4, 512, 256, 128),     # the decode tile, groups split over warps
    (16, 256, 512, 256),    # a full 16-row tile; one group over all of K
    (17, 512, 512, 64),     # the first M of the prefill path
    (37, 768, 96, 32),      # M, N not tile multiples (ragged block in N)
    (130, 256, 1024, 16),   # two row blocks, the smallest group
    (128, 512, 256, 128),   # one full 128-row prefill block
    (129, 512, 256, 64),    # one row past it
    (300, 512, 352, 128),   # ragged in M and in N (N % 128 == 96)
    (64, 80, 256, 16),      # a K tail shorter than the 64-row stage
    (40, 1024, 128, 256),   # a group over four stages of the ring
    (70, 192, 160, 48),     # groups that end inside a stage and straddle two
    (3396, 512, 256, 128),  # the 7B prefill M = B * T
])
def test_int4_kernel_matches_plain(m, k, n, group):
    dev = _card()
    x, q4, s = _int4_case(m, k, n, group, dev, seed=m + k)
    before = i4.INT4_KERNEL.launches
    shape = ("decode" if m <= 16 else "prefill", k, n)
    before_shape = i4.LAUNCHES_BY_SHAPE[shape]
    out = i4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert i4.INT4_KERNEL.launches == before + 1
    assert i4.LAUNCHES_BY_SHAPE[shape] == before_shape + 1
    assert out.dtype == torch.float32 and out.shape == (m, n)
    torch.testing.assert_close(out, i4.int4_matmul_reference(x, q4, s),
                               atol=I4_ATOL, rtol=I4_RTOL)
    # An f32 x is rounded to bf16 first, as the Pallas kernel does.
    torch.testing.assert_close(i4.int4_matmul(x.float(), q4, s), out, atol=0, rtol=0)


@pytest.mark.cuda
def test_int4_kernel_refuses_what_it_does_not_take():
    dev = _card()
    x, q4, s = _int4_case(4, 256, 256, 128, dev, seed=0)
    with pytest.raises(ValueError, match="floating"):
        i4.int4_matmul(x.to(torch.int32), q4, s)
    with pytest.raises(ValueError, match="uint8"):
        i4.int4_matmul(x, q4.to(torch.int8), s)
    with pytest.raises(ValueError, match="float32"):
        i4.int4_matmul(x, q4, s.double())
    with pytest.raises(ValueError, match="do not match"):
        i4.int4_matmul(x[:, :128].contiguous(), q4, s)
    with pytest.raises(ValueError, match="contiguous"):
        i4.int4_matmul(x, q4.T.contiguous().T, s)
    with pytest.raises(ValueError, match="group"):
        i4.int4_matmul(x, q4, s.repeat_interleave(16, dim=0))  # group 8


@pytest.mark.cuda
def test_int4_prefill_path_refuses_strided_or_misaligned_operands():
    dev = _card()
    x, q4, s = _int4_case(64, 256, 256, 128, dev, seed=3)
    before = i4.INT4_KERNEL.launches
    with pytest.raises(ValueError, match="contiguous"):
        i4.int4_matmul(torch.cat([x, x], dim=1)[:, :256], q4, s)
    with pytest.raises(ValueError, match="contiguous"):
        i4.int4_matmul(x, q4, torch.cat([s, s], dim=1)[:, :256])
    x_off = torch.empty(x.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(64, 256)
    x_off.copy_(x)  # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        i4.int4_matmul(x_off, q4, s)
    assert i4.INT4_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", [
    (1, 512, 256, 64),       # one row
    (4, 512, 96, 128),       # N % 128 == 96: the tile's last 32 columns past N
    (8, 1024, 32, 128),      # N of one warp, rows 8-15 of the m-tile unused
    (9, 768, 4128, 64),      # the first row past 8; N = 4096 + 32
    (16, 256, 256, 256),     # G = K: one group, seven empty splits
    (16, 512, 128, 16),      # G = 16: every k16 step ends a group
    (4, 384, 256, 128),      # three groups, fewer than the splits
    (4, 4096, 4096, 128),    # the 7B decode weights: q, k, v, o
    (4, 4096, 11008, 128),   # gate, up
    (4, 11008, 4096, 128),   # down: 86 groups, 10 or 11 a split
])
def test_int4_decode_path_split_k(m, k, n, group):
    """The split-K decode path: bit-equal over two calls, one launch each,
    and the plain version's values at every edge of its plan."""
    dev = _card()
    assert i4.decode_plan(m, k, n, group) is not None
    x, q4, s = _int4_case(m, k, n, group, dev, seed=m + k + n)
    out = _two_calls_equal(lambda: i4.int4_matmul(x, q4, s), i4.INT4_KERNEL)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    torch.testing.assert_close(out, i4.int4_matmul_reference(x, q4, s),
                               atol=I4_ATOL, rtol=I4_RTOL)


# K2 vs its plain version: the same arithmetic, summed in another order,
# with expf against torch.exp (1-2 ulp). That can flip the bf16 rounding of
# one slot's p * v_s: 2^-8 of that slot's share of the output, |v| <= 1.3
# here. A bf16 output adds one bf16 step at |out| < 2.
DA_ATOL = {torch.float32: 1e-2, torch.bfloat16: 2e-2}


def _decode_case(L, B, S, KV, G, hd, dev, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)

    def payload():
        return torch.randint(-127, 128, (L, B, S, KV, hd), generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)

    def scales():
        return torch.rand((L, B, S, KV, 1), generator=g, device=dev) * 0.019 + 0.001

    q = torch.randn((B, KV, G, hd), generator=g, device=dev).to(dtype)
    return q, payload(), scales(), payload(), scales()


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,S,KV,G,hd,li,n_valid,dtype", [
    (3, 2, 128, 4, 2, 64, 2, [37, 100], torch.bfloat16),
    (2, 3, 77, 2, 1, 128, 1, [1, 77, 40], torch.bfloat16),   # n_valid of 1 and of S
    (1, 2, 33, 16, 8, 32, 0, [0, 500], torch.float32),       # none visible; past S
    (32, 4, 96, 8, 1, 128, 31, [90, 3, 96, 64], torch.float32),
])
def test_decode_int8_kernel_matches_plain(L, B, S, KV, G, hd, li, n_valid, dtype):
    dev = _card()
    q, kq, ks, vq, vs = _decode_case(L, B, S, KV, G, hd, dev, seed=S + li, dtype=dtype)
    nv = torch.tensor(n_valid, device=dev, dtype=torch.int32)
    before = da.DECODE_INT8_KERNEL.launches
    out = da.decode_attention_int8(q, kq, ks, vq, vs, li, nv)
    torch.cuda.synchronize()
    assert da.DECODE_INT8_KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = da.decode_attention_int8_plain(q, kq, ks, vq, vs, li, nv)
    assert (out.float() - ref.float()).abs().max().item() < DA_ATOL[dtype]


def _split_edges(split, total):
    """n_valid per row across a kernel's split edges: none visible, one, a
    split boundary and one past it, trailing splits wholly past n_valid,
    every slot, past the end."""
    return [0, 1, min(split, total), min(split + 1, total), min(2 * split + 3, total), total,
            total + 100]


def _two_calls_equal(run, kernel):
    """Two calls of ``run`` give equal bits; each adds one launch."""
    before = kernel.launches
    out = run()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(run(), out)
    assert kernel.launches == before + 2
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("S,KV,G,hd,dtype,multi", [
    (640, 2, 1, 128, torch.bfloat16, True),   # 64-slot splits
    (640, 2, 8, 32, torch.float32, True),     # G = 8 at hd 32
    (320, 2, 8, 64, torch.bfloat16, True),    # G = 8 at hd 64
    (48, 2, 2, 64, torch.float32, False),     # one split
    (65536, 1, 1, 128, torch.bfloat16, True),  # beyond the old kernel's shared memory
])
def test_decode_int8_kernel_split_edges(S, KV, G, hd, dtype, multi):
    dev = _card()
    split, n_split = da.decode_split(S, 7 * KV, da.sm_count(dev))
    assert (n_split > 2) == multi
    q, kq, ks, vq, vs = _decode_case(1, 7, S, KV, G, hd, dev, seed=S + G, dtype=dtype)
    nv = torch.tensor(_split_edges(split, S), device=dev, dtype=torch.int32)
    out = _two_calls_equal(lambda: da.decode_attention_int8(q, kq, ks, vq, vs, 0, nv),
                           da.DECODE_INT8_KERNEL)
    assert out.dtype == dtype and out.shape == q.shape
    ref = da.decode_attention_int8_plain(q, kq, ks, vq, vs, 0, nv)
    assert (out.float() - ref.float()).abs().max().item() < DA_ATOL[dtype]


@pytest.mark.cuda
def test_decode_int8_kernel_reads_no_stale_slot():
    """Slots at or past n_valid are never read: poisoning them changes
    nothing, bit for bit."""
    dev = _card()
    q, kq, ks, vq, vs = _decode_case(2, 1, 64, 4, 2, 128, dev, seed=5)
    nv = torch.tensor([40], device=dev, dtype=torch.int32)
    out = da.decode_attention_int8(q, kq, ks, vq, vs, 1, nv)
    kq[:, :, 40:] = 127
    vs[:, :, 40:] = 1e3
    assert torch.equal(da.decode_attention_int8(q, kq, ks, vq, vs, 1, nv), out)


@pytest.mark.cuda
def test_decode_int8_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q, kq, ks, vq, vs = _decode_case(2, 2, 16, 2, 1, 64, dev, seed=0)
    nv = torch.tensor([3, 16], device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        da.decode_attention_int8(q.half(), kq, ks, vq, vs, 0, nv)
    with pytest.raises(ValueError, match="int8"):
        da.decode_attention_int8(q, kq.to(torch.int16), ks, vq, vs, 0, nv)
    with pytest.raises(ValueError, match="shape"):
        da.decode_attention_int8(q, kq, ks[:, :, :8].contiguous(), vq, vs, 0, nv)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_int8(torch.cat([q, q], dim=-1)[..., :64], kq, ks, vq, vs, 0, nv)
    with pytest.raises(ValueError, match="out of range"):
        da.decode_attention_int8(q, kq, ks, vq, vs, 2, nv)
    q9, kq9, ks9, vq9, vs9 = _decode_case(1, 1, 8, 1, 9, 64, dev, seed=1)
    with pytest.raises(ValueError, match="G <= 8"):
        da.decode_attention_int8(q9, kq9, ks9, vq9, vs9, 0, nv[:1])


def _paged_case(L, N, bs, nbpr, B, KV, G, hd, dev, seed, dtype=torch.float32):
    q, kq, ks, vq, vs = _decode_case(L, N, bs, KV, G, hd, dev, seed, dtype)
    q = torch.randn((B, KV, G, hd), generator=torch.Generator(device=dev).manual_seed(seed + 1),
                    device=dev).to(dtype)
    bt = torch.randint(0, N, (B, nbpr), generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev, dtype=torch.int32)
    return q, kq, ks, vq, vs, bt


# K3 vs its plain version: the same per-entry online softmax, summed in
# another order, with expf against torch.exp; the bar of K2 above.
@pytest.mark.cuda
@pytest.mark.parametrize("L,N,bs,nbpr,B,KV,G,hd,li,n_valid,dtype", [
    (2, 9, 32, 4, 3, 4, 2, 32, 1, [5, 67, 128], torch.float32),   # the JAX test's shapes
    (2, 9, 32, 4, 3, 4, 2, 32, 0, [0, 1, 500], torch.float32),    # none visible; past the table
    (3, 40, 64, 16, 4, 8, 1, 128, 2, [870, 64, 65, 1024], torch.bfloat16),  # serving blocks
    (1, 12, 16, 5, 2, 16, 8, 64, 0, [33, 80], torch.bfloat16),
])
def test_paged_int8_kernel_matches_plain(L, N, bs, nbpr, B, KV, G, hd, li, n_valid, dtype):
    dev = _card()
    q, kq, ks, vq, vs, bt = _paged_case(L, N, bs, nbpr, B, KV, G, hd, dev, seed=bs + li,
                                        dtype=dtype)
    nv = torch.tensor(n_valid, device=dev, dtype=torch.int32)
    before = da.PAGED_INT8_KERNEL.launches
    out = da.decode_attention_int8_paged(q, kq, ks, vq, vs, li, bt, nv)
    torch.cuda.synchronize()
    assert da.PAGED_INT8_KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = da.decode_attention_int8_paged_plain(q, kq, ks, vq, vs, li, bt, nv)
    assert (out.float() - ref.float()).abs().max().item() < DA_ATOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("N,bs,nbpr,KV,G,hd,dtype,multi", [
    (40, 64, 16, 2, 1, 128, torch.bfloat16, True),  # one entry a split
    (20, 16, 12, 2, 8, 32, torch.float32, True),    # G = 8 at hd 32, 4 entries a split
    (20, 32, 6, 2, 8, 64, torch.bfloat16, True),    # G = 8 at hd 64
    (12, 64, 1, 2, 2, 128, torch.float32, False),   # n_bpr = 1: one split
])
def test_paged_int8_kernel_split_edges(N, bs, nbpr, KV, G, hd, dtype, multi):
    dev = _card()
    split, n_split = da.paged_split(bs, nbpr, 7 * KV, da.sm_count(dev))
    assert (n_split > 2) == multi
    q, kq, ks, vq, vs, bt = _paged_case(2, N, bs, nbpr, 7, KV, G, hd, dev, seed=N + G,
                                        dtype=dtype)
    nv = torch.tensor(_split_edges(split, nbpr * bs), device=dev, dtype=torch.int32)
    out = _two_calls_equal(lambda: da.decode_attention_int8_paged(q, kq, ks, vq, vs, 1, bt, nv),
                           da.PAGED_INT8_KERNEL)
    assert out.dtype == dtype and out.shape == q.shape
    ref = da.decode_attention_int8_paged_plain(q, kq, ks, vq, vs, 1, bt, nv)
    assert (out.float() - ref.float()).abs().max().item() < DA_ATOL[dtype]


@pytest.mark.cuda
def test_paged_int8_kernel_bad_entry_in_a_later_split():
    """An entry outside the pool that only a later split reads makes that
    row NaN and no other; one past n_valid is never read."""
    dev = _card()
    q, kq, ks, vq, vs, bt = _paged_case(1, 10, 64, 16, 3, 2, 1, 128, dev, seed=9)
    split, n_split = da.paged_split(64, 16, 6, da.sm_count(dev))
    assert split == 64 and n_split == 16
    bt[1, 5] = 10    # read by row 1's sixth split
    bt[2, 12] = -1   # past row 2's visible slots
    nv = torch.tensor([1024, 700, 700], device=dev, dtype=torch.int32)
    out = da.decode_attention_int8_paged(q, kq, ks, vq, vs, 0, bt, nv)
    assert torch.isnan(out[1]).all()
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[2]).all()
    ok = bt.clone()
    ok[1, 5], ok[2, 12] = 0, 0
    ref = da.decode_attention_int8_paged_plain(q, kq, ks, vq, vs, 0, ok, nv)
    assert (out[0::2] - ref[0::2]).abs().max().item() < DA_ATOL[torch.float32]


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    """A kernel's library is named by its source and every header in
    csrc/, so an edited header builds anew instead of loading a stale
    library."""
    from eventgpt_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    kernel = _build.CudaKernel("kernel.cu", {})
    before = kernel.library_path()
    assert kernel.library_path() == before
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert kernel.library_path() != before


@pytest.mark.cuda
def test_paged_int8_kernel_reads_no_masked_slot_and_agrees_with_k2():
    """Blocks past n_valid, and the masked tail of the last visible one,
    are never read: poisoning them changes nothing, bit for bit. On the
    gathered dense view K3 agrees with K2, whose softmax is one-shot."""
    dev = _card()
    q, kq, ks, vq, vs, bt = _paged_case(2, 9, 32, 3, 1, 4, 2, 32, dev, seed=3)
    bt = torch.tensor([[4, 7, 2]], device=dev, dtype=torch.int32)
    nv = torch.tensor([40], device=dev, dtype=torch.int32)
    out = da.decode_attention_int8_paged(q, kq, ks, vq, vs, 0, bt, nv)
    gathered = [x[0][bt.long()].reshape((1, 96) + tuple(x.shape[3:]))[None].contiguous()
                for x in (kq, ks, vq, vs)]
    dense = da.decode_attention_int8(q, *gathered[:2], *gathered[2:], 0, nv)
    assert (out - dense).abs().max().item() < 2e-3
    kq[:, 2] = 127
    vs[:, 2] = 1e3
    kq[:, 7, 8:] = 127
    vs[:, 7, 8:] = 1e3
    assert torch.equal(da.decode_attention_int8_paged(q, kq, ks, vq, vs, 0, bt, nv), out)


@pytest.mark.cuda
def test_paged_int8_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q, kq, ks, vq, vs, bt = _paged_case(2, 6, 16, 3, 2, 2, 1, 64, dev, seed=0)
    nv = torch.tensor([3, 16], device=dev, dtype=torch.int32)
    f = da.decode_attention_int8_paged
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        f(q.half(), kq, ks, vq, vs, 0, bt, nv)
    with pytest.raises(ValueError, match="int8"):
        f(q, kq.to(torch.int16), ks, vq, vs, 0, bt, nv)
    with pytest.raises(ValueError, match="shape"):
        f(q, kq, ks[:, :, :8].contiguous(), vq, vs, 0, bt, nv)
    with pytest.raises(ValueError, match="contiguous"):
        f(torch.cat([q, q], dim=-1)[..., :64], kq, ks, vq, vs, 0, bt, nv)
    with pytest.raises(ValueError, match="out of range"):
        f(q, kq, ks, vq, vs, 2, bt, nv)
    with pytest.raises(ValueError, match="block_tables"):
        f(q, kq, ks, vq, vs, 0, bt[:1], nv)
    # An entry outside the pool is never read: that row's output is NaN.
    bad = bt.clone()
    bad[1, 0] = 6
    out = f(q, kq, ks, vq, vs, 0, bad, nv)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    x, q4, s = _int4_case(5, 256, 256, 128, torch.device("cpu"), seed=1)
    q, kq, ks, vq, vs = _decode_case(2, 2, 16, 2, 1, 64, torch.device("cpu"), seed=2)
    nv = torch.tensor([3, 16], dtype=torch.int32)
    pq, pkq, pks, pvq, pvs, bt = _paged_case(2, 6, 16, 3, 2, 2, 1, 64, torch.device("cpu"),
                                             seed=3)
    kernels = (i4.INT4_KERNEL, da.DECODE_INT8_KERNEL, da.PAGED_INT8_KERNEL)
    before = [k.launches for k in kernels]
    before_shapes = dict(i4.LAUNCHES_BY_SHAPE)
    y = i4.int4_matmul(x, q4, s)
    o = da.decode_attention_int8(q, kq, ks, vq, vs, 1, nv)
    po = da.decode_attention_int8_paged(pq, pkq, pks, pvq, pvs, 1, bt, nv)
    assert [k.launches for k in kernels] == before
    assert dict(i4.LAUNCHES_BY_SHAPE) == before_shapes
    torch.testing.assert_close(
        po, da.decode_attention_int8_paged_plain(pq, pkq, pks, pvq, pvs, 1, bt, nv),
        rtol=0, atol=0)
    torch.testing.assert_close(y, i4.int4_matmul_reference(x, q4, s), rtol=0, atol=0)
    torch.testing.assert_close(o, da.decode_attention_int8_plain(q, kq, ks, vq, vs, 1, nv),
                               rtol=0, atol=0)
    assert o.dtype == torch.bfloat16 and math.isfinite(o.float().abs().max().item())
