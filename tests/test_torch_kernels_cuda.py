"""The port's hand-written CUDA kernels against their plain versions, on the card.

This file imports torch and the port only, so it runs on a machine without
JAX:  python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda
Without a card the ``cuda`` tests skip; a CUDA kernel has no CPU mode.
"""

import pytest
import torch

from eventgpt_tpu_torch.ops import flash_attention as fa

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
    assert (out.float() - ref.float()).abs().max().item() < ATOL
    for row, n in enumerate(lens.tolist()):
        assert (out[row, n:] == 0).all()


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
