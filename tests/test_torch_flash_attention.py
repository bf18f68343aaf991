"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs
in interpret mode, as ``tests/test_flash_attention.py`` runs it. Both are
f32 softmax attention summed in another order, so they agree to f32
rounding: atol 2e-5, the JAX test's own bar against dense attention. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu.ops.flash_attention import flash_attention as jax_flash
from eventgpt_tpu_torch.ops import flash_attention as tflash

CASES = [
    # (shape, causal, lengths or None) -- the cases of test_flash_attention.py
    ((2, 128, 2, 128), True, None),
    ((1, 256, 4, 128), True, None),
    ((2, 128, 2, 128), False, None),
    ((2, 128, 2, 128), True, [100, 128]),
    ((1, 200, 2, 128), True, None),
    ((2, 200, 2, 128), False, [150, 200]),
]


@pytest.mark.parametrize("shape,causal,lens", CASES)
def test_plain_flash_matches_jax(shape, causal, lens):
    rng = np.random.default_rng(sum(shape) + int(causal))
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    b, s = shape[:2]
    valid = np.ones((b, s), bool) if lens is None else np.arange(s)[None, :] < np.array(lens)[:, None]

    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               valid=jnp.asarray(valid), causal=causal))
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 valid=torch.from_numpy(valid), causal=causal)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)
    if lens is not None:
        for row, n in enumerate(lens):
            # Padded query rows are exactly zero.
            assert np.abs(out.numpy()[row, n:]).max(initial=0.0) == 0.0


def test_plain_flash_fully_masked_row_is_finite():
    """A row with no visible key takes the finite NEG_INF path: no NaN."""
    q = torch.randn(1, 4, 1, 128)
    valid = torch.tensor([[False, False, False, False]])
    out = tflash.flash_attention(q, q, q, valid=valid)
    assert torch.isfinite(out).all() and (out == 0).all()


def test_kernel_wrapper_refuses_other_devices():
    q = torch.empty((1, 8, 1, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention(q, q, q)

