"""K1's gradient in the port against ``jax.grad`` through the JAX package's
``flash_attention`` (the Pallas kernel in interpret mode, its ``custom_vjp``
backward), at f32 on the CPU.

The same numpy q/k/v/mask and output cotangent go through both; dq, dk and
dv agree within 1e-5 (both backwards are the same dense f32 formula, so
they differ by the order of f32 sums). Cases: causal and not, right-padded
query rows, and GQA with the gradient taken through the head repeat.
Also: padded query rows pass no gradient, the no-grad call is the plain
forward as before, and the backward is counted once per call, with the
recompute of a checkpointed layer counted apart from the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from eventgpt_tpu.models.llama import _repeat_kv as j_repeat_kv
from eventgpt_tpu.ops.flash_attention import flash_attention as j_flash
from eventgpt_tpu_torch.models.llama import _repeat_kv
from eventgpt_tpu_torch.ops import flash_attention as fa

ATOL = 1e-5


def _inputs(seed, b, s, h, kv, hd, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    g = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    valid = np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, g, valid


def _jax_grads(q, k, v, g, valid, causal):
    n_rep = q.shape[2] // k.shape[2]

    def f(q, k, v):
        out = j_flash(q, j_repeat_kv(k, n_rep), j_repeat_kv(v, n_rep), valid=jnp.asarray(valid),
                      causal=causal, interpret=True)
        return jnp.sum(out * g)

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port_grads(q, k, v, g, valid, causal):
    n_rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention(qt, _repeat_kv(kt, n_rep).contiguous(),
                             _repeat_kv(vt, n_rep).contiguous(), valid=torch.tensor(valid),
                             causal=causal)
    (out * torch.tensor(g)).sum().backward()
    return out, [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("case", ["causal", "not_causal", "padded", "gqa_padded"])
def test_flash_grad_matches_jax(case):
    b, s, h, kv, hd = 2, 40, 4, 4, 16
    lengths = [s, s]
    if case in ("padded", "gqa_padded"):
        lengths = [s, 23]
    if case == "gqa_padded":
        kv = 2
    causal = case != "not_causal"
    q, k, v, g, valid = _inputs(5, b, s, h, kv, hd, lengths)
    want = _jax_grads(q, k, v, g, valid, causal)
    _, got = _port_grads(q, k, v, g, valid, causal)
    for name, w, t in zip("qkv", want, got):
        np.testing.assert_allclose(t, w, atol=ATOL, rtol=0, err_msg=f"d{name}")
    if lengths[1] < s:
        # Padded query rows pass no gradient to q, and none is NaN.
        assert np.all(got[0][1, lengths[1]:] == 0)
        assert all(np.isfinite(x).all() for x in got)


def test_function_matches_autograd_through_plain_version():
    q, k, v, g, valid = _inputs(6, 2, 33, 2, 2, 8, [33, 20])
    _, got = _port_grads(q, k, v, g, valid, True)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention_reference(qt, kt, vt, torch.tensor(valid), causal=True)
    (out * torch.tensor(g)).sum().backward()
    for t, ref in zip(got, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(t, ref.numpy(), atol=ATOL, rtol=0)


def test_no_grad_call_is_the_plain_forward():
    q, k, v, _, valid = _inputs(7, 1, 17, 2, 2, 8, [12])
    args = [torch.tensor(x) for x in (q, k, v)] + [torch.tensor(valid)]
    with torch.no_grad():
        out = fa.flash_attention(*args)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_reference(*args))


def test_backward_counted_and_recompute_under_checkpoint():
    q, k, v, g, valid = _inputs(8, 1, 16, 2, 2, 8, [16])
    qt = torch.tensor(q, requires_grad=True)
    kt, vt, gt, vm = torch.tensor(k), torch.tensor(v), torch.tensor(g), torch.tensor(valid)
    before = dict(fa.LAUNCHES_BY_PATH)

    def layer(x):
        return fa.flash_attention(x * 1.0, kt, vt, valid=vm)

    (checkpoint(layer, qt, use_reentrant=False) * gt).sum().backward()
    # On the CPU nothing launches; the backward runs once for the one call.
    assert fa.LAUNCHES_BY_PATH["backward"] == before["backward"] + 1
    for key in ("inference", "train_forward", "recompute"):
        assert fa.LAUNCHES_BY_PATH[key] == before[key]
    assert qt.grad is not None and torch.isfinite(qt.grad).all()
