"""The port's schedules and AdamW against optax (the JAX package's optimizer).

Schedules: both evaluated in float32, so they agree to 1e-7 (absolute, at
LRs of order 1e-3..1) over 25 counts. AdamW: the same f32 parameters and
gradients, 5 updates (or 10 micro-batches under accumulation 2), every
parameter within 1e-6 of optax's. Cases: the clip below and above its
threshold, weight decay, the projector group with its own LR, and
``optax.MultiSteps(k=2)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgpt_tpu.train import optim as joptim
from eventgpt_tpu_torch.train import optim as toptim

SCHED_ATOL = 1e-7
ADAM_ATOL = 1e-6


@pytest.mark.parametrize("init_lr,total,warmup,min_lr,start", [
    (2e-3, 20, 3, 0.0, 0.0),
    (2e-3, 20, 0, 0.0, -1.0),
    (1e-4, 17, 5, 1e-5, 0.0),
    (0.5, 25, 4, 0.05, 0.1),
])
def test_linear_warmup_cosine_matches_optax(init_lr, total, warmup, min_lr, start):
    want = joptim.linear_warmup_cosine(init_lr, total, warmup, min_lr, start)
    got = toptim.linear_warmup_cosine(init_lr, total, warmup, min_lr, start)
    for count in range(25):
        w = float(want(jnp.asarray(count, jnp.int32)))
        assert abs(got(count) - w) <= SCHED_ATOL, (count, got(count), w)
    if warmup and start == 0.0:
        assert got(0) == 0.0


def test_step_decay_matches_optax():
    want = joptim.step_decay(1e-2, 1e-4, 0.5, 3)
    got = toptim.step_decay(1e-2, 1e-4, 0.5, 3)
    for count in range(25):
        assert abs(got(count) - float(want(jnp.asarray(count, jnp.int32)))) <= SCHED_ATOL


def _tree(rng):
    return {
        "projector": {"mlp": [{"kernel": rng.standard_normal((6, 4)).astype(np.float32),
                               "bias": rng.standard_normal((4,)).astype(np.float32)}]},
        "lora": {"attn": {"q": {"a": rng.standard_normal((2, 4, 3)).astype(np.float32),
                                "b": rng.standard_normal((2, 3, 5)).astype(np.float32)}}},
    }


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.tensor(np.array(x)), tree)


@pytest.mark.parametrize("case", ["clip_above", "clip_below", "weight_decay",
                                  "projector_lr", "multisteps_2"])
def test_adamw_matches_optax(case):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    # Gradient scale picks the clip side: norms ~ 30 against max_norm 1.0
    # (clipped), ~ 0.03 (not clipped).
    gscale = 0.01 if case == "clip_below" else 10.0
    grads = [jax.tree_util.tree_map(lambda x: (gscale * rng.standard_normal(x.shape))
                                    .astype(np.float32), params) for _ in range(10)]
    kw = dict(weight_decay=0.1 if case == "weight_decay" else 0.0, grad_clip=1.0,
              projector_lr=3e-3 if case == "projector_lr" else None,
              accum_steps=2 if case == "multisteps_2" else 1)
    sched_j = joptim.linear_warmup_cosine(1e-2, 6, 2, 1e-3, 0.0)
    sched_t = toptim.linear_warmup_cosine(1e-2, 6, 2, 1e-3, 0.0)
    tx = joptim.make_optimizer(sched_j, **kw)
    opt = toptim.make_optimizer(sched_t, **kw)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = _to_torch(params)
    tstate = opt.init(tp)
    n_micro = 10 if kw["accum_steps"] == 2 else 5
    for i in range(n_micro):
        updates, jstate = tx.update(grads[i], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        flat = [torch.tensor(np.array(g)) for _, g in
                toptim.tree_leaves(grads[i])]
        tstate = opt.update(tp, flat, tstate)
    for (path, t), (_, j) in zip(toptim.tree_leaves(tp), toptim.tree_leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ADAM_ATOL, rtol=0,
                                   err_msg=str(path))
    assert tstate["count"]["base"] == 5
    # The parameters moved.
    assert not np.allclose(tp["lora"]["attn"]["q"]["a"].numpy(),
                           params["lora"]["attn"]["q"]["a"])


def test_global_norm_and_clip_rule():
    """clip leaves a gradient whose norm is below max_norm as it is and
    scales one above to exactly max_norm (no epsilon in the norm)."""
    g = [torch.tensor([3.0, 4.0])]
    assert float(toptim.global_norm(g)) == 5.0
    opt = toptim.make_optimizer(lambda c: 1.0, grad_clip=5.0, b1=0.0, b2=0.0, eps=0.0)
    p = {"w": torch.zeros(2)}
    state = opt.init(p)
    opt.update(p, g, state)
    # b1 = b2 = 0, eps 0: the update is -lr * g / |g| elementwise = -sign(g).
    np.testing.assert_array_equal(p["w"].numpy(), [-1.0, -1.0])
