"""The port's losses against ``salt_tpu.losses`` on the CPU, fp32.

Values at rtol = atol = 1e-6 (at 1e-5 where a row sums 20,000 terms or
more: there JAX's fp32 dot drifts from the float64 value, and the port
is held to that at 1e-6). Gradients:
- against JAX ``lovasz_hinge`` (which sorts with ``lax.sort_key_val`` on
  the CPU) on tie-free inputs, where any correct sort gives the same
  gradient;
- against ``jax.vmap(lovasz_hinge_flat_bitonic)`` exactly with ties: the
  port's per-image hinge sorts with the same network, so tied errors take
  the same Lovász gradient entries.
The value does not depend on tie order (a tied block contributes
``elu(e) * sum(grad)``), so it is held against ``sort_key_val`` with ties
too. A row length the kernel does not take (2 x 101 x 101) goes through
the stable ``torch.sort`` path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salt_tpu.losses import lovasz as jl
from salt_tpu.ops.bitonic import lovasz_hinge_flat_bitonic
from salt_tpu_torch.losses import lovasz as tl
from salt_tpu_torch.losses.api import get_loss_fn

TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(b, h, w, ties=False, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, h, w, 2).astype(np.float32)
    if ties:
        logits = np.round(logits * 2) / 2
    fg = (rng.rand(b, h, w) > 0.6).astype(np.float32)
    fg[0] = 0.0                                   # one empty mask
    labels = np.stack([1 - fg, fg], axis=-1)
    return logits, labels


def _port_value_and_grad(fn, logits, labels):
    x = torch.from_numpy(logits).requires_grad_(True)
    v = fn(x, torch.from_numpy(labels))
    v.backward()
    return float(v), x.grad.numpy()


@pytest.mark.parametrize("size_weighted", [False, True],
                         ids=["plain", "size_weighted"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_per_image_hinge_value(size_weighted, ties):
    logits, labels = _pair(3, 32, 32, ties)           # P = 2048: the kernel's
    want = float(jl.lovasz_hinge(jnp.asarray(logits), jnp.asarray(labels),
                                 per_image=True, size_weighted=size_weighted))
    got = float(tl.lovasz_hinge(torch.from_numpy(logits),
                                torch.from_numpy(labels), per_image=True,
                                size_weighted=size_weighted))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size_weighted", [False, True],
                         ids=["plain", "size_weighted"])
def test_per_image_hinge_gradient_tie_free(size_weighted):
    logits, labels = _pair(2, 32, 32, seed=1)
    want = np.asarray(jax.grad(lambda x: jl.lovasz_hinge(
        x, jnp.asarray(labels), per_image=True,
        size_weighted=size_weighted))(jnp.asarray(logits)))
    _, got = _port_value_and_grad(
        lambda x, y: tl.lovasz_hinge(x, y, per_image=True,
                                     size_weighted=size_weighted),
        logits, labels)
    np.testing.assert_allclose(got, want, **TOL)


def test_per_image_hinge_gradient_with_ties_matches_bitonic_network():
    logits, labels = _pair(2, 32, 32, ties=True, seed=2)
    b = logits.shape[0]

    def jax_loss(x):
        return jnp.mean(jax.vmap(lovasz_hinge_flat_bitonic)(
            x.reshape(b, -1), jnp.asarray(labels).reshape(b, -1)))

    want_v, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    got_v, got_g = _port_value_and_grad(
        lambda x, y: tl.lovasz_hinge(x, y, per_image=True), logits, labels)
    np.testing.assert_allclose(got_v, float(want_v), **TOL)
    # the same tie order: a different one would move whole Lovász
    # gradient entries (~1/P); what remains is rounding
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-6,
                               atol=1e-12)


def _float64_hinge(logits, labels):
    """The hinge of one flat row in float64 (numpy), for the value."""
    e = 1.0 - logits.astype(np.float64) * (2.0 * labels - 1.0)
    order = np.argsort(-e, kind="stable")
    es, gs = e[order], labels[order].astype(np.float64)
    gts = gs.sum()
    jac = 1.0 - (gts - np.cumsum(gs)) / (gts + np.cumsum(1.0 - gs))
    grad = np.concatenate([jac[:1], jac[1:] - jac[:-1]])
    return float(np.dot(np.where(es > 0, es, np.expm1(es)), grad))


def test_whole_batch_hinge_and_a_length_the_kernel_does_not_take():
    """Rows of 20,402 (per image) and 40,804 (whole batch) values: the
    sum of that many fp32 terms is where the packages part. The port's
    value is within 1e-6 of the float64 one; JAX's XLA dot drifts up to
    9e-6 from it, so the value is held against JAX at 1e-5."""
    logits, labels = _pair(2, 101, 101, seed=3)       # P = 20402
    rows = [_float64_hinge(logits[i].reshape(-1), labels[i].reshape(-1))
            for i in range(2)]
    exact = {True: float(np.mean(rows)),
             False: _float64_hinge(logits.reshape(-1), labels.reshape(-1))}
    for per_image in (True, False):
        want_v, want_g = jax.value_and_grad(lambda x: jl.lovasz_hinge(
            x, jnp.asarray(labels), per_image=per_image))(jnp.asarray(logits))
        got_v, got_g = _port_value_and_grad(
            lambda x, y: tl.lovasz_hinge(x, y, per_image=per_image),
            logits, labels)
        np.testing.assert_allclose(got_v, exact[per_image], **TOL)
        np.testing.assert_allclose(got_v, float(want_v), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got_g, np.asarray(want_g), **TOL)


@pytest.mark.parametrize("per_image", [False, True])
def test_lovasz_softmax(per_image):
    rng = np.random.RandomState(4)
    z = rng.randn(2, 16, 16, 3).astype(np.float32)
    probas = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    labels = rng.randint(0, 3, (2, 16, 16))
    want = float(jl.lovasz_softmax(jnp.asarray(probas), jnp.asarray(labels),
                                   per_image=per_image))
    got = float(tl.lovasz_softmax(torch.from_numpy(probas),
                                  torch.from_numpy(labels),
                                  per_image=per_image))
    np.testing.assert_allclose(got, want, **TOL)


def test_stable_bce_and_the_registry():
    logits, labels = _pair(2, 16, 16, seed=5)
    logits = logits * 20                              # saturated too
    want = float(jl.stable_bce_with_logits(jnp.asarray(logits),
                                           jnp.asarray(labels)))
    got = float(get_loss_fn("bce")(torch.from_numpy(logits),
                                   torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, **TOL)
    # the other losses are ported (tests/test_torch_losses_extra.py)
    from salt_tpu.losses.api import get_loss_fn as jax_get_loss_fn
    for name in ("dice", "focal", "mixed_dice_bce"):
        want = float(jax_get_loss_fn(name)(jnp.asarray(logits),
                                           jnp.asarray(labels)))
        got = float(get_loss_fn(name)(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(KeyError):
        get_loss_fn("nope")
