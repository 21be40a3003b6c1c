"""The dice, mixed dice and focal losses of the port (``losses/dice.py``,
``losses/focal.py``, through ``losses/api.py``) against the JAX
package's, fp32 on the CPU: each loss's value and its gradient with
respect to the logits at rtol=atol=1e-5, on random masks and on empty
and full ones. NHWC [B, H, W, 2] logits and one-hot targets, as the
train step hands them over."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from salt_tpu.losses import focal as jax_focal
from salt_tpu.losses.api import get_loss_fn as jax_get_loss_fn
from salt_tpu_torch.losses import focal
from salt_tpu_torch.losses.api import get_loss_fn

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ["dice", "mixed_dice_bce", "mixed_dice_ce", "focal",
         "focal_weighted"]


def _blobs(b, h, w, seed):
    """Masks of a few filled discs each."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for _ in range(2):
            cy, cx = rng.rand(2) * (h, w)
            r = 2 + rng.rand() * min(h, w) / 4
            masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1.0
    return masks


def _inputs(kind, b=2, h=24, w=24, seed=0):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(b, h, w, 2)).astype(np.float32)
    masks = {"random": _blobs(b, h, w, seed + 1),
             "empty": np.zeros((b, h, w), np.float32),
             "full": np.ones((b, h, w), np.float32)}[kind]
    target = np.stack([1.0 - masks, masks], axis=-1).astype(np.float32)
    return logits, target


def _jax_value_and_grad(fn, logits, target):
    value, grad = jax.value_and_grad(
        lambda x: fn(x, jnp.asarray(target)))(jnp.asarray(logits))
    return float(value), np.asarray(grad)


def _port_value_and_grad(fn, logits, target):
    x = torch.from_numpy(logits).requires_grad_(True)
    value = fn(x, torch.from_numpy(target))
    value.backward()
    return float(value.detach()), x.grad.numpy()


@pytest.mark.parametrize("kind", ["random", "empty", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_value_and_gradient_match_jax(name, kind):
    logits, target = _inputs(kind, seed=NAMES.index(name))
    want, want_grad = _jax_value_and_grad(jax_get_loss_fn(name), logits,
                                          target)
    got, got_grad = _port_value_and_grad(get_loss_fn(name), logits, target)
    assert np.isfinite(got) and np.isfinite(got_grad).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_grad, want_grad, **TOL)


@pytest.mark.parametrize("border_size", [1, 2, 3, 10])
@pytest.mark.parametrize("hw", [(24, 24), (15, 18)], ids=["even", "odd"])
def test_boundary_band_matches_reduce_window_same(border_size, hw):
    """Dilation minus erosion by max pooling equals the JAX package's
    ``reduce_window`` with SAME padding at odd and even band sizes and on
    odd and even sides."""
    fg = _blobs(3, *hw, seed=border_size)
    fg[2] = 0.0
    want = np.asarray(jax_focal._boundary_band(jnp.asarray(fg), border_size))
    got = focal.boundary_band(torch.from_numpy(fg), border_size).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].any() and not got[2].any()


def test_focal_knobs_match_jax():
    """The focal loss's other knobs: alpha, gamma, the focus threshold,
    a low weight cap and a narrow band."""
    logits, target = _inputs("random", seed=11)
    kw = dict(alpha=0.25, gamma=1.5, focus_threshold=0.2,
              use_size_weight=True, max_weight=3.0, use_border_weight=True,
              border_size=2, border_weight=4.0)
    want, want_grad = _jax_value_and_grad(
        lambda x, t: jax_focal.weighted_focal_loss(x, t, **kw), logits,
        target)
    got, got_grad = _port_value_and_grad(
        lambda x, t: focal.weighted_focal_loss(x, t, **kw), logits, target)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_grad, want_grad, **TOL)


def test_every_jax_loss_name_resolves():
    from salt_tpu.losses import api as jax_api
    import inspect
    src = inspect.getsource(jax_api.get_loss_fn)
    for name in NAMES + ["lovasz", "lovasz_size_weighted", "bce"]:
        assert f'"{name}"' in src
        assert callable(get_loss_fn(name))
    with pytest.raises(KeyError, match="unknown loss"):
        get_loss_fn("nope")
