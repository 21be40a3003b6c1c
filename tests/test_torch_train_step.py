"""The port's train step vs the JAX package's, from the same weights, on
the CPU (UNetResNet18, batch 2, 101 -> 128).

In fp32: ``_train_inputs`` with the augmentation JAX draws from a key;
then one ``runner.update`` (forward in train mode, loss, backward, Adam)
on JAX's network inputs: the loss (1e-5) and the new BatchNorm
statistics (1e-5; the port's BN moves ``running_var`` by the biased
variance as flax does) against JAX's ``value_and_grad`` of
``runner._apply`` + ``loss_fn``.

Gradients, Adam moments and updated parameters are compared with both
networks computing in float64 (the loss's sort in fp32 on both sides, as
each package casts the errors to fp32). In fp32 they cannot be compared
at 1e-4: the BatchNorm backward at 8x8 cancels, and on this input JAX's
fp32 gradient is 23% (of a leaf's max, flax's default one-pass
variance) or 1.9% (its two-pass variance) away from the float64 one,
while the port's fp32 gradient is 9.6e-4 away; that accuracy is held
separately (2e-3). In float64 gradients agree to 1e-4 of each leaf's
max (rtol 1e-4; tied errors are ordered differently by JAX's stable
sort and the port's bitonic network, which moves a few per-pixel loss
gradients).

Adam's first step is ``-lr * g / (|g| + eps)`` per element (g with the
L2 term added), about ``-lr * sign(g)``: where |g| is within the
gradients' tolerance of 0 the two packages may step in opposite
directions. Those elements (|g_jax| at most 10x the gradient tolerance)
are held to ``|delta| <= 2 lr``; every other element to 1e-3 lr.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (flagship_config, port_config, seeded_images,
                          seeded_jax_variables)
from torch_train_parity import jax_augment_params

from salt_tpu.core.experiment import _path_str
from salt_tpu.models.unet import UNetResNet as JaxUNetResNet
from salt_tpu.train.steps import SegmentationRunner as JaxRunner
from salt_tpu_torch.models.convert import load_flax_flat, to_flax_flat
from salt_tpu_torch.models.registry import build_model
from salt_tpu_torch.train.state import TrainState, make_optimizer
from salt_tpu_torch.train.steps import SegmentationRunner

B = 2
LR = 1e-4


def _masks(images):
    return (images > 140).astype(np.uint8)


def _flat_like(model, tensors):
    """Per-parameter tensors (grads, moments) under the flat flax keys."""
    clone = copy.deepcopy(model).float()
    with torch.no_grad():
        for pc, t in zip(clone.parameters(), tensors):
            pc.copy_(t)
    return {k: v for k, v in to_flax_flat(clone).items()
            if k.startswith("params/")}


def _flatten(tree, prefix):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + "/" + "/".join(_path_str(p) for p in path):
            np.asarray(leaf, np.float64) for path, leaf in flat}


def _jax_float64_step(jr, params, stats, x, y):
    """JAX gradients and one ``tx.update`` with the network in float64."""
    with jax.enable_x64(True):
        model = JaxUNetResNet(encoder_depth=18, dtype=jnp.float64,
                              hypercolumn_impl="concat",
                              decoder_impl="concat")
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats)

        def loss(p):
            out, _ = model.apply({"params": p, "batch_stats": s64},
                                 jnp.asarray(x, jnp.float64), train=True,
                                 mutable=["batch_stats"])
            return jr.loss_fn(out, jnp.asarray(y))

        grads = jax.jit(jax.grad(loss))(p64)
        updates, opt = jr.tx.update(grads, jr.tx.init(p64), p64)
        new = jax.tree.map(lambda p, u: p + u, p64, updates)
        adam = [s for s in jax.tree_util.tree_leaves(
            opt, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
        return (_flatten(grads, "params"), _flatten(new, "params"),
                _flatten(adam.mu, "params"), _flatten(adam.nu, "params"),
                _flatten(p64, "params"))


@pytest.fixture(scope="module")
def step():
    cfg = flagship_config(depth=18, dtype="float32")
    cfg.training.lr = LR
    jr = JaxRunner(cfg)
    variables, flat = seeded_jax_variables(jr.model, seed=3)
    images = seeded_images(B, seed=4)
    masks = _masks(images)
    params, stats = variables["params"], variables["batch_stats"]

    # JAX fp32: network inputs, then the loss and the new batch_stats
    aug_key, drop_key = jax.random.split(jax.random.PRNGKey(9))
    jx, jy = jr._train_inputs(jnp.asarray(images), jnp.asarray(masks),
                              aug_key)

    def compute_loss(p):
        out, mutated = jr._apply(p, stats, jx, None, train=True,
                                 rng=drop_key, mutable=True)
        return jr.loss_fn(out, jy), mutated["batch_stats"]

    jloss, jstats = jax.jit(compute_loss)(params)
    jx, jy = np.asarray(jx), np.asarray(jy)

    # the port fp32: same weights, same draws, same network inputs
    pcfg = port_config(cfg)
    runner = SegmentationRunner(pcfg, device="cpu")
    model = build_model(pcfg.model)
    load_flax_flat(model, flat)
    state = runner.train_state(model)
    px, py = runner._train_inputs(torch.from_numpy(images),
                                  torch.from_numpy(masks),
                                  jax_augment_params(aug_key, B, 101, 101))
    x = torch.from_numpy(jx).permute(0, 3, 1, 2)
    ploss = runner.update(state, x, torch.from_numpy(jy))
    m32 = state.model

    # float64 on both sides
    jgrads, jparams, jmu, jnu, old = _jax_float64_step(jr, params, stats,
                                                       jx, jy)
    m64 = build_model(pcfg.model)
    load_flax_flat(m64, flat)
    m64 = m64.double()
    m64.compute_dtype = torch.float64
    s64 = TrainState(m64, make_optimizer(m64, LR, pcfg.training.l2_reg_conv))
    runner.update(s64, x.double(), torch.from_numpy(jy))
    opt = [s64.optimizer.state[p] for p in m64.parameters()]
    return dict(
        jx=jx, jy=jy, px=px, py=py, jloss=float(jloss), ploss=float(ploss),
        jstats=_flatten(jstats, "batch_stats"), pvars32=to_flax_flat(m32),
        pgrads32=_flat_like(m32, [p.grad for p in m32.parameters()]),
        jgrads=jgrads, jparams=jparams, jmu=jmu, jnu=jnu, old=old,
        pgrads=_flat_like(m64, [p.grad for p in m64.parameters()]),
        pparams=_flat_like(m64, list(m64.parameters())),
        pmu=_flat_like(m64, [s["exp_avg"] for s in opt]),
        pnu=_flat_like(m64, [s["exp_avg_sq"] for s in opt]),
        jr=jr, variables=variables, flat=flat, runner=runner,
        images=images, masks=masks)


def test_train_inputs_match_jax(step):
    """Network input at atol 2.5e-4: the augmentation policy's 5e-5
    (tests/test_torch_augment.py) divided by the normalization's 0.229.
    Target: the thresholded mask may flip only where the warped mask sits
    within that tolerance of 0.5 (at most 0.05% of pixels)."""
    x = step["px"].permute(0, 2, 3, 1).numpy()
    assert step["px"].shape == (B, 3, 128, 128)
    np.testing.assert_allclose(x, step["jx"], atol=2.5e-4, rtol=0)
    y = step["py"].numpy()
    assert y.shape == step["jy"].shape == (B, 128, 128, 2)
    assert (y != step["jy"]).mean() <= 5e-4


def test_loss_matches_jax(step):
    assert abs(step["ploss"] - step["jloss"]) <= 1e-5, (step["ploss"],
                                                        step["jloss"])


def test_gradients_match_jax(step):
    jg, pg = step["jgrads"], step["pgrads"]
    assert set(jg) == set(pg)
    for k in jg:
        scale = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(pg[k], jg[k], rtol=1e-4,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)


def test_batch_stats_match_jax(step):
    """Catches the unbiased running variance of ``nn.BatchNorm2d``: at
    the centre (batch 2, 8x8 there) n / (n - 1) is 0.8%."""
    for k, want in step["jstats"].items():
        np.testing.assert_allclose(step["pvars32"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_fp32_gradients_match_float64(step):
    for k, want in step["pgrads"].items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(step["pgrads32"][k], want, rtol=0,
                                   atol=2e-3 * scale + 1e-12, err_msg=k)


def test_adam_moments_match_jax(step):
    for k in step["jmu"]:
        g = step["jgrads"][k]
        tol = 1e-4 * float(np.abs(g).max()) + 1e-12
        np.testing.assert_allclose(step["pmu"][k], step["jmu"][k],
                                   atol=0.1 * 2 * tol, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(step["pnu"][k], step["jnu"][k],
                                   atol=1e-3 * 4 * tol * float(np.abs(g).max()),
                                   rtol=1e-3, err_msg=k)


def test_updated_params_match_jax(step):
    """Adam steps on ``g + l2 * p`` (L2 added first), so the sign test
    is on that sum."""
    l2 = step["runner"].config.training.l2_reg_conv
    n_free = 0
    for k, want in step["jparams"].items():
        got = step["pparams"][k]
        g = step["jgrads"][k]
        tol = 1e-4 * float(np.abs(g).max()) + 1e-12
        free = np.abs(g + l2 * step["old"][k]) <= 10 * tol
        n_free += int(free.sum())
        d_got = got - step["old"][k]
        d_want = want - step["old"][k]
        assert np.all(np.abs(d_got[free]) <= 2 * LR * (1 + 1e-3)), k
        np.testing.assert_allclose(d_got[~free], d_want[~free], rtol=0,
                                   atol=1e-3 * LR, err_msg=k)
    total = sum(v.size for v in step["jparams"].values())
    assert n_free < 0.01 * total, (n_free, total)


def test_val_loss_and_metrics_steps_match_jax(step):
    jr, variables, runner = step["jr"], step["variables"], step["runner"]
    images = seeded_images(4, seed=12)
    masks = _masks(images)
    d = np.zeros((4, 1), np.float32)
    model = build_model(runner.config.model)
    load_flax_flat(model, step["flat"])
    state = runner.train_state(model)
    state.model.eval()
    want = float(jr.val_loss_step(variables["params"],
                                  variables["batch_stats"], images, masks, d))
    got = float(runner.val_loss_step(state.model, torch.from_numpy(images),
                                     torch.from_numpy(masks)))
    assert abs(got - want) <= 1e-5, (got, want)

    thresholds = np.linspace(0.5, 0.3, 21).astype(np.float32)
    probs = np.random.RandomState(5).rand(4, 101, 101).astype(np.float32)
    jiou, jiout = jr.metrics_step(probs, masks, thresholds)
    piou, piout = runner.metrics_step(torch.from_numpy(probs),
                                      torch.from_numpy(masks),
                                      torch.from_numpy(thresholds))
    np.testing.assert_allclose(piou.numpy(), np.asarray(jiou), atol=1e-6)
    np.testing.assert_allclose(piout.numpy(), np.asarray(jiout), atol=1e-6)
    empty = np.zeros_like(masks)
    zero_probs = np.zeros_like(probs)
    jiou, jiout = jr.metrics_step(zero_probs, empty, thresholds)
    piou, piout = runner.metrics_step(torch.from_numpy(zero_probs),
                                      torch.from_numpy(empty),
                                      torch.from_numpy(thresholds))
    assert np.array_equal(piou.numpy(), np.asarray(jiou))
    assert np.array_equal(piout.numpy(), np.asarray(jiout))


def test_bf16_compute_keeps_fp32_params_that_move(step):
    """The bf16 path computes under autocast and updates fp32 weights:
    an Adam step of ~lr = 1e-4 on weights ~0.05 is below bf16's
    resolution there and would be lost on bf16 weights."""
    cfg = port_config(flagship_config(depth=18, dtype="bfloat16"))
    cfg.training.lr = LR
    runner = SegmentationRunner(cfg, device="cpu")
    model = build_model(cfg.model)
    load_flax_flat(model, step["flat"])
    state = runner.train_state(model)
    before = [p.detach().clone() for p in state.model.parameters()]
    g = torch.Generator().manual_seed(0)
    loss = runner.train_step(state, torch.from_numpy(step["images"]),
                             torch.from_numpy(step["masks"]), g)
    assert torch.isfinite(loss)
    moved = total = 0
    for p, b in zip(state.model.parameters(), before):
        assert p.dtype == torch.float32
        d = (p.detach() - b).abs()
        moved += int((d > 0.1 * LR).sum())
        total += d.numel()
    assert moved > 0.9 * total, (moved, total)
    assert state.step == 1


def test_dropout_2d_drops_enc5_channels_in_train_mode_only():
    cfg = port_config(flagship_config(depth=18, dtype="float32"))
    cfg.model.dropout_2d = 0.5
    model = build_model(cfg.model)
    assert model.dropout_2d == 0.5
    x = torch.randn(2, 512, 4, 4)
    model.train()
    a = model._channel_dropout(x, torch.Generator().manual_seed(1))
    b = model._channel_dropout(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    zero = (a == 0).flatten(2).all(dim=2)
    assert 0.3 < float(zero.float().mean()) < 0.7
    torch.testing.assert_close(a[~zero], 2.0 * x[~zero])
