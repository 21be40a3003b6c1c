"""Port augmentation vs ``salt_tpu.ops.augment``.

``apply_augment`` is deterministic given its draws, so it is fed the
values JAX draws from a key (tests/torch_train_parity.py) and held
against ``augment_batch(key, ...)``. The two packages run the same fp32
arithmetic in the same order; they differ only where a library rounds
differently (sin/cos, the 8x8 solve, the elastic upsample, XLA's fusion
under ``jit``), which moves a source coordinate by an ulp or two at 101
px (7.6e-6 to 3e-5 px). Given the same coordinates the sampling is bit
for bit the same, and the filter and intensity ops agree to 1e-5. A
coordinate ulp times the steepest step of an image is what remains:
``augment_batch`` jitted and run eagerly differs from itself by up to
3.8e-5 on these inputs, so the whole policy is held at atol=5e-5 on
[0, 1] images and masks, and the test shows the JAX package's own
spread beside it. The port's own draws are held to the policy's
probabilities statistically."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import seeded_images
from torch_train_parity import jax_augment_params

from salt_tpu.ops import augment as jaug
from salt_tpu_torch.ops import augment as taug

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

ATOL = 1e-5          # per op, same coordinates
ATOL_POLICY = 5e-5   # whole policy: a coordinate ulp x an image step


def _batch(b, seed):
    imgs = seeded_images(b, seed=seed).astype(np.float32) / 255.0
    masks = (imgs > 0.55).astype(np.float32)
    return imgs, masks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_matches_jax_augment_batch(seed):
    b = 16
    imgs, masks = _batch(b, seed)
    key = jax.random.PRNGKey(seed)
    want_i, want_m = jaug.augment_batch(key, jnp.asarray(imgs),
                                        jnp.asarray(masks))
    with jax.disable_jit():
        eager_i, eager_m = jaug.augment_batch(key, jnp.asarray(imgs),
                                              jnp.asarray(masks))
    params = jax_augment_params(key, b, 101, 101)
    got_i, got_m = taug.apply_augment(params, torch.from_numpy(imgs),
                                      torch.from_numpy(masks))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i),
                               atol=ATOL_POLICY, rtol=0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                               atol=ATOL_POLICY, rtol=0)
    # the JAX package's own jit-vs-eager spread is of the same size
    spread = max(np.abs(np.asarray(want_i) - np.asarray(eager_i)).max(),
                 np.abs(np.asarray(want_m) - np.asarray(eager_m)).max())
    port = max(np.abs(got_i.numpy() - np.asarray(eager_i)).max(),
               np.abs(got_m.numpy() - np.asarray(eager_m)).max())
    assert port <= ATOL_POLICY and spread <= ATOL_POLICY, (port, spread)
    assert params.do_flip.any() or params.do_aff.any()


def test_sampling_is_exact_given_the_coordinates():
    """With JAX's coordinate maps, the port's gather and blend give the
    JAX result bit for bit."""
    b = 16
    imgs, _ = _batch(b, 5)
    kg = jax.random.split(jax.random.PRNGKey(5), 3)[0]
    ys, xs = jaug.make_warp_coords(kg, b, 101, 101)
    want = np.asarray(jaug.bilinear_sample(jnp.asarray(imgs), ys, xs))
    got = taug.bilinear_sample(torch.from_numpy(imgs),
                               torch.from_numpy(np.asarray(ys)),
                               torch.from_numpy(np.asarray(xs))).numpy()
    np.testing.assert_array_equal(got, want)


def test_every_op_fires_somewhere_in_the_parity_batches():
    """The three parity keys above cover each gate and every branch."""
    ps = [jax_augment_params(jax.random.PRNGKey(s), 16, 101, 101)
          for s in (0, 1, 2)]
    for gate in ("do_flip", "do_aff", "do_persp", "do_pw", "gate_s",
                 "gate_e", "inv_gate", "cn_gate"):
        assert any(bool(getattr(p, gate).any()) for p in ps), gate
    branches = set(torch.cat([p.branch for p in ps]).tolist())
    assert {4, 5, 6, 7} <= branches


def test_bilinear_sample_matches_jax_gather_form():
    rng = np.random.RandomState(3)
    img = rng.rand(3, 17, 23).astype(np.float32)
    ys = (rng.rand(3, 17, 23) * 22 - 2).astype(np.float32)   # some outside
    xs = (rng.rand(3, 17, 23) * 28 - 2).astype(np.float32)
    want = np.asarray(jaug.bilinear_sample(jnp.asarray(img), jnp.asarray(ys),
                                           jnp.asarray(xs)))
    got = taug.bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys),
                               torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_make_warp_coords_matches_jax():
    """Coordinates in pixels: atol 1e-4 px (the homography's 8x8 solve
    and sin/cos round differently in the two libraries)."""
    key = jax.random.PRNGKey(7)
    b, h, w = 12, 101, 101
    kg = jax.random.split(key, 3)[0]
    want_y, want_x = jaug.make_warp_coords(kg, b, h, w)
    params = jax_augment_params(key, b, h, w)
    got_y, got_x = taug.make_warp_coords(params, h, w)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-4,
                               rtol=0)


def test_filter_and_intensity_ops_match_jax():
    key = jax.random.PRNGKey(11)
    b = 16
    imgs, _ = _batch(b, 4)
    _, kf, ki = jax.random.split(key, 3)
    params = jax_augment_params(key, b, 101, 101)
    want_f = np.asarray(jaug.filter_ops(kf, jnp.asarray(imgs)))
    got_f = taug.filter_ops(params, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got_f, want_f, atol=ATOL, rtol=0)
    want_i = np.asarray(jaug.intensity_ops(ki, jnp.asarray(imgs)))
    got_i = taug.intensity_ops(params, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got_i, want_i, atol=ATOL, rtol=0)


def test_draw_augment_params_statistics():
    """Gate frequencies and value ranges of the port's draws at b = 4096:
    every gate within 4 sigma of its probability, every branch within 4
    sigma of 1/8, the uniforms inside their ranges."""
    b = 4096
    g = torch.Generator().manual_seed(0)
    p = taug.draw_augment_params(g, b, 8, 8)
    probs = {"do_flip": 0.375, "do_aff": 0.375, "do_persp": 0.3,
             "do_pw": 0.3, "gate_s": 0.375, "gate_e": 0.375,
             "inv_gate": 0.3, "cn_gate": 0.3}
    for name, prob in probs.items():
        freq = float(getattr(p, name).float().mean())
        sigma = (prob * (1 - prob) / b) ** 0.5
        assert abs(freq - prob) < 4 * sigma, (name, freq)
    counts = torch.bincount(p.branch, minlength=8).float() / b
    sigma = (1 / 8 * 7 / 8 / b) ** 0.5
    assert float((counts - 1 / 8).abs().max()) < 4 * sigma
    for name, lo, hi in (("theta", -10, 10), ("tx", -0.05, 0.05),
                         ("scale", 0.05, 0.10), ("e_scale", 0.04, 0.08),
                         ("alpha", 0.5, 1.5), ("add_v", -10 / 255, 10 / 255),
                         ("mul_v", 0.95, 1.05), ("noise", -1.0, 1.0)):
        v = getattr(p, name)
        assert float(v.min()) >= lo and float(v.max()) <= hi, name
    assert abs(float(p.jitter.std()) - 1.0) < 0.05
    assert p.noise.shape == (b, 8, 8) and p.coarse.shape == (b, 2, 5, 5)


def test_draws_are_reproducible_from_the_seed():
    a = taug.draw_augment_params(torch.Generator().manual_seed(5), 4, 8, 8)
    b = taug.draw_augment_params(torch.Generator().manual_seed(5), 4, 8, 8)
    assert torch.equal(a.noise, b.noise) and torch.equal(a.branch, b.branch)
