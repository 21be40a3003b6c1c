"""Shared helpers of the ``test_torch_*`` parity tests: seeded flagship
weights made by the JAX package and handed to both packages.

Inputs and weights come from numpy seeds and cross between the packages
as numpy arrays; JAX runs on the CPU (tests/conftest.py).
"""
import numpy as np

import jax
import jax.numpy as jnp

from salt_tpu.core.config import default_config
from salt_tpu.core.experiment import _path_str


def flagship_config(depth=18, pad_mode="same", upsample_mode="half_pixel",
                    dtype="float32"):
    """A config of both packages' shared tree (the JAX package's class):
    UNetResNet at ``depth`` with the given parity modes."""
    cfg = default_config()
    cfg.model.architecture = "UNetResNet"
    cfg.model.encoder_depth = depth
    cfg.model.conv_pad_mode = pad_mode
    cfg.model.upsample_mode = upsample_mode
    cfg.training.dtype = dtype
    return cfg


def port_config(jax_cfg):
    """The same settings in the port's own config tree."""
    from salt_tpu_torch.core.config import load_config
    return load_config(None, {f"{section}.{name}": value
                              for section, fields in jax_cfg.to_dict().items()
                              for name, value in fields.items()})


def flatten(variables):
    flat, _ = jax.tree_util.tree_flatten_with_path(variables)
    return {"/".join(_path_str(p) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def unflatten_like(flat, like):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [flat["/".join(_path_str(p) for p in path)] for path, _ in leaves])


def seeded_jax_variables(model, seed=0):
    """flax init of ``model`` (PRNGKey(seed)), then every BatchNorm leaf
    and bias redrawn from numpy seed ``seed`` so the bridge carries
    non-trivial statistics: scale and var U(0.8, 1.2), shift and mean
    0.1 N(0, 1), biases 0.05 N(0, 1)."""
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((2, 128, 128, 3), jnp.float32),
                           train=False)
    flat = flatten(variables)
    rng = np.random.RandomState(seed)
    for key in sorted(flat):
        leaf = key.rsplit("/", 1)[-1]
        shape = flat[key].shape
        if leaf in ("scale", "var"):
            flat[key] = (0.8 + 0.4 * rng.rand(*shape)).astype(np.float32)
        elif leaf == "mean":
            flat[key] = (0.1 * rng.randn(*shape)).astype(np.float32)
        elif leaf == "bias":
            flat[key] = (0.05 * rng.randn(*shape)).astype(np.float32)
            if "BatchNorm" in key:
                flat[key] = (0.1 * rng.randn(*shape)).astype(np.float32)
    return unflatten_like(flat, variables), flat


def numpy_jax_variables(model, seed=0):
    """The variable tree of ``model`` (its shapes traced with
    ``jax.eval_shape``: no flax init runs, which takes tens of seconds
    eagerly on the CPU) filled from numpy seed ``seed``: conv and dense
    kernels N(0, 1 / fan_in) (flax's lecun_normal scale), the BatchNorm
    leaves and biases as :func:`seeded_jax_variables` draws them.
    Returns (variables, flat)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 128, 128, 3), jnp.float32),
        train=False))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    rng = np.random.RandomState(seed)
    flat = {}
    for key, leaf in sorted(("/".join(_path_str(p) for p in path), leaf)
                            for path, leaf in leaves):
        shape = leaf.shape
        name = key.rsplit("/", 1)[-1]
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            value = rng.randn(*shape) / np.sqrt(fan_in)
        elif name in ("scale", "var"):
            value = 0.8 + 0.4 * rng.rand(*shape)
        elif name == "mean" or (name == "bias" and "BatchNorm" in key):
            value = 0.1 * rng.randn(*shape)
        elif name == "bias":
            value = 0.05 * rng.randn(*shape)
        else:
            raise ValueError(f"no draw for the leaf {key}")
        flat[key] = value.astype(np.float32)
    return unflatten_like(flat, shapes), flat


def seeded_images(n, seed=0):
    """Smooth uint8 101x101 images (a blurred random field, so masks have
    structure) from numpy seed ``seed``."""
    rng = np.random.RandomState(seed)
    field = rng.rand(n, 13, 13)
    up = np.kron(field, np.ones((8, 8)))[:, :101, :101]
    noise = 0.15 * rng.rand(n, 101, 101)
    return np.clip((up + noise) / 1.15 * 255, 0, 255).astype(np.uint8)
