"""Shared helpers of the ``test_torch_*`` parity tests: seeded flagship
weights made by the JAX package and handed to both packages.

Inputs and weights come from numpy seeds and cross between the packages
as numpy arrays; JAX runs on the CPU (tests/conftest.py).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from salt_tpu.core.config import default_config
from salt_tpu.core.experiment import _path_str
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu.models.registry import takes_depth
from salt_tpu_torch.models.convert import to_flax_flat
from salt_tpu_torch.models.registry import build_model

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


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


def arch_configs(arch, depth, **model):
    """(JAX config, port config) of ``arch`` at ``encoder_depth``
    ``depth``, with the other ``model`` fields given."""
    cfg = flagship_config(depth)
    cfg.model.architecture = arch
    for k, v in model.items():
        setattr(cfg.model, k, v)
    return cfg, port_config(cfg)


def check_keys_and_shapes(arch, depth):
    """The port model's flat flax keys and shapes are those of the JAX
    registry's model (traced, nothing compiled)."""
    cfg, pcfg = arch_configs(arch, depth)
    shapes = jax_variable_shapes(jax_build_model(cfg.model, "float32"),
                                 depth=takes_depth(arch))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = {"/".join(_path_str(p) for p in path): tuple(leaf.shape)
            for path, leaf in leaves}
    got = {k: v.shape for k, v in to_flax_flat(
        build_model(pcfg.model)).items()}
    assert sorted(got) == sorted(want)
    assert got == want


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


def jax_variable_shapes(model, depth=False):
    """``model``'s variable tree as shapes, traced with ``jax.eval_shape``
    (no flax init runs, which takes tens of seconds eagerly on the CPU);
    ``depth``: the model also takes the [B, 1] depth."""
    extra = (jnp.zeros((2, 1), jnp.float32),) if depth else ()
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 128, 128, 3), jnp.float32),
        *extra, train=False))


def numpy_jax_variables(model, seed=0, depth=False):
    """The variable tree of ``model`` (:func:`jax_variable_shapes`)
    filled from numpy seed ``seed``: conv and dense kernels N(0, 1 /
    fan_in) (flax's lecun_normal scale), the BatchNorm leaves and biases
    as :func:`seeded_jax_variables` draws them. Returns (variables,
    flat)."""
    shapes = jax_variable_shapes(model, depth)
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


def load_tool(name):
    """A module of the repository's ``tools/`` directory, loaded by path
    (it is not a package)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_ulp_rule(got, want, terms, k):
    """The largest |got - want| over its tolerance, one bf16 ulp of
    ``want`` plus 2 K 2^-24 ``terms`` (terms = sum |x||w| of each output):
    two fp32 sums of the same K exact products in different orders differ
    by at most the second term, and their bf16 roundings by one ulp more.
    <= 1 passes. Arguments are numpy arrays."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    _, exp = np.frexp(want)
    ulp = np.where(want == 0, 0.0, np.ldexp(1.0, exp - 8))
    tol = ulp + 2 * k * 2.0 ** -24 * np.asarray(terms, np.float64)
    return float((np.abs(got - want) / np.maximum(tol, 1e-30)).max())
