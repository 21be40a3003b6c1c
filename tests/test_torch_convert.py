"""Checkpoint bridge: a ``best.npz`` written by the JAX package's
``Experiment.save_params`` loads into the port and comes back through
``to_flax_flat`` with the same keys, shapes and values (exact: the
conversion only transposes)."""
import numpy as np
import pytest
import torch

from torch_parity import flagship_config, port_config, seeded_jax_variables

from salt_tpu.core.experiment import Experiment
from salt_tpu.models.registry import build_model as jax_build_model
from salt_tpu_torch.core.experiment import load_flat_npz, save_flat_npz
from salt_tpu_torch.models.convert import (from_flax_flat, load_flax_flat,
                                           to_flax_flat)
from salt_tpu_torch.models.registry import build_model

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    cfg = flagship_config(18)
    variables, flat = seeded_jax_variables(
        jax_build_model(cfg.model, "float32"), seed=3)
    exp = Experiment(str(tmp_path_factory.mktemp("bridge") / "exp"))
    path = exp.save_params("network", {"params": variables["params"],
                                       "batch_stats": variables["batch_stats"]})
    return cfg, path, flat


def test_jax_best_npz_round_trips_through_port(jax_checkpoint, tmp_path):
    cfg, path, flat = jax_checkpoint
    arrays = load_flat_npz(path)
    assert set(arrays) == set(flat)
    model = load_flax_flat(build_model(port_config(cfg).model), arrays)
    back = to_flax_flat(model)
    assert set(back) == set(arrays)
    for key, value in arrays.items():
        assert back[key].shape == value.shape, key
        assert back[key].dtype == np.float32, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)

    # the port's own save is readable by the JAX package's loader
    from salt_tpu.pipeline.serving import _load_flat_npz
    out = save_flat_npz(str(tmp_path / "port" / "best.npz"), back)
    restored = _load_flat_npz(out, jax_restore_like(flat))
    for key, value in flat.items():
        node = restored
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node, value, err_msg=key)


def jax_restore_like(flat):
    """A nested dict of zeros with the checkpoint's structure."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros_like(value)
    return tree


def test_leaf_conversions(jax_checkpoint):
    """HWIO -> OIHW, Dense [in,out] -> Linear [out,in], spatial-SE Dense
    -> 1x1 conv, BN leaves -> weight/bias/running stats."""
    _, _, flat = jax_checkpoint
    sd = from_flax_flat(flat)
    k = flat["params/encoder/conv1/kernel"]
    torch.testing.assert_close(sd["encoder.conv1.weight"],
                               torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    d = flat["params/dec1/ChannelSELayer_0/Dense_0/kernel"]
    torch.testing.assert_close(sd["dec1.ChannelSELayer_0.Dense_0.weight"],
                               torch.from_numpy(d.T.copy()))
    s = flat["params/dec1/SpatialSELayer_0/Dense_0/kernel"]
    assert sd["dec1.SpatialSELayer_0.Dense_0.weight"].shape == (1, s.shape[0], 1, 1)
    bn = "encoder.layer2_0.downsample_bn.BatchNorm_0"
    np.testing.assert_array_equal(
        sd[bn + ".running_var"].numpy(),
        flat["batch_stats/encoder/layer2_0/downsample_bn/BatchNorm_0/var"])
    np.testing.assert_array_equal(
        sd[bn + ".weight"].numpy(),
        flat["params/encoder/layer2_0/downsample_bn/BatchNorm_0/scale"])


def test_shape_mismatch_is_refused(jax_checkpoint):
    _, _, flat = jax_checkpoint
    from salt_tpu_torch.core.config import default_config
    model = build_model(default_config().model)       # depth 34
    with pytest.raises((ValueError, RuntimeError)):
        load_flax_flat(model, flat)
