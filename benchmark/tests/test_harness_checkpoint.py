"""The benchmark's weights restore in the program with no key missing or
unused, and at a small size on the CPU the reference agrees with the
program's forward (plain and int8) and with its first training steps.
The tests import the program; the reference never does."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import inputs, weights
from benchmark.kinds import fit as fit_kind
from benchmark.kinds import serve as serve_kind
from benchmark.reference import quant
from benchmark.reference import serve as ref_serve

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU = torch.device("cpu")


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def runner(cfg, quant_bits=0, dtype="float32"):
    from salt_tpu_torch.train.steps import SegmentationRunner
    c = serve_kind.port_config({**cfg, "dtype": dtype},
                               {"quant_bits": quant_bits, "batch": 2})
    return SegmentationRunner(c, "cpu")


@pytest.mark.parametrize("name", ["unet_resnet34", "unet_seresnext50"])
def test_checkpoint_restores_every_key(name, tmp_path):
    from salt_tpu_torch.models.convert import to_flax_flat
    cfg = config(name)
    calib, _ = inputs.images_and_masks(2, 5, 3, CPU)
    models = weights.make_folds(cfg, 1, 5, calib)
    path = weights.write_folds(models, str(tmp_path))[0]
    assert path.endswith("checkpoints/network_fold_0/best.npz")
    model = runner(cfg).restore(path)       # strict: raises on a mismatch
    with np.load(path) as f:
        written = set(f.files)
    assert written == set(to_flax_flat(model))
    ref = {k for k in models[0].state_dict()
           if not k.endswith("num_batches_tracked")}
    port = {k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")}
    assert ref == port


@pytest.fixture(scope="module")
def flagship():
    cfg = config("unet_resnet34")
    calib, _ = inputs.images_and_masks(4, 9, 3, CPU)
    model = weights.make_folds(cfg, 1, 9, calib)[0]
    images, _ = inputs.images_and_masks(2, 9, 1, CPU)
    return cfg, model, weights.flat_arrays(model), images


def test_forward_and_tta_agree(flagship):
    cfg, model, arrays, images = flagship
    r = runner(cfg)
    port = r.restore(arrays)
    x = ref_serve.preprocess(images)
    with torch.no_grad():
        assert torch.allclose(port(x, infer=True), model(x), atol=1e-4)
        p = r.predict_tta_step(port, images)[:, 1]
        q = ref_serve.tta_probs(model, images)
    assert (p - q).abs().max() < 1e-5


def test_int8_forward_agrees(flagship):
    """The program's int8 convs in fp32 against the frozen arithmetic:
    the same integers but where an operand lies on a bucket's edge, so
    the same probabilities but near such a flip (measured: mean 8e-7,
    widest 1e-3, where int8 departs from fp32 by 7e-3 and 5e-2)."""
    cfg, model, arrays, images = flagship
    r = runner({**cfg, "pallas_conv": "off"}, quant_bits=8)
    port = r.restore(arrays)
    with torch.no_grad():
        p = r.predict_tta_step(port, images)[:, 1]
        q = ref_serve.tta_probs(model, images, quant.conv_policy(8, "off"))
        full = ref_serve.tta_probs(model, images)
    gap, int8 = (p - q).abs(), (q - full).abs()
    assert gap.mean() < 1e-2 * int8.mean()
    assert gap.max() < 0.1 * int8.max()


def test_first_training_steps_agree(make_run):
    run = make_run("unet_seresnext50.fit", config_name="unet_resnet34")
    run.device = CPU
    os.makedirs(run.workdir, exist_ok=True)
    try:
        prep = fit_kind.Prepared(run)
    finally:
        import shutil
        shutil.rmtree(run.workdir, ignore_errors=True)
    g = prep.gaps(prep.reference(run))
    assert g["loss_gap"] < 1e-5 and g["grad_gap_worst"] < 1e-4
    assert g["update_norm_gap"] < 1e-2
    assert g["leaves_in_change"] >= 0.95 * len(prep.start)
