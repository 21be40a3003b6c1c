"""Each configuration names its own model reference: the two U-Nets'
seeded folds, checkpoint arrays and conv sites are pinned, a model that
is not a U-Net goes through seeding, checkpoint writing, FLOP counting
and the conv-site listing as new files alone, and the checkpoint writer
keeps every leaf the program's writer keeps."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from benchmark import costs, inputs, reference, weights
from benchmark.reference import unet

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU = torch.device("cpu")


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def digest(arrays):
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = arrays[k]
        h.update(f"{k}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


#: sha256 of each of two folds' ``flat_arrays`` (seed 7, two calibration
#: images of seed 7) as the harness wrote them before a configuration
#: named its reference; torch 2.13's CPU generator and kernels, one
#: intra-op thread (the head's calibration sums in another order on
#: more)
FOLDS = {
    ("unet_resnet34", 1.0): (
        "1143623c8eff09ea0344ef891a2d5deb65620e6c64da34a1732147c8e1eac3de",
        "0a362a59a06ab8192d002d858a1ba5fbb7b9c09b1222eb249cca4a40139351eb"),
    ("unet_resnet34", 0.1): (
        "9d80c0e03188676eb96f1b1d83ed998f4ee8f30fbd06e0df75a444d3edd9a0b0",
        "d9c0333e69984b375545ffd3b195b5ce30655be636b0615e0279ea818f146fc9"),
    ("unet_seresnext50", 1.0): (
        "f4842571baacf3bff9cde52572712c366c568f10536487ed6202f547c1ef7378",
        "175169d0047f8ad6b4fbf93ddc4964fbc348d82ab913a25c56626ac491ec2920"),
    ("unet_seresnext50", 0.1): (
        "48447667190d9cfe222a00b0b463e789a84dcca564cc5268c4f05a1bd15c1066",
        "f0b618966a39a3b1a85e511a1951dc19ff77d4d077a94c91918bba640b436a15"),
}

#: sha256 of ``repr([vars(site) ...])`` of ``forward_sites(cfg, 4, bits,
#: pallas_conv)`` as listed before a configuration named its reference
SITES = {
    ("unet_resnet34", 8, "on"):
        "4b77b2cf10e8fef4f7c446ab17e5ec5580dd825c2ab2b08384d63a383775fe7d",
    ("unet_resnet34", 0, "off"):
        "19cb7819eb4cef65bbc921ccebc7e654739fee92f3e8ac1deb188114bd3b0bca",
    ("unet_seresnext50", 8, "on"):
        "8491588929042da6b5b48b18c4586d3e55f1481d95cc455671773bf4b3421c16",
    ("unet_seresnext50", 0, "off"):
        "8a56f4bb067b258d870c7f56090f33dff200869fb51c46db1bb331fdf4dbff83",
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name,residual_scale", sorted(FOLDS))
def test_seeded_folds_pinned(name, residual_scale, one_thread):
    cfg = config(name)
    calib, _ = inputs.images_and_masks(2, 7, 3, CPU)
    models = weights.make_folds(cfg, 2, 7, calib, residual_scale)
    got = tuple(digest(weights.flat_arrays(m)) for m in models)
    assert got == FOLDS[(name, residual_scale)]


@pytest.mark.parametrize("name,bits,pallas_conv", sorted(SITES))
def test_forward_sites_pinned(name, bits, pallas_conv):
    sites = costs.forward_sites(config(name), 4, bits, pallas_conv)
    got = hashlib.sha256(repr([vars(s) for s in sites]).encode())
    assert got.hexdigest() == SITES[(name, bits, pallas_conv)]


def test_reference_by_name():
    assert reference.for_config(config("unet_resnet34")) is unet
    assert reference.for_config({"reference": "unet"}) is unet
    with pytest.raises(ValueError):
        reference.for_config({"reference": "../unet"})
    with pytest.raises(ModuleNotFoundError):
        reference.for_config({"reference": "no_such_reference"})


#: a small net that is not a U-Net: a strided stem, an x2 upsample into a
#: conv-BN-PReLU whose slope is a 0-d parameter, no hypercolumn, and its
#: 1x1 head under a name of its own; the stem and the PReLU block take
#: the conv callable, the head does not
TOY = '''
"""A toy model reference: stem, x2 upsample, conv-BN-PReLU, 1x1 head."""
import torch
import torch.nn.functional as F
from torch import nn

HEAD = "logits"
FANLESS = {"prelu_alpha": (0.25, 0.05)}


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 3, padding=1)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-5)
        self.prelu_alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x, conv):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        m = self.Conv_0
        x = self.BatchNorm_0(conv(x, m.weight, m.bias, 1, 1, 1, 1))
        return torch.where(x >= 0, x, self.prelu_alpha * x)


class Toy(nn.Module):
    def __init__(self, width, num_classes):
        super().__init__()
        self.stem = nn.Conv2d(3, width, 3, 2, 1, bias=False)
        self.stem_bn = nn.BatchNorm2d(width, eps=1e-5)
        self.up = Up(width, width)
        self.logits = nn.Conv2d(width, num_classes, 1)

    def forward(self, x, conv=None):
        conv = conv or F.conv2d
        x = F.relu(self.stem_bn(conv(x, self.stem.weight, None, 2, 1, 1, 1)))
        return self.logits(self.up(x, conv))


def build(cfg):
    return Toy(cfg["width"], cfg["num_classes"]).eval()


def build_empty(cfg, device):
    with torch.device("meta"):
        model = build(cfg)
    return model.to_empty(device=device)


@torch.no_grad()
def seed_conventions(model, residual_scale):
    model.up.BatchNorm_0.weight *= residual_scale
'''

#: run in the copied checkout: every step of the harness that takes the
#: model, on the toy's configuration
DRIVE = '''
import json
import numpy as np, torch
import benchmark
from benchmark import costs, flops, inputs, weights
from benchmark.reference import serve
cfg = json.load(open("benchmark/configs/toy.json"))
calib, _ = inputs.images_and_masks(4, 3, 3, torch.device("cpu"))
folds = weights.make_folds(cfg, 2, 2 ** 31 + 5, calib, 0.5)
paths = weights.write_folds(folds, "experiment")
with np.load(paths[1]) as f:
    arrays = {k: f[k] for k in f.files}
with torch.no_grad():
    logits = folds[1](serve.preprocess(calib))
sites = costs.forward_sites(cfg, 2, 8, "on")
print(json.dumps({
    "package": benchmark.__file__,
    "paths": paths,
    "shapes": {k: list(v.shape) for k, v in arrays.items()},
    "alpha": [float(np.load(p)["params/up/prelu_alpha"]) for p in paths],
    "bn_scale": float(np.abs(arrays["params/up/BatchNorm_0/scale"]).mean()),
    "logit_mean": logits.mean((0, 2, 3)).tolist(),
    "logit_std": logits.std((0, 2, 3)).tolist(),
    "flops": flops.forward_flops_per_image(cfg),
    "sites": [[s.x_shape, s.w_shape, s.quantized] for s in sites],
}))
'''


def test_config_added_as_files(tmp_path):
    """A configuration file and its reference module, each a new file in
    a copied checkout, go through ``make_folds``, ``write_folds``,
    ``flops`` and ``forward_sites`` with no file of the checkout edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns(".work*", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "benchmark/reference/toy.py").write_text(textwrap.dedent(TOY))
    (root / "benchmark/configs/toy.json").write_text(json.dumps(
        {"reference": "toy", "width": 8, "num_classes": 2}))
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert {p: p.read_bytes() for p in before} == before
    assert r["package"].startswith(str(root))
    assert [p.endswith(f"network_fold_{k}/best.npz")
            for k, p in enumerate(r["paths"])] == [True, True]
    assert r["shapes"] == {
        "params/stem/kernel": [3, 3, 3, 8],
        "params/stem_bn/scale": [8], "params/stem_bn/bias": [8],
        "batch_stats/stem_bn/mean": [8], "batch_stats/stem_bn/var": [8],
        "params/up/prelu_alpha": [],
        "params/up/Conv_0/kernel": [3, 3, 8, 8],
        "params/up/Conv_0/bias": [8],
        "params/up/BatchNorm_0/scale": [8],
        "params/up/BatchNorm_0/bias": [8],
        "batch_stats/up/BatchNorm_0/mean": [8],
        "batch_stats/up/BatchNorm_0/var": [8],
        "params/logits/kernel": [1, 1, 8, 2], "params/logits/bias": [2]}
    # the slope by FANLESS (0.25 + 0.05 n), one draw a fold; the block's
    # BN scale (1 + 0.1 n) halved by the family's convention
    assert all(0.0 < a < 0.5 for a in r["alpha"])
    assert r["alpha"][0] != r["alpha"][1]
    assert 0.4 < r["bn_scale"] < 0.6
    # the head under the reference's own name is calibrated
    assert np.allclose(r["logit_mean"], 0.0, atol=1e-4)
    assert np.allclose(r["logit_std"], 1.0, atol=1e-4)
    stem = 2 * 64 * 64 * 8 * 3 * 9
    up = 2 * 128 * 128 * 8 * 8 * 9
    head = 2 * 128 * 128 * 2 * 8
    assert r["flops"] == stem + up + head
    assert r["sites"] == [[[2, 3, 128, 128], [8, 3, 3, 3], True],
                          [[2, 8, 128, 128], [8, 8, 3, 3], True]]


def test_flat_arrays_keep_every_leaf_of_the_program():
    """``flat_arrays`` writes the keys and values that the program's
    ``to_flax_flat`` writes, on the program's PSPNet-34, whose PReLU
    slopes are 0-d parameters of their own modules."""
    from salt_tpu_torch.core.config import ModelConfig
    from salt_tpu_torch.models.convert import to_flax_flat
    from salt_tpu_torch.models.registry import build_model, init_seeded
    model = build_model(ModelConfig(architecture="PSPNet", encoder_depth=34))
    init_seeded(model, 3)
    ours, theirs = weights.flat_arrays(model), to_flax_flat(model)
    assert sorted(ours) == sorted(theirs)
    assert [k for k in ours if k.endswith("prelu_alpha")]
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert np.array_equal(ours[k], v), k
