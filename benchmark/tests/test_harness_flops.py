"""Each configuration file's ``forward_flops_per_image`` is a fresh
``FlopCounterMode`` count of the reference at 128x128."""
import glob
import json
import os

import pytest

from benchmark import flops

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "*.json")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_flops_table(path):
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["forward_flops_per_image"] == flops.forward_flops_per_image(cfg)


def test_published_counts():
    counts = {os.path.basename(p): json.load(open(p))[
        "forward_flops_per_image"] for p in CONFIGS}
    assert round(counts["unet_resnet34.json"] / 1e9, 1) == 19.5
    assert round(counts["unet_seresnext50.json"] / 1e9, 1) == 173.3
