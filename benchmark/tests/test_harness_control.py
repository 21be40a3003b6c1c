"""On the card, at sizes a test run holds: each cell's sound program
reads within its limits and its control does not (the reference in the
next lower precision, or the fault planted in it). The control's
readings at the cells' own sizes are in PERF.md; ``benchmark.control``
makes them."""
import os
import shutil

import pytest
import torch

from benchmark import control
from benchmark.kinds import fit as fit_kind

#: the configuration's own precision and route, which the CPU's sizes
#: replace (conftest.SMALL)
CARD = {"dtype": "bfloat16", "pallas_conv": "on"}


def on_card(run):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.device = torch.device("cuda:0")
    shutil.rmtree(run.workdir, ignore_errors=True)
    os.makedirs(run.workdir)
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["unet_resnet34.serve_int8"])
def test_serve_control_fails(make_run, cell):
    run = on_card(make_run(cell, config={**CARD, "test_images": 256,
                                         "folds_served": 2},
                           traffic={"batch": 64, "warmup_images": 64,
                                    "check_images": 64}))
    try:
        out = control.serve_readings(run)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    limit = run.limits["mask_error"]
    lower = control.CONTROL[run.traffic["quant_bits"]]
    assert out["program"] <= limit < out[f"control_reference_{lower}"], out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["unet_seresnext50.fit"])
def test_fit_control_fails(make_run, cell):
    run = on_card(make_run(cell, config={**CARD, "train_images": 480},
                           traffic={"batch": 24, "valid_batch": 24,
                                    "check_steps": 3,
                                    "warmup_valid_images": 48}))
    try:
        out = control.fit_readings(run)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)

    def fails(reading):
        return any(reading[k] > run.limits[k] for k in fit_kind.COMPARED)

    assert not fails(out["program"]), out
    assert fails(out["control_reference_fp8"]), out
    assert fails(out["fault_half_batch"]), out
