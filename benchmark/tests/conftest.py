"""Runs of the benchmark's cells on the CPU at sizes a test can hold:
``make_run(cell)`` builds the harness's ``Run`` of a cell of the
repository's ``BENCHMARK.json`` (with another configuration's file where
``config_name`` names one) at the small sizes of its traffic's kind
(``SMALL``), then with the given keys of its configuration and traffic
replaced. The fits on the CPU take ``unet_resnet34``: its ResNet-34 is
the lighter encoder."""
import argparse
import os
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: each kind's sizes on the CPU: a serve of 8 images through 2 folds;
#: a fit of 2 check steps of 4 and epochs of 5 steps. The program
#: computes in float32 there (the CPU's bf16 kernels are not the card's),
#: with every conv of an int8 cell quantized (row 3 takes bf16 alone).
SMALL = {"serve": {"config": {"test_images": 8, "folds_served": 2,
                              "dtype": "float32", "pallas_conv": "off"},
                   "traffic": {"batch": 4, "warmup_images": 4,
                               "check_images": 4}},
         "fit": {"config": {"train_images": 24, "dtype": "float32"},
                 "traffic": {"batch": 4, "valid_batch": 4, "check_steps": 2,
                             "warmup_valid_images": 4}}}


@pytest.fixture
def make_run():
    from benchmark import harness

    def make(cell, config=None, traffic=None, seed=2 ** 31 + 11, trace=0,
             config_name=None):
        args = argparse.Namespace(workload=cell, seed=seed, seconds=0.0,
                                  trace=trace)
        spec = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
        run = harness.Run(args, spec, ROOT, time.perf_counter())
        if config_name:
            run.config = harness.read_json(os.path.join(
                ROOT, "benchmark", "configs", f"{config_name}.json"))
        small = SMALL[run.traffic["kind"]]
        run.config.update({**small["config"], **(config or {})})
        run.traffic.update({**small["traffic"], **(traffic or {})})
        run.workdir = run.workdir + f".test{os.getpid()}"
        run.cache_root = os.path.join(run.workdir, "cache")
        return run

    return make
