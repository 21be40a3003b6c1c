"""The harness finds configurations, cells, traffic, limits and metrics by
name, and a cell added as files alone runs through it."""
import argparse
import json
import os
import shutil
import time

import pytest

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spec():
    return harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_name_resolves():
    s = spec()
    for cell in s["workloads"]:
        args = argparse.Namespace(workload=cell["name"], seed=1, seconds=1,
                                  trace=0)
        run = harness.Run(args, s, ROOT, time.perf_counter())
        assert run.config["architecture"]
        assert run.traffic["kind"] in ("serve", "fit")
        assert run.limits
        names = [m["name"] for m in harness.e2e_metrics(s, cell["name"])]
        assert "setup_s" in names and len(names) >= 2
        layer = [m for m in s["per_layer"]
                 if harness.applies(m, cell["name"])]
        for m in layer:
            assert m["moves"] in names, (cell["name"], m["name"])
        assert layer, cell["name"]
        for m in layer:
            assert callable(harness.reader(ROOT, m["name"]))


def test_configs_used_and_files_distinct():
    s = spec()
    used = {c["config"] for c in s["workloads"]}
    assert used == {c["name"] for c in s["configs"]}
    assert len({c["file"] for c in s["configs"]}) == len(s["configs"])


def test_unknown_workload_refused():
    args = argparse.Namespace(workload="nope", seed=1, seconds=1, trace=0)
    with pytest.raises(SystemExit):
        harness.Run(args, spec(), ROOT, time.perf_counter())


def test_cell_added_as_files(tmp_path):
    """A new traffic mix, limits and a per-layer metric, each a file of
    its own, with entries in BENCHMARK.json: found with no code edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns(".work*", "__pycache__"))
    s = spec()
    s["workloads"].append({"name": "unet_resnet34.serve_b24",
                           "config": "unet_resnet34", "traffic": "serve_b24",
                           "chips": 1, "why": "int8 serve at batch 24"})
    s["per_layer"].append({"name": "dummy.serve", "unit": "%",
                           "better": "lower", "source": "host_clock",
                           "layer": "device", "moves": "serve_images_per_s",
                           "workloads": ["unet_resnet34.serve_b24"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    traffic = json.loads(
        (root / "benchmark/workloads/serve_int8.json").read_text())
    traffic["batch"] = 24
    (root / "benchmark/workloads/serve_b24.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/limits/unet_resnet34.serve_b24.json").write_text(
        json.dumps({"mask_error": 1e-3}))
    (root / "benchmark/metrics/dummy.serve.py").write_text(
        "def read(run):\n    return run.facts.get('x')\n")
    args = argparse.Namespace(workload="unet_resnet34.serve_b24", seed=1,
                              seconds=1, trace=1)
    run = harness.Run(args, s, str(root), time.perf_counter())
    assert run.traffic["batch"] == 24 and run.limits == {"mask_error": 1e-3}
    run.facts["x"] = 7.0
    assert harness.reader(str(root), "dummy.serve")(run) == 7.0
    run.facts.clear()
    assert harness.reader(str(root), "dummy.serve")(run) is None


def test_metric_applies_by_workloads():
    m = {"name": "a", "moves": "serve_images_per_s", "workloads": ["x"]}
    assert harness.applies(m, "x")
    assert not harness.applies({**m, "workloads": ["y"]}, "x")
    # every per-layer metric lists its cells
    assert all(m["workloads"] for m in spec()["per_layer"])
