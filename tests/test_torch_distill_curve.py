"""The port's distillation curve (``salt_tpu_torch/tools/distill_curve.py``)
and its bench's student context (``salt_tpu_torch/tools/bench.py``)
against the JAX package's ``tools/distill_curve.py`` and ``bench.py``, on
the CPU.

- With ``cli.main`` replaced in both packages, the port's curve hands its
  ``cli.main`` the JAX tool's flag list for every student, with
  ``--device`` last, at full budget and in ``--smoke``; it defaults to
  ``cuda`` and raises where CUDA is absent.
- A real ``--smoke --device cpu --students saltunet16`` run against a
  fabricated teacher (a seeded ``out_of_fold_train_predictions.npz``
  over the bundle's ids, no CV run) writes ``distill_curve.json`` with
  the JAX layout; ``--reprobe-throughput`` rewrites the reports, the
  int8 student's probed in int8.
- ``emit_distill_context``, ``qualified_student_fields`` (bar 5000) and
  ``measure_serve_student``'s choice (serve replaced) equal bench.py's on
  the files tests/test_tools_smoke.py:120-195 fabricates, but for the
  names of the ratios (``vs_flagship_tta_int8``) and bench.py's
  rounding."""
import importlib
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from salt_tpu_torch.tools import bench as port_bench
from salt_tpu_torch.tools import distill_curve as port_curve

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = {"student_iout": 0.5, "teacher_iout": 0.625, "iout_delta": -0.125,
          "student_tta_images_per_sec": 1234.5}


def _jax_curve():
    spec = importlib.util.spec_from_file_location(
        "distill_curve", os.path.join(REPO, "tools", "distill_curve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording_cli(calls):
    """A ``cli.main`` that records its flags and writes the student's
    report where ``paths.experiment_dir`` points."""
    def main(flags):
        calls.append(list(flags))
        exp = next(f.split("=", 1)[1] for f in flags
                   if f.startswith("paths.experiment_dir="))
        os.makedirs(exp, exist_ok=True)
        with open(os.path.join(exp, "distill_report.json"), "w") as f:
            json.dump(REPORT, f)
        return 0
    return main


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_flag_lists_equal_the_jax_tools(tmp_path, monkeypatch, smoke):
    import salt_tpu.cli
    import salt_tpu_torch.cli
    monkeypatch.setenv("SALT_TPU_PLATFORM", "cpu")
    teacher = str(tmp_path / "teacher")
    argv = ["--teacher", teacher, "--n-images", "480", "--epochs", "3",
            "--seed", "5"] + (["--smoke"] if smoke else [])
    jax_calls, port_calls = [], []
    monkeypatch.setattr(salt_tpu.cli, "main", _recording_cli(jax_calls))
    _jax_curve().main(argv)
    with open(tmp_path / "distill_curve.json") as f:
        jax_layout = json.load(f)
    for name in port_curve.STUDENTS:
        shutil.rmtree(tmp_path / f"distill_{name}")
    monkeypatch.setattr(salt_tpu_torch.cli, "main",
                        _recording_cli(port_calls))
    curve = port_curve.main(argv + ["--device", "cpu"])
    assert len(port_calls) == len(jax_calls) == len(port_curve.STUDENTS)
    for got, want in zip(port_calls, jax_calls):
        assert got == want + ["--device", "cpu"]
    assert ("--measure-throughput" in want) != smoke
    assert curve == jax_layout
    assert list(port_curve.STUDENTS) == list(_jax_curve().STUDENTS)
    assert port_curve.STUDENTS == _jax_curve().STUDENTS


def test_defaults_to_cuda_and_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_curve.parse_args(["--teacher", "t"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_curve.main(["--teacher", str(tmp_path / "t"), "--smoke"])
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def smoke_curve(tmp_path_factory):
    """``--smoke --device cpu --students saltunet16`` against a teacher
    directory holding only a seeded out-of-fold archive over the smoke
    bundle's ids (``--seed 0``, the ``real`` difficulty)."""
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.data.bundle import synthetic_bundle
    root = tmp_path_factory.mktemp("curve")
    teacher = str(root / "teacher")
    ids = synthetic_bundle(port_curve.SMOKE_IMAGES, seed=0,
                           difficulty="real").meta["id"].tolist()
    salt = np.random.RandomState(3).rand(len(ids), 101, 101)
    probs = np.stack([1 - salt, salt], 1).astype(np.float32)
    Experiment(teacher).save_predictions("out_of_fold_train_predictions",
                                         ids, probs)
    curve = port_curve.main(["--teacher", teacher, "--smoke",
                             "--students", "saltunet16", "--device", "cpu"])
    return root, teacher, curve


def test_smoke_run_writes_the_jax_layout(smoke_curve):
    root, teacher, curve = smoke_curve
    with open(root / "distill_curve.json") as f:
        assert json.load(f) == curve
    assert set(curve) == {"teacher", "students", "teacher_iout"}
    assert curve["teacher"] == teacher
    rep = curve["students"]["saltunet16"]
    assert {"student_iout", "teacher_iout", "iout_delta",
            "student_architecture", "n_train", "n_valid"} <= set(rep)
    assert rep["n_train"] + rep["n_valid"] == port_curve.SMOKE_IMAGES
    assert curve["teacher_iout"] == rep["teacher_iout"]
    assert "student_tta_images_per_sec" not in rep    # smoke: no probe
    assert os.path.exists(root / "distill_saltunet16" / "checkpoints" /
                          "network" / "best.npz")
    # a report on disk is read, not trained again
    again = port_curve.main(["--teacher", teacher, "--smoke",
                             "--students", "saltunet16", "--device", "cpu"])
    assert again == curve


def test_reprobe_rewrites_reports_and_keeps_the_int8_student_int8(
        smoke_curve, monkeypatch):
    """The probe replaced: each student's runner reaches it with the
    quant_bits of its own config.json (the int8 student: a copy of the
    smoke student whose config says 8)."""
    from salt_tpu_torch.pipeline import distill
    root, teacher, _ = smoke_curve
    int8_dir = root / "distill_saltunet32_int8"
    shutil.copytree(root / "distill_saltunet16", int8_dir)
    with open(int8_dir / "config.json") as f:
        cfg = json.load(f)
    cfg["model"]["quant_bits"] = 8
    with open(int8_dir / "config.json", "w") as f:
        json.dump(cfg, f)
    seen = []

    def probe(runner, model):
        seen.append((runner.config.model.quant_bits,
                     runner.config.training.batch_size_inference))
        return 100.0 + len(seen)

    monkeypatch.setattr(distill, "_measure_student_throughput", probe)
    curve = port_curve.main(["--teacher", teacher, "--smoke",
                             "--students", "saltunet16", "saltunet32_int8",
                             "--reprobe-throughput", "--device", "cpu"])
    assert seen == [(0, 64), (8, 64)]
    assert [r["student_tta_images_per_sec"]
            for r in curve["students"].values()] == [101.0, 102.0]
    with open(int8_dir / "distill_report.json") as f:
        assert json.load(f)["student_tta_images_per_sec"] == 102.0


# -- the bench's student context against bench.py ---------------------------

def _jax_bench():
    bench = importlib.import_module("bench")
    bench._CONTEXT.clear()
    return bench


def _write_curve(root, students, name="distill_curve.json", mtime=None):
    root.mkdir(parents=True, exist_ok=True)
    path = root / name
    with open(path, "w") as f:
        json.dump({"teacher": "t", "students": students}, f)
    if mtime is not None:
        os.utime(path, (mtime, mtime))


def test_emit_distill_context_equals_bench_py(tmp_path):
    _write_curve(tmp_path / "old", {"saltunet16": {
        "student_tta_images_per_sec": 1.0, "iout_delta": 0.0,
        "teacher_iout": 0.5, "student_iout": 0.5}}, mtime=1000)
    _write_curve(tmp_path / "seed0", {
        "saltunet16": {"student_tta_images_per_sec": 7500.0,
                       "iout_delta": -0.05, "teacher_iout": 0.80,
                       "student_iout": 0.75},
        "unetresnet18": {"student_tta_images_per_sec": 4321.625,
                         "iout_delta": -0.00377, "teacher_iout": 0.8125,
                         "student_iout": 0.80873},
        "unmeasured": {"iout_delta": 0.0, "teacher_iout": 0.8,
                       "student_iout": 0.8}}, mtime=2000)
    bench = _jax_bench()
    bench.emit_distill_context(root=str(tmp_path))
    want = dict(bench._CONTEXT)
    bench._CONTEXT.clear()
    got = port_bench.emit_distill_context(str(tmp_path), 5000.0)
    assert set(got) == set(want) == {"distill_saltunet16",
                                     "distill_unetresnet18"}
    for name, rec in want.items():
        port = got[name]
        assert port["curve"] == str(tmp_path / "seed0" / "distill_curve.json")
        assert port["unit"] == rec["unit"]
        assert port["value"] == pytest.approx(rec["value"], abs=0.05)
        for key in ("iout_delta", "teacher_iout", "student_iout"):
            assert port[key] == pytest.approx(rec[key], abs=5e-5)
        assert port["vs_flagship_tta_int8"] == pytest.approx(
            rec["vs_5000_target"], abs=5e-4)
    assert port_bench.emit_distill_context(str(tmp_path / "none"), 1.0) == {}


def test_qualified_student_fields_equal_bench_py():
    bench = _jax_bench()
    ctx = {"flagship_tta_int8": {"value": 2925.5, "unit": "images/sec/chip"},
           "distill_saltunet16": {"value": 10000.0, "iout_delta": -0.05},
           "distill_unetresnet18": {"value": 4200.0, "iout_delta": -0.004}}
    assert port_bench.qualified_student_fields(ctx, 5000.0) == \
        bench.qualified_student_fields(ctx) == {}
    ctx["distill_saltunet32"] = {"value": 6800.0, "iout_delta": -0.013}
    ctx["distill_other"] = {"value": 5600.0, "iout_delta": 0.001}
    ctx["distill_edge"] = {"value": 9000.0, "iout_delta": -0.02}
    want = bench.qualified_student_fields(ctx)
    got = port_bench.qualified_student_fields(ctx, 5000.0)
    want["distilled_student_vs_flagship_tta_int8"] = want.pop(
        "distilled_student_vs_baseline")
    assert got == want
    assert got["distilled_student"] == "edge"
    # the port's bar is the run's own int8 flagship rate
    assert port_bench.qualified_student_fields(ctx, 2925.5)[
        "distilled_student"] == "edge"
    assert port_bench.qualified_student_fields(
        ctx, 2925.5, max_iout_cost=0.015)["distilled_student"] == "saltunet32"


def test_measure_serve_student_chooses_as_bench_py(tmp_path, monkeypatch):
    import salt_tpu.pipeline.serving as jax_serving
    from salt_tpu.core.config import default_config as jax_default_config
    from salt_tpu_torch.tools.bench import bench_config
    for i, name in enumerate(["distill_old", "distill_new", "distill_mid"]):
        d = tmp_path / f"seed0/{name}"
        d.mkdir(parents=True)
        with open(d / "distill_report.json", "w") as f:
            json.dump({"iout_delta": -0.01 * (i + 1)}, f)
        mtime = (1000, 3000, 2000)[i]
        os.utime(d / "distill_report.json", (mtime, mtime))
    served = {}

    def fake_serve(cfg, checkpoint, images_dir, out_csv, synthetic=0,
                   **kwargs):
        served.setdefault("checkpoints", []).append(checkpoint)
        served.setdefault("synthetic", []).append(synthetic)
        return {"n": synthetic, "images_per_sec": 6100.0, "seconds": 0.5,
                "submission": out_csv}

    monkeypatch.setattr(jax_serving, "serve", fake_serve)
    monkeypatch.setattr(port_bench, "serve", fake_serve)
    bench = _jax_bench()
    assert bench.measure_serve_student(jax_default_config(),
                                       root=str(tmp_path)) == 6100.0
    want = bench._CONTEXT["serve_student"]
    bench._CONTEXT.clear()
    cfg = bench_config(tiny=True, quant_bits=8)
    got = port_bench.measure_serve_student(cfg, str(tmp_path), "cpu")
    assert served["checkpoints"][0] == served["checkpoints"][1]
    assert served["checkpoints"][1].endswith("distill_new")
    assert served["synthetic"] == [2048, 2048]
    assert {k: got[k] for k in ("value", "student", "iout_delta")} == \
        {k: want[k] for k in ("value", "student", "iout_delta")}
    assert got["quant_bits"] == 8 and cfg.model.quant_bits == 8
    assert port_bench.measure_serve_student(cfg, str(tmp_path / "none"),
                                            "cpu") is None


@pytest.mark.parametrize("arch,convs", [("SaltUNet", 2 * 3 + 2 * 2),
                                        ("SaltLinkNet", 3 + 2)])
def test_int8_student_routes_every_conv_bn_relu(monkeypatch, arch, convs):
    """``model.quant_bits=8`` sends each ConvBnRelu conv of a scratch net
    (2 levels, 8 filters) through the int8 convs in the infer form and
    none in the train form (the JAX package leaves these nets in full
    precision: ``saltunet32_int8`` is int8 only in the port). The int8
    logits sit within 5% of the logits' scale from the fp32 ones, a bound
    on 8-bit quantization of both operands, not a parity tolerance."""
    from salt_tpu_torch.core.config import load_config
    from salt_tpu_torch.models import quant
    from salt_tpu_torch.models.registry import build_model, init_seeded
    calls = []
    conv = quant.conv2d_int8

    def record(x, w, *args):
        calls.append(tuple(w.shape))
        return conv(x, w, *args)

    monkeypatch.setattr(quant, "conv2d_int8", record)
    sets = {"model.architecture": arch, "model.n_filters": 8,
            "model.repeat_blocks": 2}
    fp = init_seeded(build_model(load_config(None, sets).model), seed=0)
    q = build_model(load_config(None, {**sets,
                                       "model.quant_bits": 8}).model)
    q.load_state_dict(fp.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 32, 32)
                         .astype(np.float32))
    with torch.no_grad():
        want = fp(x, infer=True)
        assert torch.equal(q(x), fp(x)) and not calls
        got = q(x, infer=True)
    n_conv_bn_relu = sum(type(m).__name__ == "ConvBnRelu"
                         for m in q.modules())
    assert len(calls) == n_conv_bn_relu == convs
    assert float((got - want).abs().max()) <= 0.05 * float(want.abs().max())
