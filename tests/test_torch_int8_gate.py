"""The int8 quality gate and the serve provenance in the port, modelled
on tests/test_int8_gate.py: the CV flow with ``model.quant_bits=8``
writes one ``int8_gate_<name>.json`` a fold, and ``serve`` with int8
writes ``<out>.int8_gate.json``; both carry the JAX package's keys, and
the JAX package's own ``write_serve_provenance`` reads the port's
artifacts as its own (the same payload, "measured"). UNetResNet-18,
fp32, 2 folds of 8 synthetic images, on the CPU (the plain int8 conv
runs in float64, a few seconds a forward here)."""
import copy
import json
import os

import pytest
import torch

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

GATE_KEYS = {"checkpoint", "checkpoint_sha256", "quant_bits",
             "n_validation_images", "float", "int8", "iout_delta"}


@pytest.fixture(scope="module")
def trained_cv_exp(tmp_path_factory):
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.core.experiment import Experiment
    from salt_tpu_torch.data.bundle import synthetic_bundle
    from salt_tpu_torch.pipeline import api

    cfg = default_config()
    cfg.model.encoder_depth = 18
    cfg.training.dtype = "float32"
    cfg.training.epochs = 1
    cfg.training.batch_size_train = 4
    cfg.training.batch_size_inference = 4
    cfg.execution.n_cv_splits = 2
    cfg.paths.experiment_dir = str(tmp_path_factory.mktemp("gate") / "exp")
    exp = Experiment(cfg.paths.experiment_dir)
    bundle = synthetic_bundle(8, seed=9)
    api.train_evaluate_cv(cfg, exp, bundle, device="cpu")
    cfg_q = copy.deepcopy(cfg)
    cfg_q.model.quant_bits = 8
    api.evaluate_cv(cfg_q, exp, bundle, device="cpu")
    return cfg_q, exp


def test_cv_flow_writes_a_gate_artifact_per_fold(trained_cv_exp):
    from salt_tpu_torch.pipeline.quality import file_sha256
    _, exp = trained_cv_exp
    for fold in range(2):
        path = os.path.join(exp.directory,
                            f"int8_gate_network_fold_{fold}.json")
        with open(path) as f:
            gate = json.load(f)
        assert set(gate) == GATE_KEYS
        assert gate["quant_bits"] == 8 and gate["n_validation_images"] == 4
        assert set(gate["float"]) == set(gate["int8"]) == {"iou", "iout"}
        assert abs(gate["iout_delta"]) < 0.5       # the same checkpoint
        assert gate["checkpoint_sha256"] == file_sha256(gate["checkpoint"])


def test_serve_int8_provenance_matches_jax(trained_cv_exp, tmp_path):
    from salt_tpu.pipeline.quality import \
        write_serve_provenance as jax_provenance
    from salt_tpu_torch.pipeline.serving import resolve_checkpoints, serve

    cfg_q, exp = trained_cv_exp
    out_csv = str(tmp_path / "sub.csv")
    result = serve(cfg_q, exp.directory, "", out_csv, synthetic=4,
                   device="cpu")
    assert result["int8_provenance"] == out_csv + ".int8_gate.json"
    with open(result["int8_provenance"]) as f:
        prov = json.load(f)
    assert prov["quant_bits"] == 8 and prov["gate_status"] == "measured"
    assert len(prov["checkpoints"]) == len(prov["gates"]) == 2
    shas = {c["sha256"] for c in prov["checkpoints"]}
    assert {g["checkpoint_sha256"] for g in prov["gates"]} == shas
    jax_csv = str(tmp_path / "jax.csv")
    path = jax_provenance(jax_csv, resolve_checkpoints(exp.directory), 8,
                          exp.directory)
    with open(path) as f:
        assert json.load(f) == prov
    # full precision writes none
    cfg = copy.deepcopy(cfg_q)
    cfg.model.quant_bits = 0
    assert "int8_provenance" not in serve(cfg, exp.directory, "",
                                          str(tmp_path / "f.csv"),
                                          synthetic=4, device="cpu")
