"""A run with the timed path broken underneath comes out not correct, and
a sound one correct: the harness's whole run on the CPU (without its
look for a chip), at a size a test can hold, once for each fault a cell
can have."""
import pytest
import torch

from benchmark import harness, inputs
from benchmark.kinds import serve as serve_kind


def serve_step_fault(monkeypatch, kind):
    from salt_tpu_torch.train.steps import SegmentationRunner
    step = SegmentationRunner.predict_tta_step

    def broken(self, model, images_u8, depths=None):
        if kind == "half_batch":
            half = step(self, model, images_u8[:images_u8.shape[0] // 2])
            return torch.cat([half, half])
        out = step(self, model, images_u8)
        out[0] = 1.0 - out[0]           # one image's answer altered
        return out

    monkeypatch.setattr(SegmentationRunner, "predict_tta_step", broken)


def drop_unchecked_answer(monkeypatch, run):
    """The submission loses the row of one image outside the checked
    sample."""
    import salt_tpu_torch.ops.rle as rle
    ids = inputs.image_ids(run.config["test_images"], run.seed)
    checked = {ids[i] for i in serve_kind.check_sample(run)}
    victim = next(i for i in ids if i not in checked)
    make = rle.create_submission

    def dropped(meta, predictions):
        frame = make(meta, predictions)
        return frame[frame["id"] != victim]

    monkeypatch.setattr(rle, "create_submission", dropped)


@pytest.mark.parametrize("fault", [None, "altered_answer", "half_batch",
                                   "dropped_answer"])
def test_serve_fault(make_run, monkeypatch, fault):
    run = make_run("unet_resnet34.serve_int8")
    if fault == "dropped_answer":
        drop_unchecked_answer(monkeypatch, run)
    elif fault:
        serve_step_fault(monkeypatch, fault)
    out = harness.execute(run, "cpu")
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] == 8
    assert out["failed"] == (fault == "dropped_answer")
    if fault == "dropped_answer":
        assert out["checks"]["mask_error"]["value"] <= \
            out["checks"]["mask_error"]["limit"]


def fit_fault(monkeypatch, kind):
    from salt_tpu_torch.train.steps import SegmentationRunner
    if kind == "unchanged_state":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        return
    loss = SegmentationRunner.train_loss

    def half(self, logits, y):
        b = logits.shape[0] // 2
        return loss(self, logits[:b], y[:b])

    monkeypatch.setattr(SegmentationRunner, "train_loss", half)


@pytest.mark.parametrize("fault", [None, "unchanged_state", "half_batch"])
def test_fit_fault(make_run, monkeypatch, fault):
    run = make_run("unet_seresnext50.fit", config_name="unet_resnet34")
    if fault:
        fit_fault(monkeypatch, fault)
    out = harness.execute(run, "cpu")
    assert out["correct"] is (fault is None), out["checks"]
    if fault == "unchanged_state":
        assert out["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)
