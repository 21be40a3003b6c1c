"""The port's tracer (``salt_tpu_torch/core/tracing.py``) on the CPU: span
nesting with parent and root ids, the shared no-op with tracing off,
counters, the session's lifetime, the profiler range with tracing off;
and the spans and counter of a small ``serve()`` and ``fit()``."""
import json
import math
import os
import threading

import numpy as np
import pytest
import torch

from salt_tpu_torch.core import tracing
from salt_tpu_torch.core.config import default_config
from salt_tpu_torch.core.experiment import checkpoint_path, save_flat_npz
from salt_tpu_torch.data.pipeline import batch_count, batch_indices
from salt_tpu_torch.models.convert import to_flax_flat
from salt_tpu_torch.models.registry import build_model, init_seeded
from salt_tpu_torch.ops import conv_kernel
from salt_tpu_torch.pipeline.serving import serve
from salt_tpu_torch.train.loop import fit
from salt_tpu_torch.train.steps import SegmentationRunner

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

SERVE_SPANS = ("serve.restore", "serve.decode", "serve.upload",
               "serve.forward", "serve.download", "serve.submission",
               "serve.provenance")
STEP_CHILDREN = ["fit.feed", "fit.augment", "fit.forward", "fit.backward",
                 "fit.optimizer", "fit.loss_read", "fit.callbacks"]


def test_nesting_parent_and_root_ids():
    with tracing.session() as rec:
        with tracing.span("a", k=1) as a:
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("d") as d:
                d.set(x="y")
            a.set(n=2)
        with tracing.span("e"):
            pass
    names = [s.name for s in rec.spans]
    assert names == ["a", "b", "c", "d", "e"]
    a, b, c, d, e = rec.spans
    assert [s.id for s in rec.spans] == list(range(5))
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (
        None, a.id, b.id, a.id, None)
    assert {s.root for s in (a, b, c, d)} == {a.id} and e.root == e.id
    assert a.attrs == {"k": 1, "n": 2} and d.attrs == {"x": "y"}
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start
    assert d.end <= a.end <= e.start <= e.end
    assert rec.children(a) == [b, d] and rec.named("c") == [c]


def test_off_returns_the_shared_noop_and_records_nothing():
    assert tracing.span("x") is tracing.span("y", k=1) is tracing.NO_SPAN
    with tracing.span("x") as s:
        s.set(k=1)
        tracing.count("n")
    with tracing.session() as rec:
        pass
    # a span and a count after the session are not recorded
    with tracing.span("late"):
        tracing.count("late")
    assert rec.spans == [] and rec.counters == {}
    assert tracing.span("x") is tracing.NO_SPAN


def test_count():
    with tracing.session() as rec:
        tracing.count("a")
        tracing.count("a", 3)
        tracing.count("b", 0)
    assert rec.counters == {"a": 4, "b": 0}


def test_session_clears_on_exit():
    with pytest.raises(ValueError):
        with tracing.session() as first:
            with tracing.span("a"):
                raise ValueError("inside")
    assert tracing._active() is None
    assert [s.name for s in first.spans] == ["a"] and first.spans[0].end
    with tracing.session() as second:
        with pytest.raises(RuntimeError):
            with tracing.session():
                pass
    assert second.spans == [] and tracing._active() is None


def test_other_threads_are_not_recorded():
    def work():
        with tracing.span("other"):
            tracing.count("other")

    with tracing.session() as rec:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        with tracing.span("mine"):
            pass
    assert not t.is_alive()
    assert [s.name for s in rec.spans] == ["mine"] and rec.counters == {}


def test_profiler_range_with_tracing_off():
    """Under a running profiler a span opens its ``record_function`` range
    without a session, as ``chip_smoke.py`` reads the conv repack's."""
    assert conv_kernel.REPACK_RANGE == "conv3x3_pair.repack"
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span(conv_kernel.REPACK_RANGE) as s:
            assert s is not tracing.NO_SPAN
            torch.ones(4).add_(1)
    ranges = [e for e in prof.events() if e.name == conv_kernel.REPACK_RANGE
              and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(ranges) == 1
    assert tracing.span("x") is tracing.NO_SPAN


@pytest.mark.parametrize("n,bs,drop_last", [(97, 24, True), (96, 24, True),
                                            (23, 24, True), (97, 24, False),
                                            (5, 1, True), (0, 3, False)])
def test_batch_count_is_batch_indices_length(n, bs, drop_last):
    rng = np.random.RandomState(0)
    assert batch_count(n, bs, drop_last) == len(
        list(batch_indices(n, bs, True, rng, drop_last)))


def _scratch_config():
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 4
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    cfg.training.batch_size_train = 2
    cfg.training.batch_size_inference = 2
    cfg.training.validate_every_n_epochs = 1
    return cfg


N_IMAGES, FOLDS = 5, 2


@pytest.fixture(scope="module")
def traced_serve(tmp_path_factory):
    """An int8 serve of 5 PNGs through 2 fold checkpoints, batch 2, hflip
    TTA, under a tracing session."""
    root = tmp_path_factory.mktemp("traced_serve")
    cfg = _scratch_config()
    exp = str(root / "cv")
    for fold in range(FOLDS):
        model = init_seeded(build_model(cfg.model), seed=30 + fold)
        save_flat_npz(checkpoint_path(exp, f"network_fold_{fold}"),
                      to_flax_flat(model))
    with open(os.path.join(exp, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    from PIL import Image
    (root / "imgs").mkdir()
    rng = np.random.RandomState(31)
    for i in range(N_IMAGES):
        Image.fromarray(rng.randint(0, 256, (101, 101), np.uint8)).save(
            root / "imgs" / f"im{i}.png")
    cfg.model.quant_bits = 8
    cfg.postpro.use_tta = True
    cfg.postpro.tta_flip_lr = True
    with tracing.session() as rec:
        result = serve(cfg, exp, str(root / "imgs"),
                       out_csv=str(root / "sub.csv"), device="cpu")
    return rec, result


def test_serve_spans_inside_their_root(traced_serve):
    rec, _ = traced_serve
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["serve"]
    root = roots[0]
    assert root.attrs == {"images": N_IMAGES, "folds": FOLDS}
    for name in SERVE_SPANS:
        assert rec.named(name), name
    for s in rec.spans[1:]:
        assert s.root == root.id
        assert root.start <= s.start <= s.end <= root.end
    assert len(rec.named("serve.restore")) == FOLDS
    # 5 images: the small-set warm-up runs once, on the root
    assert [s.parent for s in rec.named("serve.warmup")] == [root.id]
    # one chunk: a forward span a fold, each with the fold's index
    assert [s.attrs["fold"] for s in rec.named("serve.forward")] == [0, 1]
    decoders = {s.attrs["decoder"] for s in rec.named("serve.decode")}
    assert decoders <= {"native", "pil"} and len(decoders) == 1


def test_serve_forwards_counter(traced_serve):
    rec, result = traced_serve
    bs = _scratch_config().training.batch_size_inference
    assert (rec.counters["serve.forwards"] == result["batches"]
            == FOLDS * math.ceil(N_IMAGES / bs))


def test_fit_steps_and_their_children():
    cfg = _scratch_config()
    runner = SegmentationRunner(cfg, "cpu")
    rng = np.random.RandomState(32)
    images = rng.randint(0, 256, (7, 101, 101), np.uint8)
    masks = (rng.rand(7, 101, 101) > 0.5).astype(np.uint8)
    with tracing.session() as rec:
        fit(runner, (images[:5], masks[:5]), (images[5:], masks[5:]),
            epochs=2, seed=3)
    root, = [s for s in rec.spans if s.parent is None]
    assert root.name == "fit"
    epochs = rec.named("fit.epoch")
    assert [e.attrs["epoch"] for e in epochs] == [0, 1]
    assert all(e.parent == root.id for e in epochs)
    steps = rec.named("fit.step")
    # 5 images in batches of 2, the ragged tail dropped: 2 a epoch
    assert len(steps) == 2 * batch_count(5, 2)
    for step in steps:
        assert [c.name for c in rec.children(step)] == STEP_CHILDREN
    for epoch in epochs:
        kids = [c.name for c in rec.children(epoch)]
        assert kids == ["fit.step"] * batch_count(5, 2) + ["fit.validate"]
    assert all(s.root == root.id for s in rec.spans)
