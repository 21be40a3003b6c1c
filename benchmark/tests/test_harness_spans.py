"""The span pass's readings (``benchmark/spans.py``) on synthetic device
events and spans: an idle gap split across two nested spans, a gap
outside every child put down to the root, time outside the root, and the
launches inside a span; and the span metrics' readers, None without a
pass and computed from one."""
import os

import pytest
import torch

from benchmark import harness, spans, trace
from salt_tpu_torch.core.tracing import Record, Span

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SERVE, FIT = "unet_resnet34.serve_int8", "unet_seresnext50.fit"


def record(*entries, counters=None):
    """A tracer's record of (name, parent index, start, end) entries, in
    the order they opened."""
    rec = Record()
    for name, parent, start, end in entries:
        root = len(rec.spans) if parent is None else rec.spans[parent].root
        s = Span(len(rec.spans), name, parent, root, {})
        s.start, s.end = start, end
        rec.spans.append(s)
    rec.counters.update(counters or {})
    return rec


def events(*intervals):
    return [trace.Event("k", s, e) for s, e in intervals]


def test_gap_split_across_nested_spans():
    rec = record(("root", None, 0.0, 10.0), ("a", 0, 2.0, 8.0),
                 ("b", 1, 4.0, 6.0))
    p = spans.SpanPass(events((0.0, 3.0), (7.0, 10.0)), [], 0.0, 10.0, rec)
    assert p.idle_by_name() == pytest.approx({"a": 2.0, "b": 2.0})
    assert p.idle_under(["a"]) == pytest.approx(4.0)
    assert p.idle_under(["b"]) == pytest.approx(2.0)
    assert p.idle_share(["a"]) == pytest.approx(40.0)
    assert p.self_s(p.root) == pytest.approx(4.0)


def test_gap_outside_every_child_goes_to_the_root():
    rec = record(("root", None, 0.0, 10.0), ("a", 0, 2.0, 8.0))
    p = spans.SpanPass(events((0.0, 1.0), (9.0, 10.0)), [], -1.0, 11.0, rec)
    assert p.idle_by_name() == pytest.approx(
        {"root": 2.0, "a": 6.0, spans.OUTSIDE: 2.0})
    assert p.idle_under(["root"]) == pytest.approx(8.0)


def test_segments_cover_the_window_in_order():
    rec = record(("root", None, 1.0, 9.0), ("a", 0, 2.0, 3.0),
                 ("b", 0, 3.0, 5.0), ("c", 2, 4.0, 5.0))
    segs = spans.segments(rec.spans, 0.0, 10.0)
    assert [(s0, s1, sid) for s0, s1, sid in segs] == [
        (0.0, 1.0, None), (1.0, 2.0, 0), (2.0, 3.0, 1), (3.0, 4.0, 2),
        (4.0, 5.0, 3), (5.0, 9.0, 0), (9.0, 10.0, None)]


def test_launches_inside_spans():
    rec = record(("root", None, 0.0, 10.0), ("f", 0, 1.0, 2.0),
                 ("f", 0, 5.0, 6.0), ("g", 0, 6.5, 7.0))
    p = spans.SpanPass([], [0.5, 1.1, 1.9, 5.5, 6.8, 9.0], 0.0, 10.0, rec)
    assert p.launches_in("f") == 3 and p.launches_in("g") == 1
    assert p.launches_in("root") == 6 and p.launches_in("none") == 0
    assert p.wall_in("f") == pytest.approx(2.0)


def span_metrics():
    spec = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    return [m for m in spec["per_layer"] if m["source"].startswith(
        "program_")]


def test_span_metrics_listed():
    names = {m["name"]: m["workloads"] for m in span_metrics()}
    assert names == {
        "idle_in_forward.serve": [SERVE], "idle_in_host_stages.serve": [SERVE],
        "launches_per_forward.serve": [SERVE],
        "idle_in_optimizer.fit": [FIT], "idle_in_forward_backward.fit": [FIT],
        "loss_wait_share.fit": [FIT], "launches_per_step.fit": [FIT]}


@pytest.mark.parametrize("name", [m["name"] for m in span_metrics()])
def test_span_metric_reads_none_without_a_pass(name, make_run):
    m = next(m for m in span_metrics() if m["name"] == name)
    run = make_run(m["workloads"][0], trace=1)
    # no traced window, then a traced window on the CPU: no pass either way
    assert harness.reader(ROOT, name)(run) is None
    assert getattr(run, spans.ATTR) is None
    run = make_run(m["workloads"][0], trace=1)
    run.trace, run.device = object(), torch.device("cpu")
    assert harness.reader(ROOT, name)(run) is None


def test_span_metrics_read_a_pass(make_run):
    serve = record(
        ("serve", None, 0.0, 10.0), ("serve.restore", 0, 0.0, 2.0),
        ("serve.decode", 0, 2.0, 3.0), ("serve.upload", 0, 3.0, 3.5),
        ("serve.forward", 0, 3.5, 7.5), ("serve.download", 0, 7.5, 8.0),
        ("serve.submission", 0, 8.0, 9.0), ("serve.provenance", 0, 9.0, 10.0),
        counters={"serve.forwards": 4})
    run = make_run(SERVE, trace=1)
    setattr(run, spans.ATTR, spans.SpanPass(
        events((4.0, 7.0)), [3.6, 3.7, 4.0, 7.4, 8.5], 0.0, 10.0, serve))
    read = {m["name"]: harness.reader(ROOT, m["name"])(run)
            for m in span_metrics() if SERVE in m["workloads"]}
    assert read == pytest.approx({"idle_in_forward.serve": 10.0,
                                  "idle_in_host_stages.serve": 60.0,
                                  "launches_per_forward.serve": 1.0})
    fit = record(
        ("fit", None, 0.0, 10.0), ("fit.epoch", 0, 0.0, 10.0),
        ("fit.step", 1, 0.0, 4.0), ("fit.augment", 2, 0.0, 1.0),
        ("fit.forward", 2, 1.0, 2.0), ("fit.backward", 2, 2.0, 3.0),
        ("fit.optimizer", 2, 3.0, 3.5), ("fit.loss_read", 2, 3.5, 4.0),
        ("fit.step", 1, 4.0, 8.0), ("fit.validate", 1, 8.0, 10.0))
    run = make_run(FIT, trace=1)
    setattr(run, spans.ATTR, spans.SpanPass(
        events((0.5, 1.5), (3.8, 4.0)), [0.1, 1.1, 5.0], 0.0, 10.0, fit))
    read = {m["name"]: harness.reader(ROOT, m["name"])(run)
            for m in span_metrics() if FIT in m["workloads"]}
    assert read == pytest.approx({"idle_in_optimizer.fit": 5.0,
                                  "idle_in_forward_backward.fit": 20.0,
                                  "loss_wait_share.fit": 5.0,
                                  "launches_per_step.fit": 1.5})


@pytest.mark.parametrize("cell,root", [(SERVE, "serve"), (FIT, "fit")])
def test_entry_of_the_pass_runs_traced(cell, root, make_run):
    """The pass's entry of each kind, made from the cell's files as the
    kind's set-up makes it, runs one whole call on the CPU with the
    tracer on (the profiler and the card's clock are the chip's part)."""
    from salt_tpu_torch.core import tracing
    run = make_run(cell, config_name="unet_resnet34")
    run.device = torch.device("cpu")
    call, release = spans.ENTRIES[run.traffic["kind"]](run)
    try:
        with tracing.session() as rec:
            call()
    finally:
        release()
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == [root]
    assert all(s.end is not None for s in rec.spans)
    if root == "serve":
        assert rec.counters["serve.forwards"] == run.config[
            "folds_served"] * -(-run.config["test_images"]
                                // run.traffic["batch"])
        assert not os.path.exists(run.workdir)
    else:
        assert [e.attrs["epoch"] for e in rec.named("fit.epoch")] == [1]
        assert len(rec.named("fit.validate")) == 1
