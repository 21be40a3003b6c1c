"""The harness's arithmetic: rates over whole calls and epochs, the step
tail with its sample count, the union of device intervals and the idle
gaps, the whole-session rule, and each roofline's work from shapes."""
import json
import os
import time

import numpy as np
import pytest

from benchmark import costs, trace
from benchmark.kinds import fit as fit_kind
from benchmark.kinds import serve as serve_kind

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_whole_calls_hold_every_call():
    calls = []

    def call():
        calls.append(time.perf_counter())
        time.sleep(0.02)

    t0 = time.perf_counter()
    window = serve_kind.whole_calls(call, 0.05)
    # every call started in the first 0.05 s (or the moment after), and
    # the window ran on to the last call's return
    assert len(calls) >= 2 and all(t - t0 < 0.06 for t in calls)
    assert window >= 0.05 and window >= 0.02 * len(calls)
    calls.clear()
    serve_kind.whole_calls(call, 0.0)
    assert len(calls) == 1                  # one call at least


def test_timer_steps_validation_and_stop():
    t = cb = fit_kind.Timer(0.02)
    cb.on_epoch_begin({})
    for _ in range(3):
        time.sleep(0.005)
        cb.on_batch_end({"batch_loss": 1.0})
    cb.on_batch_end({"batch_loss": float("nan")})
    time.sleep(0.01)
    cb.on_epoch_end({})
    assert len(t.steps) == 4 and t.nonfinite == 1 and t.epochs == 1
    assert t.validation_s >= 0.01
    assert all(s >= 0.005 for s in t.steps[:3])
    assert cb.training_break({})            # over 0.02 s since the start
    t = fit_kind.Timer(60)
    t.on_epoch_begin({})
    assert not t.training_break({})


def test_step_tail_and_count():
    steps = np.arange(1, 201, dtype=float)        # 200 samples
    p95, n = fit_kind.step_tail(steps)
    assert n == 200 and p95 == pytest.approx(np.percentile(steps, 95))
    assert n * 0.05 >= 10                   # ten samples beyond the tail


def test_union_and_idle_gaps():
    ev = [trace.Event("a", 0.0, 1.0), trace.Event("b", 0.5, 2.0),
          trace.Event("c", 3.0, 4.0)]
    assert trace.busy_us([(e.start, e.end) for e in ev]) == 3.0
    assert trace.idle_gaps(ev, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                              (4.0, 5.0)]
    t = trace.Trace(ev, -1.0, 5.0, {}, sampler=trace.StackSampler())
    assert t.busy_s == 3.0 and t.window_s == 6.0
    t.sampler.samples = [(2.5, "decode"), (4.5, "rle"), (4.6, "rle")]
    b = t.breakdown()
    assert b["device_ops"][0] == ["b", 1.5]
    # the first gap has no sample inside, and none before its end
    assert dict(map(tuple, b["idle_gaps"])) == {
        "(no sample)": 1.0, "decode": 1.0, "rle": 1.0}
    t.sampler.samples = [(1.5, "restore"), (4.5, "rle")]
    # a gap without a sample inside takes the last one before its end
    assert dict(map(tuple, t.breakdown()["idle_gaps"])) == {
        "(no sample)": 1.0, "restore": 1.0, "rle": 1.0}


def test_idle_named_by_the_sampled_call():
    """Busy time, the window and the device operations are the profiled
    call's; the idle gaps are the sampled call's, named by its samples."""
    ev = [trace.Event("a", 0.0, 1.0)]
    named = trace.Trace([trace.Event("a", 0.0, 2.0)], 0.0, 3.0, {},
                        sampler=trace.StackSampler())
    named.sampler.samples = [(2.5, "decode")]
    t = trace.Trace(ev, 0.0, 4.0, {}, named)
    assert t.busy_s == 1.0 and t.window_s == 4.0
    b = t.breakdown()
    assert b["device_ops"] == [["a", 1.0]]
    assert b["idle_gaps"] == [["decode", 1.0]]


def test_whole_session_rule():
    # 10 calls, 2 launches a call, 1 ms each: 2 ms a call
    ev = [trace.Event("k<1>", i, i + 1e-3) for i in range(20)]
    assert trace.per_call_ms(ev, 10, "k<") == pytest.approx(2.0)
    # one event lost: the mean of the rest times the launches a call
    assert trace.per_call_ms(ev[:19], 10, "k<") == pytest.approx(2.0)
    # three lost: under 90% of the launches, not a whole session
    assert trace.per_call_ms(ev[:17], 10, "k<") is None
    assert trace.per_call_ms(ev, 10, "other") is None


def test_preprocess_and_sort_work():
    # 128 images: 10,201 B in, 128 x 128 x 3 bf16 out each
    assert costs.preprocess_s(128) == pytest.approx(
        128 * (10201 + 98304) / costs.HBM_BYTES_PER_S)
    # 24 rows of 32,768 fp32 keys + int32 payload, read and written
    assert costs.sort_s(24, 32768) == pytest.approx(
        24 * 32768 * 16 / costs.HBM_BYTES_PER_S)


def test_conv_sites_from_the_reference():
    r34 = config("unet_resnet34")
    sites = costs.forward_sites(r34, 128, 8, "on")
    assert sum(s.row3 for s in sites) == 14
    assert sum(s.quantized for s in sites) == 43
    assert len(sites) == 57
    off = costs.forward_sites(r34, 128, 8, "off")
    assert sum(s.quantized for s in off) == 57
    x = costs.forward_sites(config("unet_seresnext50"), 128, 0, "on")
    assert not any(s.row3 or s.quantized for s in x)
    row3 = [s for s in sites if s.row3][0]
    b, c, h, w = row3.x_shape
    assert costs.conv_ops(row3) == 2 * b * h * w * 64 * 64 * 9
    assert costs.row3_s(row3) == pytest.approx(max(
        2 * (2 * b * 64 * h * w + 64 * 64 * 9) / costs.HBM_BYTES_PER_S,
        costs.conv_ops(row3) / costs.BF16_DENSE_FLOPS))
    q = [s for s in sites if s.quantized][0]
    assert costs.int8_conv_s(q) > 0 and costs.int8_quant_s(q) > 0
