"""The port's bench tool (``salt_tpu_torch/tools/bench.py``), its
throughput probes (``train/throughput.py``) and the profiler reading they
and chip_smoke.py share (``tools/profiling.py``), on the CPU.

The bench runs with ``--device cpu --tiny`` and only its line's keys are
checked: a CPU rate is not the card's. The profiler reading is checked
on fabricated rows and events: a session that lost events (the profiler
does that on the card) reads low under the old rule that summed over
the calls, keeps its reading under the new one, and is profiled again
when it lost too many."""
from types import SimpleNamespace

import pytest
import torch

from salt_tpu_torch.tools import profiling

# one intra-op thread a test process: the suite runs in parallel workers,
# and a thread per core in each oversubscribes the CPU
torch.set_num_threads(1)

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
LINE_KEYS = {"device", "flagship_tta_bf16", "flagship_train",
             "salt_unet16_tta", "serve_synthetic_2048", "breakdown",
             "flagship_tta_int8", "multichip_dp_tta"}


def test_bench_line_keys_on_the_cpu(capsys, tmp_path):
    from salt_tpu_torch.tools import bench
    line = bench.main(["--device", "cpu", "--tiny", "--iters", "1",
                       "--windows", "1", "--train-iters", "1",
                       "--distill-root", str(tmp_path)])
    import json
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(line))
    assert set(line) == LINE_KEYS
    assert line["device"]["platform"] == "cpu"
    assert line["flagship_tta_int8"]["quant_bits"] == 8
    assert line["flagship_tta_int8"]["pallas_conv"] == "off"
    assert line["serve_synthetic_2048"]["quant_bits"] == 8
    # the distilled students are ported: no not_ported key, and with no
    # curve on disk no student context
    assert "not_ported" not in line
    assert not [k for k in line if k.startswith(("distill", "serve_student"))]
    assert line["multichip_dp_tta"] is None      # one process
    for key in ("flagship_tta_bf16", "flagship_tta_int8", "flagship_train",
                "salt_unet16_tta", "serve_synthetic_2048"):
        assert line[key]["value"] > 0 and "chip" not in line[key]["unit"]
    assert set(line["breakdown"]) == {"tta_step", "tta_step_int8",
                                      "train_step"}
    assert all("not_measured" in v for v in line["breakdown"].values())


def test_bench_refuses_the_cpu_at_full_size_and_defaults_to_cuda(
        monkeypatch):
    from salt_tpu_torch.tools import bench
    with pytest.raises(SystemExit):
        bench.parse_args(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--tiny"])


def test_throughput_probes_take_a_model_or_a_train_state():
    from salt_tpu_torch.core.config import default_config
    from salt_tpu_torch.train.steps import SegmentationRunner
    from salt_tpu_torch.train.throughput import (measure_tta_throughput,
                                                 measure_train_throughput)
    cfg = default_config()
    cfg.model.architecture = "SaltUNet"
    cfg.model.n_filters = 4
    cfg.model.repeat_blocks = 2
    cfg.training.dtype = "float32"
    runner = SegmentationRunner(cfg, device="cpu")
    state = runner.init_state(0)
    before = state.step
    assert measure_train_throughput(runner, state, 2, iters=2,
                                    windows=1) > 0
    assert state.step == before + 3            # a warm-up and 2 timed steps
    assert measure_tta_throughput(runner, state, 2, iters=1, windows=2) > 0
    assert not state.model.training
    assert measure_tta_throughput(runner, runner.init_model(0), 2, iters=1,
                                  windows=1) > 0


def _event(name, us, device=CUDA, start=0.0, annotation=False):
    """A raw profiler event: name, device type and time range."""
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=start + us,
                                   elapsed_us=lambda us=us: us))


def _row(key, us, count, device=CUDA, annotation=False):
    """A ``key_averages()`` row: key, count and own device time."""
    return SimpleNamespace(key=key, count=count, device_type=device,
                           is_user_annotation=annotation,
                           self_device_time_total=us)


def test_old_rules_on_fabricated_rows_of_a_session_that_dropped_events():
    """20 calls of a 300 us kernel and a library call of two 150 us
    kernels; the session kept 8 and 22 of their events. The host's aten
    row and an annotation range on the device are never device time."""
    rows = [_row("void matmul_wgmma_kernel<128>(...)", 8 * 300.0, 8),
            _row("aten::mm", 9e9, 20, device=CPU),
            _row("Optimizer.step#Adam", 9e9, 1, annotation=True)]
    rules = profiling.averages_rules(rows, 20, "matmul_wgmma_kernel")
    assert rules["matched"] == pytest.approx(0.3)   # over the recorded count
    assert rules["all"] == pytest.approx(0.12)      # over the calls: low
    lib = [_row("sm90_xmma_gemm", 22 * 150.0, 22)]
    assert profiling.averages_rules(lib, 20, "")["all"] == \
        pytest.approx(0.165)                        # it takes 0.3


def test_raw_events_matching_and_per_session_reading():
    """Host rows and annotation ranges are never device time; each
    name's mean duration times its rounded launches per call."""
    events = [_event("void matmul_wgmma_kernel<128>(...)", 300.0, start=i)
              for i in range(20)]
    events += [_event("Memcpy HtoD", 10.0, start=30 + i) for i in range(20)]
    events += [_event("cudaLaunchKernel", 5.0, device=CPU),
               _event("matmul_wgmma_kernel range", 9e9, annotation=True),
               _event("cublas workspace init", 1e4, start=99)]
    kernels = profiling.device_events(events, "matmul_wgmma_kernel")
    assert len(kernels) == 20
    got = profiling.session_reading(events, 20, "matmul_wgmma_kernel")
    assert got == {"ms": pytest.approx(0.3), "launches_per_call": 1,
                   "recorded": 20}
    got = profiling.session_reading(events, 20)     # once a session: out
    assert got["ms"] == pytest.approx(0.31) and got["launches_per_call"] == 2
    names = profiling.name_readings(events, 20)
    assert list(names)[0].startswith("void matmul_wgmma_kernel")
    assert names["cublas workspace init"]["launches_per_call"] == 0


def test_reading_of_a_session_that_lost_events():
    """19 of 20 events of a 300 us kernel and 36 of 40 of a library
    call's two 150 us kernels: the reading stays, and the session is
    whole; 8 of 20 is another count per call, and 12 of 20 too few: not
    whole."""
    events = [_event("k", 300.0, start=i) for i in range(19)]
    reading = profiling.session_reading(events, 20, "k")
    assert reading["ms"] == pytest.approx(0.3)
    assert profiling.is_whole(reading, 1, 20)
    lib = ([_event("gemm", 150.0, start=i) for i in range(18)]
           + [_event("splitk_reduce", 150.0, start=50 + i)
              for i in range(18)])
    reading = profiling.session_reading(lib, 20)
    assert reading["ms"] == pytest.approx(0.3)
    assert profiling.is_whole(reading, 2, 20)
    short = profiling.session_reading(events[:8], 20, "k")
    assert short["launches_per_call"] == 0 and short["ms"] == 0.0
    assert not profiling.is_whole(short, 1, 20)
    twelve = profiling.session_reading(events[:12], 20, "k")
    assert twelve["launches_per_call"] == 1
    assert not profiling.is_whole(twelve, 1, 20)        # under 90%
    assert not profiling.is_whole(reading, None, 20)


class _FakeProfile:
    """``torch.profiler.profile`` that hands out scripted sessions: each
    a number of device events of 300 us, or (number, us)."""

    def __init__(self, counts):
        self.counts = [c if isinstance(c, tuple) else (c, 300.0)
                       for c in counts]

    def __call__(self, activities):
        session = self

        class Prof:
            def __enter__(self):
                n, us = session.counts.pop(0)
                self._events = [_event("k", us, start=i) for i in range(n)]
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return self._events

        return Prof()


def test_whole_sessions_profile_again_after_lost_events(monkeypatch):
    import torch.profiler
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    fake = _FakeProfile([8, 12, 19, 20])
    monkeypatch.setattr(torch.profiler, "profile", fake)
    calls = []
    prof, reading = next(profiling.whole_sessions(
        calls.append, 20, "k", launches_per_call=1, warmup=0))
    assert len(prof.events()) == 19 and fake.counts == [(20, 300.0)]
    assert reading["ms"] == pytest.approx(0.3) and len(calls) == 3 * 20
    # without an expected count: the first session that repeats the one
    # before it
    monkeypatch.setattr(torch.profiler, "profile",
                        _FakeProfile([8, 20, 19, 20]))
    prof, _ = next(profiling.whole_sessions(lambda i: None, 20, warmup=0))
    assert len(prof.events()) == 19
    monkeypatch.setattr(torch.profiler, "profile",
                        _FakeProfile([20, 8, 20, 8, 20, 8]))
    with pytest.raises(RuntimeError, match="no whole session"):
        next(profiling.whole_sessions(lambda i: None, 20, "k", 5, warmup=0))
    monkeypatch.setattr(torch.profiler, "profile",
                        _FakeProfile([0, 0, 0, 0]))
    assert profiling.kernel_ms(lambda: None, "k", iters=20,
                               launches_per_call=1) == 0.0


def test_kernel_ms_is_the_median_of_three_whole_sessions(monkeypatch):
    """A whole session that recorded its events short does not move the
    time; lost-event sessions in between are profiled again."""
    import torch.profiler
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    fake = _FakeProfile([(20, 300.0), (8, 300.0), (20, 250.0), (19, 310.0)])
    monkeypatch.setattr(torch.profiler, "profile", fake)
    assert profiling.kernel_ms(lambda: None, "k", iters=20,
                               launches_per_call=1) == pytest.approx(0.3)
    assert fake.counts == []
