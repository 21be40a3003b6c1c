"""Device times from ``torch.profiler``, shared by ``chip_smoke.py`` and
``tools/bench.py``, and a check of how the profiler records them.

    python -m salt_tpu_torch.tools.profiling [--iters 20] [--sessions 300]

The profiler loses device events: on an H100 a session of 20 launches
of a kernel often records 19, and about one session in a hundred far
fewer (3 of 20 in this module's check). A time taken as the recorded
durations summed over the calls made then reads low. So a session's
reading (:func:`session_reading`) takes, for each kernel name, the mean
of its recorded durations times its launches per call (its events over
the calls, rounded), and a reading counts only from a *whole* session
(:func:`whole_sessions`): one with the expected launches per call and at
least 90% of their events. A session can also record an event short
(one whole session in 300 read ``torch.matmul`` 15% under the median,
under its bytes bound), so a time is the median of three whole
sessions' readings (:func:`kernel_ms`).

- :func:`kernel_ms`: a function's device time per call, of its kernels
  whose name contains ``match`` (all of them without);
- :func:`step_breakdown`: where a step's device time goes (top kernels,
  busy share, kernel launches per step);
- :func:`busy_us`: the time in which any of a session's device events
  ran (their intervals' union).

Run as a module on the card, the check times row 6's first GEMM (the
matmul kernel at [524288, 768] x [768, 128], bf16) and ``torch.matmul``
on the same operands in ``--sessions`` pairs of sessions, prints every
session that lost events, then the spread over all sessions of three
readings: ``key_averages()`` rows by the two rules chip_smoke.py used
before (the matched rows' time over their count; all rows' time over
the calls) and :func:`session_reading`, and of the last over the whole
sessions. The card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch


def is_device_event(event) -> bool:
    """A kernel or copy on the device's timeline: not a host-side row
    (an aten op row repeats the time of the kernels it launched) and not
    an annotation range there (``Optimizer.step#...`` spans the kernels
    it launched, which have rows of their own)."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def self_device_us(row) -> float:
    """A ``key_averages()`` row's own device time in us; 0 for rows that
    are not device events."""
    if not is_device_event(row):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(row, attr):
            return float(getattr(row, attr))
    return 0.0


def device_events(events: Sequence, match: str = "") -> List:
    """The device events among a session's raw ``events`` whose name
    contains ``match``."""
    return [e for e in events if is_device_event(e) and match in e.name]


def session_reading(events: Sequence, calls: int, match: str = "") -> Dict:
    """The device time per call of the kernels matching ``match`` among
    the raw ``events`` of a session of ``calls`` calls: for each kernel
    name, the mean of its events' durations times its launches per call
    (its events over ``calls``, rounded; a name seen in fewer than half
    the calls is not part of a call), summed. {"ms", "launches_per_call",
    "recorded"}; a lost event leaves its name's mean and rounded count
    as they were."""
    by_name: Dict[str, List[float]] = {}
    for e in device_events(events, match):
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ms, launches, recorded = 0.0, 0, 0
    for durations in by_name.values():
        n = round(len(durations) / calls)
        recorded += len(durations)
        if n:
            ms += sum(durations) / len(durations) * n / 1e3
            launches += n
    return {"ms": ms, "launches_per_call": launches, "recorded": recorded}


def busy_us(events: Sequence) -> float:
    """The time in us during which at least one of ``events`` (device
    events) ran: the union of their intervals. Kernels on more than one
    stream overlap, and their durations summed then exceed it."""
    total, start, end = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total if end is None else total + end - start


def name_readings(events: Sequence, calls: int) -> Dict[str, Dict]:
    """Kernel name -> :func:`session_reading` of its events alone, the
    names ranked by their time per call."""
    names = {e.name for e in device_events(events)}
    readings = {name: session_reading(
        [e for e in events if e.name == name], calls) for name in names}
    return dict(sorted(readings.items(), key=lambda kv: -kv[1]["ms"]))


def is_whole(reading: Dict, expected: Optional[int], calls: int) -> bool:
    """Whether a session's reading (:func:`session_reading`) can be
    trusted: its launches per call are the ``expected`` ones (the
    caller's, or the session before's) and it recorded at least 90% of
    their events. A session that lost more reads another count per
    call, or too few events."""
    return (expected is not None
            and reading["launches_per_call"] == expected
            and reading["recorded"] >= 0.9 * expected * calls)


def whole_sessions(fn: Callable[[int], object], calls: int, match: str = "",
                   launches_per_call: Optional[int] = None,
                   sessions: int = 6, warmup: int = 3, cpu: bool = False):
    """Profile ``calls`` calls of ``fn(i)`` (after ``warmup`` calls, and
    with the host's activity too when ``cpu``) session after session, and
    yield each whole one (:func:`is_whole` against ``launches_per_call``
    or, without it, against the session before) as (profiler, reading).
    Two sessions that record no device event agree (a profiler that
    records no device time: the reading's ``ms`` is then 0.0). Raises
    after ``sessions`` sessions in a row that were not whole."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    seen: List[Dict] = []
    failed = 0
    while failed < sessions:
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        reading = session_reading(prof.events(), calls, match)
        previous = seen[-1]["launches_per_call"] if seen else None
        none = reading["recorded"] == 0 and seen \
            and seen[-1]["recorded"] == 0
        if none or is_whole(reading, launches_per_call
                            if launches_per_call is not None else previous,
                            calls):
            failed = 0
            yield prof, reading
        else:
            failed += 1
        seen.append(reading)
    raise RuntimeError(
        f"profiler: no whole session of {calls} calls of {match!r} in "
        f"{sessions}; (launches per call, events) recorded "
        f"{[(r['launches_per_call'], r['recorded']) for r in seen]}")


#: whole sessions a time is the median of
READINGS = 3


def kernel_ms(fn: Callable[[], object], match: str = "", iters: int = 50,
              launches_per_call: Optional[int] = None) -> float:
    """Device ms per call of ``fn``'s kernels whose name contains
    ``match`` (all of them without): the median reading of ``READINGS``
    whole sessions (with ``launches_per_call``, sessions holding that many
    such launches a call), as a session can also record an event short.
    0.0 when the profiler records no device time."""
    sessions = whole_sessions(lambda i: fn(), iters, match,
                              launches_per_call)
    return statistics.median(next(sessions)[1]["ms"]
                             for _ in range(READINGS))


#: host-side names of a kernel launch in the profiler's CPU rows
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")


def step_breakdown(step: Callable[[int], object], steps: int = 5,
                   top: int = 10, kernels: Sequence[str] = ()
                   ) -> Dict[str, object]:
    """Where ``steps`` calls of ``step(i)`` spend the card's time: host
    wall ms per step (synchronized, without the profiler), then from a
    whole session with the host's activity device ms per step (every
    device event, :func:`session_reading`), the busy share of the wall
    time, the host's kernel launch calls per step, the ``top`` kernels by
    device time, and for each name in ``kernels`` its device ms and
    launches per step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    prof, reading = next(whole_sessions(step, steps, cpu=True))
    events = prof.events()
    ranked = list(name_readings(events, steps).items())
    return {
        "wall_ms": wall_ms,
        "device_ms": reading["ms"],
        "busy_share": reading["ms"] / wall_ms,
        "launches_per_step": sum(
            1 for e in events if e.name.startswith(LAUNCH_PREFIXES)) / steps,
        "device_launches_per_step": reading["launches_per_call"],
        "top": [{"kernel": name[:90], "calls_per_step": r["launches_per_call"],
                 "ms_per_step": r["ms"]} for name, r in ranked[:top]],
        "kernels": {name: {
            "ms_per_step": r["ms"], "launches_per_step":
                r["launches_per_call"]}
            for name, r in ((name, session_reading(events, steps, name))
                            for name in kernels)},
    }


def averages_rules(rows: Sequence, calls: int, match: str) -> Dict:
    """The two rules chip_smoke.py used before :func:`whole_sessions`, on
    a session's ``key_averages()`` rows: the matched rows' own device
    time over their count ("matched"), and every device row's own time
    over the calls made ("all")."""
    hits = [r for r in rows if match in r.key and self_device_us(r) > 0]
    return {"matched": sum(self_device_us(r) for r in hits)
            / max(sum(r.count for r in hits), 1) / 1e3,
            "all": sum(self_device_us(r) for r in rows) / calls / 1e3}


def read_trace(path: str, match: str = "") -> Dict[str, Dict[str, float]]:
    """The device kernels of a Chrome trace that ``torch.profiler``
    exported (``cli --profile DIR`` writes ``DIR/trace.json``): for each
    kernel whose name contains ``match``, {"launches", "us"} (its events
    and their summed durations)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out: Dict[str, Dict[str, float]] = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "kernel" and match in name:
            k = out.setdefault(name, {"launches": 0, "us": 0.0})
            k["launches"] += 1
            k["us"] += float(e.get("dur", 0.0))
    return out


def card() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit, "nvidia_smi": line}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sessions", type=int, default=300)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profiler check times the card: CUDA is not "
                           "available")
    from torch.profiler import ProfilerActivity, profile
    from salt_tpu_torch.ops.matmul_kernel import make_matmul_kernel
    m, k, n = 524288, 768, 128
    g = torch.Generator("cuda").manual_seed(0)
    a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    b = (torch.randn(k, n, generator=g, device="cuda") / k ** 0.5).bfloat16()
    mm = make_matmul_kernel(m, k, n)
    match = "matmul_wgmma_kernel"
    probes = {"kernel": lambda: mm(a, b), "library": lambda: torch.matmul(a, b)}
    bound_ms = (m * k + k * n + m * n) * 2 / 3.35e12 * 1e3
    readings: Dict[str, List[float]] = {}
    previous = {"kernel": 1, "library": None}
    for s in range(args.sessions):
        for name, fn in probes.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
            key = match if name == "kernel" else ""
            reading = session_reading(prof.events(), args.iters, key)
            whole = is_whole(reading, previous[name], args.iters)
            if name == "library":
                previous[name] = reading["launches_per_call"]
            rules = averages_rules(prof.key_averages(), args.iters, key)
            rec = {f"{name}_{rule}_ms": v for rule, v in rules.items()}
            rec[f"{name}_reading_ms"] = reading["ms"]
            if whole:
                rec[f"{name}_whole_reading_ms"] = reading["ms"]
            for label, v in rec.items():
                readings.setdefault(label, []).append(v)
            lost = (reading["launches_per_call"] * args.iters
                    - reading["recorded"])
            if lost:
                print(json.dumps({"session": s, "probe": name,
                                  "recorded": reading["recorded"],
                                  "launches_per_call":
                                      reading["launches_per_call"],
                                  "whole": whole, **rec}), flush=True)
    info = card()
    print(info["nvidia_smi"], flush=True)

    def spread(values):
        return [min(values), statistics.median(values), max(values)]

    out = {"gemm": [m, k, n], "iters": args.iters,
           "sessions": args.sessions, "bound_ms": bound_ms,
           "min_median_max": {label: spread(v)
                              for label, v in readings.items()},
           "count": {label: len(v) for label, v in readings.items()},
           "under_bound": {label: sum(x < bound_ms for x in v)
                           for label, v in readings.items()},
           "card": info}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
