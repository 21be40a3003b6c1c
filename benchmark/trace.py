"""The traced window: a whole call of the cell's entry (a ``serve()``
call, or a ``fit`` call of whole epochs) under ``torch.profiler``, and
the readings taken from it. The call runs twice: under the profiler
alone, whose device events give the busy time, each kernel's time and
the device operations of the breakdown; then under the profiler with
the host's stack sampled beside it, whose idle gaps the samples name
(the sampler takes the interpreter's lock from the call, so it slows
the host: that call's times are not read).

Frozen from the program's profiler reading
(``salt_tpu_torch/tools/profiling.py``), which the benchmark does not
import:

- :func:`busy_us`: the time in which any device event ran, the union
  of their intervals (kernels on more than one stream overlap);
- :func:`per_call_ms`: the whole-session rule against the profiler's lost
  events: for each kernel name, the mean of its recorded durations times
  its launches per call (its events over the calls, rounded), summed;
  a name seen in fewer than half the calls is not part of a call, and a
  reading counts only where at least 90% of the expected events were
  recorded.

The host's side is sampled, not traced: a thread reads the main
thread's stack every ``SAMPLE_PERIOD`` and names each sample by the innermost
frame of the program (else the innermost frame). An idle gap of the
device takes the name of the samples inside it, or of the last one
before its end. The device's clock is
tied to the host's by a marker kernel launched after a synchronize.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from bisect import bisect_left, bisect_right
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: the program's package, whose frames name a host sample
PROGRAM = "salt_tpu_torch"
#: at most this many entries in each list of the breakdown
TOP = 10
#: seconds between two samples of the host's stack
SAMPLE_PERIOD = 5e-3


class Event:
    """One device event: name and [start, end) in host seconds."""
    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: float, end: float):
        self.name, self.start, self.end = name, start, end


def busy_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """The union's length of ``intervals`` (any unit)."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total if end is None else total + end - start


def idle_gaps(events: Sequence[Event], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] in which no device event ran."""
    gaps, cursor = [], lo
    for s, e in sorted((ev.start, ev.end) for ev in events):
        if s > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(s, e) for s, e in gaps if e > s]


def per_call_ms(events: Sequence[Event], calls: int, match: str
                ) -> Optional[float]:
    """Device ms per call of the kernels whose name contains ``match``
    under the whole-session rule; None when they were not recorded or
    too many of their events were lost."""
    by_name: Dict[str, List[float]] = defaultdict(list)
    for ev in events:
        if match in ev.name:
            by_name[ev.name].append(ev.end - ev.start)
    ms, expected, recorded = 0.0, 0, 0
    for durations in by_name.values():
        n = round(len(durations) / calls)
        recorded += len(durations)
        if n:
            ms += sum(durations) / len(durations) * n * 1e3
            expected += n * calls
    if not expected or recorded < 0.9 * expected:
        return None
    return ms


class StackSampler:
    """Samples the calling thread's stack every ``period`` seconds from a
    thread of its own, between :meth:`start` and :meth:`stop`."""

    def __init__(self, period: float = SAMPLE_PERIOD):
        self.period = period
        self.samples: List[Tuple[float, str]] = []
        self._t: List[float] = []
        self._ident = threading.get_ident()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    @staticmethod
    def label(frame) -> str:
        inner = None
        while frame is not None:
            path = frame.f_code.co_filename
            name = (f"{os.path.basename(path)}:{frame.f_code.co_name}")
            if inner is None:
                inner = name
            if f"{os.sep}{PROGRAM}{os.sep}" in path:
                mod = path.split(f"{os.sep}{PROGRAM}{os.sep}", 1)[1]
                return f"{mod[:-3].replace(os.sep, '.')}:{frame.f_code.co_name}"
            frame = frame.f_back
        return inner or "?"

    def _loop(self):
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self._ident)
            if frame is not None:
                self.samples.append((time.perf_counter(), self.label(frame)))

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)

    def name_of(self, lo: float, hi: float) -> str:
        """The most frequent label of the samples in [lo, hi]; without
        one there (native code that holds the interpreter lock keeps the
        sampler out), the last sample's before ``hi``. The samples are in
        time order."""
        times = self._times()
        a, b = bisect_left(times, lo), bisect_right(times, hi)
        if b > a:
            names = Counter(n for _, n in self.samples[a:b])
            return names.most_common(1)[0][0]
        return self.samples[b - 1][1] if b else "(no sample)"

    def _times(self) -> List[float]:
        if len(self._t) != len(self.samples):
            self._t = [t for t, _ in self.samples]
        return self._t


class Trace:
    """What the traced calls left: the first call's device events in
    host seconds and its window; the second call's events, window and
    host samples, which name the idle gaps."""

    def __init__(self, events: List[Event], lo: float, hi: float,
                 calls: Dict[str, int], named: "Trace" = None,
                 sampler: StackSampler = None):
        self.events = events
        self.lo, self.hi = lo, hi
        #: calls of each kind in the traced window (``forwards``, ...)
        self.calls = calls
        #: the sampled call (its ``sampler`` set), or this one
        self.named = named or self
        self.sampler = sampler

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return busy_us([(e.start, e.end) for e in self.events])

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = defaultdict(float)
        for e in self.events:
            by_name[e.name] += e.end - e.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        n = self.named
        gaps: Dict[str, float] = defaultdict(float)
        for s, e in idle_gaps(n.events, n.lo, n.hi):
            gaps[n.sampler.name_of(s, e)] += e - s
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in idle]}


def _is_device(ev) -> bool:
    """A kernel, copy or fill on the device's timeline (the profiler's
    raw event; not an annotation range there)."""
    return (ev.device_type() == torch.autograd.DeviceType.CUDA
            and not ev.is_user_annotation())


def profiled(fn: Callable[[], object], device: torch.device,
             sampler: Optional[StackSampler] = None
             ) -> Tuple[List[Event], float, float]:
    """Run ``fn()`` once under the profiler (device activity), and the
    stack sampler where one is given: (the device events, the call's
    start and end), in host seconds."""
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device=device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t_mark = time.perf_counter()
        marker.add_(1)                  # the first device event
        torch.cuda.synchronize(device)
        if sampler is not None:
            sampler.start()
        lo = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        hi = time.perf_counter()
        if sampler is not None:
            sampler.stop()
    raw = sorted(((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if _is_device(e)), key=lambda e: e[0])
    if not raw:
        return [], lo, hi
    offset = t_mark - raw[0][0] * 1e-9
    return ([Event(name, s * 1e-9 + offset, e * 1e-9 + offset)
             for s, e, name in raw[1:]], lo, hi)


def traced_call(fn: Callable[[], object], calls: Dict[str, int],
                device: torch.device) -> Trace:
    """Run ``fn()`` under the profiler alone, then again with the host's
    stack sampled; ``calls`` counts the work inside one call for the
    readers."""
    events, lo, hi = profiled(fn, device)
    sampler = StackSampler()
    named = Trace(*profiled(fn, device, sampler), calls, sampler=sampler)
    return Trace(events, lo, hi, calls, named)
