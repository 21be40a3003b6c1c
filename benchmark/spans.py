"""The span pass of a ``--trace 1`` run: one more call of the cell's entry
under the profiler (device activity, as ``trace.profiled``), with the
program's tracer on (``salt_tpu_torch.core.tracing.session()``) and no
stack sampler; and its readings.

- **Idle by span**: every interval of the call in which no device event
  ran is split by the innermost program span open at each instant and
  summed by span (outside every span: :data:`OUTSIDE`).
- **Launches**: the kernel launches of the CUDA API (its events
  whose name holds ``LaunchKernel``) whose host time falls inside a span.
- **Cost**: the pass's wall against the traced window's call under the
  profiler alone (``run.trace``): what tracing costs when it is on.

The pass runs once a run, at the first reading of a metric that needs it
(:func:`of`), after the readings of the traced window, so it moves none
of them. The cell's entry is made again from the cell's files by the
kind's own set-up (``kinds/<kind>.py``'s ``Prepared``): a whole
``serve()`` call, or the epoch after the check steps and its validation.
Without ``--trace 1``, a card, or a program with a tracer, there is no
pass and its metrics read None.

The device's events and the launches are put on ``time.perf_counter()``,
the tracer's clock, by a marker kernel launched after a synchronize, as
``trace.profiled`` does.
"""
from __future__ import annotations

import os
import shutil
import sys
import time
from bisect import bisect_left, bisect_right
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from benchmark import trace

#: the run's attribute that holds its pass (None where there is none)
ATTR = "spans"
#: a launch event's name holds this (cudaLaunchKernel, cuLaunchKernelEx, ...)
LAUNCH = "LaunchKernel"
#: the label of time outside every span
OUTSIDE = "(no span)"


class SpanPass:
    """One traced call: its device events and launch times (host
    seconds), its window [lo, hi], and the tracer's record."""

    def __init__(self, events: List[trace.Event], launches: List[float],
                 lo: float, hi: float, record):
        self.events = events
        self.launches = sorted(launches)
        self.lo, self.hi = lo, hi
        self.record = record
        self.root = next(s for s in record.spans if s.parent is None)
        self._idle = idle_by_span(record.spans,
                                  trace.idle_gaps(events, lo, hi), lo, hi)

    @property
    def wall_s(self) -> float:
        """The root span's wall."""
        return self.root.seconds

    def idle_by_name(self) -> Dict[str, float]:
        by_name: Dict[str, float] = defaultdict(float)
        spans = self.record.spans
        for sid, s in self._idle.items():
            by_name[OUTSIDE if sid is None else spans[sid].name] += s
        return dict(by_name)

    def idle_under(self, names: Iterable[str]) -> float:
        """Idle seconds whose innermost span is one named in ``names`` or
        lies inside one."""
        names = set(names)
        spans = self.record.spans
        total = 0.0
        for sid, s in self._idle.items():
            while sid is not None and spans[sid].name not in names:
                sid = spans[sid].parent
            if sid is not None:
                total += s
        return total

    def idle_share(self, names: Iterable[str]) -> float:
        """:meth:`idle_under` as a percentage of the root's wall."""
        return 100.0 * self.idle_under(names) / self.wall_s

    def wall_in(self, name: str) -> float:
        return sum(s.seconds for s in self.record.named(name))

    def launches_in(self, name: str) -> int:
        """Launches made while a span named ``name`` was open."""
        t = self.launches
        return sum(bisect_right(t, s.end) - bisect_left(t, s.start)
                   for s in self.record.named(name))

    def self_s(self, span) -> float:
        """A span's wall less the part its children cover."""
        return span.seconds - sum(c.seconds
                                  for c in self.record.children(span))


def segments(spans, lo: float, hi: float) -> List[Tuple[float, float, object]]:
    """[lo, hi] cut at every span boundary: (start, end, id of the
    innermost span open there, or None), in time order. ``spans`` open in
    order and nest (one thread's), each with ``id``, ``parent``,
    ``start`` and ``end``."""
    kids: Dict[object, list] = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    out: List[Tuple[float, float, object]] = []

    def walk(sid, a: float, b: float) -> None:
        cursor = a
        for s in kids[sid]:
            s0, s1 = max(s.start, a), min(s.end, b)
            if s1 <= s0:
                continue
            if s0 > cursor:
                out.append((cursor, s0, sid))
            walk(s.id, s0, s1)
            cursor = s1
        if b > cursor:
            out.append((cursor, b, sid))

    walk(None, lo, hi)
    return out


def idle_by_span(spans, gaps: List[Tuple[float, float]], lo: float,
                 hi: float) -> Dict[object, float]:
    """Seconds of ``gaps`` (disjoint, in time order) under each innermost
    span id (None outside every span)."""
    segs = segments(spans, lo, hi)
    out: Dict[object, float] = defaultdict(float)
    i = 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            s0, s1, sid = segs[j]
            overlap = min(s1, g1) - max(s0, g0)
            if overlap > 0:
                out[sid] += overlap
            j += 1
    return dict(out)


def spanned_call(fn: Callable[[], object], device, tracing) -> SpanPass:
    """Run ``fn()`` once under the profiler with ``tracing.session()`` on."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device=device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t_mark = time.perf_counter()
        marker.add_(1)                  # the first device event
        torch.cuda.synchronize(device)
        with tracing.session() as record:
            lo = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            hi = time.perf_counter()
    device_ev, launch_ns = [], []
    for e in prof.profiler.kineto_results.events():
        if trace._is_device(e):
            device_ev.append((e.start_ns(), e.end_ns(), e.name()))
        elif LAUNCH in e.name():
            launch_ns.append(e.start_ns())
    device_ev.sort(key=lambda e: e[0])
    offset = t_mark - device_ev[0][0] * 1e-9
    events = [trace.Event(name, s * 1e-9 + offset, e * 1e-9 + offset)
              for s, e, name in device_ev[1:]]
    return SpanPass(events, [t * 1e-9 + offset for t in launch_ns], lo, hi,
                    record)


def _serve_entry(run):
    from benchmark.kinds import serve as kind
    os.makedirs(run.workdir, exist_ok=True)
    prep = kind.Prepared(run)
    return (lambda: prep.call("spans.csv"),
            lambda: shutil.rmtree(run.workdir, ignore_errors=True))


def _fit_entry(run):
    from benchmark.kinds import fit as kind
    prep = kind.Prepared(run)
    tr, va = prep.data(prep.train), prep.data(prep.valid)
    return (lambda: prep.fit(prep.runner, tr, va, state=prep.state,
                             epochs=2, seed=prep.seed, start_epoch=1),
            prep.release)


#: the entry of each kind: (the call, what frees its set-up)
ENTRIES = {"serve": _serve_entry, "fit": _fit_entry}


def of(run) -> Optional[SpanPass]:
    """The run's span pass, made at the first call; None without
    ``--trace 1``, a card, or a program with a tracer."""
    if hasattr(run, ATTR):
        return getattr(run, ATTR)
    setattr(run, ATTR, None)
    if (run.trace is None or run.device is None
            or run.device.type != "cuda"):
        return None
    try:
        from salt_tpu_torch.core import tracing
    except ImportError:
        print("spans: the program has no tracer; no span pass",
              file=sys.stderr)
        return None
    call, release = ENTRIES[run.traffic["kind"]](run)
    try:
        p = spanned_call(call, run.device, tracing)
    finally:
        release()
    setattr(run, ATTR, p)
    report(p, run.trace.window_s)
    return p


def report(p: SpanPass, profiled_s: float) -> None:
    """The pass's lines on stderr."""
    idle = sorted(p.idle_by_name().items(), key=lambda kv: -kv[1])
    busy = trace.busy_us([(e.start, e.end) for e in p.events])
    window = p.hi - p.lo
    root = p.root
    print(f"spans: pass wall {window:.3f} s, the profiler alone "
          f"{profiled_s:.3f} s (tracing on: {window - profiled_s:+.3f} s, "
          f"{100 * (window / profiled_s - 1):+.2f}%); root {root.name} "
          f"{root.seconds:.3f} s, self {p.self_s(root):.3f} s "
          f"({100 * p.self_s(root) / root.seconds:.2f}%); device idle "
          f"{100 * (1 - busy / window):.2f}% of the pass; "
          f"{len(p.record.spans)} spans", file=sys.stderr)
    print("spans: idle s by innermost span "
          + ", ".join(f"{n} {s:.4f}" for n, s in idle), file=sys.stderr)
    walls = defaultdict(float)
    for s in p.record.spans:
        walls[s.name] += s.seconds
    print("spans: wall s by span "
          + ", ".join(f"{n} {s:.4f}" for n, s in walls.items()),
          file=sys.stderr)
    decoders = sorted({s.attrs.get("decoder", "?")
                       for s in p.record.named("serve.decode")})
    kernels = sum(1 for e in p.events
                  if not e.name.startswith(("Memcpy", "Memset")))
    print(f"spans: counters {p.record.counters}; launches {len(p.launches)}, "
          f"device kernels {kernels} of {len(p.events)} events; "
          f"serve.decode decoder "
          f"{decoders or 'none'}", file=sys.stderr)
