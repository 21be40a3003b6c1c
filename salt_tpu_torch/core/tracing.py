"""The port's tracer: named spans and counters at the layer boundaries of
``serve`` and ``fit``, off unless a caller turns it on.

- :func:`span` is a context manager. With tracing off and no
  ``torch.profiler`` running it returns one shared no-op context, which
  allocates nothing and reads no clock. With tracing on it records the
  span's name, its start and end on ``time.perf_counter()``, its parent,
  its root (the outermost span open, one ``serve()`` or ``fit()`` call)
  and its attributes. Under a running ``torch.profiler`` it also opens
  ``torch.profiler.record_function(name)``, so the span shows on the
  profiler's timeline beside the kernels (``cli ... --profile DIR``).
- :func:`count` adds to a named counter; a no-op with tracing off.
- :func:`session` turns tracing on, yields the :class:`Record` that the
  spans and counters go into, and turns tracing off on exit. Spans and
  counters of other threads than the session's are not recorded.

``time.perf_counter()`` is the clock a profiled call can map the
device's events onto (a marker kernel launched after a synchronize), so
spans and device events of one call can be intersected directly.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler


class Span:
    """One recorded span: ``id`` is its index in :attr:`Record.spans`,
    ``parent`` and ``root`` are ids (``parent`` None for a root); times
    in ``time.perf_counter()`` seconds (``end`` None while open)."""
    __slots__ = ("id", "name", "parent", "root", "start", "end", "attrs")

    def __init__(self, id_: int, name: str, parent: Optional[int],
                 root: int, attrs: dict):
        self.id, self.name, self.parent, self.root = id_, name, parent, root
        self.attrs = attrs
        self.start = self.end = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Record:
    """What one :func:`session` recorded: the spans in the order they
    opened (a parent before its children) and the counters."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.thread = threading.get_ident()
        self._open: List[Span] = []

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]


_record: Optional[Record] = None


class _NoSpan:
    """The shared context of a span that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (dropped here)."""


NO_SPAN = _NoSpan()


class _Scope:
    """One span being traced: its record (with tracing on) and its
    profiler range (under a running profiler)."""
    __slots__ = ("_rec", "_name", "_attrs", "_span", "_range")

    def __init__(self, rec: Optional[Record], name: str, attrs: dict):
        self._rec, self._name, self._attrs = rec, name, attrs
        self._span = self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        rec = self._rec
        if rec is not None:
            parent = rec._open[-1] if rec._open else None
            sid = len(rec.spans)
            self._span = Span(sid, self._name,
                              None if parent is None else parent.id,
                              sid if parent is None else parent.root,
                              self._attrs)
            rec.spans.append(self._span)
            rec._open.append(self._span)
            self._span.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.end = time.perf_counter()
            self._rec._open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return None

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        if self._span is not None:
            self._span.attrs.update(attrs)


def _active() -> Optional[Record]:
    """The open session's record, if this thread opened it."""
    rec = _record
    if rec is None or rec.thread == threading.get_ident():
        return rec
    return None


def span(name: str, **attrs):
    """A context manager around one stage of the program (see the module's
    docstring); ``with span(...) as s: s.set(k=v)`` adds attributes."""
    rec = _active()
    if rec is None and not _profiler._is_profiler_enabled:
        return NO_SPAN
    return _Scope(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open session."""
    rec = _active()
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def session() -> Iterator[Record]:
    """Tracing on for the calling thread until the block ends; yields the
    record the spans and counters go into."""
    global _record
    if _record is not None:
        raise RuntimeError("a tracing session is already open")
    rec = Record()
    _record = rec
    try:
        yield rec
    finally:
        _record = None
