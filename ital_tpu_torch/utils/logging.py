"""Structured observability: JSONL per-round metrics and wall-clock timers
(port of ``ital_tpu.utils.logging``), and the spans and counters of the
served path.

Every round of an experiment emits one JSON line; stdout stays human
readable.  :class:`Timer`'s spans synchronise the run's device before they
close, so a span measures the work and not only its enqueueing.

The served path (``serve.py``, ``graphs.py``) marks its work with
:func:`span` and :func:`count` instead, which never synchronise.  They trace
only while a ``torch.profiler`` records, or inside :func:`recording`; off,
``span`` returns one shared no-op context manager and ``count`` returns at
once, after reading three flags.  On, a span keeps its name, its attributes,
its ``time.perf_counter_ns()`` readings at start and end, its parent (the
span open on its thread when it started) and its request: a span started
with none open on its thread opens a new request id, and every span beneath
it inherits that id.  Under a profiler it is also a range ``ital.<name>``
(:data:`_RANGE`), so that it lies on the profiler's timeline beside the
kernels and copies it enqueued: the profiler's own trace is the export.  The
range is the profiler's cheapest, a ``RecordFunction`` entered without the
dispatcher's operator that ``record_function`` calls, at a fraction of its
host time, so that tracing changes the profiled loop little; it carries the
name alone, the attributes staying in the span.  A span whose name ends in
``.wait`` is time in which the host is blocked on the device.

Closed spans are kept in one ring of :data:`RING` records, the oldest
dropped first, and grouped into segments, one per stretch of tracing: a new
segment starts when a span or count finds tracing on after one found it off.
Counters are kept per segment.  :func:`segments` returns the segments held,
:func:`clear` empties them.  A CUDA graph's replay runs no Python, so a
program's capture keeps its body's counts (:func:`program_counts`, tracing
on or off) and each replay adds them (:func:`add_counts`, tracing on).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import threading
import time
from typing import Any, Optional, TextIO

import torch
import torch.autograd.profiler as _profiler

# A profiler range around a span: the fast RecordFunction where this build
# of PyTorch has it, else the public ``record_function``.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


def device_mem_mb(device) -> float:
    """Memory allocated by PyTorch on ``device``, in MB; 0.0 for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / 1e6


class JsonlLogger:
    """Appends one JSON object per :meth:`log` call to ``path`` (no-op without a path)."""

    def __init__(self, path: Optional[str]):
        self._fh: Optional[TextIO] = open(path, "a") if path else None

    def log(self, **record: Any) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(record, default=float) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class Timer:
    """Accumulating wall-clock timer: ``with timer.span("select"): ...``.

    With a CUDA ``device``, each span synchronises it before reading the
    clock at its close.
    """

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.lasts: dict[str, float] = {}
        self.values: dict[str, list[float]] = {}

    def span(self, name: str):
        return _Span(self, name)

    def ms(self, name: str) -> float:
        """Mean milliseconds per recorded span."""
        c = self.counts.get(name, 0)
        return 1e3 * self.totals.get(name, 0.0) / c if c else 0.0

    def last_ms(self, name: str) -> float:
        """Milliseconds of the most recent span (what per-round rows carry)."""
        return 1e3 * self.lasts.get(name, 0.0)

    def first_ms(self, name: str) -> float:
        """Milliseconds of the first span: start-up cost, reported apart."""
        v = self.values.get(name)
        return 1e3 * v[0] if v else 0.0

    def median_ms(self, name: str, *, skip_first: int = 1) -> Optional[float]:
        """Steady-state median milliseconds, excluding the first ``skip_first``
        spans; ``None`` when no span is left."""
        v = self.values.get(name, [])[skip_first:]
        if not v:
            return None
        s = sorted(v)
        mid = len(s) // 2
        return 1e3 * (s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid]))

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class _Span:
    def __init__(self, timer: Timer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer._sync()
        dt = time.perf_counter() - self.t0
        self.timer.totals[self.name] = self.timer.totals.get(self.name, 0.0) + dt
        self.timer.counts[self.name] = self.timer.counts.get(self.name, 0) + 1
        self.timer.lasts[self.name] = dt
        self.timer.values.setdefault(self.name, []).append(dt)
        return False


# -- the served path's spans and counters --------------------------------------

RING = 1 << 18  # closed spans kept over all segments, the oldest dropped first
SEGMENTS = 64  # segments kept, the oldest dropped first

_RING: collections.deque = collections.deque(maxlen=RING)
_SEGMENTS: collections.deque = collections.deque(maxlen=SEGMENTS)
_LOCK = threading.Lock()  # opening a segment, a counter's update, recording()'s depth
# .stack: the spans open on this thread, innermost last; .tally: the counts of
# a program being captured on this thread (program_counts)
_LOCAL = threading.local()
_REQUESTS = itertools.count(1)
_SEGMENT_IDS = itertools.count(1)
_RECORDING = [0]  # depth of recording() blocks, over every thread
_GAP = [True]  # a span or count found tracing off since the newest segment opened
_OFF = contextlib.nullcontext()  # what span() returns with tracing off


@dataclasses.dataclass(eq=False)
class Segment:
    """One stretch of tracing: its spans in order of their start (those the
    ring still holds) and its counters, ``(name, attributes) -> total``."""

    index: int
    counters: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)

    def count(self, name: str, **attrs) -> int:
        """Total of counter ``name`` over the attributes that hold ``attrs``."""
        want = set(attrs.items())
        return sum(n for (key, kv), n in self.counters.items()
                   if key == name and want <= set(kv))


class Span:
    """One span: ``with`` it, or :meth:`open` and :meth:`close` it.

    A span made by :func:`timed` with tracing off reads the clock and keeps
    nothing else."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "request", "child_ns",
                 "segment", "_kept", "_range")

    def __init__(self, name: str, attrs: dict, kept: bool):
        self.name, self.attrs, self._kept = name, attrs, kept
        self.start_ns = self.end_ns = self.child_ns = 0
        self.parent = self.segment = self._range = None
        self.request = 0

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def ms(self) -> float:
        return self.ns / 1e6

    @property
    def self_ns(self) -> int:
        """Duration less that of the spans opened directly beneath it."""
        return self.ns - self.child_ns

    def open(self) -> "Span":
        if self._kept:
            stack = _stack()
            self.parent = stack[-1] if stack else None
            self.request = next(_REQUESTS) if self.parent is None else self.parent.request
            self.segment = _segment()
            if _profiler._is_profiler_enabled:
                self._range = _RANGE(f"ital.{self.name}")
                self._range.__enter__()
            stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def close(self) -> None:
        """End the span; closing it again does nothing."""
        if self.end_ns:
            return
        self.end_ns = time.perf_counter_ns()
        if not self._kept:
            return
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self.parent is not None:
            self.parent.child_ns += self.ns
        _RING.append(self)

    def __enter__(self) -> "Span":
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _segment() -> Segment:
    """The segment being recorded, a new one after tracing was found off."""
    if _GAP[0]:
        with _LOCK:
            if _GAP[0]:
                _SEGMENTS.append(Segment(next(_SEGMENT_IDS)))
                _GAP[0] = False
    return _SEGMENTS[-1]


def tracing() -> bool:
    """Whether spans and counters record now: while a ``torch.profiler``
    records, or inside :func:`recording`."""
    return bool(_profiler._is_profiler_enabled or _RECORDING[0])


def span(name: str, **attrs):
    """A context manager that records the span ``name`` with ``attrs`` while
    tracing is on; off, the shared no-op."""
    if not (_profiler._is_profiler_enabled or _RECORDING[0]):
        _GAP[0] = True
        return _OFF
    return Span(name, attrs, True)


def timed(name: str, **attrs) -> Span:
    """A span whose clock readings are kept also with tracing off (its
    ``ms``), for a timing that is recorded elsewhere too: one clock, read
    once."""
    on = tracing()
    if not on:
        _GAP[0] = True
    return Span(name, attrs, on)


def count(name: str, n: int = 1, **attrs) -> None:
    """Add ``n`` to counter ``name`` with ``attrs`` in the segment being
    recorded, while tracing is on; inside :func:`program_counts` to its
    record instead, whether tracing is on or off."""
    tally = getattr(_LOCAL, "tally", None)
    if tally is None and not (_profiler._is_profiler_enabled or _RECORDING[0]):
        _GAP[0] = True
        return
    key = (name, tuple(sorted(attrs.items())))
    if tally is None:
        add_counts({key: n})
    else:
        tally[key] = tally.get(key, 0) + n


def add_counts(counts: dict) -> None:
    """Add ``counts`` (a :func:`program_counts` record, ``(name,
    attributes) -> n``) to the segment being recorded: a replayed program's
    counters, whose ``count`` calls ran only at its capture."""
    seg = _segment()
    with _LOCK:
        for key, n in counts.items():
            seg.counters[key] = seg.counters.get(key, 0) + n


@contextlib.contextmanager
def program_counts(record: bool = True):
    """Keep this thread's :func:`count` calls in the dict this yields, by
    ``(name, attributes)``, whether tracing is on or off, and count none of
    them: what a program's capture counts happens at each of its replays,
    which :func:`add_counts` counts.  With ``record`` False, inside such a
    block, the calls count as usual again (the eager warm-up before the
    capture)."""
    outer = getattr(_LOCAL, "tally", None)
    _LOCAL.tally = {} if record else None
    try:
        yield _LOCAL.tally
    finally:
        _LOCAL.tally = outer


@contextlib.contextmanager
def recording():
    """Trace without a profiler, in a segment of its own (for tests and
    operators' scripts); every thread's spans record meanwhile."""
    with _LOCK:
        _RECORDING[0] += 1
        if _RECORDING[0] == 1:
            _GAP[0] = True
    try:
        yield
    finally:
        with _LOCK:
            _RECORDING[0] -= 1
            if _RECORDING[0] == 0:
                _GAP[0] = True


def segments() -> list:
    """The segments held, oldest first, each with the spans the ring still
    holds in order of their start and a copy of its counters."""
    with _LOCK:
        held = list(_SEGMENTS)
        counters = [dict(seg.counters) for seg in held]
    spans = collections.defaultdict(list)
    for s in list(_RING):
        spans[id(s.segment)].append(s)
    return [Segment(seg.index, c, sorted(spans[id(seg)], key=lambda s: s.start_ns))
            for seg, c in zip(held, counters)]


def clear() -> None:
    """Drop every segment and span held."""
    with _LOCK:
        _RING.clear()
        _SEGMENTS.clear()
        _GAP[0] = True
