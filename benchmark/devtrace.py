"""Stretches of a traced window under ``torch.profiler``, reduced to the
device's busy time, its heaviest operations and its idle gaps.

Busy time is the union of the intervals of every device record (kernels,
copies, sets) inside the window, which is the host-side range
``bench.window``; idle is the rest.  Each idle gap is named by the benchmark
span (``bench.<layer>``) that was open on the host when it began,
or ``between calls`` where none was.
"""

from __future__ import annotations

import bisect
import collections
import sys
import time

WINDOW = "bench.window"
# Share of a stretch's RBF launches whose device records its profile may lack
# and still be read (in capture-heavy stretches the profiler drops a few).
SHORTFALL = 0.02


def readable(summary) -> bool:
    """Whether a kept stretch holds a device record for every RBF launch the
    port counted over it, or for all but :data:`SHORTFALL` of them."""
    if not summary or not summary.get("window_s"):
        return False
    records, launches = summary["kernel_records"], summary["launches"]
    return (1.0 - SHORTFALL) * launches <= records <= launches


class Profiled:
    """``start()`` and ``stop()`` a profiled stretch; :meth:`summary` reads it."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.mark = None

    def warm_up(self) -> None:
        """Profile nothing once, so that the profiler's own start-up (CUPTI's)
        falls in set-up and not in the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function(WINDOW)
        self.mark.__enter__()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self, kernel_marks: tuple) -> dict:
        """``busy_s``, ``window_s``, ``ops`` (the ten device operations of most
        time, [name, s]), ``gaps`` (idle seconds by what the host was doing,
        the ten largest, [name, s]), ``kernel_records`` (device records
        whose name holds one of ``kernel_marks``) and ``kernel_s`` (their
        seconds)."""
        events = self.prof.profiler.kineto_results.events()
        cuda = self.torch.autograd.DeviceType.CUDA
        # record_function ranges appear on the host and, as annotations,
        # on the device's timeline too: only the host's count as spans, and
        # annotations never as device work.
        window = [e for e in events if e.name() == WINDOW and e.device_type() != cuda]
        if not window or window[0].duration_ns() <= 0:
            kinds = collections.Counter((str(e.device_type()), e.is_user_annotation())
                                        for e in events)
            print(f"devtrace: no host range {WINDOW!r} among {len(events)} records "
                  f"{dict(kinds)}", file=sys.stderr)
            return {}
        ws, we = window[0].start_ns(), window[0].start_ns() + window[0].duration_ns()
        spans, device = [], []
        for e in events:
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.is_user_annotation() or e.device_type() != cuda:
                if e.device_type() != cuda and e.name().startswith("bench.") \
                        and e.name() != WINDOW:
                    spans.append((start, end, e.name()[len("bench."):]))
            elif end > ws and start < we:
                device.append((max(start, ws), min(end, we), e.name()))
        device.sort()
        spans.sort()
        busy, gaps, cursor = 0, collections.Counter(), ws
        by_op = collections.Counter()
        for start, end, name in device:
            by_op[name] += (end - start) / 1e9
            if start > cursor:
                gaps[_open_span(spans, cursor)] += (start - cursor) / 1e9
            if end > cursor:
                busy += end - max(start, cursor)
                cursor = end
        if we > cursor:
            gaps[_open_span(spans, cursor)] += (we - cursor) / 1e9
        marked = [d for d in device if any(k in d[2] for k in kernel_marks)]
        return {
            "busy_s": busy / 1e9,
            "window_s": (we - ws) / 1e9,
            "ops": [[n, s] for n, s in by_op.most_common(10)],
            "gaps": [[n, s] for n, s in gaps.most_common(10)],
            "kernel_records": len(marked),
            "kernel_s": sum(end - start for start, end, _ in marked) / 1e9,
        }


class Stretches:
    """Profiled stretches of a traced window, one at a time, each of
    ``length`` seconds and at least ``turns`` turns, until one holds a device
    record for every RBF launch the port counted over it (``count()``,
    records named by ``marks``): a profile that dropped records would read a
    busy device as idle.  ``summary`` is the stretch kept, with its
    ``launches`` and the [first, end) positions of its ``calls``
    (``position()`` at its start and its stop): the complete one, else the
    one that kept the largest share of its records.
    (On the card the profile drops a few RBF records in some stretches of
    the 1M-row cohort, whose stretches hold graph captures: 4 of 765 and 9
    of 660; none elsewhere.)"""

    def __init__(self, torch, count, position, marks: tuple, length: float, turns: int):
        self.prof = Profiled(torch)
        self.prof.warm_up()  # the profiler's own start-up falls in set-up
        self.count, self.position, self.marks = count, position, marks
        self.length, self.turns = length, turns
        self.on = self.done = False
        self.summary = None

    def step(self, start_at: float, deadline: float) -> None:
        """After each turn of a window whose stretches start from
        ``start_at`` and which closes at ``deadline`` (``time.perf_counter()``
        readings)."""
        now = time.perf_counter()
        if self.on:
            self.turns_on += 1
            if now - self.t_on >= self.length and self.turns_on >= self.turns:
                self.close()
        elif not self.done and now >= start_at and deadline - now > self.length:
            self.prof.start()
            self.on, self.turns_on = True, 0
            self.base, self.first = self.count(), self.position()
            self.t_on = time.perf_counter()

    def close(self) -> None:
        """End the stretch under way, if any, and read it."""
        if not self.on:
            return
        self.prof.stop()
        self.on = False
        got = {**self.prof.summary(self.marks), "launches": self.count() - self.base,
               "calls": [self.first, self.position()]}
        if self.summary is None or _kept_share(got) > _kept_share(self.summary):
            self.summary = got
        self.done = got.get("kernel_records") == got["launches"]


def _kept_share(summary: dict) -> float:
    """Share of the launches counted that a stretch's profile recorded; 0
    where it recorded more than were counted or nothing at all."""
    records, launches = summary.get("kernel_records"), summary["launches"]
    if records is None or records > launches:
        return 0.0
    return 1.0 if launches == 0 else records / launches


def _open_span(spans: list, t: int) -> str:
    """The span open at ``t`` (the benchmark's spans do not nest), from
    ``spans`` sorted by start."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    return spans[i][2] if i >= 0 and spans[i][1] > t else "between calls"
