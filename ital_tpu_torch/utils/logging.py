"""Structured observability: JSONL per-round metrics and wall-clock timers
(port of ``ital_tpu.utils.logging``).

Every round of an experiment emits one JSON line; stdout stays human
readable.  Timed spans synchronise the run's device before they close, so a
span measures the work and not only its enqueueing.
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional, TextIO

import torch


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
