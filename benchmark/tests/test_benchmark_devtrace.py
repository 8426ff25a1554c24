"""The traced window's stretches: a stretch whose profile dropped RBF
records is read again from a later one; idle gaps are named by the span
open when they began."""

import benchtiny  # noqa: F401
from benchmark import devtrace


class _Profile:
    """Stands in for the profiler: each stretch reads ``records`` in turn."""

    def __init__(self, records):
        self.records = list(records)
        self.started = 0

    def warm_up(self):
        pass

    def start(self):
        self.started += 1

    def stop(self):
        pass

    def summary(self, marks):
        return {"busy_s": 1.0, "window_s": 3.0, "kernel_records": self.records.pop(0)}


def _window(records, monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(devtrace.time, "perf_counter", lambda: clock[0])
    fake = _Profile(records)
    monkeypatch.setattr(devtrace, "Profiled", lambda torch: fake)
    launches = [0]
    s = devtrace.Stretches(None, lambda: launches[0], lambda: launches[0] // 10, ("rbf",),
                           3.0, 2)
    while clock[0] < 30.0:
        clock[0] += 0.5
        launches[0] += 10
        s.step(12.0, 30.0)
    s.close()
    return s, fake


def test_a_complete_stretch_is_kept(monkeypatch):
    s, fake = _window([60, 0, 0], monkeypatch)
    assert fake.started == 1 and s.done and s.summary["launches"] == 60
    first, end = s.summary["calls"]
    assert end - first == 6 and first > 0


def test_a_stretch_that_dropped_records_is_read_again(monkeypatch):
    s, fake = _window([59, 60, 0, 0], monkeypatch)
    assert fake.started == 2 and s.done and s.summary["kernel_records"] == 60


def test_every_stretch_short_keeps_the_most_complete(monkeypatch):
    s, fake = _window([55, 59, 58, 57, 56, 55], monkeypatch)
    assert not s.done and fake.started >= 4 and s.summary["kernel_records"] == 59


def test_idle_share_reads_only_a_nearly_complete_profile():
    import types

    from benchmark.harness import load_reader

    read = load_reader("device_idle_pct")
    rec = types.SimpleNamespace(log=lambda msg: None)
    for records, want in ((100, 75.0), (98, 75.0), (97, None), (101, None)):
        rec.trace = {"busy_s": 1.0, "window_s": 4.0, "kernel_records": records,
                     "launches": 100}
        assert read(rec) == want, records


def test_gaps_are_named_by_the_open_span():
    spans = sorted([(10, 20, "select"), (25, 40, "update")])
    assert devtrace._open_span(spans, 15) == "select"
    assert devtrace._open_span(spans, 22) == "between calls"
    assert devtrace._open_span(spans, 39) == "update"
    assert devtrace._open_span(spans, 5) == "between calls"
