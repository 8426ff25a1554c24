"""The readers of the port's spans and counters: the kept stretch's segment
found from the harness's calls, its user turns on both built-in paths, and
nothing read where no segment matches, where the capture spans and the
harness's calls that captured disagree, on a CPU run, or from a program that
records none."""

import types

import pytest

import benchtiny
from benchmark import harness, portspans
from ital_tpu_torch.utils import logging as port

COHORT = [("start", 1, False), ("start", 1, False), ("feedback_many", 3, True),
          ("select_many", 8, False), ("feedback_many", 8, False), ("select_many", 8, False)]
SINGLE = [("start", 1, False), ("select", 1, False), ("feedback", 1, False),
          ("select", 1, False)]
NAMES = {"start": "serve.set_query", "feedback": "serve.feedback",
         "feedback_many": "serve.feedback_many", "select": "serve.next_batch",
         "select_many": "serve.next_batch_many"}


def _span(name, start, end, parent=None):
    s = port.Span(name, {}, True)
    s.start_ns, s.end_ns, s.parent = start, end, parent
    s.request = parent.request if parent is not None else start
    return s


def _segment(calls, t0=0):
    """A segment holding one request a call (a start: ``create_session``
    then ``set_query``) of 10 ms each, a ``delete`` before each start; each
    request holds a 2 ms ``*.wait`` span and, where the call captured, a
    3 ms ``graphs.capture`` span with a 1 ms ``.wait`` inside it."""
    spans, t, ms = [], t0, 1_000_000
    for kind, _, captured in calls:
        if kind == "start":
            spans.append(_span("serve.delete", t, t + ms))
            spans.append(_span("serve.create_session", t + ms, t + 2 * ms))
            t += 2 * ms
        req = _span(NAMES[kind], t, t + 10 * ms)
        spans.append(req)
        run = _span("graphs.run", t + ms, t + 9 * ms, req)
        spans.append(run)
        spans.append(_span("graphs.checks.wait", t + 2 * ms, t + 4 * ms, run))
        if captured:
            cap = _span("graphs.capture", t + 5 * ms, t + 8 * ms, run)
            spans += [cap, _span("graphs.checks.wait", t + 6 * ms, t + 7 * ms, cap)]
        t += 10 * ms
    counters = {("graphs.copy_bytes", (("dir", "in"),)): 3_000_000,
                ("graphs.copy_bytes", (("dir", "back"),)): 2_000_000,
                ("graphs.copy_bytes", (("dir", "out"),)): 1_000_000}
    return port.Segment(1, counters, spans)


def _rec(calls, lo, hi, trace=True):
    logged = []
    rec = types.SimpleNamespace(calls=calls, trace={"calls": [lo, hi], "busy_s": 1.0}
                                if trace else None, log=logged.append, logged=logged)
    return rec


def _read(metric, rec):
    return harness.load_reader(metric, benchtiny.ROOT)(rec)


@pytest.fixture
def held(monkeypatch):
    """Make the port report the segments this fixture's list holds."""
    segs = []
    monkeypatch.setattr(port, "segments", lambda: list(segs))
    return segs


def test_the_segment_is_found_from_the_calls_of_the_stretch(held):
    calls = SINGLE * 3
    held += [_segment(SINGLE), _segment(calls[4:10]), _segment(SINGLE[1:])]
    seg, turns = portspans.kept(_rec(calls, 4, 10))
    assert seg is held[1] and turns == 3
    seg, turns = portspans.kept(_rec(calls, 0, 4))
    assert seg is held[0] and turns == 2


@pytest.mark.parametrize("calls,turns", [(COHORT, 16), (SINGLE, 2)])
def test_user_turns_are_the_sessions_of_the_selection_calls(held, calls, turns):
    held.append(_segment(calls))
    assert portspans.kept(_rec(calls, 0, len(calls)))[1] == turns


def test_the_readers_read_the_kept_segment(held):
    held.append(_segment(COHORT))
    rec = _rec(COHORT, 0, len(COHORT))
    assert _read("capture_ms_per_turn", rec) == pytest.approx(3.0 / 16)
    assert _read("copy_mb_per_turn.cohort1m", rec) == pytest.approx(6.0 / 16)
    assert any("1 capture spans in 1 calls, 1 calls that captured" in m for m in rec.logged)
    # the calls' requests, a create_session with the start after it
    calls = portspans.by_call(held[0])
    assert [[s.name for s in reqs] for reqs in calls[:3]] == [
        ["serve.create_session", "serve.set_query"],
        ["serve.create_session", "serve.set_query"], ["serve.feedback_many"]]
    assert len(calls) == len(COHORT)


@pytest.mark.parametrize("case", ["no_match", "captures_disagree", "capture_outside_calls",
                                  "cpu_run", "parent"])
def test_nothing_is_read_where_nothing_fits(held, monkeypatch, case):
    held.append(_segment(COHORT))
    if case == "capture_outside_calls":  # a capture in a delete, which no call holds
        delete = next(s for s in held[0].spans if s.name == "serve.delete")
        held[0].spans.append(_span("graphs.capture", delete.start_ns, delete.end_ns, delete))
    lo, hi = (0, 5) if case == "no_match" else (0, len(COHORT))
    calls = list(COHORT)
    if case == "captures_disagree":  # the harness saw the capture in the next call
        calls[2:4] = [("feedback_many", 3, False), ("select_many", 8, True)]
    rec = _rec(calls, lo, hi, trace=case != "cpu_run")
    if case == "parent":
        monkeypatch.delattr(port, "segments")
    got = {m: _read(m, rec) for m in ("capture_ms_per_turn", "copy_mb_per_turn")}
    if case in ("captures_disagree", "capture_outside_calls"):
        assert got["capture_ms_per_turn"] is None
        assert got["copy_mb_per_turn"] == pytest.approx(6.0 / 16)
    else:
        assert got == dict.fromkeys(got)


def test_a_traced_stretch_of_the_port_is_found(monkeypatch):
    """The port's own recorder: a segment recorded through the service's
    spans is the one the calls name."""
    port.clear()
    with port.recording():
        for name in ("serve.create_session", "serve.set_query", "serve.next_batch"):
            with port.span(name):
                with port.span("graphs.run"):
                    port.count("graphs.copy_bytes", 2_000_000, dir="in")
    calls = [("start", 1, False), ("select", 1, False)]
    rec = _rec(calls, 0, 2)
    seg, turns = portspans.kept(rec)
    assert turns == 1 and [s.name for s in portspans.requests(seg)] == [
        "serve.create_session", "serve.set_query", "serve.next_batch"]
    assert _read("copy_mb_per_turn", rec) == pytest.approx(6.0)
    assert _read("capture_ms_per_turn", rec) == 0.0
    port.clear()
