"""The served path's spans and counters (``ital_tpu_torch.utils.logging``):
how they nest and group, that they record nothing while tracing is off, how
they lie on a ``torch.profiler`` timeline, and what ``serve.py`` and
``graphs.py`` mark with them.  The graph path runs on the CPU through a
stand-in graph; the capture's own spans are held on a card by the
``cuda``-marked test at the end.

No JAX here, so this file also runs where only the port is installed:

    python -m pytest tests/test_torch_trace.py --noconftest -q
"""

import contextlib
import gc
import os
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.ops import kernels, rbf_hopper
from ital_tpu_torch.serve import RetrievalService
from ital_tpu_torch.utils import logging as trace


@pytest.fixture(autouse=True)
def _fresh():
    trace.clear()
    yield
    trace.clear()


def _spans(seg, name):
    return [s for s in seg.spans if s.name == name]


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, 6)) * 4
    return np.concatenate([c + rng.normal(size=(40, 6)) for c in centers]).astype(np.float32)


@pytest.fixture(scope="module")
def service():
    return RetrievalService(_corpus(), length_scale=2.5, noise=0.1, cap=32, strategy="ital",
                            label_prob=1.0, mistake_prob=0.0, device="cpu",
                            method_kwargs={"pool_size": 32, "n_qmc": 16})


# --- the recorder -------------------------------------------------------------


def test_spans_nest_within_their_parent_and_share_its_request():
    with trace.recording():
        with trace.span("serve.outer", who="a"):
            with trace.span("graphs.run", program="p"):
                time.sleep(0.002)
                with trace.span("graphs.replay"):
                    time.sleep(0.001)
            with trace.span("serve.picks.wait"):
                time.sleep(0.001)
        with trace.span("serve.other"):
            pass
    (seg,) = trace.segments()
    outer, run, replay, wait, other = seg.spans
    assert [s.name for s in seg.spans] == ["serve.outer", "graphs.run", "graphs.replay",
                                           "serve.picks.wait", "serve.other"]
    assert outer.parent is None and run.parent is outer and replay.parent is run
    assert wait.parent is outer and other.parent is None
    assert outer.attrs == {"who": "a"} and run.attrs == {"program": "p"}
    for child in (run, replay, wait):
        assert child.parent.start_ns <= child.start_ns <= child.end_ns <= child.parent.end_ns
    assert outer.request == run.request == replay.request == wait.request
    assert other.request != outer.request
    assert outer.self_ns == outer.ns - run.ns - wait.ns
    assert run.self_ns == run.ns - replay.ns
    assert replay.self_ns == replay.ns > 0


def test_spans_on_another_thread_open_their_own_request():
    seen = []

    def worker():
        with trace.span("serve.next_batch"):
            seen.append(trace._stack()[0])

    with trace.recording():
        with trace.span("serve.feedback") as mine:
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    (seg,) = trace.segments()
    assert seen[0].parent is None and seen[0].request != mine.request
    assert {s.name for s in seg.spans} == {"serve.feedback", "serve.next_batch"}


def test_tracing_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    entered = []

    class Range:
        def __init__(self, *args):
            entered.append(args)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "_RANGE", Range)
    assert not trace.tracing()
    before = len(trace._RING)
    for _ in range(3):
        got = trace.span("graphs.run", program="p", graphed=True)
        assert got is trace._OFF
        with got:
            trace.count("graphs.copy_bytes", 8, dir="in")
    assert len(trace._RING) == before and trace.segments() == [] and entered == []
    # recording() alone keeps spans but opens no profiler range either
    with trace.recording(), trace.span("graphs.run"):
        pass
    assert entered == [] and len(trace.segments()[0].spans) == 1


def test_timed_keeps_its_clock_readings_with_tracing_off():
    with trace.timed("graphs.warmup") as t:
        time.sleep(0.001)
    assert t.ns >= 1_000_000 and t.ms == t.ns / 1e6
    assert trace.segments() == []
    with trace.recording():
        with trace.timed("graphs.warmup") as kept:
            pass
    (seg,) = trace.segments()
    assert seg.spans == [kept]


def test_counters_sum_by_attribute_per_segment():
    with trace.recording():
        trace.count("graphs.copy_bytes", 10, dir="in")
        trace.count("graphs.copy_bytes", 5, dir="in")
        trace.count("graphs.copy_bytes", 7, dir="back")
        trace.count("calls")
    trace.count("calls")  # off: not counted
    with trace.recording():
        trace.count("calls", 2)
    first, second = trace.segments()
    assert first.count("graphs.copy_bytes") == 22
    assert first.count("graphs.copy_bytes", dir="in") == 15
    assert first.count("graphs.copy_bytes", dir="out") == 0
    assert first.count("calls") == 1 and second.count("calls") == 2
    assert second.index > first.index


def test_threads_lose_no_count_and_keep_their_own_parents():
    """Server handler threads trace at once: no counter update is lost and
    each thread's spans nest under its own."""
    import sys

    workers, rounds = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(rounds):
                with trace.span("serve.feedback"), trace.span("graphs.run"):
                    trace.count("calls")

        with trace.recording():
            threads = [threading.Thread(target=worker) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    (seg,) = trace.segments()
    assert seg.count("calls") == workers * rounds
    runs = [s for s in seg.spans if s.name == "graphs.run"]
    assert len(runs) == workers * rounds
    assert all(s.parent.name == "serve.feedback" and s.request == s.parent.request
               for s in runs)
    assert len({s.request for s in runs}) == workers * rounds


def test_the_ring_drops_the_oldest_spans(monkeypatch):
    import collections

    monkeypatch.setattr(trace, "_RING", collections.deque(maxlen=4))
    with trace.recording():
        for i in range(6):
            with trace.span(f"s{i}"):
                pass
    (seg,) = trace.segments()
    assert [s.name for s in seg.spans] == ["s2", "s3", "s4", "s5"]


def test_each_profiler_session_opens_a_new_segment():
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("serve.next_batch"):
                torch.ones(4).add_(1)
            trace.count("calls")
        with trace.span("serve.next_batch"):  # between the sessions: off
            pass
    segs = trace.segments()
    assert len(segs) == 2
    assert [len(seg.spans) for seg in segs] == [1, 1]
    assert [seg.count("calls") for seg in segs] == [1, 1]


# --- the service and its programs -----------------------------------------------


def test_profile_holds_the_request_and_program_ranges_around_their_work(service):
    from torch.profiler import ProfilerActivity, profile

    sid = service.create_session()
    service.set_query(sid, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = service.next_batch(sid, 4)
        service.feedback(sid, {str(i): 1 for i in batch})
    service.delete(sid)
    events = prof.events()
    names = {e.name for e in events}
    assert {"ital.serve.next_batch", "ital.serve.feedback", "ital.graphs.run",
            "ital.serve.picks.wait"} <= names

    def inside(e, name):
        while e is not None:
            if e.name == name:
                return True
            e = e.cpu_parent
        return False

    ops = [e for e in events if e.name.startswith("aten::")]
    for outer in ("ital.graphs.run", "ital.serve.next_batch", "ital.serve.feedback"):
        held = [e for e in ops if inside(e, outer)]
        assert held, outer
        rng = [e for e in events if e.name == outer]
        for e in held:
            assert any(r.time_range.start <= e.time_range.start <= e.time_range.end
                       <= r.time_range.end for r in rng)
    (seg,) = trace.segments()
    assert [s.name for s in seg.spans if s.parent is None] == ["serve.next_batch",
                                                               "serve.feedback"]


def test_each_service_call_is_one_request_with_its_name(service):
    with trace.recording():
        sids = [service.create_session() for _ in range(2)]
        for sid, q in zip(sids, (3, 47)):
            service.set_query(sid, q)
        batches = service.next_batch_many(sids, 4)
        service.feedback_many({sid: {str(i): 1 for i in batches[sid]} for sid in sids})
        batch = service.next_batch(sids[0], 4)
        service.feedback(sids[0], {str(i): -1 for i in batch})
        for sid in sids:
            service.delete(sid)
    (seg,) = trace.segments()
    roots = [s for s in seg.spans if s.parent is None]
    assert [s.name for s in roots] == (
        ["serve.create_session"] * 2 + ["serve.set_query"] * 2
        + ["serve.next_batch_many", "serve.feedback_many", "serve.next_batch",
           "serve.feedback"] + ["serve.delete"] * 2)
    assert len({s.request for s in roots}) == len(roots)
    by_request = {s.request: s for s in roots}
    for s in seg.spans:
        assert s.request in by_request
    picks = _spans(seg, "serve.picks.wait")
    assert [by_request[s.request].name for s in picks] == ["serve.next_batch_many",
                                                           "serve.next_batch"]
    runs = _spans(seg, "graphs.run")
    assert runs and all(s.attrs["graphed"] is False for s in runs)
    assert {by_request[s.request].name for s in runs} >= {
        "serve.next_batch_many", "serve.feedback_many", "serve.next_batch", "serve.feedback"}


class _StandInGraph:
    """Recomputes the body into the captured outputs at each replay, as the
    captured graph rewrites its static buffers; like a graph, it does not
    keep the shared tensors alive."""

    def __init__(self, body, shared, buffers, outputs):
        self.body, self.buffers, self.outputs = body, buffers, outputs
        self.shared = {k: weakref.ref(v) for k, v in shared.items()}

    def replay(self):
        with graphs._in_program():
            new = self.body(**{k: ref() for k, ref in self.shared.items()}, **self.buffers)
        for out, val in zip(self.outputs, new):
            out.copy_(val)


@pytest.fixture
def stand_in(monkeypatch):
    """Route CPU tensors through the graph path with :class:`_StandInGraph`."""
    def capture_graph(name, body, buffers, shared, device, mesh):
        with graphs._in_program() as checks:
            outputs = tuple(t.clone() for t in body(**shared, **buffers))
        return _StandInGraph(body, shared, buffers, outputs), outputs, checks, {}, 0.0, 0.0, 0.0

    monkeypatch.setattr(graphs, "_PROGRAMS", {})
    monkeypatch.setattr(graphs, "_STAGES", {})
    monkeypatch.setattr(graphs, "_RELEASED", {})
    monkeypatch.setattr(graphs, "_GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_capture_graph", capture_graph)


def _double(a, w):
    a.mul_(2)
    return (a.sum(-1) * w,)


def _scaled(x, a):
    return (a * x.sum(),)


ONE = torch.ones(1)


def test_program_calls_split_into_their_parts_with_bytes_counted(stand_in):
    ts = [torch.arange(6, dtype=torch.float32) + j for j in range(3)]
    before = graphs.captures()
    with trace.recording():
        graphs.run("double", _double, {"a": ts, "w": ONE}, writes=("a",))
        graphs.run("double", _double, {"a": ts, "w": ONE}, writes=("a",))
    (seg,) = trace.segments()
    assert graphs.captures() - before == 1
    runs = _spans(seg, "graphs.run")
    assert len(runs) == 2 and all(s.attrs == {"program": "double", "graphed": True}
                                  for s in runs)
    (capture,) = _spans(seg, "graphs.capture")
    assert capture.parent is runs[0] and capture.attrs == {"program": "double", "cause": "new",
                                                           "stage": "grown"}
    assert [s.name for s in seg.spans if s.parent is capture] == ["graphs.pool_bytes"] * 2
    for run in runs:
        assert [s.name for s in seg.spans if s.parent is run][-4:] == [
            "graphs.copy_in", "graphs.replay", "graphs.copy_back", "graphs.copy_out"]
    assert len(_spans(seg, "graphs.replay")) == 2
    stack = 3 * 6 * 4
    # the capture's copy into its new buffers, then one copy-in a call
    assert seg.count("graphs.copy_bytes", dir="in") == 3 * (stack + 4)
    assert seg.count("graphs.copy_bytes", dir="back") == 2 * stack
    assert seg.count("graphs.copy_bytes", dir="out") == 2 * 3 * 4
    assert torch.equal(ts[1], (torch.arange(6, dtype=torch.float32) + 1) * 4)


def test_a_capture_names_why_its_program_was_released(stand_in, monkeypatch):
    small = [torch.ones(4) for _ in range(2)]
    large = [torch.ones(8) for _ in range(2)]
    one = ONE
    monkeypatch.setattr(graphs, "STACK_BYTES", 80)  # one of the two stages at a time
    before = graphs.captures()
    with trace.recording():
        graphs.run("double", _double, {"a": small, "w": one}, writes=("a",))
        graphs.run("double", _double, {"a": large, "w": one}, writes=("a",))  # releases the small one
        graphs.run("double", _double, {"a": small, "w": one}, writes=("a",))
        graphs._release_for_room()
        graphs.run("double", _double, {"a": small, "w": one}, writes=("a",))
        x = torch.ones(5)
        graphs.run("scaled", _scaled, {"a": torch.ones(3)}, shared={"x": x})
        del x
        gc.collect()
        graphs.run("double", _double, {"a": torch.ones(2), "w": one}, writes=("a",))
    (seg,) = trace.segments()
    captures = _spans(seg, "graphs.capture")
    assert graphs.captures() - before == len(captures)
    causes = [s.attrs["cause"] for s in captures]
    assert causes == ["new", "new", "after_stack_bytes", "after_room", "new", "new"]
    assert [s.attrs["program"] for s in captures].count("scaled") == 1
    reasons = [s.attrs["reason"] for s in _spans(seg, "graphs.release")]
    assert reasons == ["stack_bytes", "stack_bytes", "room", "dead_corpus"]
    assert all(s.parent.name == "graphs.capture" for s in _spans(seg, "graphs.release")
               if s.attrs["reason"] != "room")


def test_a_capture_binds_the_stage_of_its_list_input_and_counts_its_bytes(stand_in):
    """Programs over one list input's name and slice layout bind one stage:
    the first makes it (``grown``), a narrower K binds its first slices
    (``reused``), a wider K grows it, which releases the programs bound to
    it (their next capture ``after_stage_grown``); a program without a list
    input binds none.  Each call equals the eager call."""
    ts = [torch.arange(6, dtype=torch.float32) + j for j in range(4)]
    twins = [t.clone() for t in ts]
    x = torch.ones(5)
    before = graphs.captures()
    with trace.recording():
        for k in (3, 2, 4, 2, 3):
            got = graphs.run("double", _double, {"a": ts[:k], "w": ONE}, writes=("a",))
            with graphs.eager():
                want = graphs.run("double", _double, {"a": twins[:k], "w": ONE}, writes=("a",))
            assert torch.equal(got[0], want[0]) and all(map(torch.equal, ts, twins)), k
        graphs.run("scaled", _scaled, {"a": torch.ones(3)}, shared={"x": x})
    (seg,) = trace.segments()
    captures = _spans(seg, "graphs.capture")
    assert graphs.captures() - before == len(captures) == 6
    assert [(s.attrs["cause"], s.attrs["stage"]) for s in captures] == [
        ("new", "grown"), ("new", "reused"), ("new", "grown"), ("after_stage_grown", "reused"),
        ("after_stage_grown", "reused"), ("new", "none")]
    assert [s.attrs["reason"] for s in _spans(seg, "graphs.release")] == ["stage_grown"] * 2
    row = 6 * 4
    assert seg.count("graphs.stage_bytes", event="grown") == (3 + 4) * row
    assert seg.count("graphs.stage_bytes", event="reused") == (2 + 2 + 3) * row
    (stage,) = graphs.stages()
    assert stage.buffer.shape == (4, 6)
    held = [p for p in graphs.programs() if p.stacks]
    assert sorted(p.inputs["a"].shape[0] for p in held) == [2, 3, 4]
    assert all(p.inputs["a"].data_ptr() == stage.buffer.data_ptr() and p.stages == (stage,)
               for p in held)


def _add(a, w):
    a.add_(w)
    return (a.sum(-1),)


def test_threads_sharing_a_stage_lose_no_write(stand_in):
    """More threads than cores call programs of K = 3 to 8 over one list
    input, each on its own rows, with a short switch interval: every write
    lands in its own thread's rows, and once a call of 8 has made the
    stage, each K captures once."""
    n_threads, calls = (os.cpu_count() or 2) + 2, 24
    rows = [[torch.zeros(16) for _ in range(8)] for _ in range(n_threads)]
    one, c0, errors = torch.ones(1), graphs.captures(), []
    graphs.run("add", _add, {"a": [torch.zeros(16) for _ in range(8)], "w": one}, writes=("a",))

    def work(t):
        try:
            for i in range(calls):
                graphs.run("add", _add, {"a": rows[t][:3 + (t + i) % 6], "w": one},
                           writes=("a",))
        except Exception as exc:  # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    for t in range(n_threads):
        hits = [sum(j < 3 + (t + i) % 6 for i in range(calls)) for j in range(8)]
        assert [r.tolist() for r in rows[t]] == [[float(h)] * 16 for h in hits], t
    assert graphs.captures() - c0 == 6 and len(graphs.stages()) == 1


# --- counters inside a program: recorded at its capture, counted at each replay --


class _ReplayGraph:
    """Recomputes the body into the captured outputs at each replay, and, as
    a graph's replay runs no Python, lets none of its launches or counts
    reach the counters: the caller counts them from the capture's record."""

    def __init__(self, body, shared, buffers, outputs):
        self.body, self.shared, self.buffers, self.outputs = body, shared, buffers, outputs

    def replay(self):
        with rbf_hopper.recording_launches(), trace.program_counts(), graphs._in_program():
            new = self.body(**self.shared, **self.buffers)
        for out, val in zip(self.outputs, new):
            out.copy_(val)


@pytest.fixture
def replay_graph(monkeypatch):
    """The graph path on the CPU as ``graphs._capture_graph`` takes it on a
    card: an eager warm-up that counts as it runs, then a capture whose
    launches are recorded (its counts are recorded by ``graphs._capture``),
    then :class:`_ReplayGraph`; each plain RBF call counts as a launch."""
    def capture_graph(name, body, buffers, shared, device, mesh):
        with graphs._in_program(), trace.program_counts(record=False):
            body(**shared, **buffers)
        with rbf_hopper.recording_launches() as launches, graphs._in_program() as checks:
            outputs = tuple(t.clone() for t in body(**shared, **buffers))
        return (_ReplayGraph(body, shared, buffers, outputs), outputs, checks, launches,
                0.0, 0.0, 0.0)

    plain = kernels._rbf_forward

    def counted(*args):
        rbf_hopper._count_launch("wgmma")
        return plain(*args)

    monkeypatch.setattr(graphs, "_PROGRAMS", {})
    monkeypatch.setattr(graphs, "_STAGES", {})
    monkeypatch.setattr(graphs, "_RELEASED", {})
    monkeypatch.setattr(graphs, "_GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_capture_graph", capture_graph)
    monkeypatch.setattr(kernels, "_rbf_forward", counted)


KPOST_N, KPOST_BLOCK = 40, 16  # three candidate blocks: 16, 16 and 8 wide


def _kpost_inputs(k=3, dtype=torch.float32):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(KPOST_N, 6, generator=gen, dtype=dtype)
    v = [0.3 * torch.randn(4, KPOST_N, generator=gen, dtype=dtype) for _ in range(k)]
    hyper = torch.full((k,), 2.0, dtype=dtype)
    return x, {"v": v, "ls": hyper, "var": hyper * 0.5}


def _kpost(x, v, ls, var):
    groups = [list(range(v.shape[0]))]
    return (kernels.blockwise_reduce_abs_kpost_stacked(x, v, ls, var, groups,
                                                       block=KPOST_BLOCK),)


def _kpost_call(x, inputs):
    return graphs.run("kpost", _kpost, inputs, shared={"x": x})[0]


def test_a_replay_counts_what_its_capture_recorded_as_an_eager_call_does(replay_graph):
    """A program captured with tracing off and replayed under ``recording()``
    counts ``kernels.kpost_bytes`` and ``kernels.kpost_blocks`` at every
    replay, as much as an eager call of its body counts."""
    x, inputs = _kpost_inputs()
    c0 = graphs.captures()
    first = _kpost_call(x, inputs)  # tracing off: captured and replayed, nothing counted
    assert graphs.captures() - c0 == 1 and trace.segments() == []
    (prog,) = graphs.programs()
    k, per_call = 3, 3 * KPOST_N * KPOST_N * 4
    assert prog.counts == {("kernels.kpost_blocks", ()): k * 3,
                           ("kernels.kpost_bytes", ()): per_call}
    with trace.recording():
        got = [_kpost_call(x, inputs) for _ in range(3)]
    with trace.recording(), graphs.eager():
        want = _kpost_call(x, inputs)
    replayed, eager = trace.segments()
    assert graphs.captures() - c0 == 1 and prog.replays == 4
    assert replayed.count("kernels.kpost_bytes") == 3 * eager.count("kernels.kpost_bytes")
    assert eager.count("kernels.kpost_bytes") == per_call
    assert replayed.count("kernels.kpost_blocks") == 3 * eager.count("kernels.kpost_blocks")
    assert eager.count("kernels.kpost_blocks") == k * 3
    assert all(torch.equal(g, want) for g in [first, *got])


def test_a_capture_counts_its_warm_up_and_its_replay_once_each(replay_graph):
    """Under ``recording()`` a call that captures counts the body's counters
    twice, as it does its RBF launches: its eager warm-up and its replay;
    the next call once."""
    x, inputs = _kpost_inputs(k=2)
    per_call = 2 * KPOST_N * KPOST_N * 4
    with trace.recording():
        _kpost_call(x, inputs)
    with trace.recording():
        _kpost_call(x, inputs)
    captured, replayed = trace.segments()
    assert captured.count("kernels.kpost_bytes") == 2 * per_call
    assert replayed.count("kernels.kpost_bytes") == per_call
    assert trace._LOCAL.tally is None


def test_replays_with_tracing_off_count_nothing_and_launches_as_before(replay_graph):
    """With tracing off nothing is counted, at the capture or any replay;
    ``rbf_hopper.LAUNCHES`` counts the program's launches at every replay
    (a capturing call's warm-up too), tracing on or off, as before."""
    x, inputs = _kpost_inputs()
    blocks = 3  # one launch a candidate block: the three sessions share their group's
    l0 = rbf_hopper.LAUNCHES
    _kpost_call(x, inputs)
    assert rbf_hopper.LAUNCHES - l0 == 2 * blocks
    l1 = rbf_hopper.LAUNCHES
    for _ in range(2):
        _kpost_call(x, inputs)
    assert rbf_hopper.LAUNCHES - l1 == 2 * blocks
    assert trace.segments() == []
    l2 = rbf_hopper.LAUNCHES
    with trace.recording():
        _kpost_call(x, inputs)
    assert rbf_hopper.LAUNCHES - l2 == blocks
    (seg,) = trace.segments()
    assert set(seg.counters) == {("kernels.kpost_blocks", ()), ("kernels.kpost_bytes", ()),
                                 ("graphs.copy_bytes", (("dir", "in"),)),
                                 ("graphs.copy_bytes", (("dir", "out"),))}


def test_the_single_posterior_covariance_consumer_counts_its_blocks():
    """``blockwise_reduce_abs_kpost`` over a subset of candidates counts one
    block per ``block`` candidates, each N x its width x 4 bytes."""
    x, inputs = _kpost_inputs(k=1)
    cand = torch.arange(0, KPOST_N, 2)  # 20 candidates: a block of 16, one of 4
    with trace.recording():
        kernels.blockwise_reduce_abs_kpost(x, inputs["v"][0], cand, 2.0, 1.0, block=16)
    kernels.blockwise_reduce_abs_kpost(x, inputs["v"][0], cand, 2.0, 1.0, block=16)
    (seg,) = trace.segments()
    assert seg.count("kernels.kpost_blocks") == 2
    assert seg.count("kernels.kpost_bytes") == KPOST_N * 20 * 4


def _scaled_rows(a, w):
    """Writes its list input and returns a view of it."""
    a.mul_(w)
    return (a[:, :8],)


@pytest.mark.cuda
def test_a_captured_program_records_its_capture_split_causes_and_bytes(monkeypatch):
    """On a card: the capture's parts are spans whose durations are the
    program's timings, a program released under ``STACK_BYTES`` is captured
    again with that cause, and the bytes counted are the tensors' sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a graph capture has no CPU mode)")
    monkeypatch.setattr(graphs, "_PROGRAMS", {})
    monkeypatch.setattr(graphs, "_STAGES", {})
    monkeypatch.setattr(graphs, "_RELEASED", {})
    small = [torch.ones(256, device="cuda") for _ in range(4)]
    large = [torch.ones(512, device="cuda") for _ in range(4)]
    one = torch.ones(1, device="cuda")
    monkeypatch.setattr(graphs, "STACK_BYTES", 9000)  # one of the two at a time
    before = graphs.captures()
    with trace.recording():
        graphs.run("double", _double, {"a": small, "w": one}, writes=("a",))
        graphs.run("double", _double, {"a": small, "w": one}, writes=("a",))
        graphs.run("double", _double, {"a": large, "w": one}, writes=("a",))
        graphs.run("double", _double, {"a": small, "w": one}, writes=("a",))
        torch.cuda.synchronize()
    (seg,) = trace.segments()
    captures = _spans(seg, "graphs.capture")
    assert [s.attrs["cause"] for s in captures] == ["new", "new", "after_stack_bytes"]
    assert graphs.captures() - before == len(captures)
    assert len(_spans(seg, "graphs.replay")) == 4
    for cap in captures:
        parts = [s.name for s in seg.spans if s.parent is cap]
        assert parts[-5:] == ["graphs.pool_bytes", "graphs.warmup", "graphs.record",
                              "graphs.instantiate", "graphs.pool_bytes"]
    prog = graphs.programs()[-1]
    last = captures[-1]
    split = {s.name: s for s in seg.spans if s.parent is last}
    assert prog.warmup_ms == split["graphs.warmup"].ms
    assert prog.capture_ms == split["graphs.record"].ms
    assert prog.instantiate_ms == split["graphs.instantiate"].ms
    n_small, n_large = 4 * 256 * 4 + 4, 4 * 512 * 4 + 4  # the stack and w
    loads = 2 * n_small + n_large  # each capture's copy into its buffers
    calls = 3 * n_small + n_large
    assert seg.count("graphs.copy_bytes", dir="in") == loads + calls
    assert seg.count("graphs.copy_bytes", dir="back") == calls - 4 * 4
    assert seg.count("graphs.copy_bytes", dir="out") == 4 * 4 * 4
    assert torch.equal(small[0], torch.full((256,), 8.0, device="cuda"))

    # Widths 3 to 8 in alternation, every other call on a side stream: one
    # stage of 8 slices serves every width, so each K captures once, where
    # each program's own stack beside another's would have passed the budget.
    row = 4096
    monkeypatch.setattr(graphs, "STACK_BYTES", 9 * row * 4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [torch.rand(row, device="cuda", generator=gen) for _ in range(8)]
    twins = [t.clone() for t in rows]
    widths = (8, 3, 5, 8, 4, 7, 6, 3, 8, 5, 4, 6, 7, 3)
    ws = [torch.full((1,), 1.0 + 0.25 * j, device="cuda") for j in range(len(widths))]
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    got, seen, c0 = [], set(), graphs.captures()
    for j, k in enumerate(widths):  # nothing but the stage orders the two streams
        with torch.cuda.stream(side) if j % 2 else contextlib.nullcontext():
            got += graphs.run("scaled_rows", _scaled_rows, {"a": rows[:k], "w": ws[j]},
                              writes=("a",))
        seen.add(k)
        assert graphs.captures() - c0 == len(seen), (j, k)
    torch.cuda.synchronize()
    with graphs.eager():
        want = [graphs.run("scaled_rows", _scaled_rows, {"a": twins[:k], "w": ws[j]},
                           writes=("a",))[0] for j, k in enumerate(widths)]
    torch.cuda.synchronize()
    assert all(map(torch.equal, got, want)) and all(map(torch.equal, rows, twins))
    stage = next(s for s in graphs.stages() if s.key[1] == "a" and s.buffer.shape[1:] == (row,))
    assert stage.buffer.shape[0] == 8
    held = [p for p in graphs.programs() if p.name == "scaled_rows"]
    assert len(held) == 6 and all(p.inputs["a"].data_ptr() == stage.buffer.data_ptr()
                                  for p in held)


@pytest.mark.cuda
def test_a_captured_program_counts_its_body_at_every_replay(monkeypatch):
    """On a card: the body's counters of a graph captured with tracing off
    are counted at each replay under ``recording()``, as an eager call
    counts them; a capture under ``recording()`` counts its warm-up and its
    replay; the launches are counted as before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a graph capture has no CPU mode)")
    monkeypatch.setattr(graphs, "_PROGRAMS", {})
    monkeypatch.setattr(graphs, "_STAGES", {})
    monkeypatch.setattr(graphs, "_RELEASED", {})
    _, inputs = _kpost_inputs()
    x = torch.randn(KPOST_N, 128, device="cuda")  # a width the kernels take
    inputs = {k: [t.cuda() for t in v] if isinstance(v, list) else v.cuda()
              for k, v in inputs.items()}
    per_call, blocks = 3 * KPOST_N * KPOST_N * 4, 3
    l0 = rbf_hopper.LAUNCHES
    _kpost_call(x, inputs)
    assert rbf_hopper.LAUNCHES - l0 == 2 * blocks and trace.segments() == []
    with trace.recording():
        got = [_kpost_call(x, inputs) for _ in range(3)]
    with trace.recording(), graphs.eager():
        want = _kpost_call(x, inputs)
    torch.cuda.synchronize()
    replayed, eager = trace.segments()
    assert eager.count("kernels.kpost_bytes") == per_call
    assert replayed.count("kernels.kpost_bytes") == 3 * per_call
    assert replayed.count("kernels.kpost_blocks") == 3 * eager.count("kernels.kpost_blocks") == 27
    assert all(torch.equal(g, want) for g in got)
    inputs["v"] = inputs["v"][:2]  # a new signature, captured under recording()
    with trace.recording():
        _kpost_call(x, inputs)
    assert trace.segments()[-1].count("kernels.kpost_bytes") == 2 * (2 * KPOST_N * KPOST_N * 4)
    assert rbf_hopper.LAUNCHES - l0 == 2 * blocks + 4 * blocks + 2 * blocks
