"""The harness: one run of one cell.

A cell is a ``workloads`` entry of ``BENCHMARK.json``; everything it names is
found by name, so a later change adds files and entries and edits none:

* ``benchmark/configs/<config>.json``: the deployment (corpus, GP, user
  model, selection options, precisions, and the limits of ``correct``);
* ``benchmark/traffic/<traffic>.json``: the mix's parameters, read by the one
  generator (:mod:`benchmark.generator`); and, for a mix that needs code,
  ``benchmark/traffic/<traffic>.py``, whose ``turn(loop)`` and
  ``warm_up(svc, traffic, cfg)`` take the place of the built-in paths'
  (``cohort`` and ``single``, the mix's ``path``) where it defines them;
* ``benchmark/references/<strategy>.py``: the plain reference of the
  configuration's selection strategy (:mod:`benchmark.reference` holds the
  GP posterior they share); a configuration whose strategy has none is
  refused;
* ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(rec)``
  returning the metric's value from a :class:`RunRecord`, or None where it
  finds nothing to read (the metric is then left out of the line).  A metric
  split by cell, ``<metric>.<part>``, is read by ``<metric>.py`` where it has
  no reader of its own;
* ``benchmark/launches/<strategy>.<kind>.json`` or
  ``benchmark/launches/<kind>.json``: the RBF blocks one call of a kind
  launches (:mod:`benchmark.roofline`).

A run makes the corpus on the device from the seed, starts the port's
``RetrievalService`` over it, warms up the programs the mix's calls use,
then drives the closed loop for the window and times every searcher's turn:
from the moment its input (feedback, or the query of a new session) reaches
the service to the return of its next batch.  After the window it reads the
device's peak memory, the metrics, and the numbers ``correct`` compares
(:mod:`benchmark.reference`), once the service's state is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from typing import Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level modules a run may not hold: JAX and the JAX package the port
# stands beside.  Names are compared whole ("ital_tpu_torch" is not
# "ital_tpu").
FORBIDDEN = ("jax", "jaxlib", "flax", "ital_tpu")
# Device records of the port's RBF kernels (csrc/rbf_wgmma.cu, csrc/rbf_tile.cu).
RBF_KERNELS = ("rbf_wgmma_kernel", "rbf_tile_kernel")
PROFILE_AT = 0.4  # share of the window before the first traced stretch starts
PROFILE_S = 3.0  # seconds of a traced stretch (at least PROFILE_TURNS turns)
PROFILE_TURNS = 8
WIDTH_HORIZON = 2000  # turns over which the warm-up collects the feedback widths


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (``sys.modules``)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str):
    """The Python file at ``path``, loaded as a module of its own."""
    name = "benchmark_" + "".join(c if c.isalnum() else "_" for c in os.path.abspath(path))
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    root: str = ROOT  # the checkout the cell was found in
    code: object = None  # the mix's module (traffic/<traffic>.py), where it has one


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload`` in ``root``'s ``BENCHMARK.json``, with its
    configuration, its traffic and the metrics it reports.  Raises
    ``KeyError`` where the configuration's strategy has no reference or the
    mix neither code nor a built-in path."""
    spec = _load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    bench = os.path.join(root, "benchmark")
    config = _load_json(bench, "configs", f"{w['config']}.json")
    strategy = config["selection"]["strategy"]
    if not os.path.exists(reference_path(strategy, root)):
        raise KeyError(f"configuration {w['config']!r}: no reference for its strategy "
                       f"{strategy!r} (benchmark/references/{strategy}.py)")
    traffic = _load_json(bench, "traffic", f"{w['traffic']}.json")
    code_path = os.path.join(bench, "traffic", f"{w['traffic']}.py")
    code = load_module(code_path) if os.path.exists(code_path) else None
    if not hasattr(code, "turn") and traffic.get("path") not in PATHS:
        raise KeyError(f"traffic {w['traffic']!r}: no turn() of its own and no path of "
                       f"{sorted(PATHS)}")

    def reported(metrics):
        return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]

    return Cell(name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=reported(spec["end_to_end"]), per_layer=reported(spec["per_layer"]),
                root=root, code=code)


def reference_path(strategy: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "references", f"{strategy}.py")


def load_judge(strategy: str, root: str = ROOT):
    """The ``readings(ref, low, sampled)`` of the strategy's reference."""
    return load_module(reference_path(strategy, root)).readings


def load_reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``; for a metric
    ``<base>.<part>`` split by cell, of ``<base>.py`` where the split has no
    reader of its own."""
    metrics = os.path.join(root, "benchmark", "metrics")
    path = os.path.join(metrics, f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(metrics, f"{metric.split('.')[0]}.py")
    return load_module(path).read


@dataclasses.dataclass
class RunRecord:
    """What a run measured and counted; the metric readers' input."""

    cell: Cell
    device: object  # torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    turn_ms: list = dataclasses.field(default_factory=list)  # every user turn; inf if failed
    batches: int = 0  # batches returned to users
    attempted: int = 0
    failed: int = 0
    spans: dict = dataclasses.field(default_factory=dict)  # layer -> [ms] (traced runs)
    counters: dict = dataclasses.field(default_factory=dict)  # window increases
    calls: list = dataclasses.field(default_factory=list)  # (kind, sessions, captured)
    trace: Optional[dict] = None  # the kept stretch's devtrace summary and launches

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


class Spans:
    """The benchmark's spans around its calls into the service: with
    ``on``, each marks the profiler's timeline as ``bench.<layer>`` and,
    while ``timed``, closes with a device synchronization and lasts in
    ``ms``; without, nothing.  A profiled stretch turns ``timed`` off, so
    that its device timeline is the served loop's, undrained between calls."""

    def __init__(self, torch, device, on: bool):
        self.torch, self.on, self.timed = torch, on, True
        self.cuda = device.type == "cuda"
        self.ms = {"start": [], "update": [], "select": []}

    @contextmanager
    def __call__(self, layer: str):
        if not self.on:
            yield
            return
        with self.torch.profiler.record_function(f"bench.{layer}"):
            t0 = time.perf_counter()
            yield
            if not self.timed:
                return
            if self.cuda:
                self.torch.cuda.synchronize()
            self.ms.setdefault(layer, []).append((time.perf_counter() - t0) * 1e3)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


class Loop:
    """The mix's closed loop over the service.  A mix's own ``turn(loop)``
    builds its turn from the helpers below, as the built-in paths do."""

    def __init__(self, svc, traffic, cell: Cell, spans: Spans, graphs, record: RunRecord):
        self.svc, self.traffic, self.spans = svc, traffic, spans
        self.graphs, self.rec, self.cell = graphs, record, cell
        self.k = int(cell.config["selection"]["batch"])
        self.user = cell.config["user"]
        self.live = [None] * traffic.slots  # each slot's session
        self.pending = [None] * traffic.slots  # each slot's answers not yet sent
        self.ended = []

    def call(self, kind: str, sessions: int, fn):
        """``fn()``, a call of ``kind`` into the service for ``sessions``
        sessions, recorded for the launch tables (:mod:`benchmark.roofline`)."""
        before = self.graphs.captures()
        out = fn()
        self.rec.calls.append((kind, sessions, self.graphs.captures() > before))
        return out

    def start(self, slot: int) -> None:
        """Delete the slot's session, if any, and start its next one."""
        old = self.live[slot]
        if old is not None:
            self.svc.delete(old.sid)
            old.sid = None
            self.ended.append(old)
        s = self.traffic.next_session(slot)
        with self.spans("start"):
            def start():
                s.sid = self.svc.create_session()
                self.svc.set_query(s.sid, s.query)
            self.call("start", 1, start)
        self.live[slot], self.pending[slot] = s, None

    def needs_start(self, slot: int) -> bool:
        return self.live[slot] is None or self.live[slot].done

    def absorbed(self, slot: int, reply: dict) -> bool:
        """Take a feedback reply: the answers count as absorbed where the
        service holds the labels expected."""
        s = self.live[slot]
        want = 1 + self.k * (len(s.answers) + 1)
        if "error" in reply or reply.get("labeled") != want:
            self.rec.log(f"turn failed: session {s.sid} replied {reply}, expected {want} labels")
            s.rounds = len(s.answers)  # the session ends here
            self.pending[slot] = None
            return False
        s.answers.append(self.pending[slot])
        self.pending[slot] = None
        return True

    def shown(self, slot: int, batch) -> bool:
        """Take a returned batch: the user answers it where it is whole."""
        s = self.live[slot]
        batch = [int(i) for i in batch]
        if len(batch) != self.k or len(set(batch)) != self.k:
            self.rec.log(f"turn failed: session {s.sid} returned {batch}")
            return False
        s.batches.append(batch)
        self.pending[slot] = self.traffic.answer(s, batch, self.user["label_prob"],
                                                 self.user["mistake_prob"])
        return True

    def feedback(self, slot: int) -> dict:
        """The slot's pending answers, as the service takes them."""
        s = self.live[slot]
        return {str(i): a for i, a in zip(s.batches[-1], self.pending[slot])}

    def turn(self) -> list:
        """One turn of every slot; the (ms, ok) of each user turn."""
        code = self.cell.code
        if hasattr(code, "turn"):
            return code.turn(self)
        return PATHS[self.traffic.params["path"]][0](self)


def cohort_turn(loop: Loop) -> list:
    """Session starts for the slots whose session ended, one
    ``feedback_many`` over the slots with answers, one ``next_batch_many``
    over all slots: one user turn a slot, all of one length."""
    slots = range(loop.traffic.slots)
    ok = [True] * len(slots)
    t0 = time.perf_counter()
    for slot in slots:
        if loop.needs_start(slot):
            loop.start(slot)
    answering = [slot for slot in slots if loop.pending[slot] is not None]
    if answering:
        fb = {loop.live[slot].sid: loop.feedback(slot) for slot in answering}
        with loop.spans("update"):
            replies = loop.call("feedback_many", len(fb), lambda: loop.svc.feedback_many(fb))
        for slot in answering:
            ok[slot] = loop.absorbed(slot, replies[loop.live[slot].sid])
    sids = [loop.live[slot].sid for slot in slots]
    with loop.spans("select"):
        out = loop.call("select_many", len(sids), lambda: loop.svc.next_batch_many(sids, loop.k))
    ms = (time.perf_counter() - t0) * 1e3
    for slot in slots:
        ok[slot] = loop.shown(slot, out[loop.live[slot].sid]) and ok[slot]
    return [(ms, good) for good in ok]


def single_turn(loop: Loop) -> list:
    """Each slot in turn: a session start or its ``feedback``, then its
    ``next_batch``."""
    turns = []
    for slot in range(loop.traffic.slots):
        good = True
        t0 = time.perf_counter()
        if loop.needs_start(slot):
            loop.start(slot)
        else:
            sid, fb = loop.live[slot].sid, loop.feedback(slot)
            with loop.spans("update"):
                reply = loop.call("feedback", 1, lambda: loop.svc.feedback(sid, fb))
            good = loop.absorbed(slot, reply)
        sid = loop.live[slot].sid
        with loop.spans("select"):
            batch = loop.call("select", 1, lambda: loop.svc.next_batch(sid, loop.k))
        ms = (time.perf_counter() - t0) * 1e3
        turns.append((ms, loop.shown(slot, batch) and good))
    return turns


def warm_sessions(svc, traffic) -> list:
    """One started session a slot, for a warm-up; their ids."""
    sids = []
    for q in traffic.warm_queries(traffic.slots):
        sid = svc.create_session()
        svc.set_query(sid, q)
        sids.append(sid)
    return sids


def cohort_warm_up(svc, traffic, cfg: dict) -> None:
    """Run once each program the cohort path uses: the selection of all
    slots, the update of each feedback width the mix produces within
    ``WIDTH_HORIZON`` turns, a session start."""
    k = int(cfg["selection"]["batch"])
    sids = warm_sessions(svc, traffic)
    batches = svc.next_batch_many(sids, k)
    for w in sorted(traffic.feedback_widths(WIDTH_HORIZON)):
        svc.feedback_many({sid: {str(i): 1 for i in batches[sid]} for sid in sids[:w]})
        batches = svc.next_batch_many(sids, k)
    for sid in sids:
        svc.delete(sid)


def single_warm_up(svc, traffic, cfg: dict) -> None:
    """Run once each program the single path uses: a session start, its
    selection and its update."""
    k = int(cfg["selection"]["batch"])
    sids = warm_sessions(svc, traffic)
    for sid in sids:
        svc.feedback(sid, {str(i): 1 for i in svc.next_batch(sid, k)})
        svc.next_batch(sid, k)
    for sid in sids:
        svc.delete(sid)


# The built-in paths a mix names by ``path``: (turn, warm-up).
PATHS = {"cohort": (cohort_turn, cohort_warm_up), "single": (single_turn, single_warm_up)}


def warm_up(cell: Cell, svc, traffic) -> None:
    """The mix's warm-up: its own ``warm_up`` where it has one, else its path's."""
    code = cell.code
    if hasattr(code, "warm_up"):
        code.warm_up(svc, traffic, cell.config)
    else:
        PATHS[traffic.params["path"]][1](svc, traffic, cell.config)


def _sample(sessions: list, count: int, seed: int) -> list:
    """``(idx, y, batch)`` of ``count`` served batches drawn from the seed,
    the ``count // 6`` served after the most labels among them."""
    served = [(s, j) for s in sessions for j in range(len(s.batches))]
    if not served:
        return []
    longest = sorted(range(len(served)), key=lambda i: -served[i][1])[:count // 6]
    taken = set(longest)
    rest = [i for i in range(len(served)) if i not in taken]
    rng = np.random.default_rng([seed % 2**64, 4])
    pick = longest + [int(i) for i in rng.permutation(rest)[:count - len(longest)]]
    return [(*served[i][0].labels(served[i][1]), served[i][0].batches[served[i][1]])
            for i in sorted(pick)]


def run(workload: str, seed: int, seconds: float, trace: bool, device_name: str,
        t_start: float, root: str = ROOT, keep: bool = False) -> dict:
    """One run of ``workload``; returns the result line's object (with the
    readings' inputs under ``"_kept"`` where ``keep``)."""
    import torch

    from benchmark import corpus, generator, reference
    from ital_tpu_torch import graphs
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.serve import RetrievalService

    cell = resolve(workload, root)
    cfg = cell.config
    dev = torch.device(device_name)
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state f32 products
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    c, gp, sel = cfg["corpus"], cfg["gp"], cfg["selection"]
    x, labels = corpus.surrogate(int(c["n"]), int(c["dim"]), int(c["topics"]), seed, dev,
                                 getattr(torch, c["dtype"]))
    traffic = generator.Traffic(cell.traffic, seed, labels.cpu().numpy(), int(c["topics"]))
    svc = RetrievalService(
        x, length_scale=gp["length_scale"], var=gp["var"], noise=gp["noise"], cap=gp["cap"],
        strategy=sel["strategy"], label_prob=cfg["user"]["label_prob"],
        mistake_prob=cfg["user"]["mistake_prob"], corpus_name=cfg["name"],
        method_kwargs={k: v for k, v in sel.items() if k not in ("strategy", "batch")},
        corpus_dtype="" if c["dtype"] == "float32" else c["dtype"], device=dev)
    warm_up(cell, svc, traffic)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    rec = RunRecord(cell=cell, device=dev)
    spans = Spans(torch, dev, trace)
    loop = Loop(svc, traffic, cell, spans, graphs, rec)
    stretches = None
    if trace and cuda:
        from benchmark.devtrace import Stretches
        stretches = Stretches(torch, lambda: rbf_hopper.LAUNCHES, lambda: len(rec.calls),
                              RBF_KERNELS, PROFILE_S, PROFILE_TURNS)
    base = {"captures": graphs.captures(), "rbf_launches": rbf_hopper.LAUNCHES}
    crashed = False
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    while True:
        try:
            turns = loop.turn()
        except Exception:
            rec.log("turn raised:\n" + traceback.format_exc())
            turns = [(math.inf, False)] * traffic.slots
            crashed = True
        for ms, good in turns:
            rec.attempted += 1
            rec.turn_ms.append(ms if good else math.inf)
            rec.failed += not good
            rec.batches += good
        if crashed or time.perf_counter() - t0 >= seconds:
            break
        if stretches is not None:
            stretches.step(t0 + PROFILE_AT * seconds, t0 + seconds)
            spans.timed = not stretches.on
    if cuda:
        torch.cuda.synchronize()
    rec.window_s = time.perf_counter() - t0
    if stretches is not None:
        stretches.close()
        rec.trace = stretches.summary
    rec.counters = {"captures": graphs.captures() - base["captures"],
                    "rbf_launches": rbf_hopper.LAUNCHES - base["rbf_launches"]}
    rec.spans = spans.ms
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    power = _power_limit() if cuda else None
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"], root)(rec)
        if value is None:
            rec.log(f"metric {m['name']}: nothing to read in this run")
        else:
            metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    # The program's outputs to judge; then its state is freed.
    sessions = loop.ended + [s for s in loop.live if s is not None]
    live = []
    for s in loop.live:
        if s is None or s.sid is None:
            continue
        st = svc._entry(s.sid)[0].state
        live.append((*s.labels(), st.mu.detach().cpu(), st.sig2.detach().cpu()))
    sampled = _sample(sessions, int(cell.traffic.get("check_batches", 48)), seed)
    for s in loop.live:
        if s is not None and s.sid is not None:
            svc.delete(s.sid)
    x_served = svc.x
    del svc, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = reference.readings(x_served, cfg, live, sampled,
                                  load_judge(sel["strategy"], root))
    limits = cfg["correct"]["limits"]
    compared = {"failed_turns": {"value": rec.failed, "limit": 0}}
    for name, value in readings.items():
        compared[name] = {"value": value, "limit": limits[name]}
    correct = (not crashed and all(v["value"] <= v["limit"] for v in compared.values())
               and bool(sampled))
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    if power:
        device["power_limit"] = power
    traced = bool(rec.trace and "busy_s" in rec.trace)
    if traced:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
    out = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if traced:
        out["breakdown"] = {"device_ops": rec.trace["ops"], "idle_gaps": rec.trace["gaps"]}
    if keep:
        out["_kept"] = {"x": x_served, "live": live, "sampled": sampled}
    out["compared"] = compared
    return out
