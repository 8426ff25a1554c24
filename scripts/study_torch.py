"""Helpers shared by the port's study scripts (``scripts/*_torch.py``).

* :func:`parse_seeds`: ``"0,1,2"`` or ``"0-15"`` (or a mix) as a list;
* :func:`open_device`: the torch device a script runs on, refusing
  ``cuda`` without a card (``--device cpu`` runs the CPU tests' sizes);
* :func:`record_path`: an output path, refusing any that would overwrite a
  reference record (a file under ``results/`` whose name lacks ``_torch``);
* :func:`card_fields`: the ``device`` and ``power_limit`` keys of a record;
* :func:`mid_session_state`: the reference's timing workload, a GP fitted
  on a query and five rounds of four labels from ``default_rng(7)``;
* :func:`time_call`, :func:`time_selects`: a call's first-call seconds and
  its per-call ms, graphed and under ``graphs.eager()``, by CUDA events;
* :func:`pipeline_ms`, :func:`pipeline_slope`, :func:`event_ms`, :func:`sync_ms`,
  :func:`device_profile`: the reference's timing-corroboration protocol
  measured the card's way (back-to-back calls between one pair of CUDA
  events, an event pair around each call, a host clock around a
  synchronized call, and ``torch.profiler``'s device time and op count);
* :func:`user_draws`, :func:`draws_for`: the reference's user draws from a file
  (``scripts/jax_reference.py draws``), fed through the runner's
  ``round_draws`` inside a ``with`` block, for the sessions
  :func:`sessions_needed` lists;
* :func:`regression_user_draws`: the same for the regression runner
  (``runner.regression_draws``: label uniforms and N(0, 1) errors);
* :func:`map_runs`: the MAP half of the reference's selection studies, and
  :func:`paired`, their paired-delta summary of two configurations;
* :func:`scale_datasets`, :func:`load_record`: the timing scales' corpora
  and a port record to add sections to.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from scale1m_torch import card_fields  # noqa: E402,F401


def parse_seeds(text: str) -> list[int]:
    """Comma-separated seeds, each a number or an inclusive range ``a-b``."""
    seeds = []
    for part in (p.strip() for p in text.split(",") if p.strip()):
        lo, _, hi = part.partition("-")
        seeds += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return seeds


def open_device(torch, name: str):
    """``torch.device(name)``; exits non-zero for a CUDA device when none is
    available, and never falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {name}: no CUDA device is available "
                 f"(--device cpu runs the CPU tests' sizes)")
    return device


def record_path(path: str) -> str:
    """``path`` if writing there overwrites no reference record; exits
    non-zero otherwise.  A reference record is an existing file whose name
    lacks ``_torch``: the port's records all carry it."""
    if os.path.exists(path) and "_torch" not in os.path.basename(path):
        sys.exit(f"refusing to overwrite {path}: it is not a record of the port "
                 f"(its name lacks _torch)")
    return path


def write_record(path: str, record: dict) -> None:
    """``record`` as indented JSON at ``path`` (:func:`record_path` checked)."""
    record_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"wrote {path}", flush=True)


# The reference's timing workload (scripts/pool_sweep.py::_mid_session_state,
# bench.py::_labeled_history): cap 64, batch 4, five rounds of labels.
BATCH, CAP, HISTORY_ROUNDS = 4, 64, 5
LS, VAR, NOISE = 50.0, 1.0, 0.1
LABEL_PROB, MISTAKE_PROB = 0.8, 0.05


def mid_session_state(ds, device, ls: float = LS, var: float = VAR, noise: float = NOISE):
    """The reference studies' mid-session state on ``device``: the query
    drawn from ``default_rng(7)``, then the first 20 rows of a permutation
    from the same generator, each labeled +1 where relevant to the query's
    class (-1 elsewhere), fitted from scratch at cap 64."""
    import torch

    from ital_tpu_torch.models import gp as gp_mod

    rng = np.random.default_rng(7)
    q = int(rng.integers(0, ds.n))
    cls = int(np.argmax(ds.relevance[q])) if ds.relevance[q].any() else 0
    idx = [q] + [int(i) for i in rng.permutation(ds.n)[: HISTORY_ROUNDS * BATCH]]
    ys = [1.0] + [1.0 if ds.relevance[i, cls] else -1.0 for i in idx[1:]]
    state = gp_mod.gp_init(torch.from_numpy(ds.x).to(device), ls, var, noise, CAP)
    k = len(idx)
    state.idx[:k] = torch.tensor(idx, dtype=torch.int64, device=device)
    state.y[:k] = torch.tensor(ys, dtype=state.y.dtype, device=device)
    state.valid[:k] = True
    state.count = k
    return gp_mod.gp_fit(state)


def time_call(torch, device, call, *, target_s: float = 0.25, trials: int = 3) -> dict:
    """What ``call()`` costs, graphed and under ``graphs.eager()``.

    ``first_call_s``: the first call alone, host clock, synchronized (on the
    card the program's capture when this process has not captured it yet;
    ``captures`` says how many it made).  Then for each mode a warm-up call,
    and ``trials`` runs of N calls back to back, each run timed by CUDA
    events (a host clock around a synchronization on the CPU), N chosen so a
    run takes about ``target_s`` (1 to 50).  ``ms_per_round`` and
    ``eager_ms_per_round`` are the medians of the runs' ms per call;
    ``ms_trials`` and ``eager_ms_trials`` the runs'; ``launches_per_call``
    the RBF kernel launches a graphed call counts (0 on the CPU).
    """
    from ital_tpu_torch import graphs
    from ital_tpu_torch.ops import rbf_hopper

    def run_ms(n: int) -> float:
        return pipeline_ms(torch, device, call, n, trials=1) / n

    captures = graphs.captures()
    sync(torch, device)
    t0 = time.perf_counter()
    call()
    sync(torch, device)
    out = {"first_call_s": time.perf_counter() - t0, "captures": graphs.captures() - captures}
    for key, mode in (("", contextlib.nullcontext), ("eager_", graphs.eager)):
        with mode():
            n = max(1, min(50, round(target_s * 1e3 / max(run_ms(1), 1e-3))))
            launches = rbf_hopper.LAUNCHES
            runs = [run_ms(n) for _ in range(trials)]
        out.update({f"{key}ms_per_round": statistics.median(runs), f"{key}ms_trials": runs,
                    f"{key}calls_per_trial": n})
        if not key:
            out["launches_per_call"] = (rbf_hopper.LAUNCHES - launches) / (n * trials)
    return out


def time_selects(torch, device, state, rows, *, log=print, label: str = "",
                 target_s: float = 0.25) -> dict:
    """``{tag: time_call(...)}`` of the ITAL selection ``select_ital(state,
    batch_size, None, params, **kwargs)`` for each ``(tag, kwargs)`` of
    ``rows`` (``kwargs`` may name ``batch_size``, default 4), at the
    reference's user (label_prob 0.8, mistake_prob 0.05)."""
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import select_ital

    params = StrategyParams.create(device, label_prob=LABEL_PROB, mistake_prob=MISTAKE_PROB)
    out = {}
    for tag, kwargs in rows:
        kw = dict(kwargs)
        m = kw.pop("batch_size", BATCH)
        out[tag] = time_call(torch, device, lambda: select_ital(state, m, None, params, **kw),
                             target_s=target_s)
        r = out[tag]
        log(f"  {label} {tag:>24}: {r['ms_per_round']:.3f} ms/round graphed, "
            f"{r['eager_ms_per_round']:.3f} eager (first call {r['first_call_s']:.2f} s, "
            f"{r['launches_per_call']:g} launches a call)")
    return out


class _HostEvent:
    """A host-clock stand-in for a CUDA event off the card (the CPU tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _events(torch, device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    return _HostEvent(), _HostEvent()


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pipeline_ms(torch, device, call, reps: int, trials: int = 3) -> float:
    """The least total ms of ``reps`` back-to-back calls over ``trials``,
    each run between one pair of CUDA events (the reference's pipeline
    protocol, whose total held one host fetch; a host clock off the card)."""
    best = float("inf")
    for _ in range(trials):
        sync(torch, device)
        start, end = _events(torch, device)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def pipeline_slope(torch, device, call, reps: tuple = (8, 32)) -> tuple:
    """``(lo, hi, slope)``: :func:`pipeline_ms` of ``reps[0]`` and
    ``reps[1]`` calls, and the ms a call between them (the reference's
    RTT-cancelling slope)."""
    lo, hi = (pipeline_ms(torch, device, call, r) for r in reps)
    return lo, hi, (hi - lo) / (reps[1] - reps[0])


def event_ms(torch, device, call, calls: int = 10) -> list:
    """Each of ``calls`` back-to-back calls' ms between two CUDA events
    around it (a host clock off the card)."""
    sync(torch, device)
    pairs = []
    for _ in range(calls):
        start, end = _events(torch, device)
        start.record()
        call()
        end.record()
        pairs.append((start, end))
    sync(torch, device)
    return [s.elapsed_time(e) for s, e in pairs]


def sync_ms(torch, device, call, calls: int = 5) -> list:
    """Each of ``calls`` calls' host ms with a synchronization after it."""
    out = []
    for _ in range(calls):
        sync(torch, device)
        t0 = time.perf_counter()
        call()
        sync(torch, device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_profile(torch, device, call, calls: int = 1) -> dict:
    """``torch.profiler`` over ``calls`` synchronized calls on the card: the
    device's busy share (kernel and copy time over the host's wall time;
    None where the profiler saw no device time), the device ms and the
    device operations a call.  Off the card every value is None (not
    measured)."""
    if device.type != "cuda":
        return {"busy_share": None, "device_ms_per_call": None, "wall_ms_per_call": None,
                "ops_per_call": None}
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0.0) or e.device_time_total for e in events)
    return {"busy_share": busy / wall_us if busy > 0 else None,
            "device_ms_per_call": busy / 1e3 / calls, "wall_ms_per_call": wall_us / 1e3 / calls,
            "ops_per_call": sum(e.count for e in events) / calls}


def load_user_draws(path: str) -> dict:
    """``{(seed, rep, cls, query): (u_label, u_flip)}``, each (n_rounds,
    batch_size) float32, from a file of ``scripts/jax_reference.py draws``."""
    with np.load(path) as f:
        return {tuple(int(v) for v in s): (lab, flip)
                for s, lab, flip in zip(f["sessions"], f["u_label"], f["u_flip"])}


@contextlib.contextmanager
def user_draws(path: str, needed):
    """Inside the block the runner's simulated users draw the file's
    uniforms (:func:`load_user_draws`); the strategies keep the port's own
    generators.  ``needed``: ``(seed, rep, cls, query, n_rounds,
    batch_size)`` of every session the block runs; exits non-zero, before
    anything runs, when the file lacks one of them or holds fewer rounds or
    a narrower batch."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.ops.chol import host_copy

    table = load_user_draws(path)
    for seed, rep, cls, query, n_rounds, batch_size in needed:
        got = table.get((seed, rep, cls, query))
        if got is None or got[0].shape[0] < n_rounds or got[0].shape[1] < batch_size:
            sys.exit(f"--user-draws {path}: no draws for session seed={seed} rep={rep} "
                     f"cls={cls} query={query} ({n_rounds} rounds x {batch_size})")
    own = runner.round_draws

    def fed(seed, rep, cls, query, rnd, batch_size, device):
        generator, _, _ = own(seed, rep, cls, query, rnd, batch_size, device)
        lab, flip = table[(seed, rep, cls, query)]
        u = host_copy(np.stack([lab[rnd, :batch_size], flip[rnd, :batch_size]]), device)
        return generator, u[0], u[1]

    runner.round_draws = fed
    try:
        yield
    finally:
        runner.round_draws = own


@contextlib.contextmanager
def regression_user_draws(path: str, needed):
    """Inside the block the regression runner's simulated user draws the
    file's label uniforms and N(0, 1) errors (``scripts/jax_reference.py
    draws --task regression``); the strategy keeps the port's own
    generator.  ``needed``: ``(seed, rep, n_rounds, batch_size)`` of every
    run the block makes; exits non-zero, before anything runs, when the
    file lacks one of them."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.ops.chol import host_copy

    with np.load(path) as f:
        table = {tuple(int(v) for v in s): (lab, eps)
                 for s, lab, eps in zip(f["sessions"], f["u_label"], f["eps"])}
    for seed, rep, n_rounds, batch_size in needed:
        got = table.get((seed, rep))
        if got is None or got[0].shape[0] < n_rounds or got[0].shape[1] < batch_size:
            sys.exit(f"--user-draws {path}: no draws for seed={seed} rep={rep} "
                     f"({n_rounds} rounds x {batch_size})")
    own = runner.regression_draws

    def fed(seed, rep, rnd, batch_size, device):
        generator, _, _ = own(seed, rep, rnd, batch_size, device)
        lab, eps = table[(seed, rep)]
        u = host_copy(np.stack([lab[rnd, :batch_size], eps[rnd, :batch_size]]), device)
        return generator, u[0], u[1]

    runner.regression_draws = fed
    try:
        yield
    finally:
        runner.regression_draws = own


def sessions_needed(cfg_for_seed, seeds, data) -> list:
    """``(seed, rep, cls, query, n_rounds, batch_size)`` of every session the
    runs at ``seeds`` make, ``cfg_for_seed(seed)`` giving each run's config."""
    from ital_tpu_torch.runner import _session_plan

    out = []
    for seed in seeds:
        cfg = cfg_for_seed(seed)
        out += [(seed, rep, c, q, cfg.n_rounds, cfg.batch_size)
                for rep, c, q in _session_plan(cfg, data)]
    return out


def draws_for(path: str | None, ini: str, seeds, data):
    """:func:`user_draws` of ``path`` for the runs of config file ``ini`` at
    ``seeds`` over ``data``; a null context when ``path`` is None."""
    if not path:
        return contextlib.nullcontext()
    from ital_tpu_torch.utils.config import load_config

    return user_draws(path, sessions_needed(
        lambda s: load_config(ini, (f"EXPERIMENT.seed={s}",)), seeds, data))


def paired(ref_finals, new_finals) -> dict:
    """The reference studies' ``paired`` entry: new - ref per seed, its mean,
    the wins of new and the one-sample t statistic (0 when undefined)."""
    d = np.asarray(new_finals, np.float64) - np.asarray(ref_finals, np.float64)
    n = len(d)
    sd = d.std(ddof=1) if n > 1 else 0.0
    t = float(d.mean() / (sd / np.sqrt(n))) if n > 1 and sd > 0 else 0.0
    return {"delta_mean": round(float(d.mean()), 4),
            "delta_by_seed": [round(float(v), 4) for v in d],
            "wins": int((d > 0).sum()), "t_stat": round(t, 2)}


MIRFLICKR = os.path.join(REPO, "configs", "mirflickr.ini")
HEAVY = (0.6, 0.15)  # label_prob, mistake_prob of the reference's heavy noise
STANDARD = (LABEL_PROB, MISTAKE_PROB)


def map_runs(configs, seeds, *, heavy: bool, device, data, card: dict,
             draws_path: str | None = None, picks: dict | None = None, log=print) -> dict:
    """The MAP half of the reference's selection studies: for each ``(tag,
    METHOD overrides)`` of ``configs``, ITAL on the MIRFLICKR scenario
    (``configs/mirflickr.ini``: 14 topic sessions, fused cohorts of 7) at
    each seed, the reference's user at standard or ``heavy`` noise.  Each
    entry has the reference's keys plus ``map_by_seed`` and the run's
    device.  ``draws_path``: the reference's user draws
    (:func:`user_draws`); ``picks``: filled with each run's picks,
    ``picks[tag][seed]`` (sessions, rounds, batch)."""
    from method_comparison_torch import run_one

    lp, mp = HEAVY if heavy else STANDARD
    record = {}
    with draws_for(draws_path, MIRFLICKR, seeds, data):
        for tag, overrides in configs:
            curves, walls = [], []
            for seed in seeds:
                res, wall = run_one("ital", lp, mp, seed, None, method_overrides=tuple(overrides),
                                    device=device, data=data)
                curves.append([round(float(v), 4) for v in res["map"]])
                walls.append(round(wall, 1))
                if picks is not None:
                    picks.setdefault(tag, {})[str(seed)] = np.asarray(res["picks"]).tolist()
                log(f"  {tag} seed={seed}: final {curves[-1][-1]:.4f} ({walls[-1]}s)")
            arr = np.asarray(curves)
            record[tag] = {
                "map": [round(float(v), 4) for v in arr.mean(axis=0)],
                "map_std": [round(float(v), 4) for v in arr.std(axis=0)],
                "map_by_seed": {str(s): c for s, c in zip(seeds, curves)},
                "final_map_by_seed": [c[-1] for c in curves],
                "seeds": list(seeds),
                "sessions": len(res["sessions"]),
                "wall_s_per_seed": walls,
                "mode": "cohort-fused (query_batch=7)",
                "user": f"label_prob={lp}, mistake_prob={mp}",
                "user_draws": os.path.basename(draws_path) if draws_path else None,
                "platform": "gpu" if device.type == "cuda" else "cpu",
                **card,
            }
    return record


def load_record(path: str) -> dict:
    """The port's record at ``path`` to add sections to ({} when absent)."""
    record_path(path)
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


def scale_datasets(skip_100k: bool, *, n_25k: int | None = None, n_100k: int | None = None,
                   dim: int | None = None):
    """``(name, dataset)`` of the reference's timing scales: the MIRFLICKR
    surrogate (``mirflickr25k``) and, unless ``skip_100k``, ``corpus100k``
    at 100 000 x 512.  ``n_25k``, ``n_100k`` and ``dim`` cut them (the CPU
    tests' sizes) through the same generator."""
    from ital_tpu_torch.data import datasets

    yield "mirflickr25k", (datasets.mirflickr() if n_25k is None else
                           datasets.corpus100k(n=n_25k, dim=dim or 512, n_classes=14))
    if not skip_100k:
        yield "corpus100k", datasets.corpus100k(n=n_100k or 100_000, dim=dim or 512)
