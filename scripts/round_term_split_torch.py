#!/usr/bin/env python3
"""The PyTorch port's per-term split of the production interactive round.

The port's counterpart of ``scripts/round_term_split.py``, with its terms,
scales, flags and record keys.  Each term is one program
(``ital_tpu_torch.graphs.run``: a captured CUDA graph on the card):

* ``update``: ``gp_update`` of a fresh b = 4 block (labels from the query
  class's relevance), on the same state at every call (nothing written
  back, as the reference re-passes one state);
* ``rank``: the top 4096 of the posterior mean (the pool's formation);
* ``ap``: the AP of the ranking over the whole corpus (an evaluation cost);
* ``select``: ``select_ital`` at the production configuration
  (``bench.select_kwargs()``: n_qmc 32, the top 64 re-scored at n_qmc 512,
  over the pool of 4096 of ``configs/mirflickr_production.ini``);
* ``round_full``: select, the simulated user's answers, update, AP;
* ``round_serve``: the same without AP.

Scales: ``scale_25k``, the reference's mid-session state
(``study_torch.mid_session_state``: ``bench.py``'s ``default_rng(7)`` query
and five rounds of four labels, cap 64, ls 50, var 1, noise 0.1) on the
MIRFLICKR surrogate; ``scale_1m``, ``corpus100k``'s generator at 1M x 512
(``scripts/scale1m_torch.py``'s: the query from ``default_rng(7)``, eight
warming labels), float32 or ``--corpus-dtype bfloat16``.  At 1M two chained
update loops follow, each from a fresh copy of the state, every update
consuming the last one's state: ``update_chain_copy``, the graphed update
as the sessions run it (``models.session.update_program``: the state copied
into the program's buffers and its writes copied back), and
``update_chain_donate``, the same update in place under ``graphs.eager()``
(the reference's donated carry).

Each term records ``first_call_s`` (the first call, the capture on the
card), ``graphed_ms`` and ``eager_ms`` (``study_torch.time_call``: CUDA
events around back-to-back calls, the median of three runs, graphed and
under ``graphs.eager()``; the reference's ``slope_ms`` was its TPU pipeline
slope), the RBF kernel's launches a graphed call, and whether one graphed
call's outputs equal an eager call's bit for bit.  The eager call of a term
that updates (``update``, ``round_full``, ``round_serve``) first copies the
session's buffers (``gp_session_copy``, so that the state stays as it was):
its ``eager_ms`` is that copy plus the term.  ``sequence`` holds
``round_full`` against ``select``, the user, ``update`` (written back) and
``ap`` run one after the other on a copy of the state.  A chain records its
slope between 4 and 12 chained updates (the least of three trials each) and
its first call.

Writes ``results/round_term_split_torch.json`` (``--out``; the 1M float32
record of the reference is ``round_term_split_r5.json``, its bfloat16 one
``round_term_split_r5_bf16.json``), with ``device`` and ``power_limit``.
Run from the repository root::

    python3 scripts/round_term_split_torch.py
    python3 scripts/round_term_split_torch.py --skip-25k --out results/round_term_split_r5_torch.json
    python3 scripts/round_term_split_torch.py --skip-25k --corpus-dtype bfloat16 \\
        --out results/round_term_split_r5_bf16_torch.json
    python3 scripts/round_term_split_torch.py --device cpu --n 1500 --n-1m 3000 --dim 64 --out x.json

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

# bench.py's BATCH, CAP and select_kwargs(), with the production pool.
BATCH, CAP, POOL = 4, 64, 4096
SELECT_KWARGS = {"n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512, "pool_size": POOL}
N_1M, DIM = 1_000_000, 512
WARM_1M = 8
TERMS = ("update", "rank", "ap", "select", "round_full", "round_serve")
UPDATING = ("update", "round_full", "round_serve")
CHAIN_REPS = (4, 12)
CHAIN_TRIALS = 3
BLOCKS = 64  # pre-drawn feedback blocks and user uniforms, used in turn


class Workload:
    """A state and what its terms read: the query class's relevance, the
    query's exclusion, the user, pre-drawn (BLOCKS, 4) feedback blocks with
    their labels and user uniforms, used one per call in turn."""

    def __init__(self, torch, dev, state, relevance, q: int, seed: int = 0):
        from ital_tpu_torch.select.base import StrategyParams

        self.state, self.dev = state, dev
        self.relevant = torch.as_tensor(relevance, device=dev)
        self.exclude = torch.zeros(state.x.shape[0], dtype=torch.bool, device=dev)
        self.exclude[q] = True
        self.params = StrategyParams.create(dev, label_prob=st.LABEL_PROB,
                                            mistake_prob=st.MISTAKE_PROB)
        g = torch.Generator(device="cpu").manual_seed(seed)
        n = state.x.shape[0]
        self.blocks = torch.randint(0, n, (BLOCKS, BATCH), generator=g).to(dev)
        self.labels = torch.where(self.relevant[self.blocks], 1.0, -1.0).to(state.y.dtype)
        self.valid = torch.ones(BATCH, dtype=torch.bool, device=dev)
        self.uniforms = torch.rand((BLOCKS, 2, BATCH), generator=g).to(dev)
        self.turn = 0

    def next(self) -> int:
        self.turn = (self.turn + 1) % BLOCKS
        return self.turn


def _state(x, inputs):
    from ital_tpu_torch.models.gp import program_state
    from ital_tpu_torch.select.base import StrategyParams

    return program_state(x, inputs), StrategyParams.from_inputs(inputs)


def _update_body(x, *, new_idx, new_y, new_valid, **inputs) -> tuple:
    from ital_tpu_torch.models.gp import gp_update

    state, _ = _state(x, inputs)
    return (gp_update(state, new_idx, new_y, new_valid).mu,)


def _rank_body(x, *, mu) -> tuple:
    from ital_tpu_torch.utils.metrics import top_k_stable

    return (top_k_stable(mu, POOL)[1],)


def _ap_body(x, *, mu, relevant, exclude) -> tuple:
    from ital_tpu_torch.utils.metrics import average_precision

    return (average_precision(mu, relevant, exclude),)


def _select_body(x, **inputs) -> tuple:
    from ital_tpu_torch.select.ital import select_ital

    state, params = _state(x, inputs)
    return (select_ital(state, BATCH, None, params, **SELECT_KWARGS),)


def _round_body(x, *, u_label, u_flip, relevant, exclude, with_ap: bool, **inputs) -> tuple:
    from ital_tpu_torch.data.user import feedback_from_uniforms
    from ital_tpu_torch.models.gp import gp_update
    from ital_tpu_torch.select.ital import select_ital
    from ital_tpu_torch.utils.metrics import average_precision

    state, params = _state(x, inputs)
    batch = select_ital(state, BATCH, None, params, **SELECT_KWARGS)
    y, valid = feedback_from_uniforms(u_label, u_flip, batch, relevant, params.label_prob,
                                      params.mistake_prob)
    state = gp_update(state, batch, y, valid)
    if with_ap:
        return batch, state.mu, average_precision(state.mu, relevant, exclude)
    return batch, state.mu


def _round_full(x, **kw) -> tuple:
    return _round_body(x, with_ap=True, **kw)


def _round_serve(x, **kw) -> tuple:
    return _round_body(x, with_ap=False, **kw)


BODIES = {"update": _update_body, "rank": _rank_body, "ap": _ap_body, "select": _select_body,
          "round_full": _round_full, "round_serve": _round_serve}


def term(w: Workload, name: str, state=None, *, turn: int | None = None,
         batch=None, write: bool = False) -> tuple:
    """One call of term ``name`` on ``state`` (the workload's by default) at
    pre-drawn ``turn`` (the next one by default): its program's outputs.
    ``update`` takes ``batch`` = ``(idx, y, valid)`` where given.  A term
    that updates writes the state back only when ``write``: a graph works on
    its own copy of the inputs, and an eager call (the CPU, or under
    ``graphs.eager()``) on a copy of the session's buffers made here."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.models.gp import SESSION_FIELDS, gp_session_copy, program_inputs

    state = w.state if state is None else state
    turn = w.next() if turn is None else turn
    if name in UPDATING and not write and not graphs._graphed(state.mu.device):
        state = gp_session_copy(state)
    inputs = ({"mu": state.mu} if name in ("rank", "ap") else
              {**program_inputs(state), **w.params.program_inputs()})
    if name == "update":
        idx, y, valid = batch or (w.blocks[turn], w.labels[turn], w.valid)
        inputs.update(new_idx=idx, new_y=y, new_valid=valid)
    if name in ("ap", "round_full", "round_serve"):
        inputs.update(relevant=w.relevant, exclude=w.exclude)
    if name.startswith("round"):
        inputs.update(u_label=w.uniforms[turn, 0], u_flip=w.uniforms[turn, 1])
    out = graphs.run(f"round_term_split_{name}", BODIES[name], inputs, shared={"x": state.x},
                     writes=SESSION_FIELDS if write else ())
    if write:
        state.count += BATCH
    return out


def _equal(torch, a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def measure_terms(torch, w: Workload, *, log=print, label: str = "",
                  target_s: float = 0.25, trials: int = 3) -> dict:
    """Each term of :data:`TERMS`: first call, graphed and eager ms, RBF
    launches a graphed call, and whether graphed outputs equal eager's."""
    from ital_tpu_torch import graphs

    out = {}
    for name in TERMS:
        r = st.time_call(torch, w.dev, lambda: term(w, name), target_s=target_s, trials=trials)
        graphed = term(w, name, turn=0)
        with graphs.eager():
            eager = term(w, name, turn=0)
        out[name] = {"first_call_s": round(r["first_call_s"], 4), "graphed_ms": r["ms_per_round"],
                     "eager_ms": r["eager_ms_per_round"], "graphed_ms_trials": r["ms_trials"],
                     "eager_ms_trials": r["eager_ms_trials"], "captures": r["captures"],
                     "rbf_launches_per_call": r["launches_per_call"],
                     "graphed_equals_eager": _equal(torch, graphed, eager)}
        log(f"   {label} {name}: {r['ms_per_round']:.4f} ms graphed, "
            f"{r['eager_ms_per_round']:.4f} eager (first {r['first_call_s']:.3f} s, "
            f"{r['launches_per_call']:g} RBF launches a call, graphed == eager "
            f"{out[name]['graphed_equals_eager']})")
    return out


def sequence(torch, w: Workload, turn: int = 0) -> dict:
    """``round_full`` at ``turn`` against its terms run one after the other
    on a copy of the state: ``select``, the user's answers, ``update``
    written back, then ``ap``.  The batch must be equal; ``mu_max_abs`` and
    ``ap_abs`` are the gaps of the posterior mean and the AP."""
    from ital_tpu_torch.data.user import feedback_from_uniforms
    from ital_tpu_torch.models.gp import gp_session_copy

    batch, mu, ap = term(w, "round_full", turn=turn)
    copy = gp_session_copy(w.state)
    (b2,) = term(w, "select", copy, turn=turn)
    y, valid = feedback_from_uniforms(w.uniforms[turn, 0], w.uniforms[turn, 1], b2, w.relevant,
                                      w.params.label_prob, w.params.mistake_prob)
    (mu2,) = term(w, "update", copy, turn=turn, batch=(b2, y, valid), write=True)
    (ap2,) = term(w, "ap", copy, turn=turn)
    return {"batch": batch.tolist(), "batch_equal": bool(torch.equal(batch, b2)),
            "mu_max_abs": float((mu - copy.mu).abs().max()),
            "mu_equal": bool(torch.equal(mu, mu2) and torch.equal(mu, copy.mu)),
            "ap_abs": float((ap - ap2).abs()), "ap": float(ap)}


def measure_chain(torch, w: Workload, *, donate: bool, log=print) -> dict:
    """The chained update loop from a fresh copy of the state per trial:
    the graphed update (``update_program``) or, ``donate``, the same in
    place under ``graphs.eager()``.  The slope between ``CHAIN_REPS`` chained
    updates (the least of ``CHAIN_TRIALS`` trials each) and the first call."""
    import contextlib

    from ital_tpu_torch import graphs
    from ital_tpu_torch.models.gp import gp_session_copy
    from ital_tpu_torch.models.session import update_program

    mode = graphs.eager if donate else contextlib.nullcontext

    def chain(reps: int) -> float:
        best = float("inf")
        for _ in range(CHAIN_TRIALS):
            s = gp_session_copy(w.state)
            start, end = st._events(torch, w.dev)
            st.sync(torch, w.dev)
            with mode():
                start.record()
                for r in range(reps):
                    update_program(s, w.blocks[r], w.labels[r], w.valid)
                end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    s = gp_session_copy(w.state)
    st.sync(torch, w.dev)
    t0 = time.perf_counter()
    with mode():
        update_program(s, w.blocks[0], w.labels[0], w.valid)
    st.sync(torch, w.dev)
    first = time.perf_counter() - t0
    lo, hi = (chain(r) for r in CHAIN_REPS)
    rec = {"first_call_s": round(first, 4), "slope_ms": (hi - lo) / (CHAIN_REPS[1] - CHAIN_REPS[0]),
           "ms_lo": lo, "ms_hi": hi, "reps": list(CHAIN_REPS)}
    log(f"   update_chain_{'donate' if donate else 'copy'}: {rec['slope_ms']:.4f} ms an update "
        f"(first {first:.3f} s)")
    return rec


def workload_25k(torch, dev, ds) -> Workload:
    """The reference's mid-session state (``bench.py``'s) on ``ds``, the
    MIRFLICKR surrogate (or a cut of ``corpus100k``, the CPU tests)."""
    rng = np.random.default_rng(7)
    q = int(rng.integers(0, ds.n))
    cls = int(np.argmax(ds.relevance[q])) if ds.relevance[q].any() else 0
    return Workload(torch, dev, st.mid_session_state(ds, dev), ds.relevance[:, cls], q)


def workload_1m(torch, dev, n: int = N_1M, dim: int = DIM,
                corpus_dtype: str | None = None, log=print) -> Workload:
    """``scripts/scale1m_torch.py``'s state: ``corpus100k`` at ``n`` x
    ``dim``, the query from ``default_rng(7)``, eight warming labels."""
    from ital_tpu_torch.data.datasets import corpus100k
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.models.session import update_program

    t0 = time.perf_counter()
    ds = corpus100k(n=n, dim=dim)
    rng = np.random.default_rng(7)
    q = int(rng.integers(0, ds.n))
    cls = int(ds.labels[q])
    state = gp_mod.gp_init(torch.from_numpy(ds.x).to(dev), st.LS, st.VAR, st.NOISE, CAP,
                           corpus_dtype=corpus_dtype)
    state = gp_mod.gp_set_query(state, q)
    warm = rng.permutation(ds.n)[:WARM_1M]
    ys = np.where(ds.relevance[warm, cls], 1.0, -1.0).astype(np.float32)
    state = update_program(state, torch.from_numpy(warm).to(dev), torch.from_numpy(ys).to(dev),
                           torch.ones(WARM_1M, dtype=torch.bool, device=dev))
    st.sync(torch, dev)
    log(f"   {n} x {dim} corpus resident ({corpus_dtype or 'float32'}), "
        f"{time.perf_counter() - t0:.1f} s")
    return Workload(torch, dev, state, ds.relevance[:, cls], q)


def split(torch, w: Workload, *, chains: bool, label: str, trials: int = 3,
          log=print) -> dict:
    """A scale's record: every term (``trials`` timed runs a mode), the
    sequence check and, with ``chains``, the two chained update loops."""
    rec = measure_terms(torch, w, log=log, label=label, trials=trials)
    rec["sequence"] = sequence(torch, w)
    log(f"   {label} round_full against its terms in sequence: {rec['sequence']}")
    if chains:
        rec["update_chain_donate"] = measure_chain(torch, w, donate=True, log=log)
        rec["update_chain_copy"] = measure_chain(torch, w, donate=False, log=log)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-1m", action="store_true")
    ap.add_argument("--skip-25k", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "round_term_split_torch.json"))
    ap.add_argument("--corpus-dtype", default="",
                    help="GP.corpus_dtype of the 1M workload (bfloat16); use a distinct --out")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=None,
                    help="cut the 25 000-row scale to corpus100k's n rows (the CPU tests)")
    ap.add_argument("--n-1m", type=int, default=N_1M, help="rows of the 1M scale")
    ap.add_argument("--dim", type=int, default=DIM, help="features of a cut corpus")
    ap.add_argument("--trials", type=int, default=3, help="timed runs a term and mode")
    args = ap.parse_args(argv)
    import torch

    from ital_tpu_torch import graphs

    dev = st.open_device(torch, args.device)
    st.record_path(args.out)
    log = lambda s: print(s, flush=True)  # noqa: E731
    report = {"platform": "gpu" if dev.type == "cuda" else "cpu", **st.card_fields(torch, dev),
              "protocol": "CUDA events around back-to-back calls (study_torch.time_call), "
                          "graphed and under graphs.eager(); first_call_s separate",
              "select_config": SELECT_KWARGS, "batch": BATCH, "cap": CAP}
    if args.corpus_dtype:
        report["corpus_dtype"] = args.corpus_dtype
    t0 = time.time()
    if not args.skip_25k:
        log("== 25k (the reference's mid-session state)")
        from ital_tpu_torch.data import datasets

        w = workload_25k(torch, dev, datasets.mirflickr() if args.n is None else
                         datasets.corpus100k(n=args.n, dim=args.dim, n_classes=14))
        report["scale_25k"] = split(torch, w, chains=False, label="25k", trials=args.trials,
                                    log=log)
        report["scale_25k"]["n"] = w.state.x.shape[0]
        del w
        st.write_record(args.out, report)
    if not args.skip_1m:
        log(f"== 1M x 512 ({args.corpus_dtype or 'float32'})")
        w = workload_1m(torch, dev, args.n_1m, args.dim, args.corpus_dtype or None, log=log)
        report["scale_1m"] = split(torch, w, chains=True, label="1M", trials=args.trials,
                                   log=log)
        report["scale_1m"]["n"] = w.state.x.shape[0]
    report["programs"] = [{"name": p.name, "launches_per_replay": sum(p.launches.values()),
                           "static_mib": p.static_bytes / 2**20,
                           "pool_growth_mib": p.pool_bytes / 2**20}
                          for p in graphs.programs() if p.name.startswith("round_term_split")]
    report["wall_s"] = round(time.time() - t0, 1)
    scales = [report[k] for k in ("scale_25k", "scale_1m") if k in report]
    report["graphed_equals_eager"] = all(r[t]["graphed_equals_eager"] for r in scales for t in TERMS)
    report["round_full_is_its_terms"] = all(r["sequence"]["batch_equal"] for r in scales)
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
