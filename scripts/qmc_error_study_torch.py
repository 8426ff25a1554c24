#!/usr/bin/env python3
"""The PyTorch port's fixed-lattice QMC error of the MI pipeline.

The port's counterpart of ``scripts/qmc_error_study.py``, with its problems,
settings and record keys: 16 posterior-shaped problems per m from
``np.random.default_rng(17)`` (this file's copy of the reference's
``random_problem``), m = 2..8, n_qmc 64, 128, 256 and 512, 8 shifts.  The
true values come from the NumPy/SciPy oracle
(``tests/oracle/numpy_oracle.py``: ``mvn_orthant`` through SciPy's Genz
MVNDST, and ``mutual_information``), computed in a pool of worker
processes; SciPy's MVNDST draws its own quasi-random points, so each
problem's draws are seeded (``np.random.seed``) from its m and index, and
the truth is the same at every run.  The estimators are the port's, on the
card in f32: ``ops.mvn.orthant_probs_all_configs_tree`` (the single-lattice
estimate), ``orthant_probs_with_error`` (the multi-shift mean and its
self-estimate), ``select.ital.mi_with_error`` and
``mutual_information_from_relevance`` (the production MI).

Held, on one truth: the reference's own estimators rerun on the CPU
(``scripts/jax_reference.py qmc``, ``results/qmc_error_reference_cpu_torch.json``,
``--reference``) against the same seeded truth, which the rerun stores and
this study reads.  Two conditions: the rerun's truth-free entries (the
self-estimates, ``TRUTH_FREE``) lie within ``RERUN_ATOL`` (1e-6) of the
reference record's (``results/qmc_error_study.json``) at every m and n_qmc,
so the rerun is the record's estimator; and every entry of the port's
``by_m`` lies within ``HELD_ATOL`` (1e-5) of the rerun's.  The record's own
truth was drawn unseeded and cannot be drawn again, so the gap to the record
(``largest_gap_by_m``) and the oracle's own spread (``oracle_spread_by_m``:
the largest move of an entry when the truth is drawn a second time) are
printed and do not decide.  The record also says whether ``mi_max_abs_err``
at m = 8, n_qmc 256 stays under 1 % of ``mi_scale`` (the record's ground for
``MAX_MI_BATCH = 8``).

Writes ``results/qmc_error_study_torch.json`` (``--out``).  Run from the
repository root::

    python3 scripts/qmc_error_study_torch.py

It needs a CUDA card unless ``--device cpu`` is given; ``--ms 2,3,4
--nqmcs 64 --problems 2`` are the CPU tests' sizes.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

MS = (2, 3, 4, 5, 6, 7, 8)
NQMCS = (64, 128, 256, 512)
N_PROBLEMS = 16
N_SHIFTS = 8
LABEL_PROB, MISTAKE_PROB = 0.8, 0.05
HELD_ATOL = 1e-5  # the port's entries against the rerun's, on one truth
RERUN_ATOL = 1e-6  # the rerun's truth-free entries against the record's
RECORD = os.path.join(REPO, "results", "qmc_error_study.json")
RERUN = os.path.join(REPO, "results", "qmc_error_reference_cpu_torch.json")
ORACLE = "tests/oracle/numpy_oracle.py, np.random.seed(1000 m + problem + 100000 draw)"


def random_problem(rng, m):
    """Posterior-shaped (mu, cov): correlated, variances ~U(0.2, 1), means
    within a couple of posterior stds of the decision boundary (the
    reference's generator, draw for draw)."""
    a = rng.normal(size=(m, m + 2)) / np.sqrt(m + 2)
    cov = a @ a.T
    d = np.sqrt(np.diag(cov))
    scale = rng.uniform(0.45, 1.0, size=m) / d
    cov = cov * np.outer(scale, scale) + 1e-6 * np.eye(m)
    mu = rng.normal(size=m) * 0.7
    return mu, cov


def problems(ms=MS, n_problems: int = N_PROBLEMS) -> dict:
    """``{m: [(mu, cov), ...]}`` for each m of ``ms``, drawn in the
    reference's order from one ``default_rng(17)``: all of one m, then the
    next, for every m from ``MS[0]`` up to ``max(ms)``, so that any subset
    of the m's gets the problems the whole study gives them."""
    rng = np.random.default_rng(17)
    every = {m: [random_problem(rng, m) for _ in range(n_problems)]
             for m in range(MS[0], max(ms) + 1)}
    return {m: every[m] for m in ms}


def _oracle():
    """``tests/oracle/numpy_oracle.py``, loaded from its file: a ``tests``
    package installed elsewhere would shadow this repository's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "numpy_oracle", os.path.join(REPO, "tests", "oracle", "numpy_oracle.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _truth(job):
    """One problem's normalized true orthant probabilities and true MI, the
    oracle's MVNDST draws seeded from ``seed``."""
    oracle = _oracle()
    mutual_information, mvn_orthant = oracle.mutual_information, oracle.mvn_orthant

    m, mu, cov, seed = job
    np.random.seed(seed)
    # The sign configurations in the port's sign_table order (-1 before +1).
    p = np.maximum([mvn_orthant(mu, cov, s) for s in itertools.product([-1.0, 1.0], repeat=m)],
                   0.0)
    return p / max(p.sum(), 1e-12), mutual_information(mu, cov, LABEL_PROB, MISTAKE_PROB)


def truths(probs: dict, workers: int, draw: int = 0) -> dict:
    """``{m: [(probs_true, mi_true), ...]}`` for every problem, the oracle's
    draws seeded ``1000 m + problem + 100000 draw``, in a pool of
    ``workers`` processes (1: in this process)."""
    jobs = [(m, mu, cov, 1000 * m + k + 100_000 * draw)
            for m, ps in probs.items() for k, (mu, cov) in enumerate(ps)]
    if workers > 1:
        import multiprocessing

        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_truth, jobs))
    else:
        done = [_truth(j) for j in jobs]
    out: dict = {}
    for (m, *_), r in zip(jobs, done):
        out.setdefault(m, []).append(r)
    return out


def stored_truth(rerun: dict, ms, n_problems: int) -> dict:
    """The first ``n_problems`` truths of each m that a rerun record stores,
    in :func:`truths`' layout."""
    return {m: [(np.asarray(p, np.float64), float(v)) for p, v in
                zip(rerun["truth"][str(m)]["probs"][:n_problems],
                    rerun["truth"][str(m)]["mi"][:n_problems])]
            for m in ms}


def held_on_one_truth(port: dict, rerun: dict, record: dict) -> dict:
    """The study's verdict: the rerun's truth-free entries within
    ``RERUN_ATOL`` of the record's, and the port's entries within
    ``HELD_ATOL`` of the rerun's (only the m and n_qmc both hold)."""
    free = gaps(rerun, record, TRUTH_FREE)
    port_gap = gaps(port, rerun)
    is_record = all(g is not None and g <= RERUN_ATOL for m, g in free.items() if m in port)
    within = all(g is not None and g <= HELD_ATOL for g in port_gap.values())
    return {"rerun_truth_free_gap_by_m": {m: free[m] for m in port if m in free},
            "rerun_is_the_records_estimator": is_record,
            "port_gap_to_rerun_by_m": port_gap, "held": is_record and within}


def estimates(torch, device, mu, cov, n_qmc: int, params, dtype=None) -> dict:
    """The port's four estimators of one problem on ``device`` (f32 unless
    ``dtype``), as float64 numpy: ``p1`` the single-lattice orthant vector,
    ``pm``/``pe`` the multi-shift mean and its self-estimate, ``mi1``/``mie``
    ``mi_with_error``'s, ``mi_single`` the production MI."""
    from ital_tpu_torch.ops.mvn import (
        orthant_probs_all_configs_tree,
        orthant_probs_with_error,
        small_cholesky,
    )
    from ital_tpu_torch.select.ital import (
        feedback_given_relevance,
        mi_with_error,
        mutual_information_from_relevance,
    )

    dtype = dtype or torch.float32
    m = len(mu)
    mut = torch.as_tensor(np.asarray(mu), dtype=dtype, device=device)
    chol = small_cholesky(torch.as_tensor(np.asarray(cov), dtype=dtype, device=device))
    p1 = orthant_probs_all_configs_tree(mut, chol, n_points=n_qmc)
    pm, pe = orthant_probs_with_error(mut, chol, n_points=n_qmc, n_shifts=N_SHIFTS)
    mi1, mie = mi_with_error(mut, chol, params, n_qmc=n_qmc, n_shifts=N_SHIFTS)
    mi_single = mutual_information_from_relevance(
        p1, feedback_given_relevance(m, params.label_prob, params.mistake_prob))
    host = lambda v: v.detach().cpu().double().numpy()  # noqa: E731
    return {"p1": host(p1), "pm": host(pm), "pe": host(pe), "mi1": float(mi1),
            "mie": float(mie), "mi_single": float(mi_single)}


def all_estimates(torch, device, probs: dict, nqmcs=NQMCS) -> dict:
    """``{(m, n_qmc): [estimates of each problem]}`` on ``device``."""
    from ital_tpu_torch.select.base import StrategyParams

    params = StrategyParams.create(device, label_prob=LABEL_PROB, mistake_prob=MISTAKE_PROB)
    return {(m, n_qmc): [estimates(torch, device, mu, cov, n_qmc, params) for mu, cov in ps]
            for m, ps in probs.items() for n_qmc in nqmcs}


def by_m(est: dict, truth: dict, log=None) -> dict:
    """The reference's ``by_m`` table of the port's estimates ``est``
    (:func:`all_estimates`) against ``truth``."""
    out: dict = {}
    r6 = lambda v: round(float(v), 6)  # noqa: E731
    for (m, n_qmc), e in est.items():
        row = out.setdefault(str(m), {"mi_scale": float(np.mean([mt for _, mt in truth[m]]))})
        pt = [p for p, _ in truth[m]]
        mt = [v for _, v in truth[m]]
        orth = [np.max(np.abs(x["p1"] - p)) for x, p in zip(e, pt)]
        mi = [abs(x["mi_single"] - v) for x, v in zip(e, mt)]
        row[str(n_qmc)] = {
            "orthant_max_abs_err": r6(np.max(orth)),
            "orthant_mean_abs_err": r6(np.mean(orth)),
            "orthant_multishift_max_err": r6(max(np.max(np.abs(x["pm"] - p))
                                                 for x, p in zip(e, pt))),
            "orthant_self_estimate_mean": r6(np.mean([np.max(x["pe"]) for x in e])),
            "mi_max_abs_err": r6(np.max(mi)),
            "mi_mean_abs_err": r6(np.mean(mi)),
            "mi_multishift_max_err": r6(max(abs(x["mi1"] - v) for x, v in zip(e, mt))),
            "mi_self_estimate_mean": r6(np.mean([x["mie"] for x in e])),
        }
        if log:
            r = row[str(n_qmc)]
            log(f"m={m} n_qmc={n_qmc}: MI err mean {r['mi_mean_abs_err']:.1e} max "
                f"{r['mi_max_abs_err']:.1e} (self-est {r['mi_self_estimate_mean']:.1e}; "
                f"MI scale {row['mi_scale']:.3f})")
    return out


# The entries that compare an estimate with the oracle's truth, whose
# MVNDST (abseps 1e-5 an orthant) moves them from one oracle draw to the next.
TRUTH_FREE = ("orthant_self_estimate_mean", "mi_self_estimate_mean")


def gaps(port: dict, other: dict, keys=None) -> dict:
    """``{m: largest |port - other|}`` over every entry both tables hold
    (only ``keys`` where given)."""
    out = {}
    for m, row in port.items():
        ref = other.get(m, {})
        diffs = [abs(row["mi_scale"] - ref["mi_scale"])] if "mi_scale" in ref and not keys else []
        for n_qmc, entry in row.items():
            if n_qmc != "mi_scale" and n_qmc in ref:
                diffs += [abs(v - ref[n_qmc][k]) for k, v in entry.items()
                          if keys is None or k in keys]
        out[m] = max(diffs) if diffs else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "results", "qmc_error_study_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--ms", default=",".join(map(str, MS)))
    ap.add_argument("--nqmcs", default=",".join(map(str, NQMCS)))
    ap.add_argument("--problems", type=int, default=N_PROBLEMS)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="processes computing the oracle's truth")
    ap.add_argument("--reference", default=RERUN,
                    help="the reference's CPU rerun (scripts/jax_reference.py qmc)")
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    st.record_path(args.out)
    log = lambda s: print(s, flush=True)  # noqa: E731
    t00 = time.time()
    with open(args.reference) as fh:
        rerun = json.load(fh)
    ms = tuple(int(v) for v in args.ms.split(","))
    probs = problems(ms, args.problems)
    missing = [m for m in ms if len(rerun["truth"].get(str(m), {}).get("mi", [])) < args.problems]
    if missing:
        sys.exit(f"--reference {args.reference}: fewer than {args.problems} problems at m = "
                 f"{missing}")
    truth = stored_truth(rerun, ms, args.problems)
    own, truth2 = (truths(probs, args.workers, draw) for draw in (0, 1))
    oracle_s = time.time() - t00
    log(f"oracle truth, two draws: {oracle_s:.1f} s in {args.workers} processes")
    est = all_estimates(torch, device, probs, tuple(int(v) for v in args.nqmcs.split(",")))
    report = {"n_problems": args.problems, "n_shifts": N_SHIFTS, "label_prob": LABEL_PROB,
              "mistake_prob": MISTAKE_PROB, "platform": "gpu" if device.type == "cuda" else "cpu",
              **st.card_fields(torch, device), "dtype": "float32", "oracle": ORACLE,
              "truth": os.path.basename(args.reference) + " (draw 0, stored by the rerun)",
              "by_m": by_m(est, truth, log=log)}
    # This host's SciPy against the rerun's: the same seeded draw, drawn here.
    report["truth_redrawn_here_max_abs"] = max(
        max(float(np.max(np.abs(a[0] - b[0]))), abs(a[1] - b[1]))
        for m in ms for a, b in zip(truth[m], own[m]))
    with open(RECORD) as fh:
        record = json.load(fh)["by_m"]
    report.update(held_on_one_truth(report["by_m"], rerun["by_m"], record))
    # Printed, not deciding: the record's unseeded truth, and how far a
    # second draw of the oracle moves each entry.
    report["largest_gap_by_m"] = gaps(report["by_m"], record)
    report["truth_free_gap_by_m"] = gaps(report["by_m"], record, TRUTH_FREE)
    report["oracle_spread_by_m"] = gaps(by_m(est, own), by_m(est, truth2))
    report["record_gap_note"] = (
        "largest_gap_by_m and oracle_spread_by_m do not decide: the record's truth was drawn "
        "unseeded, and a second seeded draw moves the same entries as far")
    for m, g in report["port_gap_to_rerun_by_m"].items():
        log(f"m={m}: |port - rerun| {g:.2e} on one truth (rerun's self-estimates against the "
            f"record {report['rerun_truth_free_gap_by_m'][m]:.2e}); |port - record| "
            f"{report['largest_gap_by_m'][m]:.2e} and the oracle's draw-to-draw "
            f"{report['oracle_spread_by_m'][m]:.2e}, which do not decide")
    report["held_atol"] = HELD_ATOL
    report["rerun_atol"] = RERUN_ATOL
    if "8" in report["by_m"] and "256" in report["by_m"]["8"]:
        row = report["by_m"]["8"]
        report["m8_n256_mi_err_under_1pct_of_scale"] = bool(
            row["256"]["mi_max_abs_err"] < 0.01 * row["mi_scale"])
    report["oracle_s"] = round(oracle_s, 1)
    report["wall_s"] = round(time.time() - t00, 1)
    print("held" if report["held"] else "not held", flush=True)
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
