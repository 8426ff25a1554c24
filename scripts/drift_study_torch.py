#!/usr/bin/env python3
"""Long-horizon f32 drift of the PyTorch port's incremental Cholesky append.

The port's counterpart of ``scripts/drift_study.py``, with its protocol: one
session on the MIRFLICKR-scale surrogate (25 000 x 512), cap 1024, batch 4,
``--rounds`` (250) rounds of uncertainty sampling and a noiseless user
(``--noisy``: label_prob 0.8, mistake_prob 0.05), ls 50, var 1, noise 0.1,
the query drawn from ``default_rng(--seed)``.  Each round runs the port's
selection and update programs (``select.base.get_strategy`` and
``models.session.update_program``: CUDA graphs on the card).  Every
``--every`` (20) rounds and at the last, from the same label buffers:

* ``inc``: the incrementally appended posterior (the production path);
* ``refit``: ``gp_fit`` from scratch in f32;
* ``oracle``: a dense f64 NumPy/SciPy posterior (this file's copy of the
  reference's ``oracle_posterior``);

and records the reference's row keys: ``||mu_inc - mu_oracle||_inf``, the
same for ``sig2`` and for the refit, ``||mu_inc - mu_refit||_inf``, the AP
each mean induces and the share of the oracle's top 100 unlabeled items
that each f32 ranking reproduces.  ``--matmul-precision`` goes through
``utils/config.py::apply_matmul_precision`` (PyTorch's TF32 switches; the
RBF kernel runs 3xTF32 on the card whatever they say).

Writes ``results/drift_study[_noisy][_<precision>]_torch.json`` (``--out``
overrides it), the reference's keys plus ``device``, ``power_limit`` and
the labeled indices.  ``--n`` and ``--cap`` cut the corpus and the buffers
for the CPU tests and the card smoke.  Run from the repository root::

    python3 scripts/drift_study_torch.py [--noisy]
    python3 scripts/drift_study_torch.py --device cpu --n 2000 --rounds 12 --every 4 --out x.json

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from study_torch import card_fields, open_device, record_path, write_record  # noqa: E402

BATCH = 4
CAP = 1024
N, DIM, N_CLASSES = 25_000, 512, 14  # the mirflickr surrogate's shape
LS, VAR, NOISE = 50.0, 1.0, 0.1


def oracle_posterior(x64, idx, y, valid, count, block=4096):
    """Dense f64 posterior (mu, sig2) from the padded label buffers: the
    reference's ``oracle_posterior`` (inert slots absent, dense LAPACK
    solves, never more than (active, block) of the cross kernel)."""
    from scipy.linalg import cho_factor, cho_solve, solve_triangular

    act = (np.arange(idx.shape[0]) < count) & valid
    li = idx[act]
    xl = x64[li]
    yl = y[act].astype(np.float64)

    def rbf(a, b):
        d2 = (
            np.sum(a * a, axis=1)[:, None]
            + np.sum(b * b, axis=1)[None, :]
            - 2.0 * a @ b.T
        )
        return VAR * np.exp(-np.maximum(d2, 0.0) / (2.0 * LS * LS))

    k_ll = rbf(xl, xl) + NOISE * np.eye(xl.shape[0])
    cho = cho_factor(k_ll, lower=True)
    alpha = cho_solve(cho, yl)
    n = x64.shape[0]
    mu = np.empty(n)
    sig2 = np.empty(n)
    for s in range(0, n, block):
        kb = rbf(xl, x64[s : s + block])  # (active, nb)
        mu[s : s + block] = kb.T @ alpha
        v = solve_triangular(cho[0], kb, lower=True)
        sig2[s : s + block] = VAR - np.sum(v * v, axis=0)
    return mu, np.maximum(sig2, 0.0)


def corpus(n: int = N):
    """The mirflickr surrogate (``n`` rows of its generator)."""
    from ital_tpu_torch.data import datasets

    return datasets.mirflickr() if n == N else datasets._synthetic_surrogate(
        "mirflickr", n, DIM, N_CLASSES)


def run(*, device, rounds: int = 250, every: int = 20, seed: int = 0, noisy: bool = False,
        n: int = N, cap: int = CAP, matmul_precision: str = "", data=None,
        log=print) -> dict:
    """The study's record (rows every ``every`` rounds and at the last)."""
    import torch

    from ital_tpu_torch.data.user import feedback_from_uniforms
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.models.session import update_program
    from ital_tpu_torch.select.base import StrategyParams, get_strategy
    from ital_tpu_torch.utils.config import ExperimentConfig, GPConfig, apply_matmul_precision
    from ital_tpu_torch.utils.metrics import average_precision

    assert 1 + rounds * BATCH <= cap, "cap cannot hold the session"
    apply_matmul_precision(ExperimentConfig(gp=GPConfig(matmul_precision=matmul_precision)))
    ds = data if data is not None else corpus(n)
    x64 = np.asarray(ds.x, np.float64)
    rng = np.random.default_rng(seed)
    q = int(rng.integers(0, ds.n))
    cls = int(np.argmax(ds.relevance[q])) if ds.relevance[q].any() else 0
    relevant = torch.from_numpy(ds.relevance[:, cls]).to(device)
    exclude = torch.zeros(ds.n, dtype=torch.bool, device=device)
    exclude[q] = True

    state = gp_mod.gp_set_query(
        gp_mod.gp_init(torch.from_numpy(ds.x).to(device), LS, VAR, NOISE, cap), q)
    lp, mp = (0.8, 0.05) if noisy else (1.0, 0.0)
    params = StrategyParams.create(device, label_prob=lp, mistake_prob=mp)
    select = get_strategy("uncertainty_sampling")
    sel_gen = torch.Generator(device=device).manual_seed(seed)
    user = torch.Generator().manual_seed(seed)

    def ap(mu):
        return float(average_precision(torch.from_numpy(mu.astype(np.float32)).to(device),
                                       relevant, exclude))

    rows = []
    t0 = time.time()
    for rnd in range(1, rounds + 1):
        batch = select(state, BATCH, sel_gen, params)
        u = torch.rand(2, BATCH, generator=user).to(device)
        yb, valid = feedback_from_uniforms(u[0], u[1], batch, relevant, lp, mp)
        state = update_program(state, batch, yb, valid)
        if rnd % every and rnd != rounds:
            continue
        idx = state.idx.cpu().numpy()
        yv = state.y.cpu().numpy()
        valid_b = state.valid.cpu().numpy()
        count = int(state.count)
        mu_inc = state.mu.double().cpu().numpy()
        s2_inc = state.sig2.double().cpu().numpy()
        st_re = gp_mod.gp_fit(dataclasses.replace(state))
        mu_re = st_re.mu.double().cpu().numpy()
        s2_re = st_re.sig2.double().cpu().numpy()
        mu_or, s2_or = oracle_posterior(x64, idx, yv, valid_b, count)

        labeled_rows = np.zeros(ds.n, bool)
        labeled_rows[idx[(np.arange(cap) < count) & valid_b]] = True

        def top100(mu):
            m = np.where(labeled_rows, -np.inf, mu)
            return set(np.argsort(-m)[:100].tolist())

        t_or = top100(mu_or)
        row = {
            "top100_overlap_inc": len(top100(mu_inc) & t_or) / 100.0,
            "top100_overlap_refit": len(top100(mu_re) & t_or) / 100.0,
            "round": rnd,
            "labeled": count,
            "mu_inf_inc": float(np.max(np.abs(mu_inc - mu_or))),
            "mu_inf_refit": float(np.max(np.abs(mu_re - mu_or))),
            "sig2_inf_inc": float(np.max(np.abs(s2_inc - s2_or))),
            "sig2_inf_refit": float(np.max(np.abs(s2_re - s2_or))),
            "mu_inf_inc_vs_refit": float(np.max(np.abs(mu_inc - mu_re))),
            "ap_inc": ap(mu_inc),
            "ap_refit": ap(mu_re),
            "ap_oracle": ap(mu_or),
        }
        rows.append(row)
        log(f"round {rnd:4d} labeled {count:4d}  |dmu|inf inc {row['mu_inf_inc']:.2e} refit "
            f"{row['mu_inf_refit']:.2e}  top100 inc {row['top100_overlap_inc']:.2f}  ap d "
            f"{row['ap_inc'] - row['ap_oracle']:+.2e}")

    return {
        "corpus": ds.name, "n": ds.n, "dim": int(ds.x.shape[1]),
        "cap": cap, "batch": BATCH, "rounds": rounds,
        "seed": seed, "strategy": "uncertainty_sampling",
        "user": {"label_prob": lp, "mistake_prob": mp},
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "matmul_precision": matmul_precision or "backend default",
        "hyper": {"length_scale": LS, "var": VAR, "noise": NOISE},
        "wall_s": round(time.time() - t0, 1),
        "rows": rows,
        "labeled_idx": state.idx[:int(state.count)].cpu().tolist(),
        **card_fields(torch, device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=250)
    ap.add_argument("--every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noisy", action="store_true",
                    help="lp=0.8/mp=0.05 user (AP stays un-saturated)")
    ap.add_argument("--matmul-precision", default="",
                    choices=("", "default", "high", "highest"),
                    help="GP.matmul_precision (PyTorch's TF32 switches); suffixes the output file")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=N, help=f"corpus rows (default {N})")
    ap.add_argument("--cap", type=int, default=CAP, help=f"label buffer slots (default {CAP})")
    ap.add_argument("--out", default=None, help="output path")
    args = ap.parse_args(argv)

    import torch

    device = open_device(torch, args.device)
    name = "drift_study_noisy" if args.noisy else "drift_study"
    if args.matmul_precision:
        name += f"_{args.matmul_precision}"
    out = record_path(args.out or os.path.join(REPO, "results", name + "_torch.json"))
    record = run(device=device, rounds=args.rounds, every=args.every, seed=args.seed,
                 noisy=args.noisy, n=args.n, cap=args.cap,
                 matmul_precision=args.matmul_precision, log=lambda s: print(s, flush=True))
    write_record(out, record)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
