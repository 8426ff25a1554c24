#!/usr/bin/env python3
"""The PyTorch port's method comparison under label noise.

The port's counterpart of ``scripts/method_comparison.py``, with its
workload, flags and report keys: ITAL against uncertainty sampling and
random (``--methods``) on the MIRFLICKR corpus (the 25 000 x 512 surrogate)
or scikit-learn's digits (``--dataset digits``), a noisy user, every query
session of ``configs/<dataset>.ini`` per method, run through
``ital_tpu_torch.runner.run_experiment`` in cohort-fused mode
(``EXPERIMENT.fused_sessions=true``, cohorts of ``--query-batch``: 7 for
mirflickr's 14 topics, 5 otherwise).  Every MAP row is a mean +/- std over
``--seeds`` (``0,1,2``, ``0-15`` or a mix).

The record goes to ``results/<the reference's stem>_torch.json`` (``--out``
overrides it; a reference record is never overwritten), with the
reference's keys per method plus ``device`` and ``power_limit``.  Its
``platform`` is ``gpu`` on the card and ``cpu`` on the CPU.  Each method's
``wall_s_per_seed`` on the card includes the capture of the run's programs
(a fused run captures anew each run); the corpus is built once per process,
outside it.  Pair a record with the reference's with
``scripts/compare_records_torch.py``.  Run from the repository root::

    python3 scripts/method_comparison_torch.py --methods ital,uncertainty_sampling \\
        --ital-kwargs pool_size=4096,n_qmc=32,refine_top=64,refine_n_qmc=512 --seeds 0-15
    python3 scripts/method_comparison_torch.py --dataset digits --device cpu --tag cpu

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

from study_torch import card_fields, open_device, parse_seeds, record_path, write_record  # noqa: E402

DEFAULT_METHODS = ["ital", "uncertainty_sampling", "random"]


def run_one(method: str, label_prob: float, mistake_prob: float, seed: int,
            gp_noise: float | None, learn_every: int = 0,
            method_overrides: tuple = (), dataset: str = "mirflickr",
            query_batch: int = 7, gp_overrides: tuple = (), *, device="cuda",
            data=None):
    """One fused run of ``method`` at ``seed``: ``(result, wall seconds)``.
    The reference's overrides; ``data`` is the corpus, loaded from the
    config when None."""
    from ital_tpu_torch.runner import run_experiment
    from ital_tpu_torch.utils.config import load_config

    overrides = [
        f"EXPERIMENT.method={method}",
        f"EXPERIMENT.seed={seed}",
        f"EXPERIMENT.query_batch={query_batch}",
        "EXPERIMENT.fused_sessions=true",
        f"USER.label_prob={label_prob}",
        f"USER.mistake_prob={mistake_prob}",
    ]
    overrides += [f"METHOD.{kv}" for kv in method_overrides]
    if gp_noise is not None:
        overrides.append(f"GP.noise={gp_noise}")
    if learn_every:
        overrides.append(f"GP.learn_every={learn_every}")
    overrides += [f"GP.{kv}" for kv in gp_overrides]
    cfg = load_config(os.path.join(REPO, "configs", f"{dataset}.ini"), tuple(overrides))
    t0 = time.time()
    res = run_experiment(cfg, data, device=device)
    return res, time.time() - t0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heavy", action="store_true",
                    help="label_prob=0.6 mistake_prob=0.15 (heavy noise)")
    ap.add_argument("--seeds", default="0,1,2",
                    help="comma-separated seeds or ranges a-b; rows are mean+/-std")
    ap.add_argument("--gp-noise", type=float, default=None,
                    help="override GP noise (suffixes the output filename)")
    ap.add_argument("--learn-every", type=int, default=0,
                    help="GP.learn_every (suffixes the output filename)")
    ap.add_argument("--methods", default=",".join(DEFAULT_METHODS))
    ap.add_argument("--dataset", default="mirflickr",
                    help="config stem under configs/ (digits needs scikit-learn)")
    ap.add_argument("--query-batch", type=int, default=None,
                    help="cohort width; default 7 for mirflickr, 5 otherwise")
    ap.add_argument("--ital-kwargs", default="",
                    help="comma-separated k=v [METHOD] overrides of the ITAL runs only "
                         "(suffixes the output filename)")
    ap.add_argument("--tag", default="", help="extra output-filename suffix")
    ap.add_argument("--gp-overrides", default="",
                    help="comma-separated k=v [GP] overrides of every method "
                         "(suffixes the output filename)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="output path (default results/<stem>.json)")
    return ap


def record_stem(args) -> str:
    """The reference's output stem for these flags, plus ``_torch``."""
    stem = f"{args.dataset}_methods"
    if args.heavy:
        stem += "_heavynoise"
    if args.gp_noise is not None:
        stem += f"_gpnoise{args.gp_noise:g}"
    if args.learn_every:
        stem += f"_learn{args.learn_every}"
    ital_kwargs = [kv for kv in args.ital_kwargs.split(",") if kv]
    if ital_kwargs:
        stem += "_italpool" if any(kv.startswith("pool_size") for kv in ital_kwargs) \
            else "_italkw"
    gp_overrides = [kv for kv in args.gp_overrides.split(",") if kv]
    if gp_overrides:
        stem += "_" + "-".join(kv.replace("learn_", "").replace("=", "")
                               for kv in gp_overrides)
    if args.tag:
        stem += f"_{args.tag}"
    return stem + "_torch"


def compare(args, *, device, data=None, log=print) -> dict:
    """The record: for each method of ``args.methods`` its runs over
    ``args.seeds`` (the reference's keys, ``platform`` the port's)."""
    import torch

    from ital_tpu_torch import graphs

    lp, mp = (0.6, 0.15) if args.heavy else (0.8, 0.05)
    seeds = parse_seeds(args.seeds)
    methods = [m for m in args.methods.split(",") if m]
    query_batch = args.query_batch if args.query_batch is not None else (
        7 if args.dataset == "mirflickr" else 5)
    ital_kwargs = tuple(kv for kv in args.ital_kwargs.split(",") if kv)
    gp_overrides = tuple(kv for kv in args.gp_overrides.split(",") if kv)
    card = card_fields(torch, device)
    record: dict = {}
    for m in methods:
        curves, walls = [], []
        for seed in seeds:
            log(f"== {m} seed={seed}")
            res, wall = run_one(m, lp, mp, seed, args.gp_noise, args.learn_every,
                                ital_kwargs if m == "ital" else (), args.dataset,
                                query_batch, gp_overrides, device=device, data=data)
            curves.append([round(float(v), 4) for v in res["map"]])
            walls.append(round(wall, 1))
            # Whether a run releases the programs of the corpus it dropped.
            held = (f", {torch.cuda.memory_reserved(device) / 2**20:.0f} MiB reserved, "
                    f"{len(graphs.programs())} programs held" if device.type == "cuda" else "")
            log(f"   final MAP {res['map'][-1]:.4f} ({wall:.1f}s{held})")
        arr = np.asarray(curves)
        record[m] = {
            "map": [round(float(v), 4) for v in arr.mean(axis=0)],
            "map_std": [round(float(v), 4) for v in arr.std(axis=0)],
            "map_by_seed": {str(s): c for s, c in zip(seeds, curves)},
            "final_map_by_seed": [c[-1] for c in curves],
            "seeds": seeds,
            "sessions": len(res["sessions"]),
            "wall_s_per_seed": walls,
            "n_rounds": len(res["map"]),
            "user": f"label_prob={lp}, mistake_prob={mp}",
            "gp_noise": args.gp_noise,
            "learn_every": args.learn_every,
            "gp_overrides": list(gp_overrides),
            "ital_kwargs": list(ital_kwargs) if m == "ital" else [],
            "mode": f"cohort-fused (query_batch={query_batch})",
            "dataset": args.dataset,
            "platform": "gpu" if device.type == "cuda" else "cpu",
            **card,
        }
    return record


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    device = open_device(torch, args.device)
    out = args.out or os.path.join(REPO, "results", record_stem(args) + ".json")
    record_path(out)  # refuses a reference record before any run
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.utils.config import load_config

    base = load_config(os.path.join(REPO, "configs", f"{args.dataset}.ini"))
    data = load_dataset(base.dataset, **base.dataset_kwargs)
    record = compare(args, device=device, data=data, log=lambda s: print(s, flush=True))
    write_record(out, record)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
