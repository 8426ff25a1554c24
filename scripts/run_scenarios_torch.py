#!/usr/bin/env python3
"""The BASELINE scenario configs through the PyTorch port.

The port's counterpart of ``scripts/run_scenarios.py``, with its list of
scenarios, flags and report keys: each scenario's config (and overrides)
runs through ``ital_tpu_torch.runner.run_experiment`` once per seed and
writes ``<out>/<name>_torch.json`` (MAP mean +/- std over the seeds, the
per-seed curves, steady select ms, the first round's ms, provenance, and
``mesh_devices`` as the runner reports it) plus ``<out>/summary_torch.json``,
merged with any earlier summary.  Each record adds ``device`` and
``power_limit``.  Scenario 5 (``configs/scale100k.ini``,
``mesh_devices = 8``) runs on the cards there are: one card is a NCCL world
of one.  A scenario that raises is recorded in the summary as
``{"error": ...}`` and the rest run; the script then exits non-zero.
Scenarios 2-3 need scikit-learn's digits.  Run from the repository root::

    python3 scripts/run_scenarios_torch.py --seeds 0,1,2 --out results
    python3 scripts/run_scenarios_torch.py --quick --seeds 0 --only config1 --device cpu --out x

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from study_torch import card_fields, open_device, parse_seeds, write_record  # noqa: E402

SCENARIOS = [
    ("config1_toy_b1", "configs/toy.ini", ()),
    ("config2_digits_b4_noiseless", "configs/digits.ini", ()),
    ("config3_parity_uncertainty", "configs/parity_suite.ini",
     ("EXPERIMENT.method=uncertainty_sampling",)),
    ("config3_parity_borderline", "configs/parity_suite.ini",
     ("EXPERIMENT.method=borderline_sampling",)),
    ("config3_parity_variance", "configs/parity_suite.ini",
     ("EXPERIMENT.method=variance_sampling",)),
    ("config3_parity_random", "configs/parity_suite.ini",
     ("EXPERIMENT.method=random",)),
    ("config3_parity_ital", "configs/parity_suite.ini",
     ("EXPERIMENT.method=ital",)),
    ("config4_mirflickr_b4_noisy", "configs/mirflickr.ini",
     ("EXPERIMENT.max_classes=2",)),
    ("config5_scale100k_sharded", "configs/scale100k.ini",
     ("EXPERIMENT.n_rounds=3", "EXPERIMENT.max_classes=1")),
    ("usps_b4", "configs/usps.ini", ("EXPERIMENT.max_classes=4",)),
    ("natural_scenes_b4", "configs/natural_scenes.ini",
     ("EXPERIMENT.max_classes=4",)),
]

QUICK_OVERRIDES = ("EXPERIMENT.n_rounds=3", "EXPERIMENT.queries_per_class=1")


def run_scenario(cfg_path: str, ov: tuple, seeds: list, device, quick: bool) -> dict:
    """One scenario over ``seeds``: the reference's record keys."""
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.runner import run_experiment
    from ital_tpu_torch.utils.config import load_config

    t0 = time.time()
    cfg = load_config(cfg_path, ov)
    data = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    curves, select_ms, steady_ms, first_ms = [], [], [], []
    for seed in seeds:
        res = run_experiment(load_config(cfg_path, ov + (f"EXPERIMENT.seed={seed}",)),
                             data, device=device)
        curves.append([round(float(v), 4) for v in res["map"]])
        select_ms.append(res["select_ms"])
        if res.get("select_ms_steady") is not None:
            steady_ms.append(res["select_ms_steady"])
        first_ms.append(res.get("first_round_ms", 0.0))
    arr = np.asarray(curves)
    return {
        "dataset": res["dataset"],
        "method": res["method"],
        "sessions": len(res["sessions"]),
        "map": [round(float(v), 4) for v in arr.mean(axis=0)],
        "map_std": [round(float(v), 4) for v in arr.std(axis=0)],
        "map_by_seed": {str(s): c for s, c in zip(seeds, curves)},
        "select_ms_steady": (round(float(np.median(steady_ms)), 2) if steady_ms else None),
        "first_round_ms": round(float(np.median(first_ms)), 2),
        "select_ms_mean_DEPRECATED": round(float(np.mean(select_ms)), 2),
        "wall_s": round(time.time() - t0, 1),
        "n_rounds": cfg.n_rounds,
        "batch_size": cfg.batch_size,
        "queries_per_class": cfg.queries_per_class,
        "seeds": seeds,
        "quick": bool(quick),
        "overrides": list(ov),
        **{k: res[k] for k in ("mesh_devices", "query_batch", "fused", "chol2d") if k in res},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "results"))
    ap.add_argument("--only", default=None, help="substring filter on scenario name")
    ap.add_argument("--seeds", default="0,1,2",
                    help="comma-separated seeds or ranges a-b; MAP rows are mean +/- std")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    seeds = parse_seeds(args.seeds)

    import torch

    device = open_device(torch, args.device)
    card = card_fields(torch, device)
    os.makedirs(args.out, exist_ok=True)
    summary_path = os.path.join(args.out, "summary_torch.json")
    summary = {}
    if os.path.exists(summary_path):
        with open(summary_path) as fh:
            summary = json.load(fh)
    failed = []
    for name, cfg_path, overrides in SCENARIOS:
        if args.only and args.only not in name:
            continue
        ov = overrides + (QUICK_OVERRIDES if args.quick else ())
        print(f"== {name} ({cfg_path}, seeds={seeds})", flush=True)
        try:
            rec = run_scenario(os.path.join(REPO, cfg_path), ov, seeds, device, args.quick)
        except Exception as exc:  # recorded, the others run, the exit code says so
            summary[name] = {"error": f"{type(exc).__name__}: {exc}"}
            failed.append(name)
            print(f"   ERROR {type(exc).__name__}: {exc}", flush=True)
            continue
        rec.update(card)
        summary[name] = rec
        write_record(os.path.join(args.out, f"{name}_torch.json"), rec)
        print(f"   MAP {rec['map']}  ({rec['wall_s']}s)", flush=True)
    write_record(summary_path, summary)
    if failed:
        print(f"failed scenarios: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
