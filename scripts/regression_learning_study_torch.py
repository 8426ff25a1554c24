#!/usr/bin/env python3
"""The PyTorch port's hyperparameter learning on the regression task.

The port's counterpart of ``scripts/regression_learning_study.py``, with
its task, configurations and record keys: ``ital_regression`` on
``regression_toy`` (n 300, dim 2, seed 1), batch 4, ``--rounds`` rounds,
starting from a 20x-wrong GP noise (init 1.0, generative
``USER.obs_noise`` 0.05), three configurations over ``--seeds``:

- ``fixed_wrong``: ``GP.noise=1.0``;
- ``learned``: the same plus ``GP.learn_every=2`` (``learn_steps=40``);
- ``well_specified``: ``GP.noise=0.05``;

each run through ``ital_tpu_torch.runner.run_regression_experiment`` on
the card.  ``--user-draws`` feeds the reference runner's label uniforms and
N(0, 1) observation errors (``scripts/jax_reference.py draws --task
regression``) through the port's seam ``runner.regression_draws``, so each
seed's simulated user is the reference's.

Held, against the reference record (``results/regression_learning.json``):
for each configuration the paired port - record final RMSE over the seeds
has a 95 % t-interval containing 0, and ``paired_fixed_minus_learned.wins``
equals the record's over the same seeds (8 of 8 at its own); the learned
noise per seed stands beside the record's.

Writes ``results/regression_learning_torch.json`` (``--out``).  Run from
the repository root::

    python3 scripts/regression_learning_study_torch.py \\
        --user-draws results/jax_user_draws_regression_toy_s0-7_torch.npz

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402
from compare_records_torch import interval  # noqa: E402

RECORD = os.path.join(REPO, "results", "regression_learning.json")
CONFIGS = {
    "fixed_wrong": {},
    "learned": dict(learn_every=2, learn_steps=40),
    "well_specified": dict(noise=0.05),
}


def base_config(rounds: int):
    """The reference study's ``ExperimentConfig`` (its ``base``)."""
    from ital_tpu_torch.utils.config import ExperimentConfig, GPConfig, UserConfig

    return ExperimentConfig(
        task="regression", dataset="regression_toy",
        dataset_kwargs=dict(n=300, dim=2, seed=1, noise=0.0),
        method="ital_regression", batch_size=4, n_rounds=rounds, repetitions=1,
        gp=GPConfig(length_scale=1.0, var=1.0, noise=1.0, cap=48),
        user=UserConfig(label_prob=1.0, obs_noise=0.05),
    )


def run(device, seeds, rounds: int, *, configs=CONFIGS, draws_path: str | None = None,
        log=print) -> dict:
    """The reference record's ``configs`` and ``paired_fixed_minus_learned``
    of the port's runs, plus each run's wall seconds."""
    from ital_tpu_torch.runner import run_regression_experiment

    base = base_config(rounds)
    draws = (st.regression_user_draws(draws_path, [(s, 0, rounds, base.batch_size)
                                                   for s in seeds])
             if draws_path else contextlib.nullcontext())
    record: dict = {"configs": {}}
    with draws:
        for name, gp_kw in configs.items():
            finals, curves, hypers, walls = [], [], [], []
            for seed in seeds:
                cfg = dataclasses.replace(base, seed=seed,
                                          gp=dataclasses.replace(base.gp, **gp_kw))
                t0 = time.perf_counter()
                res = run_regression_experiment(cfg, device=device)
                walls.append(round(time.perf_counter() - t0, 2))
                curve = [round(float(v), 4) for v in res["mean_rmse"]]
                curves.append(curve)
                finals.append(curve[-1])
                if "hyper" in res:
                    hypers.append({k: round(v, 4) for k, v in res["hyper"].items()})
                log(f"== {name} seed={seed} final RMSE {curve[-1]:.4f} ({walls[-1]} s)")
            arr = np.asarray(finals)
            record["configs"][name] = {
                "final_rmse_mean": round(float(arr.mean()), 4),
                "final_rmse_std": round(float(arr.std()), 4),
                "final_rmse_by_seed": finals,
                "rmse_curves_by_seed": {str(s): c for s, c in zip(seeds, curves)},
                "gp_overrides": gp_kw,
                "learned_hyper_by_seed": hypers,
                "seeds": list(seeds),
                "wall_s_by_seed": walls,
            }
    if "fixed_wrong" in record["configs"] and "learned" in record["configs"]:
        fw = np.asarray(record["configs"]["fixed_wrong"]["final_rmse_by_seed"])
        le = np.asarray(record["configs"]["learned"]["final_rmse_by_seed"])
        d = fw - le
        sd = d.std(ddof=1) if len(d) > 1 else 0.0
        record["paired_fixed_minus_learned"] = {
            "mean": round(float(d.mean()), 4), "wins": int((d > 0).sum()), "n": len(d),
            "t": round(float(d.mean() / (sd / np.sqrt(len(d)))), 2) if sd > 0 else None}
    return record


def held_against(port: dict, ref: dict, seeds) -> dict:
    """Per configuration the paired port - record final RMSE (95 % interval,
    held when it contains 0), the learned noise beside the record's, and
    whether the fixed-minus-learned wins equal the record's."""
    out: dict = {"configs": {}}
    for name, entry in port["configs"].items():
        theirs = ref["configs"][name]
        ref_seeds = [int(s) for s in theirs["rmse_curves_by_seed"]]
        pairs = [(entry["final_rmse_by_seed"][i], theirs["final_rmse_by_seed"][ref_seeds.index(s)])
                 for i, s in enumerate(seeds) if s in ref_seeds]
        delta = interval([a - b for a, b in pairs])
        row = dict(delta, held=None if delta["lo"] is None else
                   bool(delta["lo"] <= 0.0 <= delta["hi"]))
        if entry["learned_hyper_by_seed"]:
            row["learned_noise_port"] = [h["noise"] for h in entry["learned_hyper_by_seed"]]
            row["learned_noise_record"] = [theirs["learned_hyper_by_seed"][ref_seeds.index(s)]
                                           ["noise"] for s in seeds if s in ref_seeds]
        out["configs"][name] = row
    if "paired_fixed_minus_learned" in port:
        # The record's wins over the same seeds (all 8 of its own).
        finals = {name: dict(zip((int(s) for s in ref["configs"][name]["rmse_curves_by_seed"]),
                                 ref["configs"][name]["final_rmse_by_seed"]))
                  for name in ("fixed_wrong", "learned")}
        want = sum(finals["fixed_wrong"][s] - finals["learned"][s] > 0 for s in seeds
                   if s in finals["learned"])
        wins = port["paired_fixed_minus_learned"]["wins"]
        out["wins"] = {"port": wins, "record": int(want), "held": wins == want}
    out["held"] = all(r["held"] for r in out["configs"].values()) and out.get(
        "wins", {}).get("held", True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-7", help="seeds as 0,1,2 or 0-7")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--user-draws", default=None,
                    help="the reference's regression draws (jax_reference.py draws --task "
                         "regression)")
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "regression_learning_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    st.record_path(args.out)
    seeds = st.parse_seeds(args.seeds)
    log = lambda s: print(s, flush=True)  # noqa: E731
    record = {
        "task": "regression_toy n=300 dim=2, ital_regression b=4, "
                f"{args.rounds} rounds; generative obs_noise=0.05, "
                "model init noise=1.0 (20x wrong)",
        "platform": "gpu" if device.type == "cuda" else "cpu", **st.card_fields(torch, device),
        "user_draws": os.path.basename(args.user_draws) if args.user_draws else None,
        **run(device, seeds, args.rounds, draws_path=args.user_draws,
              configs={k: CONFIGS[k] for k in args.configs.split(",")}, log=log),
    }
    with open(RECORD) as fh:
        record["against_record"] = held_against(record, json.load(fh), seeds)
    for name, row in record["against_record"]["configs"].items():
        log(f"{name}: port - record final RMSE {row['mean']:+.4f} "
            f"[{row['lo']}, {row['hi']}] -> {'held' if row['held'] else 'not held'}")
    print("held" if record["against_record"]["held"] else "not held", flush=True)
    st.write_record(args.out, record)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
