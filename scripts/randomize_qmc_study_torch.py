#!/usr/bin/env python3
"""Does the port's randomized-QMC selection (``randomize_qmc``) cost any MAP?

The port's counterpart of ``scripts/randomize_qmc_study.py``, with its
configurations and record keys: the production combined config (pool 4096
+ base n_qmc 32 + the top 64 re-scored at 512) with and without
``randomize_qmc`` (one Cranley-Patterson shift per greedy step, drawn from
the session's own generator), on the MIRFLICKR scenario (14 topic sessions
in fused cohorts of 7) at each of ``--seeds``, standard and heavy user
noise, with the reference's ``paired`` entry (randomized - deterministic).
``--user-draws FILE`` feeds the reference's simulated-user draws
(``scripts/jax_reference.py draws``); the shifts stay the port's own.

Writes ``results/randomize_qmc_map_torch.json`` (on the CPU
``randomize_qmc_map_cpu_torch.json``; ``--out`` overrides it).  Pair it
with ``results/randomize_qmc_map_cpu.json`` by
``scripts/compare_records_torch.py``.  Run from the repository root::

    python3 scripts/randomize_qmc_study_torch.py --seeds 0-7

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

PRODUCTION = ("pool_size=4096", "n_qmc=32", "refine_top=64", "refine_n_qmc=512")
CONFIGS = (
    ("deterministic", "false"),
    ("randomized", "true"),
)
SMOKE_ROW = "randomized"  # the row chip_smoke.py times


def timing_rows() -> list:
    """``(tag, select_ital options)`` of each configuration; the reference
    times none, ``chip_smoke.py`` times ``SMOKE_ROW``."""
    production = {k: int(v) for k, v in (kv.split("=") for kv in PRODUCTION)}
    return [(tag, dict(production, randomize_qmc=flag == "true")) for tag, flag in CONFIGS]


def run_map(seeds, *, heavy: bool, device, data, card: dict, draws_path=None,
            log=print) -> dict:
    configs = [(tag, PRODUCTION + (f"randomize_qmc={flag}",)) for tag, flag in CONFIGS]
    record = st.map_runs(configs, seeds, heavy=heavy, device=device, data=data, card=card,
                         draws_path=draws_path, log=log)
    record["paired"] = st.paired(record["deterministic"]["final_map_by_seed"],
                                 record["randomized"]["final_map_by_seed"])
    p = record["paired"]
    log(f"  paired (randomized - deterministic): delta {p['delta_mean']:+.4f}, "
        f"{p['wins']}/{len(seeds)} wins, t={p['t_stat']:.2f}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7", help="seeds as 0,1,2 or 0-7")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--user-draws", default=None,
                    help="the reference's user draws (.npz of scripts/jax_reference.py draws)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    platform = "gpu" if device.type == "cuda" else "cpu"
    suffix = "_cpu" if platform == "cpu" else ""
    out = args.out or os.path.join(REPO, "results", f"randomize_qmc_map{suffix}_torch.json")
    st.record_path(out)
    from ital_tpu_torch.data.datasets import mirflickr

    card = st.card_fields(torch, device)
    data, seeds = mirflickr(), st.parse_seeds(args.seeds)
    log = lambda s: print(s, flush=True)  # noqa: E731
    report = {"platform": platform, "config": "pool4096 32+top64@512 (production combined)",
              **card}
    for key, heavy in (("map", False), ("map_heavy", True)):
        log(f"== {'heavy' if heavy else 'standard'} noise")
        report[key] = run_map(seeds, heavy=heavy, device=device, data=data, card=card,
                              draws_path=args.user_draws, log=log)
    st.write_record(out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
