#!/usr/bin/env python3
"""The PyTorch port's measurement of the compact-pool knob (``pool_size``).

The port's counterpart of ``scripts/pool_sweep.py``, with its flags,
configurations and record keys:

1. **Timing**: the ITAL selection (n_qmc 128, batch 4) at pool_size 1024,
   4096, 16384 and the full scan, at the MIRFLICKR-25K surrogate's size and
   at 100 000 x 512 (``--skip-100k`` drops it), on the reference's
   mid-session state, each row ``study_torch.time_call`` (first call alone,
   then CUDA-event-timed calls, graphed and under ``graphs.eager()``).
   Writes ``results/pool_sweep_torch.json`` (``--out``).
2. **MAP tradeoff** (``--map``): the MIRFLICKR scenario (14 topic sessions
   in fused cohorts of 7) at pool_size 0 (``full``), 4096 and 1024 for each
   of ``--seeds``.  ``--user-draws FILE`` feeds the reference's
   simulated-user draws (``scripts/jax_reference.py draws``).  Writes
   ``results/pool_tradeoff_torch.json`` (``--map-out``); pair it with
   ``results/pool_tradeoff.json`` by ``scripts/compare_records_torch.py``.

Run from the repository root::

    python3 scripts/pool_sweep_torch.py --map --seeds 0-7

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402
from pool_refine_torch import PROTOCOL  # noqa: E402

N_QMC = 128
POOLS = (1024, 4096, 16384, 0)  # 0 = the full scan
MAP_POOLS = (0, 4096, 1024)
SMOKE_ROW = "1024"  # the row chip_smoke.py times


def pool_tag(pool: int) -> str:
    return str(pool) if pool else "full"


def timing_rows(n: int) -> list:
    """``(tag, select_ital options)`` of each timing row over ``n`` rows
    (pools of ``n`` rows or more left out)."""
    return [(pool_tag(p), {"n_qmc": N_QMC, "pool_size": p})
            for p in POOLS if not (p and p >= n)]


def run_timing(torch, device, card: dict, args, log=print) -> dict:
    report = {"platform": "gpu" if device.type == "cuda" else "cpu", "batch": st.BATCH,
              "n_qmc": N_QMC, "protocol": PROTOCOL, **card}
    for name, ds in st.scale_datasets(args.skip_100k, n_25k=args.n, n_100k=args.n,
                                      dim=args.dim):
        log(f"== timing: {name} ({ds.n} x {ds.x.shape[1]})")
        state = st.mid_session_state(ds, device)
        report[name] = {"n": ds.n, "dim": int(ds.x.shape[1]),
                        "pools": st.time_selects(torch, device, state, timing_rows(ds.n), log=log,
                                                 label=name)}
        del state
    return report


def run_map(seeds, *, device, data, card: dict, draws_path=None, log=print) -> dict:
    configs = [(pool_tag(p), (f"pool_size={p}",)) for p in MAP_POOLS]
    return st.map_runs(configs, seeds, heavy=False, device=device, data=data, card=card,
                       draws_path=draws_path, log=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-100k", action="store_true")
    ap.add_argument("--skip-timing", action="store_true")
    ap.add_argument("--map", action="store_true",
                    help="also record the MAP-vs-pool tradeoff (slower)")
    ap.add_argument("--seeds", default="0,1,2", help="seeds as 0,1,2 or 0-7")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "pool_sweep_torch.json"))
    ap.add_argument("--map-out",
                    default=os.path.join(REPO, "results", "pool_tradeoff_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--user-draws", default=None,
                    help="the reference's user draws (.npz of scripts/jax_reference.py draws)")
    ap.add_argument("--n", type=int, default=None,
                    help="cut both timing corpora to N rows (the CPU tests' sizes)")
    ap.add_argument("--dim", type=int, default=None, help="with --n, the feature width")
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    st.record_path(args.out)
    st.record_path(args.map_out)
    card = st.card_fields(torch, device)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if not args.skip_timing:
        st.write_record(args.out, run_timing(torch, device, card, args, log))
    if args.map:
        from ital_tpu_torch.data.datasets import mirflickr

        st.write_record(args.map_out, run_map(st.parse_seeds(args.seeds), device=device,
                                              data=mirflickr(), card=card,
                                              draws_path=args.user_draws, log=log))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
