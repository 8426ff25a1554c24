#!/usr/bin/env python3
"""The PyTorch port's measurement of the combined selection config: pool x two-stage.

The port's counterpart of ``scripts/pool_refine.py``, with its
configurations, flags and record keys:

1. **Timing**: the ITAL selection at the MIRFLICKR-25K surrogate's size and
   at 100 000 x 512 (``--skip-100k`` drops it) for the combined config
   (pool 4096 + base n_qmc 32 + the top 64 re-scored at 512) and the
   single-lever anchors, on the reference's mid-session state
   (``study_torch.mid_session_state``).  Each row is
   ``study_torch.time_call``: the first call alone (``first_call_s``, the
   program's capture), then the median of three runs of back-to-back calls
   timed by CUDA events, graphed (``ms_per_round``) and under
   ``graphs.eager()`` (``eager_ms_per_round``).  The reference timed by
   pipeline slope on a TPU; its rows are a record to compare with.
2. **MAP** (``--map``, ``--map-heavy``): the MIRFLICKR scenario (14 topic
   sessions in fused cohorts of 7) at each seed for ``full 128`` and the
   combined config, standard or heavy user noise, with the reference's
   ``paired`` entry (combined - full).  ``--user-draws FILE`` feeds the
   reference's simulated-user draws (``scripts/jax_reference.py draws``);
   ``--picks-out FILE`` writes every run's picks.

The record goes to ``results/pool_refine_torch.json``, or with
``--skip-timing`` to ``results/pool_refine_map_torch.json`` (``--out``
overrides either; sections already in a port record are kept, a reference
record is never written).  Pair the MAP entries with the reference's by
``scripts/compare_records_torch.py`` (``--port-key "map/full 128" --ref-key
"map/full 128"``).  Run from the repository root::

    python3 scripts/pool_refine_torch.py
    python3 scripts/pool_refine_torch.py --skip-timing --map --map-heavy --seeds 0-7 \\
        --user-draws results/jax_user_draws_mirflickr_s0-7_torch.npz

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

# (tag, pool_size, base n_qmc, refine_top, refine_n_qmc), the reference's.
CONFIGS = (
    ("full 128", 0, 128, 0, 0),
    ("full 32+top64@512", 0, 32, 64, 512),
    ("pool4096 128", 4096, 128, 0, 0),
    ("pool4096 32+top64@512", 4096, 32, 64, 512),
    ("pool1024 32+top64@512", 1024, 32, 64, 512),
)
MAP_CONFIGS = (
    ("full 128", 0, 128, 0, 0),
    ("pool4096 32+top64@512", 4096, 32, 64, 512),
)
SMOKE_ROW = "pool4096 32+top64@512"  # the row chip_smoke.py times
PROTOCOL = ("CUDA events around back-to-back calls, median of 3 runs; graphed and "
            "graphs.eager(); first call (capture) separate")


def select_kwargs(pool: int, base: int, rt: int, rq: int) -> dict:
    """The ``select_ital`` options of one configuration row."""
    return {"n_qmc": base, "pool_size": pool, "refine_top": rt, "refine_n_qmc": rq or 512}


def method_overrides(pool: int, base: int, rt: int, rq: int) -> tuple:
    """The reference's ``METHOD`` overrides of one configuration row."""
    return (f"pool_size={pool}", f"n_qmc={base}", f"refine_top={rt}",
            f"refine_n_qmc={rq or 512}")


def timing_rows() -> list:
    """``(tag, select_ital options)`` of each timing row."""
    return [(tag, select_kwargs(*c)) for tag, *c in CONFIGS]


def run_timing(torch, device, card: dict, args, log=print) -> dict:
    report = {"platform": "gpu" if device.type == "cuda" else "cpu", "batch": st.BATCH,
              "protocol": PROTOCOL, **card}
    for name, ds in st.scale_datasets(args.skip_100k, n_25k=args.n, n_100k=args.n,
                                      dim=args.dim):
        log(f"== timing: {name} ({ds.n} x {ds.x.shape[1]})")
        state = st.mid_session_state(ds, device)
        report[name] = {"n": ds.n, "dim": int(ds.x.shape[1]),
                        "configs": st.time_selects(torch, device, state, timing_rows(), log=log,
                                                   label=name)}
        del state
    return report


def run_map(seeds, *, heavy: bool, device, data, card: dict, draws_path=None, picks=None,
            log=print) -> dict:
    configs = [(tag, method_overrides(*c)) for tag, *c in MAP_CONFIGS]
    record = st.map_runs(configs, seeds, heavy=heavy, device=device, data=data, card=card,
                         draws_path=draws_path, picks=picks, log=log)
    record["paired"] = st.paired(record[MAP_CONFIGS[0][0]]["final_map_by_seed"],
                                 record[MAP_CONFIGS[1][0]]["final_map_by_seed"])
    p = record["paired"]
    log(f"  paired: delta {p['delta_mean']:+.4f}, {p['wins']}/{len(seeds)} wins, "
        f"t={p['t_stat']:.2f}")
    return record


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-100k", action="store_true")
    ap.add_argument("--skip-timing", action="store_true")
    ap.add_argument("--map", action="store_true")
    ap.add_argument("--map-heavy", action="store_true")
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7", help="seeds as 0,1,2 or 0-7")
    ap.add_argument("--out", default=None,
                    help="output record (default results/pool_refine_torch.json, with "
                         "--skip-timing results/pool_refine_map_torch.json)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--user-draws", default=None,
                    help="the reference's user draws (.npz of scripts/jax_reference.py draws)")
    ap.add_argument("--picks-out", default=None, help="write every MAP run's picks here")
    ap.add_argument("--n", type=int, default=None,
                    help="cut both timing corpora to N rows (the CPU tests' sizes)")
    ap.add_argument("--dim", type=int, default=None, help="with --n, the feature width")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    stem = "pool_refine_map_torch" if args.skip_timing else "pool_refine_torch"
    out = args.out or os.path.join(REPO, "results", f"{stem}.json")
    report = st.load_record(out)
    card = st.card_fields(torch, device)
    log = lambda s: print(s, flush=True)  # noqa: E731
    if not args.skip_timing:
        report["timing"] = run_timing(torch, device, card, args, log)
    picks: dict = {}
    if args.map or args.map_heavy:
        from ital_tpu_torch.data.datasets import mirflickr

        data, seeds = mirflickr(), st.parse_seeds(args.seeds)
        for key, heavy, on in (("map", False, args.map), ("map_heavy", True, args.map_heavy)):
            if on:
                log(f"== {key}")
                picks[key] = {}
                report[key] = run_map(seeds, heavy=heavy, device=device, data=data, card=card,
                                      draws_path=args.user_draws, picks=picks[key], log=log)
    st.write_record(out, report)
    if args.picks_out:
        with open(args.picks_out, "w") as fh:
            json.dump(picks, fh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
