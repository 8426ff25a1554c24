#!/usr/bin/env python3
"""Record a large-cap (distributed chol2d refit) session of the PyTorch port at 100k rows.

The port's counterpart of ``scripts/record_bigcap_session.py``:
``configs/scale100k.ini`` (100 000 x 512, ``mesh_devices = 8``, clamped to
the cards there are: one card is a NCCL world of one) at cap 1024 with
``GP.chol2d_threshold=1024``, 1 class x 3 rounds, so the sharded runner
absorbs each round's labels through the distributed refit
(``parallel/bigcap.py``, ``l`` in block-rows).  Extra ``SECTION.key=value``
arguments record a variant under ``--tag`` (e.g. ``METHOD.pool_size=4096
METHOD.refine_top=64 --tag fastsel``).  Each round's AP and time come from
the runner's JSONL (``round_ms`` is its ``select_ms`` plus ``update_ms``;
the first round includes the programs' captures).

Writes ``results/bigcap_session_100k[_<tag>]_torch.json`` and its JSONL
(``--out DIR`` overrides the directory), the reference's keys plus
``device`` and ``power_limit``, and fails unless the large-cap path ran.
Run from the repository root::

    python3 scripts/record_bigcap_session_torch.py
    python3 scripts/record_bigcap_session_torch.py METHOD.pool_size=4096 METHOD.refine_top=64 --tag fastsel
    python3 scripts/record_bigcap_session_torch.py DATA.n=3000 DATA.dim=128 GP.length_scale=12 \\
        EXPERIMENT.mesh_devices=2 --device cpu --out x

It needs a CUDA card unless ``--device cpu`` is given (then the mesh runs on
gloo, one process per rank).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from study_torch import card_fields, open_device, record_path, write_record  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("overrides", nargs="*", help="extra SECTION.key=value overrides")
    ap.add_argument("--tag", default="", help="record-filename suffix")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default=os.path.join(REPO, "results"), help="output directory")
    args = ap.parse_args(argv)

    import torch

    from ital_tpu_torch.runner import run_experiment
    from ital_tpu_torch.utils.config import load_config

    device = open_device(torch, args.device)
    stem = "bigcap_session_100k" + (f"_{args.tag}" if args.tag else "") + "_torch"
    out = record_path(os.path.join(args.out, f"{stem}.json"))
    log = record_path(os.path.join(args.out, f"{stem}.jsonl"))
    os.makedirs(args.out, exist_ok=True)
    if os.path.exists(log):
        os.unlink(log)
    cfg = load_config(
        os.path.join(REPO, "configs", "scale100k.ini"),
        ("EXPERIMENT.n_rounds=3", "EXPERIMENT.max_classes=1",
         "GP.cap=1024", "GP.chol2d_threshold=1024",
         f"EXPERIMENT.log_jsonl={log}") + tuple(args.overrides),
    )
    t0 = time.time()
    res = run_experiment(cfg, device=device)
    wall = time.time() - t0

    rounds = []
    with open(log) as fh:
        for line in fh:
            rec = json.loads(line)
            rounds.append({"round": rec["round"], "ap": rec["ap"],
                           "round_ms": rec["select_ms"] + rec["update_ms"]})
    record = {
        "dataset": res["dataset"],
        "method": res["method"],
        "method_kwargs": dict(cfg.method_kwargs),
        "cap": cfg.cap,
        "chol2d": bool(res.get("chol2d")),
        "mesh_devices": res.get("mesh_devices"),
        "map": [round(float(v), 4) for v in res["map"]],
        "per_round": rounds,
        "wall_s": round(wall, 1),
        "note": "cap=1024 crosses chol2d_threshold: label absorption is the "
                "distributed chol2d refit (parallel/bigcap.py); round_ms is the "
                "runner's select_ms + update_ms, the first round's including the "
                "programs' captures",
        **card_fields(torch, device),
    }
    write_record(out, record)
    print(json.dumps(record, indent=1))
    if not record["chol2d"]:
        sys.exit("the large-cap path was not taken")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
