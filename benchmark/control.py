"""Readings that set the limits of ``correct``: the program's numbers over
many seeds, and the lower-precision controls' over a few.

    python3 benchmark/control.py --workload <cell> --seeds 1-12 --control-seeds 3 \\
        --seconds 10 --out control_<cell>.jsonl

One process runs the cell's window once per seed (``--trace 0``, the cell's
own load) and prints the numbers ``correct`` compared.  For the first
``--control-seeds`` seeds it then puts each of the configuration's controls
(``correct.controls``: the plain reference in the precision below the one the
configuration states, :class:`benchmark.reference.Precision`) in the
program's place on the same sessions and labels, and prints the same numbers
of it.  ``--device cpu`` runs it on the CPU (the tests' small cells).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(workload: str, seed_list: list, control_seeds: int, seconds: float,
             device: str = "cuda", root: str = ROOT):
    """Yield one record per seed: the program's readings and, for the first
    ``control_seeds`` seeds, each control's."""
    import torch

    from benchmark import harness, reference

    cfg = harness.resolve(workload, root).config
    judge = harness.load_judge(cfg["selection"]["strategy"], root)
    for i, seed in enumerate(seed_list):
        out = harness.run(workload, seed, seconds, False, device, time.perf_counter(),
                          root=root, keep=True)
        kept = out.pop("_kept")
        row = {"seed": seed, "correct": out["correct"], "attempted": out["attempted"],
               "program": {k: v["value"] for k, v in out["compared"].items()}}
        if i < control_seeds:
            row["controls"] = {c: reference.readings(kept["x"], cfg, kept["live"],
                                                     kept["sampled"], judge, control=c)
                               for c in cfg["correct"]["controls"]}
        del kept, out
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True, help="e.g. 1-12 or 3,5,9")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sink = open(args.out, "a") if args.out else None
    try:
        for row in readings(args.workload, args.seeds, args.control_seeds, args.seconds,
                            args.device):
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
