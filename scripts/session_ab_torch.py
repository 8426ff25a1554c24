#!/usr/bin/env python3
"""Time the port's interactive session on the card from two source trees, in turns.

Each run is a process of its own that imports ``chip_smoke`` from one tree,
builds that tree's kernels and runs its phase 4 (``session_phase``: the
production configuration, 25 000 x 512, ``update_query`` and 10 rounds of
fetch / simulated user / update).  The runs go in the order A B B A, repeated
``--pairs`` times, so the two trees share the card's drift.  Prints each
run's fetch and update medians over the steady rounds (round 0 excluded),
then each tree's pooled median and quartiles, with the card's name and power
limit.

    python3 scripts/session_ab_torch.py <tree A> <tree B> [--pairs 2]

A tree is a directory holding ``chip_smoke.py`` and ``ital_tpu_torch/`` (for
example a ``git archive`` of another commit, unpacked).
"""

from __future__ import annotations

import argparse
import ast
import os
import subprocess
import sys

import numpy as np

CHILD = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from ital_tpu_torch.data.datasets import load_dataset
from ital_tpu_torch.utils.config import apply_matmul_precision, load_config

cs.device_phase(torch)
cfg = load_config(str(cs.CONFIG))
apply_matmul_precision(cfg)
cs.build_phase()
ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
cs.session_phase(torch, ds, cfg, torch.device("cuda"))
"""


def _series(out: str, name: str) -> list[float]:
    line = next(ln for ln in out.splitlines() if ln.startswith(f"session: {name} ms "))
    return ast.literal_eval(line[len(f"session: {name} ms "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--pairs", type=int, default=2, help="A B B A repeats (default 2)")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    pooled = {"A": {"fetch": [], "update": []}, "B": {"fetch": [], "update": []}}
    for i, label in enumerate("ABBA" * args.pairs):
        tree = os.path.abspath(args.tree_a if label == "A" else args.tree_b)
        proc = subprocess.run([sys.executable, "-c", CHILD, tree], cwd=tree, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            return proc.returncode
        steady = {k: _series(proc.stdout, k)[1:] for k in ("fetch", "update")}
        for k, v in steady.items():
            pooled[label][k] += v
        print(f"run {i} tree {label}: fetch median {np.median(steady['fetch']):.3f} ms, update "
              f"median {np.median(steady['update']):.3f} ms ({len(steady['fetch'])} steady "
              f"rounds) [{smi}]", flush=True)
    for label, series in pooled.items():
        print(f"tree {label} pooled: " + "; ".join(
            f"{k} median {np.median(v):.3f} ms (quartiles {np.percentile(v, 25):.3f}-"
            f"{np.percentile(v, 75):.3f}, n {len(v)})" for k, v in series.items()) + f" [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
