#!/usr/bin/env python3
"""The mesh's fused cohort and the mesh server on every card of one host (NCCL).

A fault-finding check for multi-rank NCCL meshes, which ``chip_smoke.py``
(one card) cannot reach::

    python3 scripts/mesh_nccl_check.py [--device cuda|cpu] [--ranks N]

1. ``configs/scale100k.ini`` (100 000 x 512, ITAL full scan), cut to 2
   classes x 2 queries x 2 rounds, through the runner with ``query_batch =
   4`` and ``fused_sessions`` on a mesh of N ranks (default: every card)
   beside ``mesh_devices = 0``: the MAP curves and the cohort times.
2. A mesh service of N ranks over the same corpus at the production
   selection options (``configs/mirflickr_production.ini``), 4 ITAL
   sessions through ``/batch_select`` and ``/batch_feedback`` for 2 rounds
   beside 4 twins on a single-device service answered alike, then
   ``/learn`` and ``/snapshot`` -> ``/restore``: the picks that differ, the
   largest gap between the posterior means, the request times.

Prints the card's name and power limit, and exits non-zero on any error.
With ``--device cpu`` it runs on gloo processes at 3000 x 128 rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CUT = ("EXPERIMENT.max_classes=2", "EXPERIMENT.queries_per_class=2", "EXPERIMENT.n_rounds=2")
SMALL = ("DATA.n=3000", "DATA.dim=128", "GP.length_scale=12")


def main(argv=None) -> int:
    from ital_tpu_torch import runner, serve
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0, help="mesh size (default: every card, or 4)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    small = () if cuda else SMALL
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print("\n".join(smi))
        tag = f"[{smi[0]}] x {torch.cuda.device_count()}"
    else:
        tag = "[cpu]"
    ranks = args.ranks or (torch.cuda.device_count() if cuda else 4)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    scale = load_config(str(ROOT / "configs" / "scale100k.ini"), CUT + small)
    big = load_dataset(scale.dataset, **scale.dataset_kwargs)
    res = {}
    for mesh in (0, ranks):
        cfg = dataclasses.replace(scale, mesh_devices=mesh, query_batch=4, fused_sessions=True)
        t0 = time.perf_counter()
        res[mesh] = runner.run_experiment(cfg, big, device=dev)
        print(f"runner mesh_devices={mesh}: MAP {[round(float(m), 6) for m in res[mesh]['map']]}; "
              f"cohort {res[mesh]['select_ms']:.3f} ms (first {res[mesh]['first_round_ms']:.1f}); "
              f"run {time.perf_counter() - t0:.1f} s {tag}")
    if res[ranks].get("mesh_devices") != ranks:
        raise SystemExit(f"the mesh ran {res[ranks].get('mesh_devices')} ranks, not {ranks}")
    gap = float(np.abs(res[ranks]["ap"] - res[0]["ap"]).max())
    print(f"runner: max |AP mesh - AP single| {gap:.3e}")

    prod = load_config(str(ROOT / "configs" / "mirflickr_production.ini"), small)
    kw = dict(length_scale=prod.gp.length_scale, var=prod.gp.var, noise=prod.gp.noise, cap=64,
              label_prob=prod.user.label_prob, mistake_prob=prod.user.mistake_prob,
              method_kwargs=dict(prod.method_kwargs) | ({} if cuda else {"pool_size": 256}),
              device=dev)
    t0 = time.perf_counter()
    mesh = serve.RetrievalService(big.x, mesh_devices=ranks, **kw)
    print(f"serve: mesh of {mesh.health()['mesh_devices']} ({mesh._world.mesh.backend}) started "
          f"in {time.perf_counter() - t0:.1f} s {tag}")
    single = serve.RetrievalService(big.x, **kw)
    rng = np.random.default_rng(5)
    queries = [(int(q), int(c)) for c in big.classes[:2]
               for q in big.queries_for_class(int(c), rng, 2)]
    times: dict = {}

    def timed(kind, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        times.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
        return out

    try:
        cohort, twins = [], []
        for q, _ in queries:
            cohort.append(mesh.create_session())
            timed("query", lambda: mesh.set_query(cohort[-1], q))
            twins.append(single.create_session())
            single.set_query(twins[-1], q)
        differ = 0
        for _ in range(2):
            picks = timed("batch_select", lambda: mesh.next_batch_many(cohort, 4))
            alone = {b: single.next_batch(b, 4) for b in twins}
            differ += sum(picks[a] != alone[b] for a, b in zip(cohort, twins))
            answers = {a: {str(i): 1 if big.relevance[i, c] else -1 for i in picks[a]}
                       for a, (_, c) in zip(cohort, queries)}
            timed("batch_feedback", lambda: mesh.feedback_many(answers))
            for a, b in zip(cohort, twins):
                single.feedback(b, answers[a])
        gap = 0.0
        for a, b in zip(cohort, twins):
            ranked = mesh.ranking(a, 50)
            twin = single._entry(b)[0].scores()[ranked["top"]]
            gap = max(gap, float(np.abs(np.asarray(ranked["scores"]) - twin).max()))
        learned = timed("learn", lambda: mesh.learn(cohort[0], steps=50))
        want = single.learn(twins[0], steps=50)
        blob = timed("snapshot", lambda: mesh.snapshot(cohort[0]))
        restored = timed("restore", lambda: mesh.restore(blob))
        same = mesh.ranking(restored, 20)["top"] == mesh.ranking(cohort[0], 20)["top"]
    finally:
        mesh.close()
    print(f"serve: cohort picks that differ from the twins' {differ} of {2 * len(cohort)}; max "
          f"|mu mesh - mu twin| over the top 50 {gap:.3e}; learn {learned} against {want}; "
          f"restored ranks as the snapshot: {same}")
    for kind, ms in times.items():
        print(f"serve {kind}: {len(ms)} requests, host ms median {np.median(ms):.3f} {tag}")
    if not same:
        raise SystemExit("the restored session ranks otherwise")
    return 0


if __name__ == "__main__":
    sys.exit(main())
