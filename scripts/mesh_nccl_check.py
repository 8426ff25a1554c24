#!/usr/bin/env python3
"""The mesh's fused cohort, the mesh server and the large-cap refit on every
card of one host (NCCL).

A fault-finding check for multi-rank NCCL meshes, which ``chip_smoke.py``
(one card) cannot reach::

    python3 scripts/mesh_nccl_check.py [--device cuda|cpu] [--ranks N] [--steps 1,2,3]

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
3. ``chip_smoke.py``'s phase 11: ``configs/scale100k.ini`` with cap 1024 at
   ``GP.chol2d_threshold = 1024`` and ITAL's production options, cut to 1
   class x 3 rounds, through the runner's per-round mesh of N ranks (the
   distributed refit, ``parallel/bigcap.py``: each round a selection and an
   absorption program per rank with their collectives inside), graphed and
   then under ``graphs.eager()``, beside ``mesh_devices = 0``, whose picks
   and means are read after each of its absorb programs returns.  Each mesh
   run's picks must equal the single-device run's up to MI ties (the
   refined-MI gap at the first parting, on the single-device state, within
   1e-5) and every rank's ``l`` must be (1024 / N, 1024) after every round.
   Prints the largest gap between the posterior means after each round,
   each rank's synchronized round ms graphed and eager, and the
   distributed refit (``bigcap_fit``) of the last state timed on each rank
   in graphed, eager, eager, graphed turns of three calls, its graphed mean
   within 1e-6 of the eager one.

Prints the card's name and power limit, and exits non-zero on any error.
With ``--device cpu`` it runs on gloo processes at 3000 x 128 rows.
"""

from __future__ import annotations

import argparse
import contextlib
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
BIGCAP = ("EXPERIMENT.max_classes=1", "EXPERIMENT.n_rounds=3", "GP.cap=1024",
          "GP.chol2d_threshold=1024", "METHOD.pool_size=4096", "METHOD.n_qmc=32",
          "METHOD.refine_top=64", "METHOD.refine_n_qmc=512")


TURNS = ("graphed", "eager", "eager", "graphed")
FIT_CALLS = 3
MI_TIE_ATOL = 1e-5
GRAPH_MU_ATOL = 1e-6


def _mode(mode: str):
    from ital_tpu_torch import graphs

    return graphs.eager() if mode == "eager" else contextlib.nullcontext()


def _bigcap_rank(mesh, cfg, dataset):
    """One rank of the runner's per-round large-cap mesh, run graphed, then
    under ``graphs.eager()``: each round's picks, gathered mean, ``l`` shape
    and synchronized ms.  Then the distributed refit of the graphed run's
    last state, on copies of it, in graphed, eager, eager, graphed turns.
    Returns rank 0's results with every rank's times and shapes."""
    import torch.distributed as dist

    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel import bigcap, sharded

    rounds, res, last = {}, {}, {}
    make_round = bigcap.make_bigcap_round

    def kept_round(*args, **kwargs):
        round_fn = make_round(*args, **kwargs)
        key = mode  # the run that made it

        def run(state, *a, **kw):
            _sync(mesh.device)
            t = time.perf_counter()
            out = round_fn(state, *a, **kw)
            _sync(mesh.device)
            ms = (time.perf_counter() - t) * 1e3
            rounds[key].append({"ms": ms, "picks": out[1].tolist(), "l": tuple(out[0].l.shape),
                           "mu": sharded.all_gather_cat(mesh, out[0].mu).cpu().numpy()})
            last[key] = out[0]
            return out

        return run

    bigcap.make_bigcap_round = kept_round
    try:
        for mode in ("graphed", "eager"):
            rounds[mode] = []
            with _mode(mode):
                res[mode] = runner._sharded_run(mesh, cfg, dataset)
    finally:
        bigcap.make_bigcap_round = make_round
    fit = bigcap.make_bigcap_fit(mesh)
    fits, mus = {"graphed": [], "eager": []}, {}
    for mode in TURNS:
        with _mode(mode):
            for _ in range(FIT_CALLS):
                state = gp_mod.gp_session_copy(last["graphed"])
                _sync(mesh.device)
                t = time.perf_counter()
                fit(state)
                _sync(mesh.device)
                fits[mode].append((time.perf_counter() - t) * 1e3)
            mus[mode] = sharded.all_gather_cat(mesh, state.mu).cpu().numpy()
    mine = {"fits": fits, "rounds": {m: [(r["ms"], r["l"]) for r in rs]
                                     for m, rs in rounds.items()}}
    every = [None] * mesh.size
    dist.all_gather_object(every, mine, group=mesh.group)
    return {"res": res, "rounds": rounds, "ranks": every,
            "fit_gap": float(np.abs(mus["graphed"] - mus["eager"]).max())}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _held_to_single(what: str, rounds: list, single: list, cfg, dev) -> None:
    """A mesh run's picks against the single-device run's: equal, or at the
    first round where they part an MI tie on the single-device state the
    round selected from (``chip_smoke._tie_gaps``, step by step)."""
    import types

    from chip_smoke import _tie_gaps
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.select.base import StrategyParams

    n = single[0]["mu"].shape[0]
    gaps = [float(np.abs(a["mu"][:n] - b["mu"]).max()) for a, b in zip(rounds, single)]
    part = next((r for r, (a, b) in enumerate(zip(rounds, single)) if a["picks"] != b["picks"]),
                None)
    print(f"bigcap {what}: picks {[r['picks'] for r in rounds]}; first round whose picks "
          f"differ from the single device's {part}; max |mu mesh - mu single| per round {gaps}")
    if part is None:
        return
    params = StrategyParams.create(dev, label_prob=cfg.user.label_prob,
                                   mistake_prob=cfg.user.mistake_prob)
    sess = types.SimpleNamespace(state=gp_mod.gp_session_copy(single[part]["before"], dev),
                                 params=params)
    tie = _tie_gaps(sess, rounds[part]["picks"], cfg.method_kwargs)
    print(f"bigcap {what} round {part}: refined-MI gaps of its picks on the single-device "
          f"state {tie} (tie atol {MI_TIE_ATOL})")
    if not all(abs(g) <= MI_TIE_ATOL for g in tie):
        raise SystemExit(f"bigcap {what}: the picks differ from the single device's beyond MI "
                         f"ties")


def bigcap_step(big_cfg, big, dev, ranks: int, tag: str) -> None:
    """Step 3: the large-cap per-round mesh of ``ranks``, graphed and eager,
    beside ``mesh_devices = 0``."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel.launch import launch

    single = []
    absorb = runner.absorb_step

    def kept_absorb(state, batch, *a, **kw):
        # Around the program, never inside it: the host reads come after it
        # returns.  The state before it is the one the round selected from.
        before = gp_mod.gp_session_copy(state, "cpu")
        out = absorb(state, batch, *a, **kw)
        single.append({"picks": batch.tolist(), "mu": out[0].mu.cpu().numpy().copy(),
                       "before": before})
        return out

    runner.absorb_step = kept_absorb
    try:
        t0 = time.perf_counter()
        res = runner.run_experiment(dataclasses.replace(big_cfg, mesh_devices=0), big,
                                    device=dev)
        print(f"bigcap mesh_devices=0: MAP {[round(float(m), 6) for m in res['map']]}; "
              f"update {res['update_ms']:.3f} ms mean; run {time.perf_counter() - t0:.1f} s "
              f"{tag}")
    finally:
        runner.absorb_step = absorb
    if len(single) != big_cfg.n_rounds:
        raise SystemExit(f"the single-device run absorbed {len(single)} rounds, not "
                         f"{big_cfg.n_rounds}")
    t0 = time.perf_counter()
    out = launch(ranks, _bigcap_rank, dataclasses.replace(big_cfg, mesh_devices=ranks), big,
                 device=dev)
    for mode, res in out["res"].items():
        print(f"bigcap mesh_devices={ranks} {mode}: chol2d {res.get('chol2d')}; MAP "
              f"{[round(float(m), 6) for m in res['map']]}; select {res['select_ms']:.3f} ms "
              f"mean, update {res['update_ms']:.3f} ms mean (rank 0) {tag}")
        if res.get("chol2d") is not True or res["mesh_devices"] != ranks:
            raise SystemExit(f"the mesh of {ranks} did not take the distributed refit")
        _held_to_single(f"mesh of {ranks} {mode}", out["rounds"][mode], single, big_cfg, dev)
    picks = {m: [r["picks"] for r in rs] for m, rs in out["rounds"].items()}
    print(f"bigcap mesh of {ranks}: graphed and eager runs {time.perf_counter() - t0:.1f} s; "
          f"graphed picks equal eager: {picks['graphed'] == picks['eager']}")
    want = (big_cfg.cap // ranks, big_cfg.cap)
    for rank, mine in enumerate(out["ranks"]):
        for mode, rs in mine["rounds"].items():
            print(f"bigcap rank {rank} {mode}: round ms {[round(ms, 3) for ms, _ in rs]}; l "
                  f"{sorted({l for _, l in rs})} {tag}")
            if len(rs) != big_cfg.n_rounds or any(l != want for _, l in rs):
                raise SystemExit(f"rank {rank}'s l is not {want} after every round")
        print(f"bigcap rank {rank} refit (bigcap_fit) ms per call: " + "; ".join(
            f"{mode} {[round(ms, 3) for ms in mine['fits'][mode]]}" for mode in mine["fits"])
            + f" {tag}")
    print(f"bigcap refit: max |mu graphed - mu eager| {out['fit_gap']:.3e} (atol "
          f"{GRAPH_MU_ATOL})")
    if out["fit_gap"] > GRAPH_MU_ATOL:
        raise SystemExit("the graphed refit's mean is not the eager one's")


def main(argv=None) -> int:
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0, help="mesh size (default: every card, or 4)")
    ap.add_argument("--steps", default="1,2,3", help="the steps to run, e.g. 3")
    args = ap.parse_args(argv)
    steps = {int(k) for k in args.steps.split(",")}
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
    scale = load_config(str(ROOT / "configs" / "scale100k.ini"), CUT + small)
    big = load_dataset(scale.dataset, **scale.dataset_kwargs)
    if 1 in steps:
        cohort_step(scale, big, dev, ranks, tag)
    if 2 in steps:
        serve_step(big, small, dev, ranks, tag)
    if 3 in steps:
        big_cfg = load_config(str(ROOT / "configs" / "scale100k.ini"), BIGCAP + small
                              + (() if cuda else ("METHOD.pool_size=256",)))
        bigcap_step(big_cfg, big, dev, ranks, tag)
    return 0


def cohort_step(scale, big, dev, ranks: int, tag: str) -> None:
    """Step 1: the fused cohort of 4 on the mesh beside ``mesh_devices = 0``."""
    from ital_tpu_torch import runner

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


def serve_step(big, small, dev, ranks: int, tag: str) -> None:
    """Step 2: a mesh service beside single-device twins."""
    from ital_tpu_torch import serve
    from ital_tpu_torch.utils.config import load_config

    cuda = dev.type == "cuda"
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
        _sync(dev)
        t = time.perf_counter()
        out = fn()
        _sync(dev)
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


if __name__ == "__main__":
    sys.exit(main())
