#!/usr/bin/env python3
"""One ITAL session of the PyTorch port at 1M x 512 on one card.

The port's counterpart of ``scripts/scale1m.py``, with its workload: the
``corpus100k`` generator at 1 000 000 x 512 float32, cap 64, batch 4,
n_qmc 128, ls 50, var 1, noise 0.1, the query drawn from
``default_rng(7)``, eight labels that warm the posterior, a user of
label_prob 0.8 and mistake_prob 0.05.  It measures, with a host clock
around calls that end in ``torch.cuda.synchronize()`` (never the
reference's TPU pipeline-slope protocol):

* ``init_plus_query_s``: the corpus to the card, its norms and
  ``gp_set_query``;
* ``select_full`` and ``select_pool4096``: the ITAL selection as a full scan
  and over the top-4096 pool by posterior mean, each the first call (its
  graph's capture) and the median of ``--reps`` calls graphed, and the same
  under ``graphs.eager()``;
* ``full_round_ms``: a round of the pool selection, the simulated user, the
  update and AP, the first alone and then ``STEADY_ROUNDS`` back to back
  with one synchronization at their end (each update reads its Cholesky
  check on the host);
* ``round_step_ms``: ``ital_tpu_torch.round.round_step`` (the full-scan
  round, n_qmc 64) on a copy of the state, first and steady;
* device memory after the fit and at its peak
  (``torch.cuda.max_memory_allocated``), and each program's static buffers
  and graph-pool growth.

Writes ``results/scale1m_torch.json``: the keys of ``results/scale1m.json``
plus ``device`` (the card's name), ``power_limit`` (``nvidia-smi``), the
eager times and the programs.  Run from the repository root::

    python3 scripts/scale1m_torch.py
    python3 scripts/scale1m_torch.py --device cpu --n 4096 --reps 1 --out x.json

It needs a CUDA card unless ``--device cpu`` is given (the CPU tests' small
sizes); without one it exits non-zero and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, DIM = 1_000_000, 512
BATCH, N_QMC, CAP = 4, 128, 64
POOL = 4096
LS, VAR, NOISE = 50.0, 1.0, 0.1
LABEL_PROB, MISTAKE_PROB = 0.8, 0.05
WARM = 8
STEADY_ROUNDS = 7
ROUND_STEPS = 3


def card_fields(torch, device) -> dict:
    """The device's name and power limit, each None off the card."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": smi.splitlines()[0].split(",")[-1].strip()}


def program_records(graphs) -> list:
    """Each captured program's costs (none on the CPU, where bodies run eagerly)."""
    return [{"name": p.name, "replays": p.replays,
             "launches_per_replay": sum(p.launches.values()),
             "warmup_ms": p.warmup_ms, "capture_ms": p.capture_ms,
             "instantiate_ms": p.instantiate_ms,
             "static_mib": p.static_bytes / 2**20, "pool_growth_mib": p.pool_bytes / 2**20}
            for p in graphs.programs()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=N, help=f"corpus rows (default {N})")
    ap.add_argument("--reps", type=int, default=5, help="timed selections per mode (default 5)")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "scale1m_torch.json"))
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {args.device}: no CUDA device is available "
                 f"(--device cpu runs the CPU tests' sizes)")

    from ital_tpu_torch import graphs
    from ital_tpu_torch.data.datasets import corpus100k
    from ital_tpu_torch.data.user import simulate_feedback
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.models.session import update_program
    from ital_tpu_torch.round import round_step
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import select_ital
    from ital_tpu_torch.utils.metrics import average_precision

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def mem_mb(fn):
        return fn(device) / 1e6 if on_card else None

    report = {"platform": "gpu" if on_card else "cpu", "n": args.n, "dim": DIM,
              "cap": CAP, "batch": BATCH, "pool": POOL, "n_qmc": N_QMC,
              **card_fields(torch, device)}
    print(f"== building {args.n} x {DIM} corpus on the host", flush=True)
    t0 = time.perf_counter()
    ds = corpus100k(n=args.n, dim=DIM)
    report["corpus_build_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    q = int(rng.integers(0, ds.n))
    cls = int(ds.labels[q])
    relevant = torch.from_numpy(ds.relevance[:, cls]).to(device)
    exclude = torch.zeros(ds.n, dtype=torch.bool, device=device)
    exclude[q] = True

    t0 = time.perf_counter()
    state = gp_mod.gp_init(torch.from_numpy(ds.x).to(device), LS, VAR, NOISE, CAP)
    state = gp_mod.gp_set_query(state, q)
    sync()
    report["init_plus_query_s"] = time.perf_counter() - t0
    report["device_mem_mb_after_fit"] = mem_mb(torch.cuda.memory_allocated)
    print(f"   corpus resident; init + query {report['init_plus_query_s']:.3f} s; device "
          f"mem {report['device_mem_mb_after_fit']} MB", flush=True)

    params = StrategyParams.create(device, label_prob=LABEL_PROB, mistake_prob=MISTAKE_PROB)
    # Warm the posterior so MI ties do not depend on last-ulp noise.
    warm = rng.permutation(ds.n)[:WARM]
    ys = np.where(ds.relevance[warm, cls], 1.0, -1.0).astype(np.float32)
    state = update_program(state, torch.from_numpy(warm).to(device),
                           torch.from_numpy(ys).to(device),
                           torch.ones(WARM, dtype=torch.bool, device=device))

    def timed_s(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    for label, pool in (("select_full", 0), ("select_pool4096", POOL)):
        select = lambda: select_ital(state, BATCH, None, params, n_qmc=N_QMC, pool_size=pool)
        first = timed_s(select)
        graphed = [timed_s(select) * 1e3 for _ in range(args.reps)]
        with graphs.eager():
            eager = [timed_s(select) * 1e3 for _ in range(args.reps)]
        report[label] = {"first_call_s": first, "ms_per_round": statistics.median(graphed),
                         "ms_graphed": graphed, "eager_ms_per_round": statistics.median(eager),
                         "ms_eager": eager}
        print(f"   {label}: {report[label]['ms_per_round']:.3f} ms/round graphed, "
              f"{report[label]['eager_ms_per_round']:.3f} eager (first {first:.2f} s)",
              flush=True)

    # Full interactive rounds: select (pool) -> user -> update -> AP.
    gen = torch.Generator(device=device).manual_seed(2)

    def one_round():
        batch = select_ital(state, BATCH, None, params, n_qmc=N_QMC, pool_size=POOL)
        y, valid = simulate_feedback(gen, batch, relevant, params.label_prob,
                                     params.mistake_prob)
        update_program(state, batch, y, valid)
        return average_precision(state.mu, relevant, exclude)

    t0 = time.perf_counter()
    aps = [one_round()]
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    aps += [one_round() for _ in range(STEADY_ROUNDS)]
    sync()
    steady_ms = (time.perf_counter() - t0) * 1e3 / STEADY_ROUNDS
    report["full_round_ms"] = {
        "first": first_ms, "steady_amortized": steady_ms, "steady_rounds": STEADY_ROUNDS,
        "protocol": "host clock over the steady rounds, one torch.cuda.synchronize() at "
                    "their end; each update checks its Cholesky on the host"}
    report["ap_curve"] = [float(a) for a in aps]
    print(f"   full rounds: first {first_ms:.1f} ms, steady {steady_ms:.3f} ms over "
          f"{STEADY_ROUNDS}; AP {[round(a, 4) for a in report['ap_curve']]}", flush=True)

    copy = gp_mod.gp_session_copy(state)
    gen_round = torch.Generator(device=device).manual_seed(3)
    steps = [timed_s(lambda: round_step(copy, gen_round, relevant, exclude, params)) * 1e3
             for _ in range(ROUND_STEPS)]
    report["round_step_ms"] = {"first": steps[0], "steady": statistics.median(steps[1:]),
                               "steps": steps}
    print(f"   round_step (full scan, n_qmc 64): first {steps[0]:.1f} ms, steady "
          f"{report['round_step_ms']['steady']:.3f} ms", flush=True)

    report["device_mem_mb_peak"] = mem_mb(torch.cuda.max_memory_allocated)
    report["programs"] = program_records(graphs)
    for p in report["programs"]:
        print(f"   program {p['name']}: capture {p['capture_ms']:.1f} ms, instantiate "
              f"{p['instantiate_ms']:.1f} ms, launches per replay {p['launches_per_replay']}, "
              f"static {p['static_mib']:.2f} MiB, pool growth {p['pool_growth_mib']:.2f} MiB",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}; device memory peak {report['device_mem_mb_peak']} MB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
