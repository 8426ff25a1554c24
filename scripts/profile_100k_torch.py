#!/usr/bin/env python3
"""The PyTorch port's 100 000-row round cost, on the card.

The port's counterpart of ``scripts/profile_100k.py``, with its workload
and record keys: ``corpus100k``'s generator at 100 000 x 512, the
reference's mid-session state (``study_torch.mid_session_state``: the
query and 5 x 4 labels of ``default_rng(7)``, cap 64), ITAL batch 4,
n_qmc 128, the full scan; each part graphed and under ``graphs.eager()``:

1. ``select_first_call_s`` and ``select_pipeline_slope_ms``: the
   selection's first call alone, then the slope of 8 and 32 back-to-back
   calls between one pair of CUDA events;
2. ``sharded_round_ms``: ``ROUNDS`` feedback rounds on a mesh of one
   through ``parallel/sharded.py``'s round program (``make_sharded_round``:
   the ``sharded_select`` and ``sharded_absorb`` programs; NCCL on the
   card), each round's synchronized host ms, as ``per_round``, ``first``
   and ``steady_median``;
3. ``mi_scan_block_sweep_ms``: one MI scan of the corpus at t = 1 (the
   reference's ``mi_scores_from_moments`` call, its moments computed
   once) as one program a block, at the reference's blocks 512, 1024, 2048
   and 4096 and at ``select.ital.mi_block``'s (``default_block``), the
   slope of back-to-back calls;
4. ``profiler``: ``torch.profiler``'s device-busy share, device ms and op
   count of one steady round.

Held: every round's picks equal the eager run's.  The reference's TPU
numbers are its own.

Writes ``results/scale100k_profile_torch.json`` (``--out``).  Run from the
repository root::

    python3 scripts/profile_100k_torch.py

It needs a CUDA card unless ``--device cpu`` is given (``--n 1500 --dim
64``: the CPU tests' size, gloo, host clocks).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

BATCH, N_QMC = 4, 128
N, DIM = 100_000, 512
ROUNDS = 6
SWEEP = (512, 1024, 2048, 4096)
SEED = 2  # the rounds' draws (the reference's PRNGKey(2))


def selection(torch, device, state, params) -> dict:
    """Part 1, graphed and eager."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.select.ital import select_ital

    def call():
        return select_ital(state, BATCH, None, params, n_qmc=N_QMC)

    out = {}
    for prefix, mode in (("", contextlib.nullcontext), ("eager_", graphs.eager)):
        with mode():
            st.sync(torch, device)
            t0 = time.perf_counter()
            call()
            st.sync(torch, device)
            out[f"{prefix}select_first_call_s"] = time.perf_counter() - t0
            out[f"{prefix}select_pipeline_slope_ms"] = st.pipeline_slope(torch, device, call)[2]
    return out


def sharded_rounds(torch, device, state, ds, cls: int, params, mesh, mode) -> dict:
    """Part 2 in one mode: ``ROUNDS`` rounds from a copy of ``state``, and
    part 4's profile of one more round."""
    from ital_tpu_torch import runner
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.parallel import sharded

    round_fn = sharded.make_sharded_round(mesh, strategy="ital", batch_size=BATCH, n_qmc=N_QMC,
                                          recall_ks=(10, 50))
    q = int(state.idx[0])
    relevant = torch.from_numpy(np.ascontiguousarray(ds.relevance[:, cls])).to(device)
    sel_forbid, ap_exclude = sharded.make_masks(ds.n, ds.n, q, device)
    shard = sharded.shard_state(gp_mod.gp_session_copy(state), mesh)

    def one(r):
        draws = runner.round_draws(SEED, 0, cls, q, r, BATCH, device)
        return round_fn(shard, *draws, relevant, sel_forbid, ap_exclude, params, n_real=ds.n)

    per_round, picks = [], []
    with mode():
        for r in range(ROUNDS):
            st.sync(torch, device)
            t0 = time.perf_counter()
            _, batch, ap, _ = one(r)
            float(ap)
            st.sync(torch, device)
            per_round.append((time.perf_counter() - t0) * 1e3)
            picks.append(batch.tolist())
        prof = st.device_profile(torch, device, lambda: float(one(ROUNDS)[2]))
    return {"mesh_devices": mesh.size, "backend": mesh.backend, "per_round": per_round,
            "first": per_round[0], "steady_median": statistics.median(per_round[1:]),
            "picks": picks, "profiler": prof}


def block_sweep(torch, device, state, params, blocks) -> dict:
    """Part 3: ``{block: {"ms", "eager_ms"}}`` of one t = 1 MI scan."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.select import ital

    t = 1
    mu_b, cov_bb, cross = ital._session_moments(gp_mod.stacked_view(state), params,
                                                state.idx[None, :t])
    inputs = {"mu_c": state.mu, "sig2_c": state.sig2 + params.jitter, "cross": cross[0],
              "mu_b": mu_b[0], "cov_bb": cov_bb[0], **params.program_inputs()}
    out = {}
    for block in blocks:
        def body(*, mu_c, sig2_c, cross, mu_b, cov_bb, _block=block, **p):
            from ital_tpu_torch.select.base import StrategyParams

            return (ital.mi_scores_from_moments(mu_c, sig2_c, cross, mu_b, cov_bb,
                                                StrategyParams.from_inputs(p), t=t,
                                                n_qmc=N_QMC, block=_block),)

        def call(_body=body, _block=block):
            return graphs.run("mi_scan_block_sweep", _body, inputs, static=(_block,))

        row = {}
        for key, mode in (("ms", contextlib.nullcontext), ("eager_ms", graphs.eager)):
            with mode():
                call()
                row[key] = st.pipeline_slope(torch, device, call)[2]
        out[str(block)] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "scale100k_profile_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=N, help=f"corpus rows (default {N})")
    ap.add_argument("--dim", type=int, default=DIM, help=f"feature width (default {DIM})")
    args = ap.parse_args(argv)
    import torch

    from ital_tpu_torch import graphs
    from ital_tpu_torch.data import datasets
    from ital_tpu_torch.parallel import make_mesh
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import mi_block

    device = st.open_device(torch, args.device)
    st.record_path(args.out)
    log = lambda s: print(s, flush=True)  # noqa: E731
    ds = datasets.corpus100k(n=args.n, dim=args.dim)
    state = st.mid_session_state(ds, device)
    q = int(state.idx[0])
    cls = int(np.argmax(ds.relevance[q])) if ds.relevance[q].any() else 0
    params = StrategyParams.create(device, label_prob=st.LABEL_PROB, mistake_prob=st.MISTAKE_PROB)
    report = {"platform": "gpu" if device.type == "cuda" else "cpu", "n": ds.n,
              "dim": int(ds.x.shape[1]), "batch": BATCH, "n_qmc": N_QMC, "cap": st.CAP,
              **st.card_fields(torch, device)}
    report.update(selection(torch, device, state, params))
    log(f"selection: first call {report['select_first_call_s']:.2f} s, slope "
        f"{report['select_pipeline_slope_ms']:.3f} ms graphed, "
        f"{report['eager_select_pipeline_slope_ms']:.3f} eager")
    with make_mesh(1, device=device) as mesh:
        for key, mode in (("sharded_round_ms", contextlib.nullcontext),
                          ("eager_sharded_round_ms", graphs.eager)):
            report[key] = sharded_rounds(torch, device, state, ds, cls, params, mesh, mode)
            r = report[key]
            log(f"{key}: per round {[round(v, 2) for v in r['per_round']]} ms, busy "
                f"{r['profiler']['busy_share']}")
    report["sharded_round_ms"]["round2_recorded_mean"] = 953.88
    default = mi_block(2, N_QMC)
    report["default_block"] = default
    report["mi_scan_block_sweep_ms"] = block_sweep(torch, device, state, params,
                                                   sorted(set(SWEEP + (default,))))
    log(f"block sweep: {report['mi_scan_block_sweep_ms']}")
    report["profiler"] = report["sharded_round_ms"].pop("profiler")
    report["eager_profiler"] = report["eager_sharded_round_ms"].pop("profiler")
    report["held"] = (report["sharded_round_ms"]["picks"]
                      == report["eager_sharded_round_ms"]["picks"])
    print("held" if report["held"] else "not held", flush=True)
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
