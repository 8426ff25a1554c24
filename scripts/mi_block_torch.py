#!/usr/bin/env python3
"""The MI scan's block against its working set, and the m = 8 full scans.

Three sections, each a record of the port on the card:

``working_set``: the device-memory peak of one
``select.ital.mi_scores_from_moments`` call against the rows of its block,
for m = 4, 6 and 8 (t = 3, 5, 7) at n_qmc 32, 128, 256 and 512: eager (the
peak of ``torch.cuda.max_memory_allocated`` above what was allocated
before the call) and inside a capture (the MiB the capture's private graph
pool reserved).  Each (m, n_qmc) is measured at a few row counts and
fitted with a line; its slope is the bytes a row, set beside the tree's
node-points a row, (2^m - 2) x n_qmc.  Where a row count's predicted
working set would not fit the card, it is skipped.
``select.ital.mi_block`` takes its byte budget and its bytes a row from
this record.

``selections``: ``full 128`` and ``full 256`` (the full-corpus scan at
n_qmc 128 and 256, no pool) at m = 8 on the reference's mid-session state
(``study_torch.mid_session_state``) at 25 000 and 100 000 rows, graphed and
under ``graphs.eager()``, each at the block ``mi_block`` chooses: the
graphed picks must equal the eager picks, and at every greedy step the
card's pick is held to the CPU's plain path (:func:`replay_contenders`)
up to MI ties of 1e-5.  Each row records the picks, the block of every
greedy step, the device-memory peak, the graph pool's growth at its
capture, the programs released to make room for it, and the seconds of
the first call and of one call.  The selections of a corpus run in one
process, each beside the programs the others left.
``beside_1m``: ``full 128`` at m = 8 in the same way on the mid-session
state of 1 000 000 x 512 rows (``corpus100k``'s generator) while that
session's m = 4 full-scan fetch holds its program, with what the session
held on the card before.

Writes ``results/mi_block_torch.json`` (``--out``).  Run from the
repository root::

    python3 scripts/mi_block_torch.py

``--scales 25000``, ``--scales 100000`` and ``--sections beside_1m`` run one
corpus a process, each adding to the record at ``--out``.  It needs a CUDA card unless ``--device
cpu`` is given (the CPU tests' sizes: ``--n 600 --dim 32``; no memory is
measured there).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

MS = (4, 6, 8)
NQMCS = (32, 128, 256, 512)
ROWS = (1024, 4096, 16384)
FIT_LIMIT = 40 << 30  # a measurement predicted above this many bytes is skipped
# The m = 8 selections: (tag, n_qmc), the rows, and the CPU replay's sizes.
SELECTIONS = (("full 128", 128), ("full 256", 256))
SCALES = (25_000, 100_000)
BESIDE_N = 1_000_000  # the session beside which ``beside_1m`` runs ``full 128``
MI_TIE_ATOL = 1e-5
REPLAY_TOP, REPLAY_SAMPLE = 256, 2048


def moments(torch, device, m: int, rows: int, seed: int = 0):
    """Random posterior-shaped moments of ``rows`` candidates against a
    partial batch of t = m - 1: (mu_c, sig2_c, cross, mu_b, cov_bb)."""
    g = np.random.default_rng(seed)
    t = m - 1
    a = g.normal(size=(m, m + 2)) / np.sqrt(m + 2)
    cov = a @ a.T + 0.2 * np.eye(m)
    as_t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)  # noqa: E731
    return (as_t(g.normal(size=rows) * 0.5), as_t(cov[t, t] + g.uniform(0, 0.1, rows)),
            as_t(cov[t, :t] + g.normal(size=(rows, t)) * 0.05), as_t(g.normal(size=t) * 0.5),
            as_t(cov[:t, :t]))


def predicted_bytes(m: int, n_qmc: int, rows: int) -> int:
    """A generous estimate of one call's working set, used only to skip a
    measurement that would not fit: the tree's last level holds about
    (3 m + 7) x 2^(m - 1) f32 values a QMC point and row."""
    return 2 * (3 * m + 7) * 2 ** (m - 1) * 4 * n_qmc * rows


def measure(torch, device, params, m: int, n_qmc: int, rows: int) -> dict:
    """One call's eager peak and its capture's graph-pool MiB (None off the
    card), and whether the replay equals the eager scores bit for bit."""
    from ital_tpu_torch.select.ital import mi_scores_from_moments

    mu_c, sig2_c, cross, mu_b, cov_bb = moments(torch, device, m, rows)

    def call():
        return mi_scores_from_moments(mu_c, sig2_c, cross, mu_b, cov_bb, params, t=m - 1,
                                      n_qmc=n_qmc, block=rows)

    if device.type != "cuda":
        call()
        return {"rows": rows, "eager_peak_mib": None, "graph_pool_mib": None}
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    eager = call()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # a private pool: what it reserves is this capture's
        out = call()
    pool = torch.cuda.memory_reserved(device) - reserved
    graph.replay()
    torch.cuda.synchronize(device)
    equal = bool(torch.equal(out, eager))
    del graph, out, eager
    torch.cuda.empty_cache()
    return {"rows": rows, "eager_peak_mib": peak / 2**20, "graph_pool_mib": pool / 2**20,
            "replay_equals_eager": equal}


def fit(points: list, key: str) -> dict | None:
    """Least-squares ``bytes = intercept + slope x rows`` over ``points``."""
    pts = [(p["rows"], p[key] * 2**20) for p in points if p.get(key) is not None]
    if len(pts) < 2:
        return None
    r, b = np.asarray(pts, np.float64).T
    slope, intercept = np.polyfit(r, b, 1)
    return {"bytes_per_row": float(slope), "intercept_mib": float(intercept) / 2**20}


def working_set(torch, device, *, ms=MS, nqmcs=NQMCS, rows=ROWS, log=print) -> dict:
    """The ``working_set`` section: ``{m: {n_qmc: {points, eager, graphed,
    node_points_per_row}}}``."""
    from ital_tpu_torch.select.base import StrategyParams

    params = StrategyParams.create(device, label_prob=st.LABEL_PROB, mistake_prob=st.MISTAKE_PROB)
    free = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" else FIT_LIMIT
    out = {}
    for m in ms:
        for n_qmc in nqmcs:
            points = []
            for r in rows:
                if predicted_bytes(m, n_qmc, r) > min(FIT_LIMIT, free // 2):
                    continue
                points.append(measure(torch, device, params, m, n_qmc, r))
                p = points[-1]
                log(f"  m={m} n_qmc={n_qmc} rows={r}: eager peak {p['eager_peak_mib']} MiB, "
                    f"graph pool {p['graph_pool_mib']} MiB")
            out.setdefault(str(m), {})[str(n_qmc)] = {
                "node_points_per_row": (2 ** m - 2) * n_qmc, "points": points,
                "eager": fit(points, "eager_peak_mib"), "graphed": fit(points, "graph_pool_mib")}
    return out


def replay_contenders(torch, state, picks, n_qmc: int, *, top: int = REPLAY_TOP,
                      sample: int = REPLAY_SAMPLE, seed: int = 0) -> list:
    """Hold a full-scan batch ``picks`` of ``state`` (on the card) to the
    CPU's plain path, greedy step by greedy step.

    At step t, with the earlier picks as the partial batch, the card scores
    every candidate (``score_candidates_mi``, at ``mi_block``'s block); the
    CPU scores, from a copy of the state, the card's ``top`` candidates and
    ``sample`` others drawn at random (a full CPU scan of 25 000 rows at
    m = 8 takes minutes).  Returns one row a step: the CPU's best MI among
    them minus the CPU's MI of the pick (``gap``, a tie when <= 1e-5) and
    the largest |card - CPU| over the rows scored on both (``diff``)."""
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.select import ital
    from ital_tpu_torch.select.base import StrategyParams, labeled_mask

    cpu = torch.device("cpu")
    host = gp_mod.state_from_arrays(gp_mod.state_to_arrays(state), cpu)
    on = {dev: StrategyParams.create(dev, label_prob=st.LABEL_PROB,
                                     mistake_prob=st.MISTAKE_PROB) for dev in (state.mu.device, cpu)}
    rng = np.random.default_rng(seed)
    excluded = labeled_mask(state).cpu()
    batch = torch.as_tensor(np.asarray(picks), dtype=torch.int64)
    rows = []
    for t, pick in enumerate(int(p) for p in picks):
        card = ital.score_candidates_mi(state, batch.to(state.mu.device), t,
                                        on[state.mu.device], n_qmc=n_qmc).cpu()
        card = torch.where(excluded, -torch.inf, card)
        eligible = np.flatnonzero(~excluded.numpy())
        best = eligible[np.argsort(-card.numpy()[eligible], kind="stable")[:top]]
        chosen = np.union1d(best, rng.choice(eligible, min(sample, eligible.size), replace=False))
        chosen = np.union1d(chosen, [pick])
        p = on[cpu]
        mu_b, cov_bb, cross = ital._session_moments(gp_mod.stacked_view(host), p,
                                                    batch[None, :t])
        idx = torch.as_tensor(chosen)
        ref = ital.mi_scores_from_moments(host.mu[idx], host.sig2[idx] + p.jitter,
                                          cross[0, idx], mu_b[0], cov_bb[0], p, t=t, n_qmc=n_qmc)
        at = int(np.flatnonzero(chosen == pick)[0])
        rows.append({"step": t, "pick": pick, "scored": int(chosen.size),
                     "gap": float(ref.max() - ref[at]),
                     "diff": float((ref - card[idx]).abs().max())})
        excluded[pick] = True
    return rows


def _run_selection(torch, device, state, params, n_qmc: int, mode) -> dict:
    """Two calls of one m = 8 full scan in ``mode``, beside whatever
    programs the process holds: the picks, the first call's and the second
    call's seconds, the device-memory peak above what was allocated before,
    the graph pool's growth at the program's capture (graphed on the card,
    else None), and the programs released to make room for it
    (``graphs.released_for_room``)."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.select.ital import MAX_MI_BATCH, select_ital

    on_card = device.type == "cuda"
    device = state.mu.device
    released, captures = graphs.released_for_room(), graphs.captures()
    with mode():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device) if on_card else 0
        calls = []
        for _ in range(2):
            st.sync(torch, device)
            t0 = time.perf_counter()
            picks = select_ital(state, MAX_MI_BATCH, None, params, n_qmc=n_qmc)
            st.sync(torch, device)
            calls.append(time.perf_counter() - t0)
    captured = graphs.programs()[-1] if graphs.captures() > captures else None
    return {"picks": picks.tolist(), "first_call_s": calls[0], "call_s": calls[1],
            "peak_mib": ((torch.cuda.max_memory_allocated(device) - base) / 2**20
                         if on_card else None),
            "pool_growth_mib": (captured.pool_bytes / 2**20
                                if on_card and captured is not None else None),
            "released_for_room": graphs.released_for_room() - released}


def selections_at(torch, device, state, *, configs=SELECTIONS,
                  uncounted=contextlib.nullcontext, log=print) -> dict:
    """``{tag: row}`` of the m = 8 full scans ``configs`` (tag, n_qmc) on
    ``state``: each eager, its picks replayed on the CPU (inside
    ``uncounted()``), then each graphed (the eager runs and the replays'
    card scans first, so that no eager working set meets these captured
    pools), with the block of every greedy step and ``held``."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import MAX_MI_BATCH, mi_block

    params = StrategyParams.create(device, label_prob=st.LABEL_PROB, mistake_prob=st.MISTAKE_PROB)
    n = int(state.x.shape[0])
    out = {tag: {"n": n, "m": MAX_MI_BATCH, "n_qmc": n_qmc,
                 "blocks_by_step": [mi_block(t + 1, n_qmc) for t in range(MAX_MI_BATCH)]}
           for tag, n_qmc in configs}
    for mode_name, mode in (("eager", graphs.eager), ("graphed", contextlib.nullcontext)):
        for tag, n_qmc in configs:
            row = out[tag]
            row[mode_name] = r = _run_selection(torch, device, state, params, n_qmc, mode)
            log(f"  {tag} at {n} rows, {mode_name}: picks {r['picks']}, first call "
                f"{r['first_call_s']:.2f} s, a call {r['call_s']:.3f} s, peak {r['peak_mib']} "
                f"MiB, pool growth {r['pool_growth_mib']} MiB, programs released for room "
                f"{r['released_for_room']}")
            if mode_name == "eager":
                with graphs.eager(), uncounted():
                    row["cpu_replay"] = steps = replay_contenders(torch, state, r["picks"], n_qmc)
                row["cpu_held"] = all(s["gap"] <= MI_TIE_ATOL and s["diff"] <= MI_TIE_ATOL
                                      for s in steps)
                log(f"  {tag}: CPU replay gaps {[round(s['gap'], 8) for s in steps]}, largest "
                    f"|card - CPU| {max(s['diff'] for s in steps):.2e} -> "
                    f"{'held' if row['cpu_held'] else 'not held'}")
    for row in out.values():
        row["graphed_equals_eager"] = row["graphed"]["picks"] == row["eager"]["picks"]
        row["held"] = bool(row["graphed_equals_eager"] and row["cpu_held"])
    return out


def selections(torch, device, *, scales=SCALES, n=None, dim=None, log=print) -> dict:
    """The ``selections`` section: ``{n: selections_at(...)}``."""
    from ital_tpu_torch.data import datasets

    out = {}
    for rows in scales if n is None else (n,):
        ds = (datasets.mirflickr() if rows == 25_000 and n is None else
              datasets.corpus100k(n=rows, dim=dim or 512, n_classes=14))
        state = st.mid_session_state(ds, device)
        out[str(ds.n)] = selections_at(torch, device, state, log=log)
        del state
    return out


def beside_session(torch, device, *, n: int = BESIDE_N, dim: int = 512, log=print) -> dict:
    """The ``beside_1m`` section: ``full 128`` at m = 8 on the mid-session
    state of ``n`` rows (``corpus100k``'s generator, as
    ``scripts/scale1m_torch.py``) while that session's production fetch, the
    m = 4 full scan at n_qmc 128, holds its program: what the session holds
    on the card before (allocated MiB, graph pools MiB), then
    :func:`selections_at`'s row."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.data import datasets
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import select_ital

    on_card = device.type == "cuda"
    ds = datasets.corpus100k(n=n, dim=dim)
    state = st.mid_session_state(ds, device)
    params = StrategyParams.create(device, label_prob=st.LABEL_PROB, mistake_prob=st.MISTAKE_PROB)
    fetch = select_ital(state, st.BATCH, None, params, n_qmc=128).tolist()
    st.sync(torch, device)
    held = {"n": ds.n, "fetch_picks": fetch, "programs": len(graphs.programs()),
            "allocated_mib": torch.cuda.memory_allocated(device) / 2**20 if on_card else None,
            "graph_pools_mib": graphs._pool_bytes(state.mu.device) / 2**20 if on_card else None}
    log(f"  session of {ds.n} rows: {held['programs']} programs, allocated "
        f"{held['allocated_mib']} MiB, graph pools {held['graph_pools_mib']} MiB")
    try:
        row = selections_at(torch, device, state, configs=SELECTIONS[:1], log=log)
    except Exception as exc:  # the card ran out of memory even after making room
        if not graphs._out_of_memory(exc):
            raise
        tag = SELECTIONS[0][0]
        row = {tag: {"n": ds.n, "held": False, "error": str(exc).splitlines()[0]}}
        log(f"  {tag} at {ds.n} rows: {row[tag]['error']}")
    return {"session": held, **row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "results", "mi_block_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--sections", default="working_set,selections")
    ap.add_argument("--n", type=int, default=None,
                    help="one corpus of N rows for the selections (the CPU tests' sizes)")
    ap.add_argument("--dim", type=int, default=None, help="with --n, the feature width")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)),
                    help="the working set's row counts")
    ap.add_argument("--scales", default=",".join(map(str, SCALES)),
                    help="the selections' corpus rows; a record at --out gains them")
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    st.record_path(args.out)
    log = lambda s: print(s, flush=True)  # noqa: E731
    report = st.load_record(args.out)
    report.update(platform="gpu" if device.type == "cuda" else "cpu",
                  **st.card_fields(torch, device))
    sections = args.sections.split(",")
    if "working_set" in sections:
        report["working_set"] = working_set(
            torch, device, rows=tuple(int(r) for r in args.rows.split(",")), log=log)
    if "beside_1m" in sections:
        report["beside_1m"] = beside_session(torch, device, n=args.n or BESIDE_N,
                                             dim=args.dim or 512, log=log)
    if "selections" in sections:
        report.setdefault("selections", {}).update(selections(
            torch, device, scales=tuple(int(v) for v in args.scales.split(",")), n=args.n,
            dim=args.dim, log=log))
    if "selections" in sections or "beside_1m" in sections:
        rows = [r for by_tag in report.get("selections", {}).values() for r in by_tag.values()]
        rows += [r for tag, r in report.get("beside_1m", {}).items() if tag != "session"]
        report["held"] = all(r["held"] for r in rows)
        print("held" if report["held"] else "not held", flush=True)
    st.write_record(args.out, report)
    return 0 if report.get("held", True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
