#!/usr/bin/env python3
"""Does the port's full-scan MAP depend on which row wins an exact MI tie?

ITAL's greedy argmax takes the lowest row index among exactly equal MI
values, as the reference's ``jnp.argmax`` does.  The port's MI ties exactly
where the reference's differs by a rounding residual
(``results/full_scan_partings_torch.json``), so in the MIRFLICKR
surrogate's own row order the port takes the same lowest tied row at the
first greedy step of every session.  This study runs
``pool_refine_torch``'s ``full 128`` MAP half (14 topic sessions in fused
cohorts of 7, the reference's user draws) on the same corpus with its rows
in other orders: order 0 is the corpus's own, order r > 0 the permutation
``numpy.random.default_rng(r).permutation(N)``, each session's query and
user draws carried to the query's new row.  A row's features, relevance
and query draws move with it, so an order changes which row comes first in
a tie and nothing else the run is given; the spread of the final MAP over
orders is what tie-breaking alone moves.  ``--phi f32`` runs the same
with the normal CDF of the QMC chain taken as an f32 erfc, the reference's
own order of operations, in place of the port's erfc in f64 rounded once
to f32 (``ops/mvn.py::norm_cdf``), which makes the exact ties.

Each order is paired seed by seed with the reference's ``full 128``
records, ``results/pool_refine_map_cpu.json`` (CPU) and
``results/pool_refine.json`` (TPU), by ``compare_records_torch.interval``;
``over_orders`` pairs the mean final over the orders at each seed, which
averages the tie-breaking out, with both.  Writes
``results/tie_order_torch.json`` (``--out``).  Run from the repository
root::

    python3 scripts/tie_order_study_torch.py --orders 0-3 --seeds 0-7 \\
        --user-draws results/jax_user_draws_mirflickr_s0-7_torch.npz

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402
from compare_records_torch import interval  # noqa: E402
from pool_refine_torch import MAP_CONFIGS, method_overrides  # noqa: E402

REFERENCES = {"cpu": "pool_refine_map_cpu.json", "tpu": "pool_refine.json"}


def f32_norm_cdf(x, *, eps: float = 1e-6):
    """``ops/mvn.py::norm_cdf`` as the reference computes it: an erfc in
    ``x``'s own dtype, clamped to ``[eps, 1 - eps]``."""
    import torch

    p = 0.5 * torch.special.erfc(-x * (1.0 / math.sqrt(2.0)))
    return torch.clamp(p, eps, 1.0 - eps)


@contextlib.contextmanager
def phi(kind: str):
    """Inside the block the QMC chain's normal CDF is the port's own
    (``f64``) or :func:`f32_norm_cdf` (``f32``)."""
    from ital_tpu_torch.ops import mvn

    own = mvn.norm_cdf
    mvn.norm_cdf = {"f64": own, "f32": f32_norm_cdf}[kind]
    try:
        yield
    finally:
        mvn.norm_cdf = own


def row_order(n: int, order: int) -> np.ndarray:
    """The corpus's rows in order ``order``: new row i holds old row
    ``perm[i]`` (order 0 the identity)."""
    return np.arange(n) if order == 0 else np.random.default_rng(order).permutation(n)


def permuted(data, perm: np.ndarray):
    """``data`` with its rows in the order ``perm``; its queries are the
    same old rows, at their new positions (the same draws of the seed's
    generator pick them)."""
    inv = np.argsort(perm)

    class Permuted(type(data)):
        def queries_for_class(self, c, rng, k):
            return inv[data.queries_for_class(c, rng, k)]

    fields = {f.name: getattr(data, f.name) for f in dataclasses.fields(data)}
    fields.update(x=np.ascontiguousarray(data.x[perm]), labels=data.labels[perm],
                  relevance=np.ascontiguousarray(data.relevance[perm]))
    return Permuted(**fields)


def moved_draws(path: str, perm: np.ndarray, out: str) -> str:
    """The draws file at ``path`` with each session's query moved to its row
    in the order ``perm``, written to ``out``."""
    inv = np.argsort(perm)
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    sessions = arrays["sessions"].copy()
    sessions[:, 3] = inv[sessions[:, 3]]
    np.savez(out, **dict(arrays, sessions=sessions))
    return out


def run_order(order: int, seeds, *, device, data, card: dict, draws_path: str,
              log=print) -> dict:
    """``full 128``'s MAP entry (``study_torch.map_runs``) with the corpus in
    order ``order``, plus the first picks of each seed's sessions as rows of
    the corpus's own order and the most frequent of them."""
    tag, *full = MAP_CONFIGS[0]
    perm = row_order(data.n, order)
    picks: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        moved = moved_draws(draws_path, perm, os.path.join(tmp, os.path.basename(draws_path)))
        entry = st.map_runs([(tag, method_overrides(*full))], seeds, heavy=False,
                            device=device, data=permuted(data, perm), card=card,
                            draws_path=moved, picks=picks, log=log)[tag]
    first = {s: perm[np.asarray(p)[:, 0, 0]].tolist() for s, p in picks[tag].items()}
    common = collections.Counter(r for rows in first.values() for r in rows).most_common(1)
    return dict(entry, order=order, first_picks_by_seed=first,
                most_frequent_first_pick=list(common[0]) if common else None)


def reference_finals() -> dict:
    """``{name: {seed: final MAP}}`` of ``full 128`` in each of ``REFERENCES``."""
    out = {}
    for name, record in REFERENCES.items():
        with open(os.path.join(REPO, "results", record)) as fh:
            entry = json.load(fh)["map"][MAP_CONFIGS[0][0]]
        out[name] = dict(zip(entry["seeds"], entry["final_map_by_seed"]))
    return out


def paired(finals: dict, ref: dict) -> dict:
    """``finals`` ({seed: final}) - ``ref`` at the seeds both hold: the
    mean, its 95 % t-interval, the seeds and whether it holds 0."""
    seeds = [s for s in finals if s in ref]
    delta = interval([finals[s] - ref[s] for s in seeds])
    held = None if delta["lo"] is None else bool(delta["lo"] <= 0.0 <= delta["hi"])
    return dict(delta, seeds=seeds, held=held)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--orders", default="0-3",
                    help="row orders as 0,1,2 or 0-3 (0: the corpus's own)")
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7", help="seeds as 0,1,2 or 0-7")
    ap.add_argument("--user-draws", required=True,
                    help="the reference's user draws (.npz of scripts/jax_reference.py draws)")
    ap.add_argument("--phi", choices=("f64", "f32"), default="f64",
                    help="the QMC chain's normal CDF: the port's (f64, rounded) or an f32 erfc")
    ap.add_argument("--out", default=None,
                    help="default results/tie_order_torch.json (tie_order_phi32_torch.json "
                         "with --phi f32)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=None,
                    help="cut the corpus to N rows (the CPU tests' sizes)")
    ap.add_argument("--dim", type=int, default=None, help="with --n, the feature width")
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    out = args.out or os.path.join(REPO, "results", "tie_order_torch.json" if args.phi == "f64"
                                   else "tie_order_phi32_torch.json")
    st.record_path(out)
    log = lambda s: print(s, flush=True)  # noqa: E731
    (_, data), = st.scale_datasets(True, n_25k=args.n, dim=args.dim)
    seeds = st.parse_seeds(args.seeds)
    refs = reference_finals()
    report = {"config": MAP_CONFIGS[0][0], "phi": args.phi, "references": REFERENCES,
              "n": data.n, **st.card_fields(torch, device), "orders": {}}
    for order in st.parse_seeds(args.orders):
        log(f"== order {order}")
        with phi(args.phi):
            entry = run_order(order, seeds, device=device, data=data, card={},
                              draws_path=args.user_draws, log=log)
        finals = dict(zip(seeds, entry["final_map_by_seed"]))
        entry["paired_with"] = {name: paired(finals, ref) for name, ref in refs.items()}
        log(f"  order {order}: final {np.mean(entry['final_map_by_seed']):.4f}; " + "; ".join(
            f"to {name} {p['mean']:+.4f} [{p['lo']}, {p['hi']}]"
            for name, p in entry["paired_with"].items())
            + f"; most frequent first pick {entry['most_frequent_first_pick']}")
        report["orders"][str(order)] = entry
    orders = report["orders"].values()
    mean = {s: float(np.mean([o["final_map_by_seed"][i] for o in orders]))
            for i, s in enumerate(seeds)}
    report["over_orders"] = {
        "final_mean_by_order": {k: float(np.mean(o["final_map_by_seed"]))
                                for k, o in report["orders"].items()},
        "final_map_by_seed": [mean[s] for s in seeds],
        "paired_with": {name: paired(mean, ref) for name, ref in refs.items()},
        "orders_held": {name: sum(bool(o["paired_with"][name]["held"]) for o in orders)
                        for name in refs},
    }
    log(f"over {len(report['orders'])} orders: " + json.dumps(report["over_orders"]))
    st.write_record(out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
