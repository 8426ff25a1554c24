#!/usr/bin/env python3
"""Pair a record of the port with a reference record, seed by seed.

Both packages draw each seed's queries from ``default_rng(seed)``, so seed
``s`` of a port record and seed ``s`` of a reference record run the same
query sessions; the users' and the strategies' draws differ, so the
comparison is statistical.  For each method both records hold (or the one
entry of each, as with ``--ref-key map/32+top64@512`` of
``results/refine_study.json``), over the seeds they share:

* the mean paired delta (port - reference) of the final MAP and of the
  mean MAP over rounds, each with its 95 % t-interval and n (the mean over
  rounds needs both records' per-seed curves);
* ``held``: the final-MAP interval contains 0;
* the first round whose paired delta's interval excludes 0, if any;
* whether the reference record's ordering of the methods by mean final MAP
  holds in the port's record.

Reads ``map_by_seed`` (or ``final_map_by_seed`` with ``seeds``) from a
method comparison's per-method entries or from one scenario record.  Prints
a line per method; ``--json`` also writes the numbers.  Run from the
repository root::

    python3 scripts/compare_records_torch.py results/mirflickr_methods_torch.json \\
        results/mirflickr_methods.json
    python3 scripts/compare_records_torch.py results/mirflickr_methods_italkw_torch.json \\
        results/refine_study.json --ref-key map/32+top64@512
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


def entries(record: dict, key: str | None = None) -> dict:
    """``{name: entry}`` of a record: the entry at ``key`` (``a/b`` path),
    the record itself when it is one entry, else its per-method entries."""
    if key:
        for part in key.split("/"):
            record = record[part]
        return {key.split("/")[-1]: record}
    if "map_by_seed" in record or "final_map_by_seed" in record:
        return {record.get("method", "entry"): record}
    return {name: e for name, e in record.items()
            if isinstance(e, dict) and ("map_by_seed" in e or "final_map_by_seed" in e)}


def curves(entry: dict) -> dict:
    """``{seed: curve}``, or ``{seed: [final]}`` when only finals are kept."""
    if "map_by_seed" in entry:
        return {int(s): list(c) for s, c in entry["map_by_seed"].items()}
    return {int(s): [f] for s, f in zip(entry["seeds"], entry["final_map_by_seed"])}


def interval(deltas) -> dict:
    """Mean, its 95 % t-interval (None for n < 2) and n of ``deltas``."""
    from scipy import stats

    d = np.asarray(deltas, np.float64)
    n = int(d.size)
    out = {"n": n, "mean": float(d.mean()) if n else None, "lo": None, "hi": None}
    if n >= 2:
        half = float(stats.t.ppf(0.975, n - 1) * d.std(ddof=1) / math.sqrt(n))
        out.update(lo=out["mean"] - half, hi=out["mean"] + half)
    return out


def pair(port: dict, ref: dict) -> dict:
    """The paired deltas of one method over the seeds both entries hold."""
    a, b = curves(port), curves(ref)
    seeds = sorted(set(a) & set(b))
    final = interval([a[s][-1] - b[s][-1] for s in seeds])
    full = all(len(a[s]) > 1 and len(a[s]) == len(b[s]) for s in seeds)
    mean = interval([np.mean(a[s]) - np.mean(b[s]) for s in seeds]) if full and seeds else None
    parting = None
    if full and seeds and len(seeds) >= 2:
        for r in range(len(a[seeds[0]])):
            i = interval([a[s][r] - b[s][r] for s in seeds])
            if not i["lo"] <= 0.0 <= i["hi"]:
                parting = r
                break
    held = None if final["lo"] is None else bool(final["lo"] <= 0.0 <= final["hi"])
    return {"seeds": seeds, "final": final, "mean_map": mean, "held": held,
            "first_parting_round": parting,
            "port_final_mean": float(np.mean([a[s][-1] for s in seeds])) if seeds else None,
            "ref_final_mean": float(np.mean([b[s][-1] for s in seeds])) if seeds else None}


def compare(port: dict, ref: dict, *, ref_key: str | None = None,
            methods: list | None = None) -> dict:
    """Every method's :func:`pair` and the ordering check."""
    p, r = entries(port), entries(ref, ref_key)
    if methods:
        p = {m: e for m, e in p.items() if m in methods}
        r = r if ref_key else {m: e for m, e in r.items() if m in methods}
    if len(p) == 1 and len(r) == 1:
        (pm, pe), (_, re_) = next(iter(p.items())), next(iter(r.items()))
        pairs = {pm: pair(pe, re_)}
    else:
        pairs = {m: pair(p[m], r[m]) for m in p if m in r}
    order = {}
    if len(pairs) > 1:
        ref_order = sorted(pairs, key=lambda m: -pairs[m]["ref_final_mean"])
        port_order = sorted(pairs, key=lambda m: -pairs[m]["port_final_mean"])
        order = {"reference": ref_order, "port": port_order,
                 "holds": ref_order == port_order}
    return {"pairs": pairs, "ordering": order}


def _fmt(i: dict | None) -> str:
    if i is None:
        return "n/a"
    if i["lo"] is None:
        return f"{i['mean']:+.4f} (n={i['n']})"
    return f"{i['mean']:+.4f} [{i['lo']:+.4f}, {i['hi']:+.4f}] (n={i['n']})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port", help="the port's record")
    ap.add_argument("ref", help="the reference record (or another port record)")
    ap.add_argument("--ref-key", default=None,
                    help="a/b path to the reference's one entry (e.g. map/32+top64@512)")
    ap.add_argument("--methods", default="", help="comma-separated methods to pair")
    ap.add_argument("--json", default=None, help="also write the numbers here")
    args = ap.parse_args(argv)
    with open(args.port) as fh:
        port = json.load(fh)
    with open(args.ref) as fh:
        ref = json.load(fh)
    out = compare(port, ref, ref_key=args.ref_key,
                  methods=[m for m in args.methods.split(",") if m] or None)
    out.update(port_record=args.port, ref_record=args.ref, ref_key=args.ref_key)
    for m, p in out["pairs"].items():
        print(f"{m}: final MAP port {p['port_final_mean']:.4f} ref {p['ref_final_mean']:.4f}, "
              f"paired delta {_fmt(p['final'])}, mean MAP delta {_fmt(p['mean_map'])}, "
              f"held {p['held']}, first parting round {p['first_parting_round']}")
    if out["ordering"]:
        print(f"ordering: reference {out['ordering']['reference']}, port "
              f"{out['ordering']['port']}, holds {out['ordering']['holds']}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
