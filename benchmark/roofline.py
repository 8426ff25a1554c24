"""The yardstick of the RBF kernels: the card's peaks, a block's least time,
and the blocks each call into the service launches.

``rbf_bound_ms`` is a frozen copy of ``chip_smoke.py``'s (with the published
peaks of one NVIDIA H100 SXM, dense rates, at its full 700 W).

The launch tables describe the port: which RBF blocks one call of a kind
launches.  A call kind's table is ``benchmark/launches/<strategy>.<kind>.json``
where the configuration's strategy shapes it (the selections), else
``benchmark/launches/<kind>.json`` (session starts and updates: the GP's).
Each entry is one block, ``{"m": [factor, ...], "n": [factor, ...]}``, its
extents the products of sizes named N (corpus rows), D (width), C
(labeled-slot capacity), P (pool), B (batch), K (sessions of the call) and t
(the greedy step), or whole numbers; with ``"steps": true`` one block per
step t = 1 .. B - 1, ``"same": true`` where b is a's rows, ``"norms": true``
where b is the corpus with its cached norms.
"""

from __future__ import annotations

import collections
import json
import os

HBM_BYTES_PER_S = 3.35e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12


def rbf_bound_ms(m: int, n: int, d: int, bf16: bool, norms: int,
                 same: bool = False) -> tuple[float, str]:
    """The least time the card could take for one (M, N, D) RBF block, and
    which of bytes and operations sets it.

    Bytes: a and b read once (once in all where ``same``: b is a's rows, as
    in a labeled set's own block K(xl, xl)), the ``norms`` given f32 norm
    vectors (their entries) read once, the f32 output written once.
    Operations: the 2 M N D of the product, three times over in TF32 for f32
    inputs (3xTF32), once in bf16 for a bf16 corpus.
    """
    item = 2 if bf16 else 4
    nbytes = (m if same else m + n) * d * item + 4 * norms + 4 * m * n
    ops = 2.0 * m * n * d * (1 if bf16 else 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sizes_of(cfg: dict) -> dict:
    """The named sizes of a configuration's blocks."""
    return {"N": int(cfg["corpus"]["n"]), "D": int(cfg["corpus"]["dim"]),
            "C": int(cfg["gp"]["cap"]), "P": int(cfg["selection"].get("pool_size", 0)),
            "B": int(cfg["selection"]["batch"])}


def launch_table(kind: str, strategy: str, root: str):
    """The entries of a call kind's table, or None where it has none."""
    folder = os.path.join(root, "benchmark", "launches")
    for name in (f"{strategy}.{kind}.json", f"{kind}.json"):
        path = os.path.join(folder, name)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    return None


def _extent(factors: list, env: dict) -> int:
    out = 1
    for f in factors:
        out *= f if isinstance(f, int) else env[f]
    return out


def blocks(calls: list, sizes: dict, strategy: str, root: str):
    """Launch count of each block ``(m, n, same, norms)`` over ``calls``
    (``(kind, sessions, captured)``; a call that captured a program launched
    its blocks twice, in the capture's warm-up and in its replay), or None
    where a call's kind has no table."""
    out = collections.Counter()
    tables = {}
    for kind, k, captured in calls:
        if kind not in tables:
            tables[kind] = launch_table(kind, strategy, root)
        if tables[kind] is None:
            return None
        for entry in tables[kind]:
            for t in (range(1, sizes["B"]) if entry.get("steps") else [0]):
                env = {**sizes, "K": k, "t": t}
                key = (_extent(entry["m"], env), _extent(entry["n"], env),
                       bool(entry.get("same")), bool(entry.get("norms")))
                out[key] += 1 + captured
    return out
