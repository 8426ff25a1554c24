#!/usr/bin/env python3
"""The PyTorch port's sweep of the MI scan's candidate block (``block``).

The port's counterpart of ``scripts/block_sweep.py``, with its
configurations and record keys: the ITAL selection on the reference's
mid-session state at the MIRFLICKR-25K surrogate's size (the reference's
``bench`` state of record: the same ``default_rng(7)`` history), for the
production pool config (``pool4096_refine``: pool 4096, base n_qmc 32, the
top 64 re-scored at 512) and the full-scan two-stage config
(``fullscan_refine``), at the reference's blocks 512, 1024, 2048 and 4096
and at 8192 and the port's default ``select.ital.MI_BLOCK`` (32768).  Each
row is ``study_torch.time_call`` (first call alone, then CUDA-event-timed
calls, graphed and under ``graphs.eager()``); its per-call ms is
``ms_per_round`` where the reference's pipeline slope was ``slope_ms``.
Scores do not depend on the block beyond float associativity, so this is a
measurement of cost alone.  ``preferred`` names each config's fastest
block, graphed; the record changes no default.

Writes ``results/block_sweep_torch.json`` (``--out``).  Run from the
repository root::

    python3 scripts/block_sweep_torch.py

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402
from pool_refine_torch import PROTOCOL  # noqa: E402

BLOCKS = (512, 1024, 2048, 4096, 8192, 32768)
REFINE = {"n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512}
CONFIGS = (
    ("pool4096_refine", dict(REFINE, pool_size=4096)),
    ("fullscan_refine", REFINE),
)
SMOKE_ROW = ("fullscan_refine", "8192")  # the (config, block) chip_smoke.py times


def timing_rows(config: str) -> list:
    """``(block, select_ital options)`` of each of ``config``'s rows."""
    return [(str(b), dict(dict(CONFIGS)[config], block=b)) for b in BLOCKS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "results", "block_sweep_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=None,
                    help="cut the corpus to N rows (the CPU tests' sizes)")
    ap.add_argument("--dim", type=int, default=None, help="with --n, the feature width")
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    st.record_path(args.out)
    log = lambda s: print(s, flush=True)  # noqa: E731
    (_, ds), = st.scale_datasets(True, n_25k=args.n, dim=args.dim)
    state = st.mid_session_state(ds, device)
    report = {"platform": "gpu" if device.type == "cuda" else "cpu",
              "workload": f"the reference's mid-session state ({ds.n} x {ds.x.shape[1]}, b=4)",
              "protocol": PROTOCOL, **st.card_fields(torch, device), "configs": {},
              "preferred": {}}
    for tag, _ in CONFIGS:
        rows = st.time_selects(torch, device, state, timing_rows(tag), log=log, label=tag)
        report["configs"][tag] = rows
        report["preferred"][tag] = int(min(rows, key=lambda b: rows[b]["ms_per_round"]))
        log(f"  {tag}: fastest at block {report['preferred'][tag]}")
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
