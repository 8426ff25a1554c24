#!/usr/bin/env python3
"""The PyTorch port's timing of the two-stage (coarse base + top-T refined) MI scoring knob.

The port's counterpart of the timing half of ``scripts/refine_study.py``:
the ITAL selection at the MIRFLICKR-25K surrogate's size and at
100 000 x 512 (``--skip-100k`` drops it) for the reference's (base n_qmc x
refinement) matrix, on the reference's mid-session state, each row
``study_torch.time_call`` (first call alone, then CUDA-event-timed calls,
graphed and under ``graphs.eager()``).  The reference's MAP half is the
port's ``results/mirflickr_methods_italkw_torch.json``
(``scripts/method_comparison_torch.py --ital-kwargs
n_qmc=32,refine_top=64,refine_n_qmc=512``).

Writes the ``timing`` section of ``results/refine_study_torch.json``
(``--out`` overrides it; other sections of a port record are kept).  Run
from the repository root::

    python3 scripts/refine_study_torch.py

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

# (base n_qmc, refine_top, refine_n_qmc); refine_top 0 is single-stage.
CONFIGS = (
    (128, 0, 0),
    (64, 0, 0),
    (64, 64, 512),
    (32, 64, 512),
)
SMOKE_ROW = "32+top64@512"  # the row chip_smoke.py times


def tag(base: int, rt: int, rq: int) -> str:
    """The reference's row name: ``128`` or ``32+top64@512``."""
    return f"{base}" if not rt else f"{base}+top{rt}@{rq}"


def timing_rows() -> list:
    """``(tag, select_ital options)`` of each timing row."""
    return [(tag(b, t, q), {"n_qmc": b, "refine_top": t, "refine_n_qmc": q or 512})
            for b, t, q in CONFIGS]


def run_timing(torch, device, card: dict, args, log=print) -> dict:
    report = {"platform": "gpu" if device.type == "cuda" else "cpu", "batch": st.BATCH,
              "protocol": PROTOCOL, **card}
    for name, ds in st.scale_datasets(args.skip_100k, n_25k=args.n, n_100k=args.n,
                                      dim=args.dim):
        log(f"== timing: {name} ({ds.n} x {ds.x.shape[1]})")
        state = st.mid_session_state(ds, device)
        report[name] = {"n": ds.n, "dim": int(ds.x.shape[1]),
                        "configs": st.time_selects(torch, device, state, timing_rows(), log=log,
                                                   label=name)}
        del state
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-100k", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "refine_study_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=None,
                    help="cut both corpora to N rows (the CPU tests' sizes)")
    ap.add_argument("--dim", type=int, default=None, help="with --n, the feature width")
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    report = st.load_record(args.out)
    report["timing"] = run_timing(torch, device, st.card_fields(torch, device), args,
                                  lambda s: print(s, flush=True))
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
