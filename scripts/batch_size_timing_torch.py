#!/usr/bin/env python3
"""The PyTorch port's selection cost against the MI batch size m.

The port's counterpart of ``scripts/batch_size_timing.py``, with its
configurations and record keys: a full greedy ITAL selection at m = 4, 6
and 8 (the port's ``MAX_MI_BATCH`` is 8) at the MIRFLICKR-25K surrogate's
size for

- ``full 128``: the full-corpus scan at n_qmc 128;
- ``full 256``: the same at n_qmc 256;
- ``pool4096 32+top64@512``: the production combination;

on the reference's mid-session state (the reference builds it through
``bench.build_state``: the same ``default_rng(7)`` history), each row
``study_torch.time_call`` (first call alone, then CUDA-event-timed calls,
graphed and under ``graphs.eager()``).  Step t of the greedy loop scores
2^(t+1) orthants, so the cost grows about 2^m, and so does the MI scan's
working set; its default block (``select.ital.mi_block``, recorded per
greedy step under ``mi_blocks``) keeps that within a fixed budget.  A row that
runs out of device memory (in its eager warm-up or in its capture) records
the error as its result.  Each row's programs are released after it, so
every row is measured with the card's memory to itself.

Writes ``results/batch_size_timing_torch.json`` (``--out``); the reference
has no record to compare with.  ``--batch-sizes 8`` times m = 8 alone, in a
process that has captured no other program.  Run from the repository
root::

    python3 scripts/batch_size_timing_torch.py

It needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402
from pool_refine_torch import PROTOCOL, select_kwargs  # noqa: E402

BATCH_SIZES = (4, 6, 8)
# (tag, pool_size, base n_qmc, refine_top, refine_n_qmc)
CONFIGS = (
    ("full 128", 0, 128, 0, 0),
    ("full 256", 0, 256, 0, 0),
    ("pool4096 32+top64@512", 4096, 32, 64, 512),
)
SMOKE_ROW = (6, "pool4096 32+top64@512")  # the (m, tag) chip_smoke.py times


def timing_rows(m: int) -> list:
    """``(tag, select_ital options)`` of each row at MI batch size ``m``."""
    return [(tag, dict(select_kwargs(*c), batch_size=m)) for tag, *c in CONFIGS]


def time_row(torch, device, state, tag: str, kwargs: dict, log) -> dict:
    """One row's :func:`study_torch.time_selects` entry, or its error when
    the device runs out of memory."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.select.ital import mi_block

    m = kwargs["batch_size"]
    try:
        return st.time_selects(torch, device, state, [(tag, kwargs)], log=log,
                               label=f"m={m}")[tag]
    except (torch.cuda.OutOfMemoryError, graphs.CaptureError) as exc:
        # Out of memory in the eager warm-up, or in the capture after it.
        if not isinstance(exc.__cause__ or exc, torch.cuda.OutOfMemoryError):
            raise
        torch.cuda.empty_cache()
        block = mi_block(m, kwargs["n_qmc"])  # the last greedy step's, the largest tree's
        log(f"  m={m} {tag}: out of memory at block {block}")
        return {"error": f"out of memory at block {block}: {str(exc).splitlines()[0]}"}


def mi_blocks(m: int) -> dict:
    """``{tag: [block of each greedy step]}``: the base scan's default block
    (``select.ital.mi_block``) of each row at MI batch size ``m``."""
    from ital_tpu_torch.select.ital import mi_block

    return {tag: [mi_block(t + 1, kwargs["n_qmc"]) for t in range(m)]
            for tag, kwargs in timing_rows(m)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "batch_size_timing_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--batch-sizes", default=",".join(map(str, BATCH_SIZES)))
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
    report = {"platform": "gpu" if device.type == "cuda" else "cpu", "n": ds.n,
              "dim": int(ds.x.shape[1]), "protocol": PROTOCOL,
              **st.card_fields(torch, device), "rows": {}, "mi_blocks": {}}
    for m in (int(v) for v in args.batch_sizes.split(",")):
        report["mi_blocks"][f"m{m}"] = mi_blocks(m)
        report["rows"][f"m{m}"] = {tag: time_row(torch, device, state, tag, kwargs, log)
                                   for tag, kwargs in timing_rows(m)}
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
