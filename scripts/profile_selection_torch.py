#!/usr/bin/env python3
"""Corroborate how the PyTorch port's selection is timed, on the card.

The port's counterpart of ``scripts/profile_selection.py``, with its
workload and record keys: the ITAL full scan (batch 4, n_qmc 128, cap 64)
on the reference's mid-session state (``study_torch.mid_session_state``)
at the MIRFLICKR-25K surrogate's 25 000 x 512, timed four ways, graphed
and under ``graphs.eager()``:

- ``pipeline_ms_reps8_total`` / ``pipeline_ms_reps32_total``: 8 and 32
  back-to-back calls between one pair of CUDA events (the least of 3
  runs), and ``pipeline_slope_ms_per_call``, their difference over 24;
- ``sync_ms_per_call_median``: a host clock around each call and a
  synchronization (5 calls);
- ``event_ms_per_call_median``: two CUDA events around each of 10
  back-to-back calls;
- ``profiler``: ``torch.profiler``'s device-busy share, device ms and
  device op count of one call (a replayed program, graphed).

The graphed section's keys are the reference's; the eager section's carry
``eager_``.  Held: in each mode the pipeline slope lies within 10 % of the
per-call event median.  The reference's TPU numbers are its own.

Writes ``results/timing_corroboration_torch.json`` (``--out``).  Run from
the repository root::

    python3 scripts/profile_selection_torch.py

It needs a CUDA card unless ``--device cpu`` is given (``--n 1500 --dim
64``: the CPU tests' size; host clocks, no profiler).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

BATCH, N_QMC = 4, 128
SLOPE_RTOL = 0.10


def corroborate(torch, device, call, *, log=print, label: str = "") -> dict:
    """The four readings of ``call`` (one selection) in the current mode,
    keyed as the reference's record, plus ``held``."""
    call()  # the program exists (graphed) and the tables are cached
    lo, hi, slope = st.pipeline_slope(torch, device, call)
    events = st.event_ms(torch, device, call)
    out = {
        "pipeline_ms_reps8_total": lo, "pipeline_ms_reps32_total": hi,
        "pipeline_slope_ms_per_call": slope,
        "sync_ms_per_call_median": statistics.median(st.sync_ms(torch, device, call)),
        "event_ms_per_call_median": statistics.median(events), "event_ms_per_call": events,
        "profiler": st.device_profile(torch, device, call),
    }
    out["slope_over_event_median"] = slope / out["event_ms_per_call_median"]
    out["held"] = bool(abs(out["slope_over_event_median"] - 1.0) <= SLOPE_RTOL)
    log(f"  {label}: slope {slope:.3f} ms a call, event median "
        f"{out['event_ms_per_call_median']:.3f}, sync median "
        f"{out['sync_ms_per_call_median']:.3f}, busy {out['profiler']['busy_share']} -> "
        f"{'held' if out['held'] else 'not held'}")
    return out


def run(torch, device, state, *, log=print) -> dict:
    """``corroborate`` of the full-scan selection, graphed (the reference's
    keys) and eager (``eager_`` keys); ``held`` when both are."""
    from ital_tpu_torch import graphs
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import select_ital

    params = StrategyParams.create(device, label_prob=st.LABEL_PROB, mistake_prob=st.MISTAKE_PROB)

    def call():
        return select_ital(state, BATCH, None, params, n_qmc=N_QMC)

    out = {}
    for prefix, mode in (("", contextlib.nullcontext), ("eager_", graphs.eager)):
        with mode():
            got = corroborate(torch, device, call, log=log, label=prefix.rstrip("_") or "graphed")
        out.update({prefix + k: v for k, v in got.items()})
    out["held"] = bool(out.pop("held") and out.pop("eager_held"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "timing_corroboration_torch.json"))
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
    report = {"platform": "gpu" if device.type == "cuda" else "cpu", "n": ds.n,
              "dim": int(ds.x.shape[1]), "batch": BATCH, "n_qmc": N_QMC, "cap": st.CAP,
              **st.card_fields(torch, device), **run(torch, device, state, log=log),
              "note": "the slope of back-to-back calls between one pair of CUDA events "
                      "against the median of an event pair around each call; the "
                      "profiler's device time of one call"}
    print("held" if report["held"] else "not held", flush=True)
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
