#!/usr/bin/env python3
"""The learned-hyperparameter trajectory of the PyTorch port's serial runner.

The port's counterpart of ``results/hyperopt_trajectory.jsonl``
(``docs/NOISE_ANALYSIS.md`` Finding 4): the serial runner's per-round log
(``ital_tpu_torch.runner.run_experiment`` with ``EXPERIMENT.log_jsonl``) on
``configs/mirflickr.ini`` at the record's settings (:data:`OVERRIDES`: seed
0, the first three classes, whose queries are the record's 20900, 16292 and
12802; the heavy-noise user, label_prob 0.6 and mistake_prob 0.15; GP noise
1.0; a re-learn every 2 rounds), the simulated user drawing the reference's
uniforms (``--user-draws``, ``scripts/jax_reference.py draws``).

Each line has the runner's keys plus ``batch`` (the round's picks) and
``hyper_raw`` (the learned length scale, variance and noise unrounded).
With ``--reference`` (the reference's own serial run on the same draws,
``scripts/jax_reference.py trajectory``, which logs the same two keys) it
holds the port to it: per session, up to the first round whose picks part,
each round's AP and learned (length scale, variance, noise) within
``RTOL`` (1e-3) relative, and the labeled count equal; at that round the
port's MI of both picks at the parting greedy step, on the state both
packages shared, must lie within ``MI_TIE`` (1e-5): the packages part at an
MI tie.  Past the parting round the rows are reported, not held; a session
that parts in its first round compared nothing and is ``not decided``.  Then the
forced replay (``<out>`` with ``_forced_torch`` for ``_torch``): the same run
with each round's selection replaced by the reference's picks, so that the
simulated user, the updates, the re-learns and the AP of every round are
held to the reference's within ``RTOL`` with no tie in the way.  The
verdicts (``verdict`` of the free run, ``forced.verdict``, and ``overall``:
``not held`` if either is, else ``held`` if either holds a round, else
``not decided``) go to ``<out>`` with ``.summary.json`` in place of
``.jsonl``.

Run from the repository root::

    python3 scripts/jax_reference.py trajectory \\
        --out results/hyperopt_trajectory_reference_cpu_torch.jsonl
    python3 scripts/hyperopt_trajectory_torch.py \\
        --reference results/hyperopt_trajectory_reference_cpu_torch.jsonl

It needs a CUDA card unless ``--device cpu`` is given.  Trailing
``SECTION.key=value`` overrides come after :data:`OVERRIDES` (the CPU tests
cut the corpus and the rounds).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

OVERRIDES = ("EXPERIMENT.seed=0", "EXPERIMENT.max_classes=3", "USER.label_prob=0.6",
             "USER.mistake_prob=0.15", "GP.noise=1.0", "GP.learn_every=2")
CONFIG = st.MIRFLICKR
DRAWS = os.path.join(REPO, "results", "jax_user_draws_mirflickr_s0-7_torch.npz")
RTOL = 1e-3
MI_TIE = 1e-5


def read_jsonl(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def run(config: str, overrides: tuple, out: str, *, device, draws: str | None,
        reference: list | None = None, forced: bool = False) -> list:
    """The port's serial run of ``config`` at :data:`OVERRIDES` plus
    ``overrides``, its log written to ``out`` with each line's ``batch`` and
    ``hyper_raw``; where ``reference`` (the reference's lines) is given, the
    first round whose picks part from it also gets ``parting``: the greedy
    step, both picks and the port's MI gap between them there.  ``forced``:
    each round shows the reference's picks instead of selecting."""
    import torch

    from ital_tpu_torch import runner
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.select.ital import score_candidates_mi
    from ital_tpu_torch.utils.config import load_config

    cfg = load_config(config, OVERRIDES + tuple(overrides) + (f"EXPERIMENT.log_jsonl={out}",))
    data = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    if os.path.exists(out):
        os.remove(out)  # the runner's logger appends
    calls, parted = [], set()
    own_strategy, own_fields = runner.get_strategy, runner._hyper_log_fields
    n_qmc = cfg.method_kwargs.get("n_qmc", 128)

    def strategy(name):
        select = own_strategy(name)

        def recorded(state, batch_size, generator, params, **kw):
            k = len(calls)
            batch = (torch.tensor(reference[k]["batch"], device=state.idx.device) if forced
                     else select(state, batch_size, generator, params, **kw))
            session, rnd = divmod(k, cfg.n_rounds)
            calls.append({"batch": batch.tolist()})
            theirs = reference[k]["batch"] if reference and k < len(reference) else None
            if theirs is not None and theirs != calls[-1]["batch"] and session not in parted:
                parted.add(session)
                t = next(j for j, (a, b) in enumerate(zip(calls[-1]["batch"], theirs)) if a != b)
                mi = score_candidates_mi(state, batch, t, params, n_qmc=n_qmc)
                port, ref = calls[-1]["batch"][t], theirs[t]
                calls[-1]["parting"] = {"round": rnd, "t": t, "port_pick": port,
                                        "reference_pick": ref,
                                        "mi": [float(mi[port]), float(mi[ref])],
                                        "mi_gap": float(mi[port] - mi[ref])}
            return batch

        return recorded

    def fields(state, cfg_):
        h = state.hyper
        return {**own_fields(state, cfg_), **calls[-1],
                "hyper_raw": [float(h.length_scale), float(h.var), float(h.noise)]}

    runner.get_strategy, runner._hyper_log_fields = strategy, fields
    try:
        with (st.user_draws(draws, st.sessions_needed(lambda s: cfg, [cfg.seed], data))
              if draws else contextlib.nullcontext()):
            runner.run_experiment(cfg, data, device=device)
    finally:
        runner.get_strategy, runner._hyper_log_fields = own_strategy, own_fields
    return read_jsonl(out)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= RTOL * max(abs(a), abs(b))


def hold(port: list, ref: list) -> dict:
    """The verdict of the port's lines against the reference's, session by
    session (lines keyed by rep, cls, query, round)."""
    key = lambda r: (r["rep"], r["cls"], r["query"])  # noqa: E731
    sessions = {}
    for r in ref:
        sessions.setdefault(key(r), {})[r["round"]] = r
    out = {"sessions": [], "rtol": RTOL, "mi_tie": MI_TIE}
    for k in dict.fromkeys(key(r) for r in port):
        rows = sorted((r for r in port if key(r) == k), key=lambda r: r["round"])
        theirs = sessions.get(k, {})
        s = {"rep_cls_query": list(k), "rounds_held": 0, "parting_round": None,
             "parting": None, "worst_rel": 0.0, "verdict": "held"}
        for r in rows:
            other = theirs.get(r["round"])
            if other is None:
                s["verdict"] = "not held"
                break
            if r["batch"] != other["batch"]:
                s["parting_round"] = r["round"]
                s["parting"] = r.get("parting")
                tie = bool(s["parting"] and abs(s["parting"]["mi_gap"]) <= MI_TIE)
                s["verdict"] = ("not held" if not tie else
                                "not decided" if s["rounds_held"] == 0 else "held")
                break
            pairs = [(r["ap"], other["ap"])] + list(zip(r["hyper_raw"], other["hyper_raw"]))
            rel = max(abs(a - b) / max(abs(a), abs(b), 1e-30) for a, b in pairs)
            s["worst_rel"] = max(s["worst_rel"], rel)
            if not all(_close(a, b) for a, b in pairs) or r["labeled"] != other["labeled"]:
                s["verdict"] = "not held"
                break
            s["rounds_held"] += 1
        s["held"] = s["verdict"] == "held"
        out["sessions"].append(s)
    out["verdict"] = _combine([s["verdict"] for s in out["sessions"]])
    out["held"] = out["verdict"] == "held"
    return out


def _combine(verdicts: list) -> str:
    """``not held`` if any is; ``not decided`` if none compared a round (a
    session that parts at an MI tie in its first round holds nothing); else
    ``held``."""
    if not verdicts or "not held" in verdicts:
        return "not held"
    return "held" if "held" in verdicts else "not decided"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--user-draws", default=DRAWS,
                    help="the reference's user draws (scripts/jax_reference.py draws)")
    ap.add_argument("--reference", default=None,
                    help="the reference's serial run (scripts/jax_reference.py trajectory)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "hyperopt_trajectory_torch.jsonl"))
    ap.add_argument("overrides", nargs="*", help="SECTION.key=value after OVERRIDES")
    args = ap.parse_args(argv)
    import torch

    dev = st.open_device(torch, args.device)
    st.record_path(args.out)
    ref = read_jsonl(args.reference) if args.reference else None
    lines = run(args.config, tuple(args.overrides), args.out, device=dev,
                draws=args.user_draws or None, reference=ref)
    for r in lines:
        print(f"cls {r['cls']} query {r['query']} round {r['round']}: AP {r['ap']:.4f}, "
              f"ls {r['length_scale']}, var {r['gp_var']}, noise {r['gp_noise']}, "
              f"labeled {r['labeled']}, batch {r['batch']}", flush=True)
    summary = {"config": os.path.relpath(args.config, REPO), "overrides": list(OVERRIDES)
               + list(args.overrides), "user_draws": args.user_draws and
               os.path.basename(args.user_draws), "platform": "gpu" if dev.type == "cuda"
               else "cpu", **st.card_fields(torch, dev),
               "noise_by_session": [[r["gp_noise"] for r in lines if r["query"] == q]
                                    for q in dict.fromkeys(r["query"] for r in lines)],
               "map": [float(np.mean([r["ap"] for r in lines if r["round"] == k]))
                       for k in sorted({r["round"] for r in lines})]}
    if ref is not None:
        summary["reference"] = os.path.basename(args.reference)
        summary.update(hold(lines, ref))
        forced_out = args.out.replace("_torch.jsonl", "_forced_torch.jsonl")
        st.record_path(forced_out)
        forced = run(args.config, tuple(args.overrides), forced_out, device=dev,
                     draws=args.user_draws or None, reference=ref, forced=True)
        summary["forced"] = dict(hold(forced, ref), log=os.path.basename(forced_out),
                                 map=[float(np.mean([r["ap"] for r in forced if r["round"] == k]))
                                      for k in sorted({r["round"] for r in forced})])
        # A free run that compared no round decides nothing: the forced
        # replay, which holds every round with no tie in the way, decides.
        summary["overall"] = _combine([summary["verdict"], summary["forced"]["verdict"]])
        print(f"free run {summary['verdict']}; forced replay {summary['forced']['verdict']}; "
              f"overall {summary['overall']}", flush=True)
    st.write_record(args.out.replace(".jsonl", "") + ".summary.json", summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
