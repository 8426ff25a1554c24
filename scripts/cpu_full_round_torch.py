#!/usr/bin/env python3
"""The PyTorch port held to the f64 oracle's full-fidelity greedy round.

The port's counterpart of ``scripts/cpu_full_round.py``, which ran the dense
f64 NumPy/SciPy oracle (``tests/oracle/numpy_oracle.py``) over every
candidate of the MIRFLICKR surrogate at each greedy step of one batch-4
round and recorded its picks (``results/cpu_full_round.json``,
``selected_batch``).  The oracle itself is NumPy/SciPy that the port shares
unchanged, so this script does not run it again.  It:

* builds the port's ``mirflickr()`` corpus and checks its name, shape and
  flag against the record's ``corpus``;
* derives the record's labeled history (:func:`history`: the query from
  ``default_rng(7)``, then the first 20 rows of a permutation from the same
  generator, labeled +1 where relevant to the query's class), 21 labels, the
  state of ``study_torch.mid_session_state`` (ls 50, var 1, noise 0.1);
* runs the port's greedy full scan over every candidate at n_qmc 512
  (``select_ital``, no pool, no re-scoring) on the card: ``port_batch``;
* at each step ``t`` it also scores every candidate after the record's own
  partial batch (``score_candidates_mi``, n_qmc 512) and takes the port's
  best there, so every step compares like with like.  Where that pick is
  not the record's, both rows are scored by the f64 oracle on the CPU
  (``OracleGP`` on the labeled rows, the partial batch and the two rows, and
  ``mutual_information`` with its MVNDST draws seeded): the step is held if
  the two MI lie within the port's QMC error at n_qmc 512 for that batch
  size (``mi_max_abs_err`` of ``results/qmc_error_study_torch.json``).

Writes ``results/cpu_full_round_torch.json`` with ``device`` and
``power_limit``.  Run from the repository root::

    python3 scripts/cpu_full_round_torch.py

It needs a CUDA card unless ``--device cpu`` is given (the same round on the
CPU, a few minutes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402

RECORD = os.path.join(REPO, "results", "cpu_full_round.json")
QMC_RECORD = os.path.join(REPO, "results", "qmc_error_study_torch.json")
N_QMC = 512
ORACLE_JITTER = 1e-6  # the record's predict_cov + 1e-6 I


def history(ds) -> tuple[list, list]:
    """The record's labeled history (``scripts/cpu_full_round.py``'s
    derivation, as ``bench.py``'s): indices and +-1 labels."""
    rng = np.random.default_rng(7)
    q = int(rng.integers(0, ds.n))
    cls = int(np.argmax(ds.relevance[q])) if ds.relevance[q].any() else 0
    idx = [q] + [int(i) for i in rng.permutation(ds.n)[: st.HISTORY_ROUNDS * st.BATCH]]
    ys = [1.0] + [1.0 if ds.relevance[i, cls] else -1.0 for i in idx[1:]]
    return idx, ys


def oracle_mi(ds, idx, ys, prefix: list, rows: list, seed: int = 0) -> list:
    """The f64 oracle's MI of ``prefix + [r]`` for each ``r`` of ``rows``:
    ``OracleGP`` over only the labeled rows, the prefix and ``rows`` (a GP
    posterior at given points reads no other row), MVNDST seeded."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from qmc_error_study_torch import _oracle

    oracle = _oracle()
    keep = list(dict.fromkeys(list(idx) + list(prefix) + list(rows)))
    at = {r: k for k, r in enumerate(keep)}
    gp = oracle.OracleGP(ds.x[keep], st.LS, st.VAR, st.NOISE)
    gp.fit([at[i] for i in idx], ys)
    out = []
    for r in rows:
        sel = [at[i] for i in prefix] + [at[r]]
        np.random.seed(seed)
        mu = gp.predict_mean(sel)
        cov = gp.predict_cov(sel) + ORACLE_JITTER * np.eye(len(sel))
        out.append(float(oracle.mutual_information(mu, cov, st.LABEL_PROB, st.MISTAKE_PROB)))
    return out


def qmc_error(m: int, path: str = QMC_RECORD) -> float | None:
    """The port's measured MI error at batch size ``m`` and n_qmc 512 (the
    study starts at m = 2, whose error stands for m = 1), from ``path``."""
    with open(path) as fh:
        row = json.load(fh)["by_m"].get(str(max(m, 2)), {})
    return row.get(str(N_QMC), {}).get("mi_max_abs_err")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "cpu_full_round_torch.json"))
    ap.add_argument("--qmc-record", default=QMC_RECORD,
                    help="the port's QMC study, whose MI error bounds a parting step")
    args = ap.parse_args(argv)
    import torch

    from ital_tpu_torch.data.datasets import mirflickr
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import score_candidates_mi, select_ital

    dev = st.open_device(torch, args.device)
    st.record_path(args.out)
    log = lambda s: print(s, flush=True)  # noqa: E731
    with open(RECORD) as fh:
        record = json.load(fh)
    want = record["selected_batch"]
    ds = mirflickr()
    corpus = {"name": ds.name, "n": int(ds.n), "dim": int(ds.x.shape[1]),
              "synthetic": bool(ds.synthetic)}
    idx, ys = history(ds)
    state = st.mid_session_state(ds, dev)
    params = StrategyParams.create(dev, label_prob=st.LABEL_PROB, mistake_prob=st.MISTAKE_PROB)
    st.sync(torch, dev)
    t0 = time.perf_counter()
    port = select_ital(state, len(want), None, params, n_qmc=N_QMC).tolist()
    st.sync(torch, dev)
    select_s = time.perf_counter() - t0
    log(f"port's batch {port} ({select_s:.3f} s, first call); the record's {want}")
    forbid = torch.zeros(ds.n, dtype=torch.bool, device=dev)
    forbid[idx] = True
    steps = []
    for t in range(len(want)):
        prefix = torch.tensor(want, dtype=torch.long, device=dev)
        mi = score_candidates_mi(state, prefix, t, params, n_qmc=N_QMC)
        mi = mi.masked_fill(forbid, -torch.inf)
        if t:
            mi[prefix[:t]] = -torch.inf
        pick = int(torch.argmax(mi))
        row = {"t": t, "record_pick": want[t], "port_pick": pick, "equal": pick == want[t],
               "port_mi": [float(mi[want[t]]), float(mi[pick])]}
        if pick != want[t]:
            row["oracle_mi"] = oracle_mi(ds, idx, ys, want[:t], [want[t], pick])
            row["oracle_gap"] = abs(row["oracle_mi"][0] - row["oracle_mi"][1])
            row["qmc_mi_max_abs_err"] = qmc_error(t + 1, args.qmc_record)
            row["held"] = (row["qmc_mi_max_abs_err"] is not None
                           and row["oracle_gap"] <= row["qmc_mi_max_abs_err"])
        else:
            row["held"] = True
        steps.append(row)
        log(json.dumps(row))
    report = {"platform": "gpu" if dev.type == "cuda" else "cpu", **st.card_fields(torch, dev),
              "corpus": corpus, "corpus_is_the_records": corpus == record["corpus"],
              "labeled_history": len(idx), "n_qmc": N_QMC, "record_batch": want,
              "port_batch": port, "port_batch_equal": port == want,
              "select_s_first_call": select_s, "qmc_record": os.path.basename(args.qmc_record),
              "steps_after_the_records_prefix": steps,
              "held": corpus == record["corpus"] and all(s["held"] for s in steps)}
    print("held" if report["held"] else "not held", flush=True)
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
