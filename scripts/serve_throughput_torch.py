#!/usr/bin/env python3
"""Serving latency of the PyTorch port over HTTP, incl. the cohort endpoints.

The port's counterpart of ``scripts/serve_throughput.py``, with its drive:
the port's server (``ital_tpu_torch.serve``) in-process on one card, K = 8
ITAL sessions (cap 64, ls 50 on the large corpora, label_prob 0.9,
mistake_prob 0.05), each with a query and four labels, then, over the wire
(localhost), the medians of five trips of

1. one ``GET /batch`` and eight of them one after another;
2. ``POST /batch_select`` for the eight sessions (one stacked program);
3. a full cohort round, ``/batch_select`` then ``/batch_feedback`` (one
   stacked update), against the same round driven session by session (four
   trips each).

The same switches as the reference's script:

* ``SERVE_TP_CORPUS``: ``digits`` (default), ``mirflickr``, ``corpus100k``
  (100 000 x 512) or ``corpus1m`` (``corpus100k``'s generator at
  1 000 000 x 512);
* ``SERVE_TP_FASTSEL=1``: the production selection service-wide (n_qmc 32,
  the top 64 re-scored at 512; at ``corpus1m`` also the top-4096 pool);
* ``SERVE_TP_CORPUS_DTYPE=bfloat16``: the service's one corpus copy stored in
  bfloat16.

Writes ``results/serve_throughput_torch_<corpus>[_fastsel][_<dtype>].json``
(never a reference record) with the reference's keys plus ``device`` and
``power_limit``.  Run from the repository root::

    SERVE_TP_CORPUS=corpus1m SERVE_TP_FASTSEL=1 SERVE_TP_CORPUS_DTYPE=bfloat16 \\
        python3 scripts/serve_throughput_torch.py
    SERVE_TP_CORPUS=corpus100k SERVE_TP_FASTSEL=1 python3 scripts/serve_throughput_torch.py

``--device cpu --n 4096 --reps 1`` runs the CPU tests' size; without a card
and without ``--device cpu`` it exits non-zero.  Each request's host time
ends once the response is read, as the reference's does.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

K = 8  # cohort size
CORPORA = ("digits", "mirflickr", "corpus100k", "corpus1m")


def _req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        # The server puts the handler's exception in the 500 body.
        sys.stderr.write(f"{url}: HTTP {exc.code}: "
                         f"{exc.read().decode(errors='replace')[:2000]}\n")
        raise


def report_name(corpus: str, method_kwargs: dict, corpus_dtype: str) -> str:
    """The report's file name under ``results/``: the reference's name for the
    same switches with ``torch_`` after ``serve_throughput_``."""
    return (f"serve_throughput_torch_{corpus}" + ("_fastsel" if method_kwargs else "")
            + (f"_{corpus_dtype}" if corpus_dtype else "") + ".json")


def load_corpus(name: str, n: int):
    """(dataset, length scale) of the corpus ``name``; ``n`` (0: the corpus'
    own) cuts the synthetic ones' rows to a test's size."""
    from ital_tpu_torch.data.datasets import corpus100k, digits, mirflickr

    if name == "mirflickr":
        return mirflickr(), 50.0
    if name in ("corpus100k", "corpus1m"):
        rows = n or (1_000_000 if name == "corpus1m" else 100_000)
        return corpus100k(n=rows, dim=512), 50.0
    return digits(), 2.2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=0, help="corpus rows (default: the corpus')")
    ap.add_argument("--reps", type=int, default=0,
                    help="trips per median (default: the reference's 5 and 4)")
    ap.add_argument("--out", default=None, help="the report's path (default: under results/)")
    args = ap.parse_args(argv)
    corpus = os.environ.get("SERVE_TP_CORPUS", "digits")
    if corpus not in CORPORA:
        sys.exit(f"SERVE_TP_CORPUS={corpus!r}: one of {CORPORA}")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {args.device}: no CUDA device is available "
                 f"(--device cpu runs the CPU tests' sizes)")

    from ital_tpu_torch.serve import RetrievalService, make_server
    from scale1m_torch import card_fields

    card = card_fields(torch, device)
    ds, ls = load_corpus(corpus, args.n)
    mkw = ({"n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512}
           if os.environ.get("SERVE_TP_FASTSEL") else {})
    if mkw and corpus == "corpus1m":
        mkw["pool_size"] = 4096
    cdt = os.environ.get("SERVE_TP_CORPUS_DTYPE", "")
    svc = RetrievalService(
        ds.x, length_scale=ls, var=1.0, noise=0.1, cap=64, strategy="ital",
        label_prob=0.9, mistake_prob=0.05, corpus_name=corpus, method_kwargs=mkw,
        corpus_dtype=cdt, device=device)
    srv = make_server(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    rng = np.random.default_rng(0)
    sids = []
    for _ in range(K):
        sid = _req(f"{base}/sessions", "POST", {})["session_id"]
        q = int(rng.integers(0, ds.n))
        _req(f"{base}/sessions/{sid}/query", "POST", {"index": q})
        labs = {str(int(i)): (1 if ds.labels[i] == ds.labels[q] else -1)
                for i in rng.integers(0, ds.n, size=4)}
        _req(f"{base}/sessions/{sid}/feedback", "POST", {"labels": labs})
        sids.append(sid)

    # Warm both programs (their graphs' captures).
    _req(f"{base}/sessions/{sids[0]}/batch?k=4")
    _req(f"{base}/batch_select", "POST", {"session_ids": sids, "k": 4})

    def timed(fn, reps):
        times = []
        for _ in range(args.reps or reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    single_ms = timed(lambda: [_req(f"{base}/sessions/{s}/batch?k=4") for s in sids], 5)
    cohort_ms = timed(lambda: _req(f"{base}/batch_select", "POST",
                                   {"session_ids": sids, "k": 4}), 5)
    one_ms = timed(lambda: _req(f"{base}/sessions/{sids[0]}/batch?k=4"), 5)

    def full_round_cohort():
        r = _req(f"{base}/batch_select", "POST", {"session_ids": sids, "k": 4})
        fb = {sid: {str(i): (1 if ds.labels[i] == ds.labels[int(b[0])] else -1) for i in b}
              for sid, b in r["batches"].items()}
        _req(f"{base}/batch_feedback", "POST", {"feedback": fb})

    def full_round_individual():
        for s in sids:
            b = _req(f"{base}/sessions/{s}/batch?k=4")["batch"]
            labs = {str(i): (1 if ds.labels[i] == ds.labels[int(b[0])] else -1) for i in b}
            _req(f"{base}/sessions/{s}/feedback", "POST", {"labels": labs})

    full_round_cohort()  # warm the stacked update program
    round_cohort_ms = timed(full_round_cohort, 4)
    round_indiv_ms = timed(full_round_individual, 4)
    srv.shutdown()
    srv.server_close()

    report = {
        "corpus": f"{corpus} ({ds.n} x {ds.x.shape[1]})",
        "k_sessions": K,
        "single_request_ms": one_ms,
        "k_individual_requests_ms": single_ms,
        "batch_select_ms_total": cohort_ms,
        "batch_select_ms_per_session": cohort_ms / K,
        "speedup_vs_individual": single_ms / cohort_ms,
        "full_round_cohort_ms_total": round_cohort_ms,
        "full_round_cohort_ms_per_session": round_cohort_ms / K,
        "full_round_individual_ms": round_indiv_ms,
        "full_round_speedup": round_indiv_ms / round_cohort_ms,
        "method_kwargs": mkw,
        "mesh_devices": 0,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        **card,
    }
    if cdt:
        report["corpus_dtype"] = cdt
    if device.type == "cuda":
        report["device_mem_mb_peak"] = torch.cuda.max_memory_allocated(device) / 1e6
    out = args.out or os.path.join(REPO, "results", report_name(corpus, mkw, cdt))
    with open(out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
