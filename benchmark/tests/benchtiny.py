"""A copy of the benchmark with small cells added from files alone, for the
CPU tests: ``tiny`` (2000 x 512 rows, pool 128, the top 16 re-scored) under
the mixes ``tinycohort`` (3 slots, sessions of 1-3 rounds) and ``single``;
and ``tinytop.tinymixed``, whose every piece is new: the configuration
``tinytop`` (the ``topscoring`` strategy, with a plain reference and launch
table of its own), the mix ``tinymixed`` (code of its own: each slot's
feedback through ``feedback``, all slots' batches through one
``next_batch_many``) and the metric ``feedback_calls`` that only it
reports."""

from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SHARED = ("tiny.tinycohort", "tiny.single")  # report the 25 000-row cohort's metrics
NEW = "tinytop.tinymixed"
CELLS = SHARED + (NEW,)

MIXED_TURN = '''
import time


def turn(loop):
    """Each slot's feedback through ``feedback``, then one ``next_batch_many``."""
    slots = range(loop.traffic.slots)
    ok = [True] * len(slots)
    t0 = time.perf_counter()
    for slot in slots:
        if loop.needs_start(slot):
            loop.start(slot)
        elif loop.pending[slot] is not None:
            sid, fb = loop.live[slot].sid, loop.feedback(slot)
            with loop.spans("update"):
                reply = loop.call("feedback", 1, lambda: loop.svc.feedback(sid, fb))
            ok[slot] = loop.absorbed(slot, reply)
    sids = [loop.live[slot].sid for slot in slots]
    with loop.spans("select"):
        out = loop.call("select_many", len(sids), lambda: loop.svc.next_batch_many(sids, loop.k))
    ms = (time.perf_counter() - t0) * 1e3
    return [(ms, loop.shown(slot, out[loop.live[slot].sid]) and ok[slot]) for slot in slots]


def warm_up(svc, traffic, cfg):
    k = int(cfg["selection"]["batch"])
    sids = []
    for q in traffic.warm_queries(traffic.slots):
        sid = svc.create_session()
        svc.set_query(sid, q)
        sids.append(sid)
    batches = svc.next_batch_many(sids, k)
    for sid in sids:
        svc.feedback(sid, {str(i): 1 for i in batches[sid]})
        svc.delete(sid)
'''

TOP_REFERENCE = '''
import torch


def readings(ref, low, sampled):
    """``top_gap``: the widest amount by which a served pick's posterior
    mean lies below the best mean among the rows it could have taken."""
    gap = 0.0
    for idx, y, batch in sampled:
        mu = ref.posterior(idx, y).full(with_var=False)[0]
        labeled = torch.zeros(ref.n, dtype=torch.bool, device=ref.device)
        labeled[torch.as_tensor(idx, device=ref.device)] = True
        if low is not None:  # the lower precision's own picks in the program's place
            mu_low = low.posterior(idx, y).full(with_var=False)[0]
            batch = torch.topk(torch.where(labeled, -torch.inf, mu_low), len(batch)).indices
        for t in range(len(batch)):
            bt, pick = [int(b) for b in batch[:t]], int(batch[t])
            if not ref.selectable(labeled, bt, pick):
                return {"top_gap": 1e9}
            free = torch.where(labeled, -torch.inf, mu)
            free[bt] = -torch.inf
            gap = max(gap, float(free.max() - mu[pick]))
    return {"top_gap": gap}
'''

FEEDBACK_CALLS = '''
def read(rec):
    n = sum(1 for kind, _, _ in rec.calls if kind == "feedback")
    return n or None
'''


def _write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def tiny_copy(dest: str) -> str:
    """``BENCHMARK.json`` and ``benchmark/`` copied to ``dest`` with the small
    cells added as new files and entries; the port linked beside them.
    Returns ``dest``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "ital_tpu_torch"), os.path.join(dest, "ital_tpu_torch"))
    bench = os.path.join(dest, "benchmark")
    with open(os.path.join(bench, "configs", "mirflickr25k.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny"
    cfg["corpus"].update(n=2000)
    cfg["selection"].update(pool_size=128, refine_top=16)
    _write(os.path.join(bench, "configs", "tiny.json"), json.dumps(cfg))
    cfg["name"] = "tinytop"
    cfg["selection"] = {"strategy": "topscoring", "batch": 4}
    cfg["correct"] = {"reference": "float64", "controls": ["tf32"],
                      "limits": {"posterior_err": 2e-4, "top_gap": 1e-5}}
    _write(os.path.join(bench, "configs", "tinytop.json"), json.dumps(cfg))
    _write(os.path.join(bench, "references", "topscoring.py"), TOP_REFERENCE)
    # topscoring ranks the posterior mean the updates keep: no RBF block.
    _write(os.path.join(bench, "launches", "topscoring.select_many.json"), "[]")
    with open(os.path.join(bench, "traffic", "cohort8.json")) as f:
        mix = json.load(f)
    mix.update(slots=3, rounds=[1, 3], check_batches=12)
    _write(os.path.join(bench, "traffic", "tinycohort.json"), json.dumps(mix))
    _write(os.path.join(bench, "traffic", "tinymixed.json"),
           json.dumps({"slots": 2, "rounds": [1, 3], "check_batches": 8}))
    _write(os.path.join(bench, "traffic", "tinymixed.py"), MIXED_TURN)
    _write(os.path.join(bench, "metrics", "feedback_calls.py"), FEEDBACK_CALLS)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for name in ("tiny", "tinytop"):
        spec["configs"].append({"name": name, "source": "CPU tests", "why": "CPU tests",
                                "file": f"benchmark/configs/{name}.json", "reduced": ["corpus"]})
    for cell in CELLS:
        config, traffic = cell.split(".")
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "mirflickr25k.cohort8" in m["workloads"]:
            m["workloads"].extend(CELLS)
    spec["per_layer"].append({"name": "feedback_calls", "unit": "calls", "better": "lower",
                              "source": "program_counter", "layer": "service",
                              "moves": "turn_ms_p95", "workloads": [NEW]})
    _write(os.path.join(dest, "BENCHMARK.json"), json.dumps(spec))
    return dest
