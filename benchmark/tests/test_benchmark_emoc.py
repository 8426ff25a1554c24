"""The plain EMOC reference (``references/emoc.py``) against the port at a
small size on the CPU; a small EMOC cell run end to end; faults planted
under its timed path coming out as not correct; the launch tables against
the port's blocking at the configuration's size."""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchtiny
from benchmark import control, harness, roofline
from benchmark import reference as ref
from benchmark.corpus import surrogate

EMOC = harness.load_module(harness.reference_path("emoc"))
CELL = "tinyemoc.tinycohort"
# A length scale at which the 32-wide surrogate's rows are neither all alike
# nor all apart (at the configuration's 50 every kernel value is near 1).
SPEC = {"gp": {"length_scale": 8.0, "var": 1.0, "noise": 0.1},
        "user": {"label_prob": 0.8, "mistake_prob": 0.05},
        "selection": {"strategy": "emoc", "batch": 4}}


def emoc_copy(dest: str) -> str:
    """:func:`benchtiny.tiny_copy` with the cell ``tinyemoc.tinycohort``
    added from files alone: ``mirflickr25k_emoc`` at 1000 rows under the
    small cohort mix, reporting what ``mirflickr25k_emoc.cohort8`` reports."""
    root = benchtiny.tiny_copy(dest)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "mirflickr25k_emoc.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tinyemoc"
    cfg["corpus"].update(n=1000)
    with open(os.path.join(bench, "configs", "tinyemoc.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tinyemoc", "source": "CPU tests", "why": "CPU tests",
                            "file": "benchmark/configs/tinyemoc.json", "reduced": ["corpus"]})
    spec["workloads"].append({"name": CELL, "config": "tinyemoc", "traffic": "tinycohort",
                              "chips": 1, "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "mirflickr25k_emoc.cohort8" in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return emoc_copy(str(tmp_path_factory.mktemp("bench")))


def _sessions(dtype):
    """Three port EMOC sessions over a 600 x 32 surrogate at cap 16, each
    with its own query and two rounds of seeded answers; their labels."""
    from ital_tpu_torch.models.session import ActiveRetrieval

    x, _ = surrogate(600, 32, 14, 11, "cpu")
    x = x.to(dtype)
    rng = np.random.default_rng(3)
    sessions, labels = [], []
    for query in (17, 230, 451):
        s = ActiveRetrieval(x, length_scale=8.0, var=1.0, noise=0.1, cap=16, strategy="emoc",
                            label_prob=0.8, mistake_prob=0.05, device="cpu")
        s.update_query(query)
        idx, y = [query], [1.0]
        for _ in range(2):
            fb = {int(i): int(rng.choice([-1, 0, 1])) for i in s.fetch_unlabelled(4)}
            s.update(fb)
            for i, a in fb.items():
                if a:
                    idx.append(i)
                    y.append(float(a))
        sessions.append(s)
        labels.append((idx, y))
    return x, sessions, labels


# Tolerances, relative to the largest column sum or score: in float64 only
# the order of the sums parts the two (600 terms a column, 1e-12 leaves a
# thousandfold room over their rounding); in float32 the port's kernel block,
# its whitened rows and its column sums round at 6e-8 each, and the sums of
# 600 absolute values accumulate about 600 * 6e-8 = 4e-5 at worst.
TOL = {torch.float64: 1e-12, torch.float32: 4e-5}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stacked_column_sums_and_scores_match_the_reference(dtype):
    from ital_tpu_torch.models import gp
    from ital_tpu_torch.select import baselines
    from ital_tpu_torch.select.base import get_stacked_strategy, per_session

    x, sessions, labels = _sessions(dtype)
    st = gp.stack_states([s.state for s in sessions])
    colabs = baselines._colabs(st, st.v)
    got = baselines.emoc_scores_from_moments(st.mu, st.sig2, per_session(st.hyper.noise),
                                             colabs)
    r = ref.Reference(x, SPEC, ref.Precision("float64"))
    want, want_colabs = EMOC.scores(r, labels)
    assert want_colabs.shape == colabs.shape == (3, 600)
    for a, b in ((colabs, want_colabs), (got, want)):
        err = (a.to(torch.float64) - b).abs().max() / b.abs().max()
        assert err < TOL[dtype], (dtype, float(err))
    params = sessions[0].params
    picks = get_stacked_strategy("emoc")([s.state for s in sessions], 4,
                                         [s.generator for s in sessions], params)
    sampled = [(idx, y, picks[j].tolist()) for j, (idx, y) in enumerate(labels)]
    assert EMOC.readings(r, None, sampled)["emoc_gap"] < TOL[dtype]


def test_a_labeled_or_repeated_pick_is_invalid_and_a_low_pick_reads_its_gap():
    x, sessions, labels = _sessions(torch.float64)
    r = ref.Reference(x, SPEC, ref.Precision("float64"))
    idx, y = labels[1]
    scores, _ = EMOC.scores(r, [(idx, y)])
    free = torch.where(EMOC._labeled(r, idx), -torch.inf, scores[0])
    order = torch.sort(free, descending=True).indices.tolist()
    top = order[:4]
    assert EMOC.readings(r, None, [(idx, y, top)])["emoc_gap"] == 0.0
    for bad in ([top[0], top[0], top[2], top[3]], [idx[0], top[1], top[2], top[3]],
                [top[0], top[1], top[2], 600]):
        assert EMOC.readings(r, None, [(idx, y, bad)])["emoc_gap"] == ref.INVALID_GAP
    fifth = top[:3] + [order[10]]
    gap = EMOC.readings(r, None, [(idx, y, fifth)])["emoc_gap"]
    assert gap == pytest.approx(float((free[top[3]] - free[order[10]]) / free[top[0]]))
    assert gap > 0


def test_the_port_counts_its_posterior_covariance_blocks_through_the_service():
    """A ``/batch_select`` of 3 at N rows counts 3 N^2 x 4 bytes and 3 blocks
    a 2048 candidates; nothing with tracing off."""
    from ital_tpu_torch.serve import RetrievalService
    from ital_tpu_torch.utils import logging as trace

    x, _ = surrogate(600, 32, 14, 11, "cpu")
    svc = RetrievalService(x, length_scale=8.0, noise=0.1, cap=16, strategy="emoc",
                           label_prob=0.8, mistake_prob=0.05, device="cpu")
    sids = []
    for q in (3, 40, 77):
        sids.append(svc.create_session())
        svc.set_query(sids[-1], q)
    trace.clear()
    svc.next_batch_many(sids, 4)
    assert trace.segments() == []
    with trace.recording():
        svc.next_batch_many(sids, 4)
    (seg,) = trace.segments()
    assert seg.count("kernels.kpost_bytes") == 3 * 600 * 600 * 4
    assert seg.count("kernels.kpost_blocks") == 3
    trace.clear()


def test_launch_tables_follow_the_ports_blocks_at_the_configurations_size(monkeypatch):
    """The port's stacked column sums at 25 000 rows launch one (N, 2048)
    block per full candidate block and one (N, 424) tail, shared by the
    sessions of one hyperparameter group: the tables' blocks."""
    from ital_tpu_torch.ops import kernels

    seen = []

    def recorded(a, b, length_scale, var, a2, b2, out=None):
        seen.append((a.shape[0], b.shape[0], a2 is not None and b2 is not None))
        return torch.zeros(a.shape[0], b.shape[0])

    monkeypatch.setattr(kernels, "_rbf_forward", recorded)
    n = 25000
    x = torch.zeros(n, 512)
    v = torch.zeros(3, 2, n)
    hyper = torch.ones(3)
    kernels.blockwise_reduce_abs_kpost_stacked(x, v, hyper, hyper, [[0, 1, 2]],
                                               x2=torch.zeros(n))
    got = collections.Counter((m, width, False, norms) for m, width, norms in seen)
    assert got == {(n, 2048, False, True): 12, (n, 424, False, True): 1}
    sizes = roofline.sizes_of(harness.resolve("mirflickr25k_emoc.cohort8").config)
    for kind in ("select_many", "select"):
        assert roofline.blocks([(kind, 3, False)], sizes, "emoc", benchtiny.ROOT) == got


def _run(root, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=root,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_emoc_cell_runs_correct_on_the_cpu(root, trace):
    p = _run(root, "--workload", CELL, "--seed", str(2**31 + 11), "--seconds", "3",
             "--trace", trace, "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["compared"]) == {"failed_turns", "posterior_err", "emoc_gap"}
    assert out["compared"]["emoc_gap"]["value"] <= 1e-6
    # kpost_gb_per_turn reads the profiled stretch, which a CPU run has not.
    want = {"0": {"turn_ms_p95", "rounds_per_s", "setup_s"},
            "1": {"select_ms", "update_ms", "start_ms", "captures", "rbf_launches_per_turn"}}
    assert set(out["metrics"]) == want[trace]


def test_the_tf32_control_fails_a_limit(root):
    (row,) = control.readings(CELL, [5], 1, 3.0, "cpu", root=root)
    limits = harness.resolve(CELL, root).config["correct"]["limits"]
    assert row["correct"] is True
    assert all(row["program"][k] <= v for k, v in limits.items())
    got = row["controls"]["tf32"]
    assert got["posterior_err"] > limits["posterior_err"], got


def _session_zero_v(real):
    def colabs(st, v):
        return real(st, v[:1].expand_as(v).contiguous())
    return colabs


@pytest.mark.parametrize("fault", ["pick_altered", "session_zero_v"])
def test_faults_under_the_timed_path_are_not_correct(root, monkeypatch, fault):
    from ital_tpu_torch import serve
    from ital_tpu_torch.select import baselines

    if fault == "pick_altered":
        many = serve.RetrievalService.next_batch_many

        def altered(self, sids, k):
            out = many(self, sids, k)
            n = self.x.shape[0]
            return {sid: b[:-1] + [(b[-1] + n // 2) % n] for sid, b in out.items()}

        monkeypatch.setattr(serve.RetrievalService, "next_batch_many", altered)
    else:
        monkeypatch.setattr(baselines, "_colabs", _session_zero_v(baselines._colabs))
    out = harness.run(CELL, 9, 3.0, False, "cpu", 0.0, root=root)
    assert out["correct"] is False, out["compared"]
    assert out["compared"]["emoc_gap"]["value"] > out["compared"]["emoc_gap"]["limit"]
