"""The port's last counterparts of the reference's studies, on the CPU.

* ``scripts/jax_reference.py qmc`` against ``scripts/qmc_error_study_torch.py``
  on one truth: the reference's estimators rerun on the study's 16 problems
  at m = 2 and 3, n_qmc 64, their truth-free entries within 1e-6 of
  ``results/qmc_error_study.json``, and every entry of the port's table
  within 1e-5 of the rerun's.
* ``ital_tpu_torch/data/digits.npz``: equal to scikit-learn's
  ``load_digits()``, ``digits()`` equal to the reference's, and read with
  scikit-learn blocked.
* ``scripts/round_term_split_torch.py --device cpu`` at a toy size: the
  reference record's keys, graphed (here eager) equal to eager, and
  ``round_full`` equal to its terms run in sequence.
* ``scripts/hyperopt_trajectory_torch.py`` at 2 sessions x 4 rounds on
  JAX's draws against the reference's serial run
  (``jax_reference.py trajectory``) within 1e-3 up to each session's first
  MI tie.
* ``scripts/cpu_full_round_torch.py``'s labeled history against
  ``scripts/cpu_full_round.py``'s derivation.

``jax`` and ``ital_tpu`` are imported inside the test bodies.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cpu_full_round_torch as cfr  # noqa: E402
import hyperopt_trajectory_torch as htt  # noqa: E402
import qmc_error_study_torch as qes  # noqa: E402
import round_term_split_torch as rts  # noqa: E402

# A cut of the trajectory's configuration: corpus100k at 1500 x 32, two
# classes, four rounds (two re-learns), a length scale that makes every row
# correlated with the query.
TRAJECTORY_CUT = ("EXPERIMENT.dataset=corpus100k", "DATA.n=1500", "DATA.dim=32",
                  "EXPERIMENT.max_classes=2", "EXPERIMENT.n_rounds=4", "GP.length_scale=20")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("m", [2, 3])
def test_the_port_holds_the_reference_rerun_on_one_truth(m):
    import jax_reference

    rerun = jax_reference.qmc([m], [64], qes.N_PROBLEMS, workers=1, log=lambda s: None)
    with open(qes.RECORD) as fh:
        record = json.load(fh)["by_m"]
    assert rerun["truth_free_gap_by_m"][str(m)] <= qes.RERUN_ATOL
    probs = qes.problems((m,), qes.N_PROBLEMS)
    est = qes.all_estimates(torch, torch.device("cpu"), probs, (64,))
    port = qes.by_m(est, qes.stored_truth(rerun, (m,), qes.N_PROBLEMS))
    verdict = qes.held_on_one_truth(port, rerun["by_m"], record)
    assert verdict["rerun_is_the_records_estimator"]
    assert verdict["port_gap_to_rerun_by_m"][str(m)] <= qes.HELD_ATOL
    assert verdict["held"]


@pytest.mark.parametrize("m", ["2", "5", "8"])
def test_the_committed_rerun_is_the_records_estimator(m):
    """``results/qmc_error_reference_cpu_torch.json``: its self-estimates are
    the record's at every n_qmc, and it stores 16 truths of 2^m orthants."""
    with open(qes.RERUN) as fh:
        rerun = json.load(fh)
    with open(qes.RECORD) as fh:
        record = json.load(fh)["by_m"]
    assert qes.gaps({m: rerun["by_m"][m]}, record, qes.TRUTH_FREE)[m] <= qes.RERUN_ATOL
    truth = rerun["truth"][m]
    assert len(truth["mi"]) == qes.N_PROBLEMS
    assert all(len(p) == 2 ** int(m) and abs(sum(p) - 1.0) < 1e-9 for p in truth["probs"])


def test_a_port_gap_over_the_tolerance_is_not_held():
    with open(qes.RERUN) as fh:
        rerun = json.load(fh)["by_m"]
    with open(qes.RECORD) as fh:
        record = json.load(fh)["by_m"]
    port = {"3": json.loads(json.dumps(rerun["3"]))}
    assert qes.held_on_one_truth(port, rerun, record)["held"]
    port["3"]["128"]["mi_max_abs_err"] += 2 * qes.HELD_ATOL
    assert not qes.held_on_one_truth(port, rerun, record)["held"]


@pytest.mark.parametrize("key", ["data", "target"])
def test_the_digits_file_is_scikit_learns(key):
    from sklearn.datasets import load_digits

    from ital_tpu_torch.data.datasets import DIGITS_FILE

    want = getattr(load_digits(), key)
    with np.load(DIGITS_FILE) as f:
        got = f[key]
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got.astype(want.dtype), want)


@pytest.mark.parametrize("normalize", [True, False])
def test_digits_equals_the_reference_s(normalize):
    from ital_tpu.data import datasets as jds
    from ital_tpu_torch.data import datasets as tds

    ref, got = jds.digits(normalize=normalize), tds.digits(normalize=normalize)
    assert got.x.dtype == ref.x.dtype and np.array_equal(got.x, ref.x)
    for field in ("labels", "relevance", "classes"):
        assert np.array_equal(getattr(got, field), getattr(ref, field))
    assert got.labels.dtype == np.int64 and got.name == ref.name


def test_digits_reads_no_scikit_learn():
    code = ("import sys; sys.modules['sklearn'] = None\n"
            "from ital_tpu_torch.data.datasets import digits, load_dataset\n"
            "d = digits(); e = load_dataset('digits')\n"
            "assert d.x.shape == (1797, 64) and (d.x == e.x).all()\n"
            "assert not [m for m in sys.modules if m.startswith('sklearn.')]\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("scale,flags", [
    ("scale_25k", ["--skip-1m", "--n", "600"]),
    ("scale_1m", ["--skip-25k", "--n-1m", "800"])])
def test_the_term_split_writes_the_reference_s_keys(tmp_path, scale, flags):
    out = tmp_path / "round_term_split_torch.json"
    assert rts.main(["--device", "cpu", "--dim", "32", "--trials", "1", "--out", str(out),
                     *flags]) == 0
    rec = json.loads(out.read_text())
    with open(os.path.join(REPO, "results", "round_term_split_r5.json")) as fh:
        ref = json.load(fh)
    assert set(ref["scale_1m"]) == set(rts.TERMS) | {"update_chain_donate", "update_chain_copy"}
    want = set(ref["scale_1m"]) if scale == "scale_1m" else set(rts.TERMS)
    assert want <= set(rec[scale])
    for name in rts.TERMS:
        entry = rec[scale][name]
        assert entry["graphed_equals_eager"] and entry["graphed_ms"] > 0 and entry["eager_ms"] > 0
        assert entry["first_call_s"] >= 0
    assert rec[scale]["sequence"]["batch_equal"] and rec[scale]["sequence"]["mu_equal"]
    assert rec[scale]["sequence"]["ap_abs"] == 0.0
    assert rec["graphed_equals_eager"] and rec["round_full_is_its_terms"]
    assert rec["select_config"] == {**rec["select_config"], **ref["select_config"]}
    assert rec["device"] == "cpu" and rec["batch"] == ref["batch"] and rec["cap"] == ref["cap"]
    if scale == "scale_1m":
        for chain in ("update_chain_donate", "update_chain_copy"):
            assert rec[scale][chain]["reps"] == list(rts.CHAIN_REPS)


def test_round_full_is_its_terms_after_a_written_update():
    """The terms in sequence write only the copy: the workload's state is
    as it was, and a second sequence equals the first."""
    from ital_tpu_torch.data import datasets

    ds = datasets.corpus100k(n=500, dim=32, n_classes=14)
    w = rts.workload_25k(torch, torch.device("cpu"), ds)
    before = w.state.mu.clone(), w.state.count
    first, second = rts.sequence(torch, w, turn=3), rts.sequence(torch, w, turn=3)
    assert first == second and first["batch_equal"] and first["mu_equal"]
    assert torch.equal(w.state.mu, before[0]) and w.state.count == before[1]


@pytest.fixture(scope="module")
def trajectory_reference(tmp_path_factory):
    """JAX's draws of the cut trajectory and the reference's serial run on
    them: ``(draws path, the reference's lines)``."""
    import jax_reference

    tmp = tmp_path_factory.mktemp("trajectory")
    draws = tmp / "draws_torch.npz"
    np.savez(draws, **jax_reference.export(htt.CONFIG, [0], htt.OVERRIDES + TRAJECTORY_CUT))
    ref_path = tmp / "reference_torch.jsonl"
    jax_reference.trajectory(htt.CONFIG, TRAJECTORY_CUT, str(ref_path))
    return str(draws), htt.read_jsonl(str(ref_path))


@pytest.mark.parametrize("forced", [False, True])
def test_the_trajectory_is_the_reference_s_up_to_its_ties(tmp_path, trajectory_reference,
                                                          forced):
    """The free run is held up to each session's first MI tie; the forced
    replay (the reference's picks shown) over every round."""
    draws, ref = trajectory_reference
    lines = htt.run(htt.CONFIG, TRAJECTORY_CUT, str(tmp_path / "port_torch.jsonl"),
                    device="cpu", draws=draws, reference=ref, forced=forced)
    assert len(lines) == len(ref) == 8
    assert all({"batch", "hyper_raw", "length_scale", "gp_noise", "ap"} <= set(r) for r in lines)
    verdict = htt.hold(lines, ref)
    assert verdict["held"], verdict
    held = sum(s["rounds_held"] for s in verdict["sessions"])
    assert held == 8 if forced else held >= 2
    for s in verdict["sessions"]:
        assert s["worst_rel"] <= htt.RTOL
        if s["parting"] is not None:
            assert abs(s["parting"]["mi_gap"]) <= htt.MI_TIE


def test_a_trajectory_that_parts_off_a_tie_is_not_held():
    row = {"rep": 0, "cls": 0, "query": 5, "round": 0, "ap": 0.5, "labeled": 3,
           "batch": [1, 2, 3, 4], "hyper_raw": [50.0, 1.0, 1.0]}
    other = dict(row, batch=[1, 2, 9, 4])
    tie = dict(row, parting={"round": 0, "t": 2, "mi_gap": 1e-7})
    off = dict(row, parting={"round": 0, "t": 2, "mi_gap": 1e-3})
    # A tie in the first round leaves nothing compared: not decided.
    assert htt.hold([tie], [other])["verdict"] == "not decided"
    assert not htt.hold([tie], [other])["held"]
    later = lambda r: dict(r, round=1)  # noqa: E731
    assert htt.hold([row, later(tie)], [row, later(other)])["verdict"] == "held"
    assert htt.hold([row, later(off)], [row, later(other)])["verdict"] == "not held"
    assert not htt.hold([off], [other])["held"]
    drift = dict(row, hyper_raw=[50.0, 1.0, 1.01])
    assert htt.hold([row], [row])["held"] and not htt.hold([drift], [row])["held"]
    # Either run not held is not held; a run that decides nothing defers.
    assert htt._combine(["not decided", "held"]) == "held"
    assert htt._combine(["not decided", "not held"]) == "not held"
    assert htt._combine(["not decided", "not decided"]) == "not decided"


def test_the_full_round_history_is_the_reference_s():
    from ital_tpu.data.datasets import mirflickr as jmirflickr

    from ital_tpu_torch.data.datasets import mirflickr

    ds = jmirflickr()
    # scripts/cpu_full_round.py:51-56, verbatim.
    rng = np.random.default_rng(7)
    q = int(rng.integers(0, ds.n))
    cls = int(np.argmax(ds.relevance[q])) if ds.relevance[q].any() else 0
    idx = [q] + [int(i) for i in rng.permutation(ds.n)[: 5 * 4]]
    ys = [1.0] + [1.0 if ds.relevance[i, cls] else -1.0 for i in idx[1:]]
    port = mirflickr()
    assert cfr.history(port) == (idx, ys)
    with open(cfr.RECORD) as fh:
        record = json.load(fh)
    assert record["labeled_history"] == len(idx) == 21
    assert {"name": port.name, "n": port.n, "dim": port.x.shape[1],
            "synthetic": port.synthetic} == record["corpus"]
