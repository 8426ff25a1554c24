"""The port's QMC-error, regression-learning, router A/B and selection-profile
studies, and the MI block's record, on the CPU.

* ``scripts/qmc_error_study_torch.py``: the port's four estimators on the
  study's own problems (m = 2..4, n_qmc 64, 2 problems) against
  ``ital_tpu``'s, within 1e-6 (f32) and 1e-10 (f64).
* ``scripts/regression_learning_study_torch.py``: the ``learned``
  configuration in f64 (1 seed, 4 rounds) on JAX's own draws fed through
  ``runner.regression_draws`` gives the reference's
  ``run_regression_experiment`` RMSE curve within 1e-6; the draws file of
  ``scripts/jax_reference.py draws --task regression`` holds the reference
  runner's f32 draws, and through the study's ``--user-draws`` the
  ``fixed_wrong`` configuration's f32 curve equals the reference's within
  1e-5 (the runner's f32 parity tolerance, ``test_torch_runner.py``).
* Each new script at a toy size with ``--device cpu``: it writes its
  record's keys, and refuses to overwrite a reference record.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import jax_reference  # noqa: E402
import mi_block_torch as mbt  # noqa: E402
import pallas_ab_torch as pab  # noqa: E402
import profile_100k_torch as p100  # noqa: E402
import profile_selection_torch as psel  # noqa: E402
import qmc_error_study_torch as qes  # noqa: E402
import regression_learning_study_torch as rls  # noqa: E402

from ital_tpu import runner as jrunner  # noqa: E402
from ital_tpu.data import datasets as jds  # noqa: E402
from ital_tpu.ops import mvn as jmvn  # noqa: E402
from ital_tpu.select import ital as jital  # noqa: E402
from ital_tpu.select.base import StrategyParams as JParams  # noqa: E402
from ital_tpu.utils import config as jconfig  # noqa: E402
from ital_tpu_torch import runner as trunner  # noqa: E402
from ital_tpu_torch.data import datasets as tds  # noqa: E402
from ital_tpu_torch.select.base import StrategyParams  # noqa: E402

DRAWS = os.path.join(REPO, "results", "jax_user_draws_regression_toy_s0-7_torch.npz")
EST_F32, EST_F64 = 1e-6, 1e-10
RMSE_F64, RMSE_F32 = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the QMC-error study --------------------------------------------------------


def _jax_estimates(mu, cov, n_qmc, dtype):
    m = len(mu)
    muj = jnp.asarray(mu, dtype)
    chol = jmvn.small_cholesky(jnp.asarray(cov, dtype))
    p = JParams(label_prob=jnp.asarray(qes.LABEL_PROB, dtype),
                mistake_prob=jnp.asarray(qes.MISTAKE_PROB, dtype))
    p1 = jmvn.orthant_probs_all_configs_tree(muj, chol, n_points=n_qmc)
    pm, pe = jmvn.orthant_probs_with_error(muj, chol, n_points=n_qmc, n_shifts=qes.N_SHIFTS)
    mi1, mie = jital.mi_with_error(muj, chol, p, n_qmc=n_qmc, n_shifts=qes.N_SHIFTS)
    mi_single = jital.mutual_information_from_relevance(
        p1, jital.feedback_given_relevance(m, p.label_prob, p.mistake_prob))
    f64 = lambda v: np.asarray(v, np.float64)  # noqa: E731
    return {"p1": f64(p1), "pm": f64(pm), "pe": f64(pe), "mi1": float(mi1), "mie": float(mie),
            "mi_single": float(mi_single)}


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qmc_study_estimators_equal_the_reference_s(m, dtype):
    probs = qes.problems((2, 3, 4), n_problems=2)[m]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    params = StrategyParams(**{k: torch.tensor(v, dtype=tdt) for k, v in (
        ("label_prob", qes.LABEL_PROB), ("mistake_prob", qes.MISTAKE_PROB), ("jitter", 1e-6),
        ("tradeoff", 0.5))})
    atol = EST_F32 if dtype == np.float32 else EST_F64
    for mu, cov in probs:
        got = qes.estimates(torch, torch.device("cpu"), mu, cov, 64, params, dtype=tdt)
        with jax.enable_x64(dtype == np.float64):
            want = _jax_estimates(mu, cov, 64, dtype)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)


def test_qmc_study_problems_are_the_reference_s():
    """The study's copy of ``random_problem`` draws what the reference's does."""
    sys.path.insert(0, REPO)
    from scripts import qmc_error_study as ref

    rng = np.random.default_rng(17)
    want = {m: [ref.random_problem(rng, m) for _ in range(3)] for m in (2, 3)}
    got = qes.problems((2, 3), n_problems=3)
    for m in want:
        for (a, b), (c, d) in zip(got[m], want[m]):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


# -- the regression-learning study ------------------------------------------------


def _f64_regression_toy(mod):
    own = mod.regression_toy

    def f64(**kw):
        ds = own(**kw)
        return dataclasses.replace(ds, x=ds.x.astype(np.float64), y=ds.y.astype(np.float64))
    return f64


def _jax_x64_draws(seed, rep, rnd, batch_size, device):
    """The reference runner's draws of one regression round in x64 mode."""
    with jax.enable_x64(True):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), rep), rnd)
        _, k_lab, k_eps = jax.random.split(key, 3)
        u = np.array(jax.random.uniform(k_lab, (batch_size,)))
        eps = np.array(jax.random.normal(k_eps, (batch_size,)))
    return None, torch.from_numpy(u).to(device), torch.from_numpy(eps).to(device)


def _reference_config(rounds: int, seed: int, **gp_kw):
    base = rls.base_config(rounds)
    return jconfig.ExperimentConfig(
        task="regression", dataset="regression_toy", dataset_kwargs=base.dataset_kwargs,
        method="ital_regression", batch_size=4, n_rounds=rounds, repetitions=1, seed=seed,
        gp=dataclasses.replace(jconfig.GPConfig(length_scale=1.0, var=1.0, noise=1.0, cap=48),
                               **gp_kw),
        user=jconfig.UserConfig(label_prob=1.0, obs_noise=0.05))


def test_the_learned_configuration_in_f64_is_the_reference_s(monkeypatch):
    from ital_tpu.models import gp as jgp

    monkeypatch.setattr(jds, "regression_toy", _f64_regression_toy(jds))
    monkeypatch.setattr(tds, "regression_toy", _f64_regression_toy(tds))
    monkeypatch.setattr(trunner, "regression_draws", _jax_x64_draws)
    # In x64 mode the reference's update slices at (0, count), a 64-bit
    # literal beside its int32 count, which lax refuses: start it at int64.
    init = jgp.gp_init
    monkeypatch.setattr(jgp, "gp_init",
                        lambda *a, **k: init(*a, **k).replace(count=jnp.zeros((), jnp.int64)))
    learned = rls.CONFIGS["learned"]
    with jax.enable_x64(True):
        want = jrunner.run_regression_experiment(_reference_config(4, 0, **learned))
    got = rls.run("cpu", [0], 4, configs={"learned": learned}, log=lambda s: None)
    entry = got["configs"]["learned"]
    np.testing.assert_allclose(entry["rmse_curves_by_seed"]["0"],
                               np.round(want["mean_rmse"], 4), rtol=0, atol=RMSE_F64)
    # Unrounded, through the runner itself.
    cfg = dataclasses.replace(rls.base_config(4), seed=0,
                              gp=dataclasses.replace(rls.base_config(4).gp, **learned))
    res = trunner.run_regression_experiment(cfg, device="cpu")
    assert res["rmse"].dtype == np.float64
    np.testing.assert_allclose(res["mean_rmse"], want["mean_rmse"], rtol=0, atol=RMSE_F64)
    for k, v in want["hyper"].items():
        np.testing.assert_allclose(res["hyper"][k], v, rtol=0, atol=RMSE_F64)


def test_the_draws_file_is_the_reference_runner_s():
    with np.load(DRAWS) as f:
        sessions, u_label, eps = f["sessions"], f["u_label"], f["eps"]
    assert sessions.tolist() == [[s, 0] for s in range(8)]
    assert u_label.shape == eps.shape == (8, 10, 4)
    again = jax_reference.export_regression([3], 10, 4)
    np.testing.assert_array_equal(again["u_label"][0], u_label[3])
    np.testing.assert_array_equal(again["eps"][0], eps[3])


def test_the_fixed_configuration_on_the_draws_file_is_the_reference_s():
    want = jrunner.run_regression_experiment(_reference_config(4, 1))
    got = rls.run("cpu", [1], 4, configs={"fixed_wrong": {}}, draws_path=DRAWS,
                  log=lambda s: None)
    np.testing.assert_allclose(got["configs"]["fixed_wrong"]["rmse_curves_by_seed"]["1"],
                               np.round(want["mean_rmse"], 4), rtol=0, atol=RMSE_F32)


# -- each script at a toy size ----------------------------------------------------


def _run(tmp_path, module, args, name):
    out = tmp_path / f"{name}_torch.json"
    assert module.main(["--device", "cpu", "--out", str(out), *args]) == 0
    return json.loads(out.read_text())


def test_the_mi_block_script_writes_its_record(tmp_path):
    rec = _run(tmp_path, mbt, ["--rows", "8,16", "--n", "160", "--dim", "16"], "mi_block")
    assert set(rec["working_set"]) == {"4", "6", "8"}
    entry = rec["working_set"]["8"]["128"]
    assert entry["node_points_per_row"] == 254 * 128 and len(entry["points"]) == 2
    row = rec["selections"]["160"]["full 256"]
    assert row["blocks_by_step"] == [mbt_block(t + 1, 256) for t in range(8)]
    assert row["graphed_equals_eager"] and row["cpu_held"] and rec["held"]
    assert len(row["cpu_replay"]) == 8 and row["graphed"]["picks"] == row["eager"]["picks"]


def mbt_block(m, n_qmc):
    from ital_tpu_torch.select.ital import mi_block

    return mi_block(m, n_qmc)


def test_the_qmc_script_writes_its_record(tmp_path):
    rec = _run(tmp_path, qes, ["--ms", "2,3", "--nqmcs", "64", "--problems", "2",
                               "--workers", "1"], "qmc")
    assert set(rec["by_m"]) == {"2", "3"}
    assert set(rec["by_m"]["2"]["64"]) == set(
        json.load(open(qes.RECORD))["by_m"]["2"]["64"])
    for key in ("largest_gap_by_m", "truth_free_gap_by_m", "oracle_spread_by_m"):
        assert set(rec[key]) == {"2", "3"}
    assert rec["device"] == "cpu" and rec["held"] in (True, False)


def test_the_regression_script_writes_its_record(tmp_path):
    rec = _run(tmp_path, rls, ["--seeds", "0", "--rounds", "2", "--user-draws", DRAWS],
               "regression")
    assert set(rec["configs"]) == set(rls.CONFIGS)
    assert rec["configs"]["learned"]["gp_overrides"] == {"learn_every": 2, "learn_steps": 40}
    assert len(rec["configs"]["learned"]["learned_hyper_by_seed"]) == 1
    assert set(rec["against_record"]["configs"]) == set(rls.CONFIGS)
    assert rec["user_draws"] == os.path.basename(DRAWS)


def test_the_router_ab_script_writes_its_record(tmp_path):
    rec = _run(tmp_path, pab, ["--scales", "300", "--dim", "16"], "pallas_ab")
    for key in ("scales", "scales_bf16"):
        entry = rec[key]["300"]
        assert set(entry["plain"]) == set(pab.CASES)
        assert set(entry["fastest"]) == set(pab.CASES)
        assert entry["plain"]["emoc_block"]["router"] in ("wgmma", "tile")
    assert rec["block"] == 2048 and rec["cap"] == 64 and rec["held"]


def test_the_profile_scripts_write_their_records(tmp_path):
    rec = _run(tmp_path, psel, ["--n", "600", "--dim", "32"], "timing_corroboration")
    for key in ("pipeline_ms_reps8_total", "pipeline_ms_reps32_total",
                "pipeline_slope_ms_per_call", "sync_ms_per_call_median",
                "event_ms_per_call_median", "profiler", "eager_pipeline_slope_ms_per_call"):
        assert key in rec
    assert rec["profiler"]["busy_share"] is None  # not measured off the card
    rec = _run(tmp_path, p100, ["--n", "600", "--dim", "32"], "scale100k_profile")
    rounds = rec["sharded_round_ms"]
    assert len(rounds["per_round"]) == p100.ROUNDS and rounds["first"] == rounds["per_round"][0]
    assert set(rec["mi_scan_block_sweep_ms"]) == {str(b) for b in p100.SWEEP} | {
        str(rec["default_block"])}
    assert rec["held"] and rounds["picks"] == rec["eager_sharded_round_ms"]["picks"]


@pytest.mark.parametrize("module,record", [
    (mbt, "block_sweep.json"), (qes, "qmc_error_study.json"),
    (rls, "regression_learning.json"), (pab, "pallas_ab.json"),
    (psel, "timing_corroboration.json"), (p100, "scale100k_profile.json")])
def test_each_script_refuses_to_overwrite_a_reference_record(module, record):
    path = os.path.join(REPO, "results", record)
    assert os.path.exists(path)
    before = open(path, "rb").read()
    with pytest.raises(SystemExit):
        module.main(["--device", "cpu", "--out", path])
    assert open(path, "rb").read() == before
