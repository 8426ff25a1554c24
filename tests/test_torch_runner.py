"""The port's experiment harness and CLI against ``ital_tpu.runner`` and ``ital_tpu.cli``.

Small toy configurations only.  With a noiseless user (label_prob 1,
mistake_prob 0) the random draws decide nothing, so the AP curves must equal
JAX's; with a noisy user the port is fed JAX's draws through its draws seam
(:func:`ital_tpu_torch.runner.round_draws`).  AP is float32: atol 1e-6.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ital_tpu import cli as jcli
from ital_tpu import runner as jrunner
from ital_tpu.utils import config as jconfig
from ital_tpu_torch import cli as tcli
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
AP_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(mod, method="ital", label_prob=1.0, mistake_prob=0.0, gp=None, **kw):
    """The same toy experiment as a JAX (``mod=jconfig``) or port config."""
    base = dict(
        dataset="toy", dataset_kwargs=dict(n_per_class=40, n_classes=3, dim=2, seed=0),
        method=method, batch_size=2, n_rounds=3, repetitions=1, queries_per_class=1,
        max_classes=2, seed=0,
        gp=mod.GPConfig(**{"length_scale": 1.5, "var": 1.0, "noise": 0.1, "cap": 16, **(gp or {})}),
        user=mod.UserConfig(label_prob=label_prob, mistake_prob=mistake_prob),
    )
    base.update(kw)
    return mod.ExperimentConfig(**base)


def jax_round_draws(seed, rep, cls, query, rnd, batch_size, device):
    """The draws of JAX's serial runner for one round, as the port's seam hands them."""
    skey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), rep), cls), query)
    _, k_user = jax.random.split(jax.random.fold_in(skey, rnd))
    k_label, k_flip = jax.random.split(k_user)
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (batch_size,)))).to(device)
         for k in (k_label, k_flip)]
    return None, u[0], u[1]


def jax_regression_draws(seed, rep, rnd, batch_size, device):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), rep), rnd)
    _, k_lab, k_eps = jax.random.split(key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(k_lab, (batch_size,))))
    eps = torch.from_numpy(np.array(jax.random.normal(k_eps, (batch_size,))))
    return None, u.to(device), eps.to(device)


@pytest.mark.parametrize("method", ["ital", "emoc", "sud", "rbmal", "uncertainty_sampling"])
def test_noiseless_curves_equal_jax(method):
    want = jrunner.run_experiment(_cfg(jconfig, method))
    got = trunner.run_experiment(_cfg(tconfig, method), device="cpu")
    assert got["ap"].shape == (2, 3)
    np.testing.assert_allclose(got["ap"], want["ap"], atol=AP_ATOL)
    assert got["sessions"] == want["sessions"] and got["dataset"] == want["dataset"]
    assert got["device"] == "cpu"


@pytest.mark.parametrize("method", ["ital", "emoc", "uncertainty_sampling"])
def test_noisy_curves_equal_jax_with_its_draws(method, monkeypatch):
    """A user model whose path has no f32 MI ties (at 0.7/0.15 two candidates'
    MI differ by one ulp, and the two packages order that batch differently)."""
    user = dict(label_prob=0.8, mistake_prob=0.1)
    want = jrunner.run_experiment(_cfg(jconfig, method, **user))
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got = trunner.run_experiment(_cfg(tconfig, method, **user), device="cpu")
    np.testing.assert_allclose(got["ap"], want["ap"], atol=AP_ATOL)


def test_round_draws_depend_on_the_round_alone():
    a = trunner.round_draws(0, 0, 1, 7, 2, 4, "cpu")
    b = trunner.round_draws(0, 0, 1, 7, 2, 4, "cpu")
    c = trunner.round_draws(0, 0, 1, 7, 3, 4, "cpu")
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[1], c[1])
    assert torch.equal(torch.rand(3, generator=a[0]), torch.rand(3, generator=b[0]))


def test_resume_is_bit_identical(tmp_path):
    noisy = dict(label_prob=0.8, mistake_prob=0.1)
    full = trunner.run_experiment(_cfg(tconfig, "random", n_rounds=4, **noisy), device="cpu")
    ck = str(tmp_path / "ck")
    part = trunner.run_experiment(_cfg(tconfig, "random", n_rounds=2, checkpoint_dir=ck,
                                       **noisy), device="cpu")
    np.testing.assert_array_equal(part["ap"], full["ap"][:, :2])
    resumed = trunner.run_experiment(_cfg(tconfig, "random", n_rounds=4, checkpoint_dir=ck,
                                          resume=True, **noisy), device="cpu")
    np.testing.assert_array_equal(resumed["ap"], full["ap"])


def test_crash_resume_recovers(tmp_path):
    """A subprocess killed by the fault variable after round 1 resumes to the
    uninterrupted run's curve."""
    ck = str(tmp_path / "ck")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("ITAL_TPU_FAULT_AFTER_ROUND", None)

    def run(log_name, resume=False, fault=None):
        log = tmp_path / log_name
        args = [sys.executable, "-m", "ital_tpu_torch.cli", "configs/toy.ini", "--device", "cpu",
                "EXPERIMENT.n_rounds=4", "EXPERIMENT.batch_size=2", "EXPERIMENT.max_classes=1",
                "EXPERIMENT.queries_per_class=1", "DATA.n_per_class=40", "DATA.n_classes=2",
                "GP.cap=16", "USER.label_prob=0.8", "USER.mistake_prob=0.1",
                f"EXPERIMENT.checkpoint_dir={ck}", f"EXPERIMENT.log_jsonl={log}"]
        args += ["EXPERIMENT.resume=true"] if resume else []
        extra = {} if fault is None else {"ITAL_TPU_FAULT_AFTER_ROUND": str(fault)}
        p = subprocess.run(args, cwd=ROOT, env={**env, **extra}, capture_output=True,
                           text=True, timeout=300)
        rows = [json.loads(ln) for ln in log.read_text().splitlines()] if log.exists() else []
        return p, [r["ap"] for r in rows]

    p_ref, ref = run("ref.jsonl")
    assert p_ref.returncode == 0, p_ref.stderr[-2000:]
    for f in Path(ck).glob("*"):
        f.unlink()
    p_crash, crashed = run("crash.jsonl", fault=1)
    assert p_crash.returncode == 17, (p_crash.returncode, p_crash.stderr[-800:])
    assert len(crashed) == 2
    p_res, resumed = run("res.jsonl", resume=True)
    assert p_res.returncode == 0, p_res.stderr[-2000:]
    assert len(resumed) == 2  # only the rounds left are run
    assert crashed + resumed == ref


def test_refit_every_equals_jax_and_plain():
    want = jrunner.run_experiment(_cfg(jconfig, "uncertainty_sampling", gp={"refit_every": 1}))
    got = trunner.run_experiment(_cfg(tconfig, "uncertainty_sampling", gp={"refit_every": 1}),
                                 device="cpu")
    np.testing.assert_allclose(got["ap"], want["ap"], atol=AP_ATOL)
    plain = trunner.run_experiment(_cfg(tconfig, "uncertainty_sampling"), device="cpu")
    np.testing.assert_allclose(got["ap"], plain["ap"], atol=2e-3)


def test_capacity_guard():
    with pytest.raises(ValueError, match="capacity"):
        trunner.run_experiment(_cfg(tconfig, "random", gp={"cap": 6}), device="cpu")
    reg = tconfig.ExperimentConfig(task="regression", dataset="regression_toy",
                                   dataset_kwargs=dict(n=100, dim=1, seed=0),
                                   method="ital_regression", batch_size=3, n_rounds=6,
                                   gp=tconfig.GPConfig(cap=17))
    with pytest.raises(ValueError, match="capacity"):
        trunner.run_regression_experiment(reg, device="cpu")


def test_sessions_do_not_share_buffers():
    """Every session starts from the template; none writes it."""
    st0 = tgp.gp_init(torch.rand(50, 3), 1.0, 1.0, 0.1, 8)
    before = {f: getattr(st0, f).clone() for f in ("idx", "y", "valid", "l", "v", "mu", "sig2")}
    a = tgp.gp_set_query(tgp.gp_session_copy(st0), 4)
    tgp.gp_update(a, torch.tensor([1, 2]), torch.ones(2), torch.ones(2, dtype=torch.bool))
    for f, t in before.items():
        assert torch.equal(getattr(st0, f), t), f
    assert a.x is st0.x and a.x2 is st0.x2


def test_jsonl_rows_and_profile(tmp_path):
    log = tmp_path / "log.jsonl"
    res = trunner.run_experiment(_cfg(tconfig, "sud", n_rounds=2, log_jsonl=str(log),
                                      profile_dir=str(tmp_path / "prof")), device="cpu")
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert len(rows) == 2 * 2
    assert {"rep", "cls", "query", "round", "ap", "select_ms", "update_ms", "labeled",
            "device_mem_mb", "recall@10", "recall@50"} <= set(rows[0])
    assert rows[0]["device_mem_mb"] == 0.0 and rows[1]["labeled"] == 5
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert res["select_ms_steady"] is not None and res["first_round_ms"] > 0


def test_regression_rmse_equals_jax_with_its_draws(monkeypatch):
    kw = dict(task="regression", dataset="regression_toy", dataset_kwargs=dict(n=300, dim=1, seed=0),
              method="ital_regression", batch_size=3, n_rounds=5, repetitions=2, seed=0)
    want = jrunner.run_regression_experiment(jconfig.ExperimentConfig(
        gp=jconfig.GPConfig(length_scale=0.6, var=1.0, noise=0.05, cap=16),
        user=jconfig.UserConfig(label_prob=0.8), **kw))
    monkeypatch.setattr(trunner, "regression_draws", jax_regression_draws)
    got = trunner.run_regression_experiment(tconfig.ExperimentConfig(
        gp=tconfig.GPConfig(length_scale=0.6, var=1.0, noise=0.05, cap=16),
        user=tconfig.UserConfig(label_prob=0.8), **kw), device="cpu")
    assert got["rmse"].shape == (2, 5)
    np.testing.assert_allclose(got["rmse"], want["rmse"], atol=1e-5)
    assert got["mean_rmse"][-1] < got["mean_rmse"][0]


def test_cli_lists_the_reference_strategies_and_datasets(capsys):
    for flag in ("--list-strategies", "--list-datasets"):
        assert jcli.main([flag]) == 0
        want = capsys.readouterr().out
        assert tcli.main([flag]) == 0
        assert capsys.readouterr().out == want
    assert len(want.split()) == 6


def test_cli_map_table_equals_jax(capsys, tmp_path):
    ini = tmp_path / "toy.ini"
    ini.write_text(
        "[EXPERIMENT]\ndataset = toy\nmethod = borderline_sampling\n"
        "batch_size = 2\nn_rounds = 3\nqueries_per_class = 1\n"
        "[DATA]\nn_per_class = 40\nn_classes = 2\ndim = 2\nseed = 1\n"
        "[GP]\nlength_scale = 1.5\ncap = 8\n"
    )
    assert jcli.main([str(ini)]) == 0
    want = capsys.readouterr().out.splitlines()
    assert tcli.main([str(ini), "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    table = want.index("round  MAP")
    assert got[table:] == want[table:] and len(got[table:]) == 4
    assert got[0].endswith("device=cpu")


def test_cli_without_a_card_fails_on_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tcli.main(["configs/toy.ini"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
