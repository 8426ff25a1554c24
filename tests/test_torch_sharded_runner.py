"""The port's runner with ``EXPERIMENT.mesh_devices`` (the sharded per-round
path) against its own ``mesh_devices = 0`` run, on gloo meshes of 2 and 4
CPU processes.

Every rank draws what the single-device runner draws, so the AP curves are
equal (AP is float32: atol 1e-6).  A 135-row toy corpus pads to 136 rows on
both meshes.  The ranks are started by the runner itself (spawn), so this
module imports nothing of ``jax`` or ``ital_tpu``.
"""

import json

import numpy as np
import pytest
import torch

from ital_tpu_torch import cli as tcli
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.utils import config as tconfig

AP_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(method, mesh=0, gp=None, **kw):
    base = dict(
        dataset="toy", dataset_kwargs=dict(n_per_class=45, n_classes=3, dim=2, seed=0),
        method=method, batch_size=2, n_rounds=3, repetitions=1, queries_per_class=1,
        max_classes=2, seed=0, mesh_devices=mesh,
        gp=tconfig.GPConfig(**{"length_scale": 1.5, "var": 1.0, "noise": 0.1, "cap": 16,
                               **(gp or {})}),
        user=tconfig.UserConfig(label_prob=0.8, mistake_prob=0.1),
        method_kwargs={"n_qmc": 32} if method == "ital" else {},
    )
    base.update(kw)
    return tconfig.ExperimentConfig(**base)


def _both(method, mesh, **kw):
    return (trunner.run_experiment(_cfg(method, mesh, **kw), device="cpu"),
            trunner.run_experiment(_cfg(method, 0, **kw), device="cpu"))


@pytest.mark.parametrize("mesh,method", [
    (2, "ital"), (2, "emoc"), (2, "sud"), (2, "random"),
    (4, "ital"), (4, "mcmi_min"), (4, "rbmal"), (4, "emoc_batch"),
])
def test_sharded_runner_curves_equal_the_single_device_runner(mesh, method):
    got, want = _both(method, mesh)
    assert got["ap"].shape == (2, 3) and got["mesh_devices"] == mesh
    np.testing.assert_allclose(got["ap"], want["ap"], atol=AP_ATOL)
    np.testing.assert_allclose(got["map"], want["map"], atol=AP_ATOL)
    assert got["sessions"] == want["sessions"] and got["device"] == "cpu"


def test_ital_modes_on_the_mesh_give_the_single_device_curves():
    """Pool with refinement, randomized QMC and a subsample, drawn from each
    round's generator on every rank as the single-device run draws."""
    for kw in ({"n_qmc": 16, "pool_size": 30, "refine_top": 8, "refine_n_qmc": 64,
                "randomize_qmc": True},
               {"n_qmc": 16, "subsample_size": 40, "randomize_qmc": True}):
        got, want = _both("ital", 2, method_kwargs=kw)
        np.testing.assert_allclose(got["ap"], want["ap"], atol=AP_ATOL, err_msg=str(kw))


@pytest.mark.parametrize("gp", [{"learn_every": 2, "learn_steps": 20},
                                {"refit_every": 1}], ids=["learn_every", "refit_every"])
def test_learn_and_refit_on_the_mesh_equal_the_single_device_runner(gp, tmp_path):
    log = tmp_path / "mesh.jsonl"
    got, want = _both("uncertainty_sampling", 2, gp=gp, log_jsonl=str(log))
    np.testing.assert_allclose(got["ap"], want["ap"], atol=AP_ATOL)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    mesh_rows = [r for r in rows if "sharded" in r]
    assert len(mesh_rows) == 6 and all(r["sharded"] == 2 for r in mesh_rows)
    if "learn_every" in gp:  # the learned values of both runs, round by round
        single = [r for r in rows if "sharded" not in r]
        for a, b in zip(mesh_rows, single):
            assert abs(a["length_scale"] - b["length_scale"]) <= 1e-4
        assert mesh_rows[-1]["length_scale"] != 1.5


def test_jsonl_rows_carry_recall_labeled_and_the_mesh(tmp_path):
    log = tmp_path / "log.jsonl"
    trunner.run_experiment(_cfg("sud", 4, log_jsonl=str(log)), device="cpu")
    rows = [json.loads(line) for line in log.read_text().splitlines()]  # rank 0's alone
    assert len(rows) == 2 * 3
    assert {"rep", "cls", "query", "round", "ap", "select_ms", "update_ms", "labeled",
            "recall@10", "recall@50", "sharded"} <= set(rows[0])
    assert all(1 <= r["labeled"] <= 3 + 2 * r["round"] for r in rows)
    assert all(0.0 <= r["recall@50"] <= 1.0 for r in rows)


def test_resume_from_a_round_checkpoint_is_bit_identical(tmp_path):
    full = trunner.run_experiment(_cfg("random", 2, n_rounds=4), device="cpu")
    ck = tmp_path / "ck"
    part = trunner.run_experiment(_cfg("random", 2, n_rounds=2, checkpoint_dir=str(ck)),
                                  device="cpu")
    np.testing.assert_array_equal(part["ap"], full["ap"][:, :2])
    serial = tmp_path / "serial"
    trunner.run_experiment(_cfg("random", 0, n_rounds=2, checkpoint_dir=str(serial)),
                           device="cpu")
    name = sorted(p.name for p in ck.glob("*.npz"))[0]
    with np.load(ck / name) as a, np.load(serial / name) as b:  # the single-device layout
        assert set(a.files) == set(b.files)
        assert a["state_v"].shape[1] == 136 and b["state_v"].shape[1] == 135
        np.testing.assert_array_equal(a["state_idx"], b["state_idx"])
        np.testing.assert_allclose(a["state_mu"][:135], b["state_mu"], atol=1e-6)
    resumed = trunner.run_experiment(_cfg("random", 2, n_rounds=4, checkpoint_dir=str(ck),
                                          resume=True), device="cpu")
    np.testing.assert_array_equal(resumed["ap"], full["ap"])


def test_a_mesh_of_one_runs_in_process():
    got, want = _both("emoc", 1)
    np.testing.assert_array_equal(got["ap"], want["ap"])  # the same blocks, the same sums
    assert got["mesh_devices"] == 1


def test_cli_prints_the_single_device_map_table(capsys):
    args = ["configs/toy.ini", "EXPERIMENT.n_rounds=3", "EXPERIMENT.queries_per_class=1",
            "DATA.n_per_class=40"]
    assert tcli.main(args + ["--device", "cpu"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert tcli.main(args + ["EXPERIMENT.mesh_devices=2", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    table = want.index("round  MAP")
    assert got[table:] == want[table:] and len(got[table:]) == 4


def test_a_mesh_without_cards_fails_and_never_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="requested 1 devices, only 0 available"):
        trunner.run_experiment(_cfg("random", 8), device="cuda")
    assert "# mesh_devices=8 requested, 0 available -> using 1" in capsys.readouterr().out
