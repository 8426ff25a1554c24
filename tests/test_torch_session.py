"""The port's slice end to end: sessions, round step, config and data, against ``ital_tpu``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu.data import datasets as jds
from ital_tpu.models import gp as jgp
from ital_tpu.models.session import ActiveRetrieval as JaxSession
from ital_tpu.select import ital as jital
from ital_tpu.select.base import StrategyParams as JaxParams
from ital_tpu.utils import config as jconfig
from ital_tpu_torch.data import datasets as tds
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.models.session import ActiveRetrieval
from ital_tpu_torch.round import round_step
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.utils import config as tconfig
from ital_tpu_torch.utils.metrics import average_precision
from tests.test_torch_gp import jax_state_arrays

ROOT = Path(__file__).resolve().parents[1]
PRODUCTION_INI = ROOT / "configs" / "mirflickr_production.ini"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_session_over_rounds_equals_jax():
    """The production selection (compact pool + two-stage refinement) at a
    small size: both sessions, fed the same feedback, pick the same batches
    every round and keep the same posterior mean."""
    ds = tds._synthetic_surrogate("mirflickr", 2000, 64, 14)
    kw = {"pool_size": 256, "n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512}
    common = dict(length_scale=12.0, var=1.0, noise=0.1, cap=32, label_prob=0.8,
                  mistake_prob=0.05, method_kwargs=kw)
    jsess = JaxSession(ds.x, **common)
    tsess = ActiveRetrieval(ds.x, device="cpu", **common)
    q = 17
    cls = int(ds.labels[q])
    jsess.update_query(q)
    tsess.update_query(q)
    for r in range(4):
        want = jsess.fetch_unlabelled(4)
        got = tsess.fetch_unlabelled(4)
        np.testing.assert_array_equal(got, want, err_msg=f"round {r}")
        # Relevance-true labels, with one item skipped per round.
        fb = {int(i): (1 if ds.relevance[i, cls] else -1) for i in want}
        fb[int(want[r % 4])] = None
        jsess.update(fb)
        tsess.update(fb)
        np.testing.assert_allclose(tsess.scores(), jsess.scores(), atol=1e-4,
                                   err_msg=f"round {r}")
    assert tsess.state.count == int(jsess.state.count) == 17
    np.testing.assert_array_equal(np.sort(tsess.relevant_ids), np.sort(jsess.relevant_ids))
    np.testing.assert_array_equal(np.sort(tsess.irrelevant_ids), np.sort(jsess.irrelevant_ids))
    np.testing.assert_array_equal(tsess.top_k(20), jsess.top_k(20))


def test_session_rejects_bad_options_and_overflow():
    ds = tds.toy_gaussians(n_per_class=20, n_classes=2, dim=2, seed=1)
    with pytest.raises(ValueError, match="unknown method_kwargs"):
        ActiveRetrieval(ds.x, length_scale=1.5, method_kwargs={"pool_siez": 8}, device="cpu")
    with pytest.raises(TypeError, match="numeric/bool scalar"):
        ActiveRetrieval(ds.x, length_scale=1.5, method_kwargs={"n_qmc": "32"}, device="cpu")
    sess = ActiveRetrieval(ds.x, length_scale=1.5, cap=5, device="cpu")
    sess.update_query(0)
    sess.update({1: 1, 2: -1})  # padded to 4 slots
    assert sess.state.count == 5
    with pytest.raises(ValueError, match="capacity exceeded"):
        sess.update({3: 1})


def test_round_step_matches_jax_selection():
    """round_step picks the reference's batch and absorbs the user's answers."""
    ds = jds.toy_gaussians(n_per_class=40, n_classes=3, dim=2, seed=2)
    js = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), 1.5, 1.0, 0.1, 16), jnp.asarray(3))
    js = jgp.gp_update(js, jnp.asarray([10, 50, 90, 100]), jnp.asarray([1., -1., 1., -1.]),
                       jnp.ones(4, bool))
    jp = JaxParams(label_prob=jnp.asarray(0.9), mistake_prob=jnp.asarray(0.1))
    want = np.asarray(jital.select_ital(js, 4, jax.random.PRNGKey(0), jp, n_qmc=64))
    ts = tgp.state_from_arrays(jax_state_arrays(js), "cpu")
    relevant = torch.from_numpy(ds.relevance[:, int(ds.labels[3])])
    exclude = torch.zeros(ds.n, dtype=torch.bool)
    exclude[3] = True
    tp = StrategyParams.create("cpu", label_prob=0.9, mistake_prob=0.1)
    ts, batch, ap = round_step(ts, torch.Generator().manual_seed(0), relevant, exclude, tp)
    np.testing.assert_array_equal(batch.numpy(), want)
    assert ts.count == 9
    np.testing.assert_array_equal(ts.idx[5:9].numpy(), want)
    assert float(ap) == float(average_precision(ts.mu, relevant, exclude))
    assert 0.0 < float(ap) <= 1.0


def test_production_config_loads_as_in_jax():
    want = jconfig.load_config(str(PRODUCTION_INI))
    got = tconfig.load_config(str(PRODUCTION_INI))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.method_kwargs == {"pool_size": 4096, "n_qmc": 32, "refine_top": 64,
                                 "refine_n_qmc": 512}
    with pytest.raises(ValueError, match="unknown key"):
        tconfig.load_config(str(PRODUCTION_INI), ("GP.lenght_scale=3",))


@pytest.mark.parametrize("precision,allow", [("", False), ("highest", False), ("high", True)])
def test_matmul_precision_sets_tf32_switches(precision, allow):
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        cfg = tconfig.load_config(str(PRODUCTION_INI), (f"GP.matmul_precision={precision}",))
        tconfig.apply_matmul_precision(cfg)
        assert torch.backends.cuda.matmul.allow_tf32 is allow
        assert torch.backends.cudnn.allow_tf32 is allow
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_large_batch_with_coarse_lattice_warns():
    with pytest.warns(UserWarning, match="coarse QMC lattice"):
        tconfig.load_config(str(PRODUCTION_INI),
                            ("EXPERIMENT.batch_size=7", "METHOD.refine_top=0"))


@pytest.mark.parametrize("name,kwargs", [
    ("surrogate", {}),
    ("toy", {"n_per_class": 30, "n_classes": 3, "dim": 5, "seed": 2}),
    ("mirflickr", {}),
])
def test_datasets_bit_equal_to_jax_package(name, kwargs):
    if name == "surrogate":
        want = jds._synthetic_surrogate("x", 700, 96, 5, seed=3)
        got = tds._synthetic_surrogate("x", 700, 96, 5, seed=3)
    else:
        want = jds.load_dataset(name, **kwargs)
        got = tds.load_dataset(name, **kwargs)
    assert got.name == want.name and got.synthetic == want.synthetic
    for f in ("x", "labels", "relevance", "classes"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_port_imports_neither_jax_nor_ital_tpu():
    """Importing the port, every module of it, loads no JAX."""
    code = (
        "import sys\n"
        "import ital_tpu_torch, ital_tpu_torch.round, ital_tpu_torch.models.session\n"
        "import ital_tpu_torch.models.gp, ital_tpu_torch.select.ital\n"
        "import ital_tpu_torch.select.base, ital_tpu_torch.ops.kernels\n"
        "import ital_tpu_torch.ops.rbf_hopper, ital_tpu_torch.ops._build\n"
        "import ital_tpu_torch.ops.chol, ital_tpu_torch.ops.mvn, ital_tpu_torch.ops.blocking\n"
        "import ital_tpu_torch.data.datasets, ital_tpu_torch.data.user\n"
        "import ital_tpu_torch.utils.config, ital_tpu_torch.utils.metrics\n"
        "import ital_tpu_torch.select.baselines, ital_tpu_torch.select.regression\n"
        "import ital_tpu_torch.runner, ital_tpu_torch.cli, ital_tpu_torch.utils.checkpoint\n"
        "import ital_tpu_torch.utils.logging, ital_tpu_torch.serve, ital_tpu_torch.models.hyperopt\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ital_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("strategy", ["sud", "adapt_al"])
def test_session_tradeoff_and_density_equal_jax(strategy):
    """The constructor's ``tradeoff`` and ``with_density`` reach the
    density-weighted baselines as in the reference session."""
    ds = tds.toy_gaussians(n_per_class=40, n_classes=3, dim=3, seed=7)
    common = dict(length_scale=1.5, noise=0.1, cap=16, strategy=strategy, tradeoff=0.3,
                  with_density=True)
    jsess = JaxSession(ds.x, **common)
    tsess = ActiveRetrieval(ds.x, device="cpu", **common)
    np.testing.assert_allclose(tsess.state.density.numpy(), np.asarray(jsess.state.density),
                               atol=1e-6)
    assert float(tsess.params.tradeoff) == pytest.approx(0.3)
    for s in (jsess, tsess):
        s.update_query(4)
        s.update({50: -1, 9: 1, 100: -1})
    np.testing.assert_array_equal(tsess.fetch_unlabelled(3), jsess.fetch_unlabelled(3))


def test_session_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """A NumPy corpus goes to the card by default; without one that raises,
    and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((10, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActiveRetrieval(x, length_scale=1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActiveRetrieval(torch.from_numpy(x), length_scale=1.0, device="cuda")
    assert ActiveRetrieval(x, length_scale=1.0, device="cpu").device.type == "cpu"
    assert ActiveRetrieval(torch.from_numpy(x), length_scale=1.0).device.type == "cpu"
