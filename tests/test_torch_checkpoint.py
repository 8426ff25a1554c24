"""Session checkpoints: round trips within the port and across packages, both ways."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu import runner as jrunner
from ital_tpu.data import datasets as jds
from ital_tpu.models import gp as jgp
from ital_tpu.utils import checkpoint as jckpt
from ital_tpu.utils import config as jconfig
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.utils import checkpoint as tckpt
from ital_tpu_torch.utils import config as tconfig
from tests.test_torch_gp import jax_state_arrays
from tests.test_torch_runner import _cfg

SESSION = ("idx", "y", "valid", "l", "beta", "v", "mu", "sig2", "density")


@pytest.fixture(scope="module")
def jax_state():
    """A warmed JAX session with a density and a skipped slot."""
    ds = jds.toy_gaussians(n_per_class=30, n_classes=3, dim=2, seed=4)
    st = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), 1.5, 0.9, 0.1, cap=12), jnp.asarray(5))
    st = jgp.gp_update(st, jnp.asarray([10, 40, 70, 3]), jnp.asarray([1.0, -1.0, 1.0, -1.0]),
                       jnp.asarray([True, True, False, True]))
    return st.replace(density=jgp.corpus_density(st))


def _port_state(js):
    arrays = jax_state_arrays(js)
    arrays["density"] = np.asarray(js.density)
    return tgp.state_from_arrays(arrays, "cpu")


def _template(js):
    """The port's fresh session over the same corpus (no labels, no density)."""
    return tgp.gp_init(torch.from_numpy(np.array(js.x)), 1.0, 1.0, 0.5, js.cap)


def _assert_same_session(ts, js):
    assert ts.count == int(js.count)
    for f in SESSION:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        assert got.shape == want.shape and np.array_equal(got, want), f
    for f in ("length_scale", "var", "noise"):
        assert float(getattr(ts.hyper, f)) == float(getattr(js.hyper, f)), f


def test_port_round_trip_keeps_everything(tmp_path, jax_state):
    ts = _port_state(jax_state)
    path = str(tmp_path / "s.npz")
    tckpt.save_session(path, ts, extra={"curve": np.array([0.5, 0.75]), "next_round": 2})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["s.npz"]  # no torn .tmp left
    template = _template(jax_state)
    got, extras = tckpt.load_session(path, template)
    _assert_same_session(got, jax_state)
    assert got.x is template.x and got.x2 is template.x2
    np.testing.assert_array_equal(extras["curve"], [0.5, 0.75])
    assert int(extras["next_round"]) == 2
    # The restored buffers are the session's own: updating it leaves the template alone.
    mu0 = template.mu.clone()
    tgp.gp_update(got, torch.tensor([20, 21]), torch.ones(2), torch.ones(2, dtype=torch.bool))
    assert torch.equal(template.mu, mu0)


def test_port_snapshot_restores_in_jax(tmp_path, jax_state):
    path = str(tmp_path / "s.npz")
    tckpt.save_session(path, _port_state(jax_state), extra={"next_round": 3})
    jtemplate = jgp.gp_init(jax_state.x, 1.0, 1.0, 0.5, jax_state.cap)
    js, extras = jckpt.load_session(path, jtemplate)
    for f in SESSION + ("count",):
        a, b = np.asarray(getattr(js, f)), np.asarray(getattr(jax_state, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert float(js.hyper.var) == float(jax_state.hyper.var)
    assert int(extras["next_round"]) == 3


def test_jax_snapshot_restores_in_port(tmp_path, jax_state):
    path = str(tmp_path / "s.npz")
    jckpt.save_session(path, jax_state, extra={"curve": np.array([0.25])})
    got, extras = tckpt.load_session(path, _template(jax_state))
    _assert_same_session(got, jax_state)
    np.testing.assert_array_equal(extras["curve"], [0.25])
    # Without a density in the snapshot the template's is kept.
    jckpt.save_session(path, jax_state.replace(density=None))
    template = _template(jax_state)
    template.density = torch.full_like(template.mu, 0.5)
    assert tckpt.load_session(path, template)[0].density is template.density


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_runner_resumes_across_packages(tmp_path, writer):
    """Two rounds run by one package, checkpointed, then finished by the other,
    give the curve of an uninterrupted run."""
    ck = str(tmp_path / "ck")
    full = jrunner.run_experiment(_cfg(jconfig, "emoc", n_rounds=4))
    if writer == "jax":
        jrunner.run_experiment(_cfg(jconfig, "emoc", n_rounds=2, checkpoint_dir=ck))
        resumed = trunner.run_experiment(
            _cfg(tconfig, "emoc", n_rounds=4, checkpoint_dir=ck, resume=True), device="cpu")
    else:
        trunner.run_experiment(_cfg(tconfig, "emoc", n_rounds=2, checkpoint_dir=ck), device="cpu")
        resumed = jrunner.run_experiment(
            _cfg(jconfig, "emoc", n_rounds=4, checkpoint_dir=ck, resume=True))
    np.testing.assert_allclose(resumed["ap"], full["ap"], atol=1e-6)
