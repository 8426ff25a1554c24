"""Hyperparameter learning in the port against ``ital_tpu.models.hyperopt``.

The marginal likelihood, the Adam trajectories of ``fit_hyperparams`` (with
and without the MAP type-II knobs), the RBF block's hyperparameter gradient,
``ActiveRetrieval.learn_hyperparams`` and the runner's ``GP.learn_every``,
each on shared NumPy inputs.  Tolerances: the likelihood to 1e-5 relative in
f32; in f64 to 1e-10 against the dense formula and 1e-7 against JAX, whose
f64 path takes some products in f32.  Learned values to 1e-4 relative in f32
(1e-6 in f64): the two packages differentiate the same arithmetic in other
orders, and the Adam steps carry that difference along without amplifying it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu import runner as jrunner
from ital_tpu.models.gp import GPHyper as JaxHyper
from ital_tpu.models.hyperopt import fit_hyperparams as jfit
from ital_tpu.models.hyperopt import log_marginal_likelihood as jmll
from ital_tpu.models.session import ActiveRetrieval as JaxSession
from ital_tpu.utils import config as jconfig
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.models import hyperopt
from ital_tpu_torch.models.gp import GPHyper
from ital_tpu_torch.models.session import ActiveRetrieval
from ital_tpu_torch.ops.kernels import RBFHyperGrad, rbf_kernel, rbf_kernel_plain
from ital_tpu_torch.utils import config as tconfig
from tests.test_torch_runner import _cfg, jax_regression_draws, jax_round_draws

HYPER = ("length_scale", "var", "noise")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hypers(ls, var, noise, dtype=np.float32):
    jh = JaxHyper(length_scale=jnp.asarray(ls, dtype), var=jnp.asarray(var, dtype),
                  noise=jnp.asarray(noise, dtype))
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    th = GPHyper(length_scale=torch.tensor(ls, dtype=tdt), var=torch.tensor(var, dtype=tdt),
                 noise=torch.tensor(noise, dtype=tdt))
    return jh, th


def _values(h):
    return np.array([float(getattr(h, f)) for f in HYPER])


def _flippy(rng, cap=48, d=4, n_act=40, dtype=np.float32, inert=True):
    """±1 labels with 15% flips, where plain type-II ML moves the noise far."""
    xl = rng.normal(size=(cap, d)).astype(dtype)
    y = np.sign(xl[:, 0] + 1e-3).astype(dtype)
    y[rng.random(cap) < 0.15] *= -1
    active = np.arange(cap) < n_act
    if inert:
        active[[3, 7]] = False  # inert slots among the active ones
    return xl, y, active


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_act", [1, 7, 12])
def test_mll_matches_jax_and_dense_numpy(rng, dtype, n_act):
    """The padded likelihood equals JAX's and the textbook formula on the
    active block, with padding rows that are garbage."""
    cap, d = 12, 3
    xl = rng.normal(size=(cap, d)).astype(dtype)
    xl[~(np.arange(cap) < n_act)] = 1e3  # padding rows may hold anything
    y = rng.choice([-1.0, 1.0], size=cap).astype(dtype)
    active = np.arange(cap) < n_act
    with jax.enable_x64(dtype == np.float64):
        jh, th = _hypers(1.5, 0.8, 0.2, dtype)
        (jx, jy, ja), (tx, ty, ta) = _both((xl, y, active))
        want = float(jmll(jx, jy, ja, jh))
    got = hyperopt.log_marginal_likelihood(tx, ty, ta, th)
    assert got.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
    xa, ya = xl[active].astype(np.float64), y[active].astype(np.float64)
    k = 0.8 * np.exp(-((xa[:, None] - xa[None]) ** 2).sum(-1) / (2 * 1.5**2)) + 0.2 * np.eye(n_act)
    dense = -0.5 * (ya @ np.linalg.solve(k, ya) + np.linalg.slogdet(k)[1]
                    + n_act * np.log(2 * np.pi))
    f32 = dtype == np.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5 if f32 else 1e-7)
    np.testing.assert_allclose(float(got), dense, rtol=1e-4 if f32 else 1e-10)


FIT_CASES = {
    "defaults": {},
    "fixed_noise": {"learn_noise": False},
    "map": {"prior_strength": 2.0},
    "map_center": {"prior_strength": 2.0, "center": (0.7, 0.5, 0.2)},
    "noise_floor": {"noise_floor": 0.3},
    "map_and_floor": {"prior_strength": 1.0, "noise_floor": 0.05},
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_trajectory_matches_jax_f32(rng, case):
    kw = dict(FIT_CASES[case])
    center = kw.pop("center", None)
    (jx, jy, ja), (tx, ty, ta) = _both(_flippy(rng))
    jh, th = _hypers(2.0, 1.0, 1.0)
    jkw, tkw = dict(kw), dict(kw)
    if center is not None:
        jkw["prior_center"], tkw["prior_center"] = _hypers(*center)
    want = jfit(jx, jy, ja, jh, steps=60, lr=0.08, **jkw)
    got = hyperopt.fit_hyperparams(tx, ty, ta, th, steps=60, lr=0.08, **tkw)
    assert all(getattr(got, f).dtype == torch.float32 for f in HYPER)
    np.testing.assert_allclose(_values(got), _values(want), rtol=1e-4)
    assert not np.allclose(_values(got), [2.0, 1.0, 1.0], rtol=1e-3)  # it moved
    if case == "fixed_noise":
        assert got.noise is th.noise  # pinned bit-exactly
    if "noise_floor" in kw:
        assert float(got.noise) >= kw["noise_floor"] * (1 - 1e-6)


def test_fit_trajectory_matches_jax_f64(rng):
    """An f64 state: the iterate stays f32 (as in the reference), the
    hyperparameters come back f64."""
    with jax.enable_x64(True):
        (jx, jy, ja), (tx, ty, ta) = _both(_flippy(rng, dtype=np.float64))
        jh, th = _hypers(2.0, 1.0, 1.0, np.float64)
        want = _values(jfit(jx, jy, ja, jh, steps=40, lr=0.08))
    got = hyperopt.fit_hyperparams(tx, ty, ta, th, steps=40, lr=0.08)
    assert got.length_scale.dtype == torch.float64
    np.testing.assert_allclose(_values(got), want, rtol=1e-6)


def test_ascent_improves_mll_and_recovers_scale(rng):
    """Data drawn from a GP of known length scale: ascent raises the
    likelihood and moves the length scale toward it."""
    cap, d, n_act, true_ls = 32, 2, 28, 2.0
    xl = rng.normal(size=(cap, d)).astype(np.float32) * 3.0
    d2 = ((xl[:n_act, None] - xl[None, :n_act]) ** 2).sum(-1)
    k = np.exp(-d2 / (2 * true_ls**2)) + 0.05 * np.eye(n_act)
    y = np.zeros(cap, np.float32)
    y[:n_act] = np.linalg.cholesky(k) @ rng.normal(size=n_act)
    args = [torch.from_numpy(a) for a in (xl, y, np.arange(cap) < n_act)]
    _, h0 = _hypers(0.4, 1.0, 0.3)
    h1 = hyperopt.fit_hyperparams(*args, h0, steps=120, lr=0.08)
    assert float(hyperopt.log_marginal_likelihood(*args, h1)) > \
        float(hyperopt.log_marginal_likelihood(*args, h0)) + 1.0
    assert abs(np.log(float(h1.length_scale) / true_ls)) < abs(np.log(0.4 / true_ls))


def test_map_prior_strength_pins_its_center(rng):
    """A very strong prior keeps the estimate at its center; strength 0
    ignores the center entirely (the defaults are plain type-II ML)."""
    args = [torch.from_numpy(a) for a in _flippy(rng, inert=False)]
    _, h0 = _hypers(2.0, 1.0, 1.0)
    pinned = hyperopt.fit_hyperparams(*args, h0, steps=120, lr=0.08, prior_strength=1e4)
    np.testing.assert_allclose(_values(pinned), [2.0, 1.0, 1.0], rtol=2e-3)
    plain = hyperopt.fit_hyperparams(*args, h0, steps=40, lr=0.08)
    _, far = _hypers(9.0, 9.0, 9.0)
    off = hyperopt.fit_hyperparams(*args, h0, steps=40, lr=0.08, prior_strength=0.0,
                                   prior_center=far, noise_floor=0.0)
    assert _values(plain).tolist() == _values(off).tolist()


def test_rbf_hyper_gradient_gradchecks():
    """The Function's backward on the CPU, where its forward is the plain
    version, against finite differences in f64."""
    dtype = torch.float64
    g = torch.Generator().manual_seed(0)
    a = torch.rand(7, 3, generator=g, dtype=dtype)
    b = torch.rand(5, 3, generator=g, dtype=dtype)
    ls = torch.tensor(0.7, dtype=dtype, requires_grad=True)
    var = torch.tensor(1.3, dtype=dtype, requires_grad=True)
    assert torch.autograd.gradcheck(lambda l, v: RBFHyperGrad.apply(a, b, l, v, None, None),
                                    (ls, var))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("norms", [False, True])
def test_rbf_hyper_gradient_equals_plain_autograd(dtype, norms):
    """rbf_kernel routes through the Function when a hyperparameter requires
    grad; its gradients equal autograd through the plain version."""
    g = torch.Generator().manual_seed(1)
    a = torch.rand(9, 4, generator=g, dtype=dtype) * 3
    b = torch.rand(6, 4, generator=g, dtype=dtype) * 3
    w = torch.rand(9, 6, generator=g, dtype=dtype)
    kw = {"a2": (a * a).sum(-1), "b2": (b * b).sum(-1)} if norms else {}
    grads = []
    for fn in (rbf_kernel, rbf_kernel_plain):
        ls = torch.tensor(1.1, dtype=dtype, requires_grad=True)
        var = torch.tensor(0.6, dtype=dtype, requires_grad=True)
        k = fn(a, b, ls, var, **kw)
        assert (k.grad_fn is not None) and ((fn is rbf_kernel) == ("RBFHyperGrad" in
                                                                   type(k.grad_fn).__name__))
        (k * w).sum().backward()
        grads.append([float(ls.grad), float(var.grad)])
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(grads[0], grads[1], rtol=rtol)


def test_rbf_hyper_gradient_reaches_only_the_parameter_that_asks():
    a = torch.rand(4, 2)
    var = torch.tensor(0.5, requires_grad=True)
    rbf_kernel(a, a, 1.0, var).sum().backward()
    np.testing.assert_allclose(float(var.grad), float(rbf_kernel_plain(a, a, 1.0, 1.0).sum()),
                               rtol=1e-6)


def test_rbf_hyper_gradient_refuses_feature_gradients():
    a = torch.rand(4, 2, requires_grad=True)
    ls = torch.tensor(1.0, requires_grad=True)
    with pytest.raises(ValueError, match="must not require grad"):
        rbf_kernel(a, torch.rand(3, 2), ls, 1.0)


def _sessions():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(80, 4)).astype(np.float32)
    common = dict(length_scale=0.5, noise=0.3, cap=16)
    return x, JaxSession(x, **common), ActiveRetrieval(x, device="cpu", **common)


@pytest.mark.parametrize("kw", [{"steps": 40, "lr": 0.08}, {"steps": 30, "prior_strength": 1.0,
                                                            "noise_floor": 0.2},
                                {"steps": 30, "learn_noise": False}],
                         ids=["ml", "map+floor", "fixed_noise"])
def test_session_learn_hyperparams_matches_jax(kw):
    """The same labels give the same learned values and the same refit posterior."""
    _, js, ts = _sessions()
    for s in (js, ts):
        s.update_query(3)
        s.update({10: 1, 20: -1, 30: 1, 40: -1, 50: 1})
    before = ts.scores()
    want = js.learn_hyperparams(**kw)
    got = ts.learn_hyperparams(**kw)
    np.testing.assert_allclose([got[f] for f in HYPER], [want[f] for f in HYPER], rtol=1e-4)
    np.testing.assert_allclose(ts.scores(), js.scores(), atol=1e-4)
    assert not np.allclose(ts.scores(), before)
    after = ts.scores()
    assert after[10] > after[20] and after[50] > after[40]
    assert ts.state.hyper.length_scale.dtype == torch.float32


def test_failed_learn_leaves_the_session_as_it_was(monkeypatch):
    """A refit that fails (here: a fit that returns a negative noise, so the
    labeled block is not positive definite) changes nothing."""
    _, _, ts = _sessions()
    ts.update_query(3)
    ts.update({10: 1, 20: -1})
    mu, l, hyper = ts.state.mu.clone(), ts.state.l.clone(), ts.state.hyper
    bad = GPHyper(length_scale=torch.tensor(0.5), var=torch.tensor(1.0), noise=torch.tensor(-5.0))
    monkeypatch.setattr(hyperopt, "fit_hyperparams", lambda *a, **k: bad)
    with pytest.raises(torch.linalg.LinAlgError):
        ts.learn_hyperparams(steps=3)
    assert ts.state.hyper is hyper
    assert torch.equal(ts.state.mu, mu) and torch.equal(ts.state.l, l)


LEARN_GP = {"learn_every": 2, "learn_steps": 20, "learn_lr": 0.05}


@pytest.mark.parametrize("gp", [
    LEARN_GP,
    {**LEARN_GP, "learn_prior_strength": 1.0, "learn_noise_floor": 0.05},
    {**LEARN_GP, "learn_noise": False},
], ids=["ml", "map", "fixed_noise"])
def test_runner_learn_every_matches_jax_with_its_draws(gp, monkeypatch, tmp_path):
    """GP.learn_every on the serial runner, a noisy user fed JAX's draws:
    the AP curves and the logged hyperparameters equal JAX's."""
    user = dict(label_prob=0.8, mistake_prob=0.1)
    kw = dict(n_rounds=4, method_kwargs={"n_qmc": 32}, gp=gp, **user)
    jlog, tlog = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    want = jrunner.run_experiment(_cfg(jconfig, "ital", log_jsonl=str(jlog), **kw))
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got = trunner.run_experiment(_cfg(tconfig, "ital", log_jsonl=str(tlog), **kw), device="cpu")
    np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-5)
    fields = ("length_scale", "gp_var", "gp_noise")
    jrows = [json.loads(line) for line in jlog.read_text().splitlines()]
    trows = [json.loads(line) for line in tlog.read_text().splitlines()]
    assert len(trows) == len(jrows) == 8
    np.testing.assert_allclose([[r[f] for f in fields] for r in trows],
                               [[r[f] for f in fields] for r in jrows], rtol=2e-4, atol=1e-4)
    assert trows[-1]["length_scale"] != 1.5  # learning moved it


def test_regression_learn_every_matches_jax_with_its_draws(monkeypatch):
    """On a tie-free dataset seed: at seed 0 the picks right after the first
    re-learn split on a near-tie of ital_regression's scores, which a 1e-6
    difference in the learned values decides."""
    kw = dict(task="regression", dataset="regression_toy",
              dataset_kwargs=dict(n=300, dim=1, seed=2), method="ital_regression",
              batch_size=3, n_rounds=4, repetitions=1, seed=0)
    gp = dict(length_scale=0.6, var=1.0, noise=0.05, cap=16, **LEARN_GP)
    want = jrunner.run_regression_experiment(jconfig.ExperimentConfig(
        gp=jconfig.GPConfig(**gp), user=jconfig.UserConfig(label_prob=0.8), **kw))
    monkeypatch.setattr(trunner, "regression_draws", jax_regression_draws)
    got = trunner.run_regression_experiment(tconfig.ExperimentConfig(
        gp=tconfig.GPConfig(**gp), user=tconfig.UserConfig(label_prob=0.8), **kw), device="cpu")
    np.testing.assert_allclose(got["rmse"], want["rmse"], atol=1e-5)
    np.testing.assert_allclose([got["hyper"][f] for f in ("length_scale", "var", "noise")],
                               [want["hyper"][f] for f in ("length_scale", "var", "noise")],
                               rtol=1e-4)


def test_runner_learn_every_resumes_bit_identically(tmp_path):
    """The learned hyperparameters ride in the checkpoint: a resumed run
    continues with them."""
    noisy = dict(label_prob=0.8, mistake_prob=0.1)
    kw = dict(n_rounds=4, method_kwargs={"n_qmc": 32}, gp=LEARN_GP, **noisy)
    full = trunner.run_experiment(_cfg(tconfig, "ital", **kw), device="cpu")
    ck = str(tmp_path / "ck")
    trunner.run_experiment(_cfg(tconfig, "ital", checkpoint_dir=ck,
                                **{**kw, "n_rounds": 3}), device="cpu")
    resumed = trunner.run_experiment(_cfg(tconfig, "ital", checkpoint_dir=ck, resume=True, **kw),
                                     device="cpu")
    np.testing.assert_array_equal(resumed["ap"], full["ap"])


def test_learn_kwargs_anchor_the_prior_at_the_config():
    cfg = _cfg(tconfig, "ital", gp={**LEARN_GP, "learn_prior_strength": 2.0})
    st = tgp.gp_init(torch.zeros(5, 2), 3.0, 2.0, 0.5, 4)  # the iterate's values differ
    kw = trunner._learn_kwargs(cfg, st)
    assert kw["prior_strength"] == 2.0 and kw["steps"] == 20
    assert [float(getattr(kw["prior_center"], f)) for f in HYPER] == [1.5, 1.0, pytest.approx(0.1)]
