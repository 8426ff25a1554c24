"""The hyperparameter ascent as a program (``ital_tpu_torch.graphs``): the
fit, its stacked K-session form, the stacked refit, ``/learn``'s re-learn and
the runner's re-learn inside its cohort programs, against their eager runs
and against ``ital_tpu``.

The graph path runs through the stand-in graph of ``tests/test_torch_graphs.py``
(the body recomputed into the captured buffers at each replay), so a graphed
call is held to its ``graphs.eager()`` twin bit for bit.  Sizes: cap <= 16,
D <= 32.  Tolerances against JAX are ``tests/test_torch_hyperopt.py``'s:
learned values to 1e-4 relative in f32 and 1e-6 in f64; curves to 1e-5.  The
stacked forms against their single-session forms: bit for bit on the CPU,
where a batched LAPACK call factors each matrix as a single call does.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu import runner as jrunner
from ital_tpu.data import datasets as jds
from ital_tpu.models.gp import GPHyper as JaxHyper
from ital_tpu.models.hyperopt import fit_hyperparams as jfit
from ital_tpu.utils import config as jconfig
from ital_tpu_torch import graphs
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.data import datasets as tds
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.models import hyperopt
from ital_tpu_torch.models.gp import GPHyper
from ital_tpu_torch.serve import RetrievalService
from ital_tpu_torch.utils import config as tconfig
from tests.test_torch_graphs import stand_in  # noqa: F401 (the stand-in graph fixture)
from tests.test_torch_runner import jax_round_draws

HYPER = ("length_scale", "var", "noise")
CAP, D = 16, 8
N_SURROGATE, D_SURROGATE, LS = 600, 32, 12.0
PRODUCTION_KW = {"pool_size": 256, "n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512}
FIT_CASES = {
    "ml": {},
    "map": {"prior_strength": 2.0, "center": (0.7, 0.5, 0.2)},
    "noise_floor": {"noise_floor": 0.3},
    "fixed_noise": {"learn_noise": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def surrogate():
    return tds._synthetic_surrogate("mirflickr", N_SURROGATE, D_SURROGATE, 14, seed=3)


def _labeled(seed, dtype=np.float32, n_act=13):
    """A (CAP, D) labeled set of ±1 labels with 15% flips and two inert
    slots among the active ones."""
    rng = np.random.default_rng(seed)
    xl = rng.normal(size=(CAP, D)).astype(dtype)
    y = np.sign(xl[:, 0] + 1e-3).astype(dtype)
    y[rng.random(CAP) < 0.15] *= -1
    active = np.arange(CAP) < n_act
    active[[2, 5]] = False
    return xl, y, active


def _hyper(values, dtype=torch.float32):
    return GPHyper(*(torch.tensor(v, dtype=dtype) for v in values))


def _fit_kw(case, dtype=torch.float32):
    kw = dict(FIT_CASES[case], steps=12, lr=0.08)
    center = kw.pop("center", None)
    if center is not None:
        kw["prior_center"] = _hyper(center, dtype)
    return kw


def _values(h):
    return np.array([float(getattr(h, f)) for f in HYPER])


def _equal_hyper(a, b):
    for f in HYPER:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# -- the single ascent ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(FIT_CASES))
def test_graphed_fit_equals_eager_fit(stand_in, case, dtype):
    """The ascent through its program equals its eager run bit for bit, at
    every step's gradient; a second labeled set replays the program."""
    h0 = _hyper((2.0, 1.0, 1.0), dtype)
    kw = _fit_kw(case, dtype)
    for seed in (0, 1):
        xl, y, active = (torch.from_numpy(a) for a in _labeled(seed, np.float64
                                                               if dtype == torch.float64
                                                               else np.float32))
        got, got_grads = hyperopt.fit_with_gradients(xl, y, active, h0, **kw)
        with graphs.eager():
            want, want_grads = hyperopt.fit_with_gradients(xl, y, active, h0, **kw)
        _equal_hyper(got, want)
        assert torch.equal(got_grads, want_grads)
        assert got_grads.shape == (kw["steps"], 3) and bool((got_grads != 0).any())
        assert got.length_scale.dtype == dtype
        if case == "fixed_noise":
            assert got.noise is h0.noise
    assert stand_in == ["fit_hyperparams"]
    (prog,) = graphs.programs()
    assert prog.replays == 2 and sum(prog.launches.values()) == kw["steps"]


def test_fit_hyperparams_is_the_program_and_keeps_its_options_apart(stand_in):
    """``fit_hyperparams`` is a program that returns the iterate alone: it
    equals ``fit_with_gradients``, whose gradients are an output of a
    program of its own, and replays at the same shapes and options; other
    options or shapes capture programs of their own."""
    xl, y, active = (torch.from_numpy(a) for a in _labeled(0))
    h0 = _hyper((2.0, 1.0, 1.0))
    a = hyperopt.fit_hyperparams(xl, y, active, h0, steps=5)
    (fit,) = graphs.programs()
    assert len(fit.outputs) == 1
    b, _ = hyperopt.fit_with_gradients(xl, y, active, h0, steps=5)
    _equal_hyper(a, b)
    with torch.no_grad():  # the body differentiates whatever the caller's mode
        _equal_hyper(hyperopt.fit_hyperparams(xl, y, active, h0, steps=5), a)
    hyperopt.fit_hyperparams(xl, y, active, h0, steps=6)
    hyperopt.fit_hyperparams(xl[:8], y[:8], active[:8], h0, steps=5)
    assert stand_in == ["fit_hyperparams"] * 4
    assert fit.replays == 2
    assert sorted(p.replays for p in graphs.programs()) == [1, 1, 1, 2]


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_a_block_that_is_not_positive_definite_raises_after_the_ascent(stand_in, graphed):
    """A negative noise makes every step's block indefinite: the ascent raises
    the Cholesky's own error once, after its steps."""
    xl, y, active = (torch.from_numpy(a) for a in _labeled(0))
    with contextlib.nullcontext() if graphed else graphs.eager():
        with pytest.raises(torch.linalg.LinAlgError, match="not positive-definite") as err:
            hyperopt.fit_hyperparams(xl, y, active, _hyper((2.0, 1.0, -5.0)), steps=4)
    assert str(err.value).startswith("linalg.cholesky: The factorization")  # one matrix's text
    assert [p.replays for p in graphs.programs()] == ([1] if graphed else [])


# -- the stacked ascent and refit -------------------------------------------------------


def _stacked_labeled(k, dtype=np.float32):
    sets = [_labeled(seed, dtype, n_act=9 + seed) for seed in range(k)]
    return [np.stack(a) for a in zip(*sets)]


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-4), (np.float64, 1e-6)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["ml", "map", "noise_floor", "fixed_noise"])
def test_stacked_fit_equals_single_fits_and_jax_vmap(stand_in, case, dtype, rtol):
    """K sessions' ascent as one program follows each session's own
    ``fit_hyperparams`` bit for bit and ``jax.vmap`` of the reference's
    within its tolerance; graphed equals eager."""
    k = 3
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    xl, y, active = _stacked_labeled(k, dtype)
    starts = [(2.0, 1.0, 1.0), (1.2, 0.7, 0.4), (3.0, 1.5, 0.8)]
    kw = _fit_kw(case, tdt)
    center = kw.pop("prior_center", None)
    h0 = [_hyper(s, tdt) for s in starts]
    theta0 = torch.stack([hyperopt._log_theta(h) for h in h0])
    theta_c = None if center is None else hyperopt._log_theta(center)
    txl, ty, ta = (torch.from_numpy(a) for a in (xl, y, active))
    got = hyperopt.fit_hyperparams_stacked(txl, ty, ta, theta0, theta_c=theta_c, **kw)
    with graphs.eager():
        want = hyperopt.fit_hyperparams_stacked(txl, ty, ta, theta0, theta_c=theta_c, **kw)
    assert torch.equal(got, want) and got.shape == (k, 3) and got.dtype == torch.float32
    single = hyperopt._unpack(got, tdt)
    for j in range(k):
        one = hyperopt.fit_hyperparams(txl[j], ty[j], ta[j], h0[j], prior_center=center, **kw)
        for f in HYPER[:2] if case == "fixed_noise" else HYPER:
            assert torch.equal(getattr(single, f)[j], getattr(one, f)), (j, f)
    with jax.enable_x64(dtype == np.float64):
        jh0 = JaxHyper(*(jnp.asarray([s[i] for s in starts], dtype) for i in range(3)))
        jkw = {key: v for key, v in kw.items()}
        if center is not None:
            jkw["prior_center"] = JaxHyper(*(jnp.asarray(float(getattr(center, f)), dtype)
                                             for f in HYPER))
        fit = jax.vmap(lambda a, b, c, h: jfit(a, b, c, h, **jkw),
                       in_axes=(0, 0, 0, JaxHyper(0, 0, 0)))
        jout = fit(jnp.asarray(xl), jnp.asarray(y), jnp.asarray(active), jh0)
        want_j = np.stack([np.asarray(getattr(jout, f)) for f in HYPER], -1)
    np.testing.assert_allclose(torch.stack([getattr(single, f) for f in HYPER], -1).numpy(),
                               want_j, rtol=rtol)
    assert stand_in == ["fit_hyperparams_stacked", "fit_hyperparams"]


def _cohort_states(surrogate, specs, dtype=torch.float32):
    """Sessions of ``(query, hyperparameters, blocks of 4)`` on the surrogate."""
    x = torch.from_numpy(surrogate.x).to(dtype)
    out = []
    for q, hyper, blocks in specs:
        st = tgp.gp_set_query(tgp.gp_init(x, *hyper, CAP), q)
        rng = np.random.default_rng(q)
        for _ in range(blocks):
            idx = torch.from_numpy(rng.choice(N_SURROGATE, 4, replace=False))
            y = torch.tensor([1.0, -1.0, 1.0, 1.0], dtype=dtype)
            tgp.gp_update(st, idx, y, torch.tensor([True, True, False, True]))
        out.append(st)
    return out


SPECS = [(17, (LS, 1.0, 0.1), 1), (240, (10.0, 0.8, 0.05), 2), (410, (8.0, 1.2, 0.2), 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gp_fit_stacked_equals_single_fits(surrogate, dtype):
    """K sessions refit at once, each with its own hyperparameters and at
    its own count, equal K ``gp_fit``s."""
    states = _cohort_states(surrogate, SPECS, dtype)
    st = tgp.stack_states(states)
    st.hyper_groups = [[0], [1], [2]]
    tgp.gp_fit_stacked(st)
    atol = 1e-6 if dtype == torch.float32 else 1e-12
    for j, s in enumerate(states):
        fitted = tgp.gp_fit(tgp.gp_session_copy(s))
        for f in tgp.POSTERIOR_FIELDS:
            np.testing.assert_allclose(getattr(st, f)[j].numpy(), getattr(fitted, f).numpy(),
                                       rtol=0, atol=atol, err_msg=f)


def test_gp_refit_writes_the_session_buffers_in_place(surrogate):
    (state,) = _cohort_states(surrogate, SPECS[:1])
    bufs = {f: getattr(state, f) for f in tgp.POSTERIOR_FIELDS}
    want = tgp.gp_fit(tgp.gp_session_copy(state))
    tgp.gp_refit(state)
    for f, buf in bufs.items():
        assert getattr(state, f) is buf and torch.equal(buf, getattr(want, f)), f


# -- the re-learn programs ---------------------------------------------------------------


def test_relearn_stacked_equals_each_session_relearn(surrogate, stand_in):
    """The cohort body's re-learn of K sessions equals each session's own
    ``relearn`` program: new values, singleton groups, refit posteriors."""
    states = _cohort_states(surrogate, SPECS)
    twins = [tgp.gp_session_copy(s) for s in states]
    learn = dict(steps=8, lr=0.05, learn_noise=True, prior_strength=1.0, noise_floor=0.05)
    center = torch.tensor([LS, 1.0, 0.1])
    st = tgp.stack_states(states)
    hyperopt.relearn_stacked(st, center=center, **learn)
    assert st.hyper_groups == [[0], [1], [2]]
    for j, s in enumerate(twins):
        h = hyperopt.relearn(s, prior_center=GPHyper(*center.unbind()), **learn)
        for f in HYPER:
            assert torch.equal(getattr(st.hyper, f)[j], getattr(h, f)), (j, f)
        for f in tgp.POSTERIOR_FIELDS:
            np.testing.assert_allclose(getattr(st, f)[j].numpy(), getattr(s, f).numpy(),
                                       rtol=0, atol=1e-6, err_msg=f)
    assert stand_in == ["fit_hyperparams_stacked", "relearn"]
    assert [p.replays for p in graphs.programs()] == [1, 3]


def test_failed_relearn_leaves_the_session_unchanged(surrogate, stand_in, monkeypatch):
    """A refit whose block is not positive definite raises once the relearn
    program ran, and nothing reaches the session."""
    (state,) = _cohort_states(surrogate, SPECS[:1])
    before = tgp.gp_session_copy(state)
    hyper = state.hyper
    monkeypatch.setattr(hyperopt, "fit_hyperparams",
                        lambda *a, **k: _hyper((LS, 1.0, -5.0)))
    with pytest.raises(torch.linalg.LinAlgError, match="not positive-definite"):
        hyperopt.relearn(state, steps=3)
    assert state.hyper is hyper
    for f in tgp.SESSION_FIELDS:
        assert torch.equal(getattr(state, f), getattr(before, f)), f
    assert [p.name for p in graphs.programs()] == ["relearn"]


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_failed_stacked_relearn_leaves_all_sessions_unchanged(surrogate, stand_in, monkeypatch,
                                                              graphed):
    """A cohort program whose re-learn gives one session a block that is not
    positive definite raises once it ran, and no write reaches any of the K
    sessions."""
    cfg = _run_cfg(tconfig, query_batch=3, gp={"learn_every": 1, "learn_steps": 3})
    states = _cohort_states(surrogate, [(q, (LS, 1.0, 0.1), n) for q, _, n in SPECS])
    before = [tgp.gp_session_copy(s) for s in states]
    fit = hyperopt.fit_hyperparams_stacked

    def broken(*args, **kwargs):
        theta = fit(*args, **kwargs)
        return torch.cat([theta[:, :2], torch.full_like(theta[:, 2:], torch.nan)], 1)

    monkeypatch.setattr(hyperopt, "fit_hyperparams_stacked", broken)
    params = trunner.StrategyParams.create("cpu", label_prob=0.8, mistake_prob=0.05)
    chunk = [(0, int(surrogate.labels[q]), q) for q, _, _ in SPECS]
    relevant = torch.from_numpy(np.stack([surrogate.relevance[:, c] for _, c, _ in chunk]))
    exclude = torch.zeros((3, N_SURROGATE), dtype=torch.bool)
    with contextlib.nullcontext() if graphed else graphs.eager():
        with pytest.raises(torch.linalg.LinAlgError, match="not positive-definite"):
            trunner._cohort_rounds(cfg, states, params, dict(PRODUCTION_KW), chunk, range(1),
                                   relevant, exclude)
    for a, b in zip(states, before):
        for f in tgp.SESSION_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert a.hyper is b.hyper
    assert [p.replays for p in graphs.programs()] == ([1] if graphed else [])


# -- the entry points: /learn and the runner ------------------------------------------------


def test_service_learn_is_graphed_and_equals_eager(surrogate, stand_in):
    """``/learn`` through ``RetrievalService`` replays one relearn program
    (a second session with other labels replays it too) and gives the eager
    service's values and posterior bit for bit."""
    svc = RetrievalService(surrogate.x, length_scale=LS, noise=0.1, cap=CAP, label_prob=0.8,
                           mistake_prob=0.05, method_kwargs=PRODUCTION_KW, device="cpu")
    sids = {}
    with graphs.eager():  # only /learn goes through the graph path
        for name, q in (("a", 17), ("a_twin", 17), ("b", 240), ("b_twin", 240)):
            sids[name] = svc.create_session()
            svc.set_query(sids[name], q)
            svc.feedback(sids[name], {str(q + j): (1 if j % 2 else -1) for j in range(1, 6)})
    for name in ("a", "b"):
        got = svc.learn(sids[name], steps=10, prior_strength=1.0)
        with graphs.eager():
            want = svc.learn(sids[f"{name}_twin"], steps=10, prior_strength=1.0)
        assert got == want and got["length_scale"] != LS
        a, b = svc._entry(sids[name])[0].state, svc._entry(sids[f"{name}_twin"])[0].state
        for f in tgp.SESSION_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
        _equal_hyper(a.hyper, b.hyper)
    assert stand_in == ["relearn"]
    assert graphs.programs()[0].replays == 2


def _run_cfg(mod, **kw):
    gp = dict(length_scale=LS, var=1.0, noise=0.1, cap=CAP)
    gp.update(kw.pop("gp", {}))
    base = dict(dataset="mirflickr", method="ital", batch_size=4, n_rounds=3, repetitions=1,
                queries_per_class=2, max_classes=2, seed=2, gp=mod.GPConfig(**gp),
                user=mod.UserConfig(label_prob=0.8, mistake_prob=0.05),
                method_kwargs=dict(PRODUCTION_KW))
    base.update(kw)
    return mod.ExperimentConfig(**base)


LEARN = {"learn_every": 2, "learn_steps": 10, "learn_prior_strength": 1.0}


@pytest.mark.parametrize("mode,captures,programs", [
    ({}, 1, {"relearn": 4}),
    ({"query_batch": 2, "fused_sessions": True}, 1, {"fused_session": 2}),
    ({"query_batch": 2}, 3, {"cohort_round": 2 * 3}),
], ids=["serial", "qb2+fused", "qb2"])
def test_runner_learn_every_through_the_programs_equals_eager(surrogate, stand_in, mode,
                                                              captures, programs):
    """``GP.learn_every`` through the graph path: the serial run's re-learn
    is the relearn program, a fused cohort's rounds and re-learn one
    program, an unfused cohort's re-learning round a signature of its own;
    curves and picks equal the eager run's."""
    cfg = _run_cfg(tconfig, gp=LEARN, **mode)
    before = graphs.captures()
    got = trunner.run_experiment(cfg, surrogate, device="cpu")
    assert graphs.captures() - before == len(stand_in) >= captures
    with graphs.eager():
        want = trunner.run_experiment(cfg, surrogate, device="cpu")
    assert np.array_equal(got["ap"], want["ap"])
    if "picks" in want:
        assert np.array_equal(got["picks"], want["picks"])
    by_name = {}
    for p in graphs.programs():
        if p.name in programs:
            by_name[p.name] = by_name.get(p.name, 0) + p.replays
    assert by_name == programs
    assert stand_in.count(next(iter(programs))) == captures


@pytest.fixture(scope="module")
def jax_surrogate():
    return jds._synthetic_surrogate("mirflickr", N_SURROGATE, D_SURROGATE, 14, seed=3)


def test_fused_learning_cohort_matches_the_references_vmapped_run(surrogate, jax_surrogate,
                                                                  stand_in, monkeypatch):
    """A fused cohort with ``GP.learn_every = 2`` through the graph path, one
    program a cohort, reaches the curves of the reference's
    ``run_experiment_vmapped`` with ``fused_sessions`` on JAX's draws."""
    mode = dict(query_batch=2, fused_sessions=True)
    want = jrunner.run_experiment(_run_cfg(jconfig, gp=dict(LEARN), **mode), jax_surrogate)
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got = trunner.run_experiment(_run_cfg(tconfig, gp=dict(LEARN), **mode), surrogate,
                                 device="cpu")
    np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-5)
    assert stand_in == ["fused_session"]
    (prog,) = graphs.programs()
    assert prog.replays == 2
