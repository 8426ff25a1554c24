"""Every strategy's selection as one program, against ``ital_tpu``'s compiled selection.

The 15 baselines and ``ital_regression`` each register one body over a
stack of sessions (``select.base.register_program``).  On a seeded,
warmed three-session problem (unequal counts, two hyperparameter groups,
mixed user models and tradeoffs, a shared corpus density), the stacked
program picks each session's own eager batch and the reference service's
``_batched_select`` batches (``jax.vmap`` of the strategy over
``_stack_gpstates``, each session's own ``StrategyParams``), in f32 and f64
with TF32 off.  Then the entry points: the single-session fetch, the
runner's cohort rounds and fused cohorts and the regression runner each
call ``graphs.run`` once per selection, round or cohort, and through the
stand-in graph (``tests/test_torch_graphs.py``) each call is one capture or
replay; the runner's fused and ``query_batch`` modes give the serial
mode's curves and picks.

Sizes: the 300 x 16 surrogate, cap 16, K = 3, batch 3; the runner on the
120-row toy configuration.  Picks are compared exactly; curves within
1e-12 (the stacked update and the single one are equal on the CPU).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu import serve as jserve
from ital_tpu.models import gp as jgp
from ital_tpu.select.base import StrategyParams as JaxParams
from ital_tpu_torch import graphs
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.data import datasets as tds
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.select import STRATEGIES, base
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.utils import config as tconfig
from tests.test_torch_gp import jax_state_arrays
from tests.test_torch_graphs import stand_in  # noqa: F401 (the stand-in graph fixture)

NAMES = sorted(set(STRATEGIES) - {"ital"})
N, D, CAP, B = 300, 16, 16, 3
# (query, (length scale, var, noise), feedback blocks of 4): counts 5, 9
# and 1, the third session re-learned other hyperparameters.
SESSIONS = [(11, (4.0, 1.0, 0.1), 1), (120, (4.0, 1.0, 0.1), 2), (230, (3.0, 0.8, 0.05), 0)]
# Each session's user model: (label_prob, mistake_prob, tradeoff).
USERS = [(0.9, 0.05, 0.5), (0.8, 0.1, 0.3), (0.95, 0.0, 0.8)]
SEEDS = (1, 2, 3)
RUNNER_CHECKED = ("sud", "rbmal", "emoc", "random")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_no_tf32():
    prev = torch.get_num_threads(), torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(prev[0])
    torch.backends.cuda.matmul.allow_tf32 = prev[1]


@pytest.fixture(scope="module")
def surrogate():
    return tds._synthetic_surrogate("s", N, D, 4, seed=5)


def _jax_sessions(ds, dtype):
    """The sessions in JAX, each warmed with its blocks from one seeded
    history (a skipped third item in each), the corpus density attached."""
    rng = np.random.default_rng(0)
    out = []
    for q, (ls, var, noise), n_blocks in SESSIONS:
        st = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x.astype(dtype)), ls, var, noise,
                                          cap=CAP), jnp.asarray(q))
        if dtype == np.float64:  # the reference's slice offsets need one int type under x64
            st = st.replace(count=st.count.astype(jnp.int64))
        cls = int(ds.labels[q])
        for _ in range(n_blocks):
            idx = rng.choice(np.delete(np.arange(N), q), 4, replace=False)
            y = np.where(ds.relevance[idx, cls], 1.0, -1.0).astype(dtype)
            st = jgp.gp_update(st, jnp.asarray(idx, jnp.int32), jnp.asarray(y),
                               jnp.asarray([True, True, False, True]))
        out.append(st)
    density = jgp.corpus_density(out[0])
    return [s.replace(density=density) for s in out]


@pytest.fixture(scope="module", params=[np.float32, np.float64], ids=["f32", "f64"])
def problem(request, surrogate):
    """(JAX sessions, port states, the port's per-session params, the
    reference's stacked params, dtype)."""
    dtype = request.param
    with jax.enable_x64(dtype == np.float64):
        js = _jax_sessions(surrogate, dtype)
        arrays = [jax_state_arrays(s) for s in js]
        density = np.array(js[0].density)
    ts = [tgp.state_from_arrays(a, "cpu") for a in arrays]
    dens = torch.from_numpy(density)
    for s in ts:
        s.density = dens
    # Each package's params in the state's dtype, as its f64 tests take them.
    tp = [StrategyParams(*(torch.tensor(v, dtype=ts[0].mu.dtype) for v in (lp, mp, 1e-6, tr)))
          for lp, mp, tr in USERS]
    with jax.enable_x64(dtype == np.float64):
        jp = [JaxParams(*(jnp.asarray(v, dtype) for v in (lp, mp, 1e-6, tr)))
              for lp, mp, tr in USERS]
    return js, ts, tp, jp, dtype


def _gens():
    return [torch.Generator().manual_seed(s) for s in SEEDS]


@pytest.fixture
def run_calls(monkeypatch):
    """The names of the programs ``graphs.run`` is called for."""
    names = []
    orig = graphs.run

    def spy(name, *args, **kwargs):
        names.append(name)
        return orig(name, *args, **kwargs)

    monkeypatch.setattr(graphs, "run", spy)
    return names


def _reference_picks(name, js, jp, dtype, keys):
    batched = jserve.RetrievalService._batched_select(
        types.SimpleNamespace(_batched_select_cache={}), name, B, ())
    params_b = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves), *jp)
    with jax.enable_x64(dtype == np.float64):
        return np.asarray(batched(js, keys, params_b))


def _feed_uniforms(monkeypatch, uniforms):
    """Make ``random``'s program draw ``uniforms`` (K, N) instead of its
    generators' (the reference's key-derived draws)."""
    make = base.COHORT_PROGRAMS["random"]

    def fed(batch_size, options):
        prog = make(batch_size, options)
        return dataclasses.replace(prog, draw=lambda *a: {"uniforms": uniforms})

    monkeypatch.setitem(base.COHORT_PROGRAMS, "random", fed)


@pytest.mark.parametrize("name", NAMES)
def test_stacked_program_picks_each_sessions_batch_and_the_references(
        problem, name, run_calls, monkeypatch):
    js, ts, tp, jp, dtype = problem
    got = base.get_stacked_strategy(name)(ts, B, _gens(), StrategyParams.stack(tp))
    assert run_calls == [f"select_{name}_stacked"]
    assert got.shape == (3, B) and got.dtype == torch.int64
    oracle = base.each_session(name)(ts, B, _gens(), tp)  # one fetch program each
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())
    assert run_calls[1:] == [f"select_{name}"] * 3
    for k in range(3):  # unlabeled and distinct
        assert len(set(got[k].tolist())) == B
        assert not set(got[k].tolist()) & set(ts[k].idx[ts[k].active].tolist())

    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    want = _reference_picks(name, js, jp, dtype, keys)
    if name == "random":
        with jax.enable_x64(dtype == np.float64):
            u = np.stack([np.asarray(jax.random.uniform(k, (N,), js[0].mu.dtype)) for k in keys])
        _feed_uniforms(monkeypatch, torch.from_numpy(u))
        got = base.get_stacked_strategy(name)(ts, B, [None] * 3, StrategyParams.stack(tp))
    np.testing.assert_array_equal(got.numpy(), want)


def test_every_strategy_has_a_program_and_a_select_budget():
    from ital_tpu_torch import serve

    assert set(base.COHORT_PROGRAMS) == set(base.STACKED) == set(STRATEGIES)
    assert set(serve.SELECT_BUDGET) == set(STRATEGIES)


def test_one_user_model_for_all_equals_the_stacked_copies(problem):
    """A group that shares one user model may take it once (0-d fields) or
    stacked: the same picks."""
    _, ts, tp, _, _ = problem
    for name in ("tcal", "adapt_al", "ital_regression"):
        one = base.get_stacked_strategy(name)(ts, B, _gens(), tp[1])
        stacked = base.get_stacked_strategy(name)(ts, B, _gens(), StrategyParams.stack([tp[1]] * 3))
        np.testing.assert_array_equal(one.numpy(), stacked.numpy())


def test_ital_stacked_takes_each_sessions_user_model(problem, run_calls):
    """ITAL's stacked selection with three user models is one program whose
    MI scan weighs each session's candidates with its own feedback table:
    each session's own batch and the reference's vmapped ones."""
    js, ts, tp, jp, dtype = problem
    kw = {"n_qmc": 32, "pool_size": 64, "refine_top": 8, "refine_n_qmc": 128}
    got = base.get_stacked_strategy("ital")(ts, B, [None] * 3, StrategyParams.stack(tp), **kw)
    assert run_calls == ["select_ital_stacked"]
    oracle = base.each_session("ital")(ts, B, [None] * 3, tp, **kw)
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())
    batched = jserve.RetrievalService._batched_select(
        types.SimpleNamespace(_batched_select_cache={}), "ital", B, tuple(sorted(kw.items())))
    params_b = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves), *jp)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(batched(js, jax.random.split(jax.random.PRNGKey(7), 3), params_b))
    np.testing.assert_array_equal(got.numpy(), want)


# -- the runner's programs ---------------------------------------------------

def _run_cfg(method, **kw):
    base_cfg = dict(
        dataset="toy", dataset_kwargs=dict(n_per_class=40, n_classes=3, dim=2, seed=0),
        method=method, batch_size=2, n_rounds=3, repetitions=1, queries_per_class=1,
        max_classes=3, seed=0, gp=tconfig.GPConfig(length_scale=1.5, var=1.0, noise=0.1, cap=16),
        user=tconfig.UserConfig(label_prob=0.8, mistake_prob=0.1),
        method_kwargs={"tradeoff": 0.4})
    base_cfg.update(kw)
    return tconfig.ExperimentConfig(**base_cfg)


@pytest.mark.parametrize("mode", ["cohort", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_runner_selects_inside_one_program_per_round_or_cohort(name, mode, stand_in, run_calls):
    """A cohort of 3 for 2 rounds: one ``cohort_round`` call a round, or one
    ``fused_session`` call for the cohort, each one capture or replay of one
    program."""
    cfg = _run_cfg(name, n_rounds=2, query_batch=3, fused_sessions=mode == "fused")
    res = trunner.run_experiment(cfg, device="cpu")
    assert res["ap"].shape == (3, 2) and np.isfinite(res["ap"]).all()
    want = ["cohort_round"] * 2 if mode == "cohort" else ["fused_session"]
    assert run_calls == want and stand_in == want[:1]
    (prog,) = graphs.programs()
    assert prog.replays == len(want)  # the capturing call replays too


@pytest.fixture(scope="module")
def serial_runs():
    """Each checked strategy's serial run and its picks, session by round."""
    out = {}
    for name in RUNNER_CHECKED:
        picks = []
        orig = STRATEGIES[name]

        def recording(*args, orig=orig, picks=picks, **kwargs):
            batch = orig(*args, **kwargs)
            picks.append(batch.tolist())
            return batch

        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(STRATEGIES, name, recording)
            res = trunner.run_experiment(_run_cfg(name), device="cpu")
        out[name] = (res, np.asarray(picks).reshape(3, 3, 2))
    return out


@pytest.mark.parametrize("mode", [{"query_batch": 2}, {"fused_sessions": True},
                                  {"query_batch": 2, "fused_sessions": True}],
                         ids=["qb2", "fused", "qb2+fused"])
@pytest.mark.parametrize("name", RUNNER_CHECKED)
def test_runner_modes_give_the_serial_curves_and_picks(serial_runs, name, mode, run_calls):
    """Three sessions (qb2 leaves a short last cohort, padded): the serial
    mode's AP curves and batches; fused, one program call per cohort."""
    serial, serial_picks = serial_runs[name]
    got = trunner.run_experiment(_run_cfg(name, **mode), device="cpu")
    np.testing.assert_allclose(got["ap"], serial["ap"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["picks"], serial_picks)
    cohorts = 2 if mode.get("query_batch") else 3
    if mode.get("fused_sessions"):
        assert run_calls == ["fused_session"] * cohorts
    else:
        assert run_calls == ["cohort_round"] * (3 * cohorts)


def test_regression_runner_selects_through_the_program(run_calls):
    cfg = tconfig.ExperimentConfig(
        task="regression", method="ital_regression", batch_size=2, n_rounds=3, repetitions=1,
        seed=0, dataset_kwargs=dict(n=80), gp=tconfig.GPConfig(length_scale=0.5, noise=0.05,
                                                               cap=8))
    res = trunner.run_regression_experiment(cfg, device="cpu")
    assert res["rmse"].shape == (1, 3) and np.isfinite(res["rmse"]).all()
    assert run_calls.count("select_ital_regression") == 3
