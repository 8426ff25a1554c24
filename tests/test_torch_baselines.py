"""The port's baselines, regression strategy and hypothetical GP updates against ``ital_tpu``.

Both packages score the same warmed GP state, built by JAX and handed to the
port as NumPy arrays.  Tolerances are for float32 on the CPU: the two sum in
different orders, so scores agree to about 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu.data import datasets as jds
from ital_tpu.models import gp as jgp
from ital_tpu.ops import kernels as jkernels
from ital_tpu.select import STRATEGIES as JAX_STRATEGIES
from ital_tpu.select import baselines as jbaselines
from ital_tpu.select import regression as jregression
from ital_tpu.select.base import StrategyParams as JaxParams
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.ops import kernels as tkernels
from ital_tpu_torch.select import STRATEGIES
from ital_tpu_torch.select import baselines as tbaselines
from ital_tpu_torch.select import regression as tregression
from ital_tpu_torch.select.base import StrategyParams
from tests.test_torch_gp import jax_state_arrays

BASELINES = sorted(set(STRATEGIES) - {"ital", "ital_regression"})
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6  # f32, different summation orders
BATCH = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _warm_toy():
    ds = jds.toy_gaussians(n_per_class=50, n_classes=3, dim=2, seed=2)
    st = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), 1.5, 1.0, 0.1, cap=16), jnp.asarray(7))
    return jgp.gp_update(st, jnp.asarray([20, 80, 110]), jnp.asarray([1.0, -1.0, -1.0]),
                         jnp.ones(3, bool))


def _warm_surrogate():
    ds = jds._synthetic_surrogate("s", 400, 16, 4, seed=5)
    rel = ds.relevance[:, int(ds.labels[11])]
    picks = [3, 50, 97, 144, 191, 238, 285, 332]
    st = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), 4.0, 1.0, 0.1, cap=16), jnp.asarray(11))
    return jgp.gp_update(st, jnp.asarray(picks), jnp.asarray([1.0 if rel[i] else -1.0 for i in picks]),
                         jnp.asarray([True] * 7 + [False]))


@pytest.fixture(scope="module", params=["toy", "surrogate"])
def states(request):
    """(JAX state, port state) of one warmed posterior, density attached."""
    js = {"toy": _warm_toy, "surrogate": _warm_surrogate}[request.param]()
    js = js.replace(density=jgp.corpus_density(js))
    arrays = jax_state_arrays(js)
    arrays["density"] = np.asarray(js.density)
    return js, tgp.state_from_arrays(arrays, "cpu")


def _spy_first_scores(monkeypatch, module, zeros):
    """Record the t=0 scores every strategy of ``module`` hands its greedy loop."""
    seen = []
    orig = module.greedy_argmax_batch

    def spy(score_fn, state, batch_size):
        seen.append(np.asarray(score_fn(zeros(batch_size), 0)))
        return orig(score_fn, state, batch_size)

    monkeypatch.setattr(module, "greedy_argmax_batch", spy)
    return seen


def test_registry_holds_the_reference_strategies():
    assert sorted(STRATEGIES) == sorted(JAX_STRATEGIES)
    assert len(BASELINES) == 15


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_matches_jax(states, name, monkeypatch):
    """Same batch as JAX on a warmed state; the same scores at the first
    greedy step (``random`` gets JAX's uniforms through its seam)."""
    js, ts = states
    key = jax.random.PRNGKey(1)
    jparams = JaxParams(label_prob=jnp.asarray(0.9), mistake_prob=jnp.asarray(0.05))
    tparams = StrategyParams.create("cpu", label_prob=0.9, mistake_prob=0.05)
    j_scores = _spy_first_scores(monkeypatch, jbaselines,
                                 lambda b: jnp.zeros((b,), jnp.int32))
    t_scores = _spy_first_scores(monkeypatch, tbaselines,
                                 lambda b: torch.zeros(b, dtype=torch.int64))

    want = np.asarray(JAX_STRATEGIES[name](js, BATCH, key, jparams))
    if name == "random":
        u = jax.random.uniform(key, (js.x.shape[0],), js.mu.dtype)
        got = tbaselines.random_from_uniforms(ts, BATCH, torch.from_numpy(np.array(u)))
    else:
        got = STRATEGIES[name](ts, BATCH, None, tparams)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(j_scores) == len(t_scores) == 1
    np.testing.assert_allclose(t_scores[0], j_scores[0], rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_ital_regression_matches_jax(states):
    js, ts = states
    jparams = JaxParams()
    want = np.asarray(jregression.select_ital_regression(js, 4, jax.random.PRNGKey(0), jparams))
    got = tregression.select_ital_regression(ts, 4, None, StrategyParams.create("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_draws_from_its_generator(states):
    """Seeded alike, two draws agree; the batch is distinct and unlabeled."""
    _, ts = states
    p = StrategyParams.create("cpu")
    a = tbaselines.select_random(ts, 5, torch.Generator().manual_seed(3), p)
    b = tbaselines.select_random(ts, 5, torch.Generator().manual_seed(3), p)
    assert torch.equal(a, b) and len(set(a.tolist())) == 5
    assert not set(a.tolist()) & set(ts.idx[ts.active].tolist())


def test_blockwise_reduce_abs_kpost_matches_jax(states):
    """Several candidate blocks, the last one ragged.

    Each |k_post| entry carries a few f32 ulps of ``var`` of cancellation
    error, and a column sums N of them: atol 4e-7 x N.
    """
    js, ts = states
    n = ts.x.shape[0]
    cand = np.arange(3, n, 2)
    want = jkernels.blockwise_reduce_abs_kpost(
        js.x, js.v, jnp.asarray(cand), js.hyper.length_scale, js.hyper.var, block=32)
    got = tkernels.blockwise_reduce_abs_kpost(
        ts.x, ts.v, torch.from_numpy(cand), ts.hyper.length_scale, ts.hyper.var,
        x2=ts.x2, block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCORE_RTOL, atol=4e-7 * n)


def test_blockwise_reduce_abs_kpost_weighted_matches_jax(states):
    """``weights`` w(x) > 0 scale each corpus row's |k_post| before the column
    sum, as the reference's ``weights``; the tolerance of the unweighted test,
    scaled by the largest weight."""
    js, ts = states
    n = ts.x.shape[0]
    cand = np.arange(1, n, 3)
    w = np.random.default_rng(4).uniform(0.1, 2.0, size=n).astype(np.float32)
    want = jkernels.blockwise_reduce_abs_kpost(
        js.x, js.v, jnp.asarray(cand), js.hyper.length_scale, js.hyper.var,
        weights=jnp.asarray(w), block=32)
    got = tkernels.blockwise_reduce_abs_kpost(
        ts.x, ts.v, torch.from_numpy(cand), ts.hyper.length_scale, ts.hyper.var,
        weights=torch.from_numpy(w), x2=ts.x2, block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCORE_RTOL,
                               atol=4e-7 * n * 2.0)


def test_rbf_kernel_blockwise_equals_rbf_kernel(states):
    _, ts = states
    a, b = ts.x[:70], ts.x[100:130]
    np.testing.assert_array_equal(
        tkernels.rbf_kernel_blockwise(a, b, 1.7, 0.8, block_rows=16).numpy(),
        tkernels.rbf_kernel(a, b, 1.7, 0.8).numpy())


def test_corpus_density_matches_jax(states):
    js, ts = states
    want = np.asarray(jgp.corpus_density(js, block_rows=64))
    np.testing.assert_allclose(tgp.corpus_density(ts, block_rows=64).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def _snapshot(ts):
    return {f: getattr(ts, f).clone() for f in ("idx", "y", "valid", "l", "beta", "v", "mu", "sig2")}


def test_hypothetical_updates_match_jax_and_write_nothing(states):
    js, ts = states
    ind = np.array([5, 33, 60, 101])
    y = np.array([1.0, -1.0, 1.0, 1.0], np.float32)
    valid = np.array([True, True, False, True])
    before = _snapshot(ts)

    jg, jw = jgp.gp_updated_whitening(js, jnp.asarray(ind), jnp.asarray(y), jnp.asarray(valid))
    tg, tw = tgp.gp_updated_whitening(ts, torch.from_numpy(ind), torch.from_numpy(y),
                                      torch.from_numpy(valid))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    assert float(tw[2].abs().max()) == 0.0 and float(tg[2]) == 0.0  # the invalid row

    jm, js2 = jgp.gp_updated_prediction(js, jnp.asarray(ind), jnp.asarray(y))
    tm, ts2 = tgp.gp_updated_prediction(ts, torch.from_numpy(ind), torch.from_numpy(y))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), atol=1e-5)

    jd = jgp.gp_updated_mean_delta(js, jnp.asarray(60), -1.0)
    td = tgp.gp_updated_mean_delta(ts, 60, -1.0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)

    np.testing.assert_array_equal(tgp.gp_predict_mean(ts, torch.from_numpy(ind)).numpy(),
                                  np.asarray(jgp.gp_predict_mean(js, jnp.asarray(ind))))
    mean, var = tgp.gp_predict_diag(ts, torch.from_numpy(ind))
    jmean, jvar = jgp.gp_predict_diag(js, jnp.asarray(ind))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(var.numpy(), np.asarray(jvar))
    for f, t in before.items():
        assert torch.equal(getattr(ts, f), t), f


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-4), (np.float64, 1e-10)])
def test_updated_prediction_equals_gp_update(states, dtype, atol):
    """The closed-form hypothetical posterior is what absorbing the block gives."""
    _, ts = states
    arrays = tgp.state_to_arrays(ts)
    del arrays["x2"]  # f32 norms would not match f64 distances: recompute them
    for f in ("x", "y", "l", "beta", "v", "mu", "sig2", "length_scale", "var", "noise",
              "density"):
        arrays[f] = arrays[f].astype(dtype)
    st = tgp.gp_fit(tgp.state_from_arrays(arrays, "cpu"))  # the posterior in this dtype
    ind = torch.tensor([5, 33, 60, 101])
    y = torch.tensor([1.0, -1.0, 1.0, 1.0], dtype=st.mu.dtype)
    valid = torch.tensor([True, True, False, True])
    mu, sig2 = tgp.gp_updated_prediction(st, ind, y, valid)
    after = tgp.gp_update(tgp.gp_session_copy(st), ind, y, valid)
    np.testing.assert_allclose(mu.numpy(), after.mu.numpy(), atol=atol)
    np.testing.assert_allclose(sig2.numpy(), after.sig2.numpy(), atol=atol)


def test_bf16_corpus_emoc_takes_stored_norms():
    """On a bfloat16 corpus the EMOC and MCMI kernel blocks take the cached f32
    norms of the stored corpus (``x2``) for its N rows."""
    ds = jds._synthetic_surrogate("s", 200, 16, 4, seed=1)
    st = tgp.gp_set_query(tgp.gp_init(torch.from_numpy(ds.x), 4.0, 0.7, 0.1, 8,
                                      corpus_dtype="bfloat16"), 3)
    calls = []
    orig = tkernels.rbf_kernel

    def spy(a, b, ls, var=1.0, **norms):
        calls.append((a.shape[0], norms.get("a2")))
        return orig(a, b, ls, var, **norms)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tkernels, "rbf_kernel", spy)
        mp.setattr(tgp, "rbf_kernel", spy)
        p = StrategyParams.create("cpu")
        for name in ("emoc", "mcmi_min"):
            STRATEGIES[name](st, 2, None, p)
    corpus_blocks = [a2 for m, a2 in calls if m == 200]
    assert len(corpus_blocks) == 2 and all(a2 is st.x2 for a2 in corpus_blocks)


def test_state_arrays_carry_density(states):
    _, ts = states
    back = tgp.state_from_arrays(tgp.state_to_arrays(ts), "cpu")
    assert torch.equal(back.density, ts.density)
    plain = tgp.state_to_arrays(dataclasses.replace(ts, density=None))
    assert "density" not in plain and tgp.state_from_arrays(plain, "cpu").density is None
