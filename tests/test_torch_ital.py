"""The port's ITAL selection against ``ital_tpu.select.ital`` on shared posteriors.

Posteriors are warmed (a query plus labels) before batches are compared: an
uninformative posterior saturates MI at log 2^m and its argmax order is
decided by the last ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu.data.datasets import toy_gaussians
from ital_tpu.models import gp as jgp
from ital_tpu.select import ital as jital
from ital_tpu.select.base import StrategyParams as JaxParams
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.select import ital as tital
from ital_tpu_torch.select.base import StrategyParams
from tests.test_torch_gp import jax_state_arrays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(label_prob=0.9, mistake_prob=0.05):
    return (JaxParams(label_prob=jnp.asarray(label_prob), mistake_prob=jnp.asarray(mistake_prob)),
            StrategyParams.create("cpu", label_prob=label_prob, mistake_prob=mistake_prob))


@pytest.fixture(scope="module")
def warmed():
    """A toy posterior warmed with a query and four labels, in both packages."""
    ds = toy_gaussians(n_per_class=60, n_classes=3, dim=2, seed=4)
    js = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), 1.5, 1.0, 0.1, cap=16),
                          jnp.asarray(5))
    cls = int(ds.labels[5])
    picks = [11, 40, 90, 130]
    ys = [1.0 if ds.relevance[i, cls] else -1.0 for i in picks]
    js = jgp.gp_update(js, jnp.asarray(picks, jnp.int32), jnp.asarray(ys, jnp.float32),
                       jnp.ones(len(picks), bool))
    return js, tgp.state_from_arrays(jax_state_arrays(js), "cpu")


@pytest.mark.parametrize("t", [0, 1, 2, 3])
def test_mi_scores_match_jax(warmed, t):
    js, ts = warmed
    jp, tp = _params()
    prefix = [7, 120, 60, 0][:t] + [0] * (4 - t)
    want = np.asarray(jital.score_candidates_mi(js, jnp.asarray(prefix), t, jp, n_qmc=64))
    got = tital.score_candidates_mi(ts, torch.tensor(prefix), t, tp, n_qmc=64, block=50)
    # A candidate already in the batch has a singular joint covariance (up to
    # the jitter) and is never scored by the selection, which masks it.
    eligible = np.ones(want.shape[0], bool)
    eligible[prefix[:t]] = False
    np.testing.assert_allclose(got.numpy()[eligible], want[eligible], atol=1e-5)


@pytest.mark.parametrize("m,label_prob,mistake_prob", [(1, 1.0, 0.0), (3, 0.8, 0.1)])
def test_feedback_table_and_mi_formula_match_jax(rng, m, label_prob, mistake_prob):
    jpfr = jital.feedback_given_relevance(m, jnp.asarray(label_prob), jnp.asarray(mistake_prob))
    tpfr = tital.feedback_given_relevance(m, torch.tensor(label_prob), torch.tensor(mistake_prob))
    np.testing.assert_allclose(tpfr.numpy(), np.asarray(jpfr), atol=1e-7)
    p_r = rng.dirichlet(np.ones(2 ** m), size=5).astype(np.float32)
    np.testing.assert_allclose(
        tital.mutual_information_from_relevance(torch.from_numpy(p_r), tpfr).numpy(),
        np.asarray(jital.mutual_information_from_relevance(jnp.asarray(p_r), jpfr)), atol=1e-6)
    np.testing.assert_array_equal(tital.sign_table(m), jital.sign_table(m))
    np.testing.assert_array_equal(tital.feedback_table(m), jital.feedback_table(m))


@pytest.mark.parametrize("kw", [
    {"pool_size": 25, "n_qmc": 32, "refine_top": 8, "refine_n_qmc": 512},
    {"pool_size": 25, "n_qmc": 32},
    {"n_qmc": 32, "refine_top": 16, "refine_n_qmc": 256},
    {"n_qmc": 32},
], ids=["pool+refine", "pool", "full+refine", "full"])
def test_batches_equal_jax_on_warmed_posterior(warmed, kw):
    js, ts = warmed
    jp, tp = _params()
    want = np.asarray(jital.select_ital(js, 3, jax.random.PRNGKey(0), jp, **kw))
    got = tital.select_ital(ts, 3, None, tp, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_qmc_shifts_reproduce_jax_qmc_key(warmed):
    """Per-step shifts drawn as the reference draws them from a qmc_key give
    the reference's randomized-QMC batch."""
    js, ts = warmed
    jp, tp = _params()
    key = jax.random.PRNGKey(11)
    shifts = [torch.from_numpy(np.array(jital._step_shift(key, t, jnp.float32)))
              for t in range(3)]
    kw = {"pool_size": 25, "n_qmc": 32}
    want = np.asarray(jital.select_ital(js, 3, jax.random.PRNGKey(0), jp, qmc_key=key, **kw))
    got = tital.select_ital(ts, 3, None, tp, qmc_shifts=shifts, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pool_indices_break_ties_like_lax_top_k(warmed):
    """Tied rankings: the lowest index wins, as with jax.lax.top_k."""
    js, ts = warmed
    n = ts.mu.shape[0]
    ranking = np.repeat(np.arange(n // 4, dtype=np.float32), 4)[::-1].copy()
    ranking[[3, 8, 9]] = ranking.max()  # a tie across the labeled query's row
    jidx, jforbid = jital.candidate_pool_indices(js, jnp.asarray(ranking), 30)
    tidx, tforbid = tital.candidate_pool_indices(ts, torch.from_numpy(ranking), 30)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tforbid.numpy(), np.asarray(jforbid))


def test_oversized_pool_flags_excluded_slots(warmed):
    js, ts = warmed
    n = ts.mu.shape[0]
    jidx, jforbid = jital.candidate_pool_indices(js, js.mu, n)
    tidx, tforbid = tital.candidate_pool_indices(ts, ts.mu, n)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert int(tforbid.sum()) == 5 and np.array_equal(tforbid.numpy(), np.asarray(jforbid))


@pytest.mark.parametrize("pool_size", [1, 25, 170])
def test_pool_mask_matches_jax(warmed, pool_size):
    """True outside the top unlabeled candidates, labeled rows never in the
    pool; for a stack, each session's own."""
    js, ts = warmed
    ranking = np.random.default_rng(pool_size).random(ts.mu.shape[0]).astype(np.float32)
    want = np.asarray(jital.candidate_pool_mask(js, jnp.asarray(ranking), pool_size))
    got = tital.candidate_pool_mask(ts, torch.from_numpy(ranking), pool_size)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[ts.idx[:ts.count]].all()
    st = tgp.stack_states([ts, ts])
    both = tital.candidate_pool_mask(st, torch.from_numpy(np.stack([ranking, ranking[::-1]])),
                                     pool_size)
    np.testing.assert_array_equal(both[0].numpy(), want)
    want_rev = np.asarray(jital.candidate_pool_mask(js, jnp.asarray(ranking[::-1].copy()),
                                                    pool_size))
    np.testing.assert_array_equal(both[1].numpy(), want_rev)


def test_block_size_does_not_change_scores(warmed):
    _, ts = warmed
    _, tp = _params()
    prefix = torch.tensor([7, 120, 0, 0])
    a = tital.score_candidates_mi(ts, prefix, 2, tp, n_qmc=32, block=7)
    b = tital.score_candidates_mi(ts, prefix, 2, tp, n_qmc=32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_unported_modes_and_batch_guard_raise(warmed):
    """Every mode runs now; the reference's guards still raise: the two
    candidate restrictions together, and a batch past the supported maximum."""
    _, ts = warmed
    _, tp = _params()
    with pytest.raises(ValueError, match="mutually exclusive"):
        tital.select_ital(ts, 2, None, tp, subsample_size=10, pool_size=10)
    with pytest.raises(ValueError, match="exceeds the supported maximum"):
        tital.select_ital(ts, tital.MAX_MI_BATCH + 1, None, tp)


def _jax_draws(key, n, batch_size):
    """JAX's subsample uniforms and per-step shifts of one selection key, as tensors."""
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,), jnp.float32)))
    shifts = [torch.from_numpy(np.array(jital._step_shift(key, t, jnp.float32)))
              for t in range(batch_size)]
    return u, shifts


@pytest.mark.parametrize("kw", [
    {"subsample_size": 40, "n_qmc": 32},
    {"subsample_size": 40, "n_qmc": 32, "refine_top": 8, "refine_n_qmc": 256},
    {"subsample_size": 500, "n_qmc": 32},
], ids=["subsample", "subsample+refine", "oversized"])
@pytest.mark.parametrize("seed", [1, 2])
def test_subsample_with_jax_draws_picks_jax_batch(warmed, kw, seed):
    js, ts = warmed
    jp, tp = _params()
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jital.select_ital(js, 3, key, jp, **kw))
    u, _ = _jax_draws(key, ts.mu.shape[0], 3)
    got = tital.select_ital(ts, 3, None, tp, subsample_uniforms=u, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # The picks lie in the subset: the top of the uniforms among unlabeled items.
    pool, _ = tital.candidate_pool_indices(ts, u, min(kw["subsample_size"], ts.mu.shape[0]))
    assert set(got.tolist()) <= set(pool.tolist())


@pytest.mark.parametrize("kw", [
    {"pool_size": 25, "n_qmc": 32},
    {"n_qmc": 32},
    {"n_qmc": 32, "refine_top": 16, "refine_n_qmc": 256},
    {"subsample_size": 40, "n_qmc": 32},
], ids=["pool", "full", "full+refine", "subsample"])
def test_randomize_qmc_with_jax_draws_picks_jax_batch(warmed, kw):
    """randomize_qmc shifts each greedy step by a draw from the selection key;
    fed JAX's draws, the port picks JAX's batch."""
    js, ts = warmed
    jp, tp = _params()
    key = jax.random.PRNGKey(5)
    want = np.asarray(jital.select_ital(js, 3, key, jp, randomize_qmc=True, **kw))
    u, shifts = _jax_draws(key, ts.mu.shape[0], 3)
    extra = {"subsample_uniforms": u} if "subsample_size" in kw else {}
    got = tital.select_ital(ts, 3, None, tp, randomize_qmc=True, qmc_shifts=shifts,
                            **extra, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_modes_draw_from_the_generator(warmed):
    """Without fed draws, subsample_size and randomize_qmc draw from the
    strategy's generator: the same seed gives the same batch, the draws are
    the seam's (uniforms first, then one shift per step), and explicit
    qmc_shifts win over randomize_qmc."""
    _, ts = warmed
    _, tp = _params()
    kw = {"subsample_size": 40, "n_qmc": 32, "randomize_qmc": True}
    a = tital.select_ital(ts, 3, torch.Generator().manual_seed(3), tp, **kw)
    b = tital.select_ital(ts, 3, torch.Generator().manual_seed(3), tp, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    g = torch.Generator().manual_seed(3)
    u = torch.rand(ts.mu.shape[0], generator=g)
    shifts = tital.draw_qmc_shifts(g, 3, torch.float32, "cpu")
    assert [s.shape[0] for s in shifts] == [0, 1, 2]
    fed = tital.select_ital(ts, 3, None, tp, subsample_uniforms=u, qmc_shifts=shifts,
                            **{k: v for k, v in kw.items() if k != "randomize_qmc"})
    np.testing.assert_array_equal(a.numpy(), fed.numpy())
    zero = [torch.zeros(t) for t in range(3)]
    fixed = tital.select_ital(ts, 3, None, tp, pool_size=25, n_qmc=32)
    pinned = tital.select_ital(ts, 3, torch.Generator().manual_seed(9), tp, pool_size=25,
                               n_qmc=32, randomize_qmc=True, qmc_shifts=zero)
    np.testing.assert_array_equal(pinned.numpy(), fixed.numpy())


@pytest.mark.parametrize("n_shifts", [1, 3, 8])
@pytest.mark.parametrize("m", [1, 3])
def test_mi_with_error_matches_jax(rng, n_shifts, m):
    jp, tp = _params(0.8, 0.1)
    mu = rng.normal(size=m).astype(np.float32) * 0.5
    a = rng.normal(size=(m, m))
    cov = (a @ a.T + m * np.eye(m)).astype(np.float32) * 0.3
    chol = np.linalg.cholesky(cov).astype(np.float32)
    want = jital.mi_with_error(jnp.asarray(mu), jnp.asarray(chol), jp, n_qmc=64,
                               n_shifts=n_shifts, seed=4)
    got = tital.mi_with_error(torch.from_numpy(mu), torch.from_numpy(chol), tp, n_qmc=64,
                              n_shifts=n_shifts, seed=4)
    np.testing.assert_allclose(float(got[0]), float(want[0]), atol=2e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=2e-6)
    if n_shifts == 1:  # one replicate: no error estimate
        assert float(got[1]) == 0.0
    if m == 1:  # no sampled dimension: the replicates agree to rounding
        assert float(got[1]) < 1e-6


def test_mi_with_error_two_shifts_raises():
    _, tp = _params()
    with pytest.raises(ValueError, match="n_shifts=2"):
        tital.mi_with_error(torch.zeros(2), torch.eye(2), tp, n_shifts=2)
