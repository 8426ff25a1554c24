"""The port's Genz QMC pieces against ``ital_tpu.ops.mvn``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu.ops import mvn as jmvn
from ital_tpu_torch.ops import mvn as tmvn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_norm_cdf_and_fast_ndtri_match_jax():
    x = np.linspace(-6.0, 6.0, 401, dtype=np.float32)
    np.testing.assert_allclose(tmvn.norm_cdf(torch.from_numpy(x)).numpy(),
                               np.asarray(jmvn.norm_cdf(jnp.asarray(x))), atol=1e-7)
    p = np.concatenate([np.linspace(1e-6, 0.02425, 50), np.linspace(0.03, 0.97, 101),
                        np.linspace(0.976, 1 - 1e-6, 50)]).astype(np.float32)
    np.testing.assert_allclose(tmvn.fast_ndtri(torch.from_numpy(p)).numpy(),
                               np.asarray(jmvn.fast_ndtri(jnp.asarray(p))), atol=2e-6)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_small_cholesky_matches_jax(rng, m):
    a = rng.normal(size=(5, m, m))
    cov = (a @ a.transpose(0, 2, 1) + 0.3 * np.eye(m)).astype(np.float32)
    want = np.stack([np.asarray(jmvn.small_cholesky(jnp.asarray(c))) for c in cov])
    got = tmvn.small_cholesky(torch.from_numpy(cov))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(cov), atol=1e-5)


def _moments(rng, m, n_cand=6):
    a = rng.normal(size=(n_cand, m, m))
    cov = a @ a.transpose(0, 2, 1) / m + 0.2 * np.eye(m)
    mu = 0.7 * rng.normal(size=(n_cand, m))
    return mu, np.linalg.cholesky(cov)


@pytest.mark.parametrize("n_qmc", [32, 512])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_orthant_tree_matches_jax_f32(rng, m, n_qmc, shifted):
    """All 2^m orthant probabilities, in sign_table order, per candidate."""
    mu, chol = _moments(rng, m)
    mu, chol = mu.astype(np.float32), chol.astype(np.float32)
    shift = rng.random(m - 1).astype(np.float32) if shifted else None
    want = np.stack([
        np.asarray(jmvn.orthant_probs_all_configs_tree(
            jnp.asarray(mu[i]), jnp.asarray(chol[i]), n_points=n_qmc,
            shift=None if shift is None else jnp.asarray(shift)))
        for i in range(mu.shape[0])
    ])
    got = tmvn.orthant_probs_all_configs_tree(
        torch.from_numpy(mu), torch.from_numpy(chol), n_points=n_qmc,
        shift=None if shift is None else torch.from_numpy(shift))
    assert got.shape == (mu.shape[0], 2 ** m)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("m", [2, 4])
def test_orthant_tree_matches_jax_f64(rng, m):
    mu, chol = _moments(rng, m, n_cand=3)
    with jax.enable_x64(True):
        want = np.stack([
            np.asarray(jmvn.orthant_probs_all_configs_tree(
                jnp.asarray(mu[i]), jnp.asarray(chol[i]), n_points=64))
            for i in range(mu.shape[0])
        ])
    got = tmvn.orthant_probs_all_configs_tree(torch.from_numpy(mu), torch.from_numpy(chol),
                                              n_points=64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)


@pytest.mark.parametrize("n_points,dim", [(32, 0), (32, 3), (512, 7)])
def test_lattice_and_shift_tables_bit_equal(n_points, dim):
    np.testing.assert_array_equal(tmvn.richtmyer_lattice(n_points, dim),
                                  jmvn.richtmyer_lattice(n_points, dim))
    np.testing.assert_array_equal(tmvn.shift_table(5, dim, 3), jmvn.shift_table(5, dim, 3))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("n_shifts", [1, 4, 9])
@pytest.mark.parametrize("m", [1, 3, 4])
def test_orthant_probs_with_error_matches_jax(rng, m, n_shifts, normalize):
    """The mean over the random shifts and its standard error, f32, 1e-5."""
    mu, chol = _moments(rng, m, n_cand=1)
    mu, chol = mu[0].astype(np.float32), chol[0].astype(np.float32)
    want_p, want_e = jmvn.orthant_probs_with_error(
        jnp.asarray(mu), jnp.asarray(chol), n_points=64, n_shifts=n_shifts, seed=2,
        normalize=normalize)
    got_p, got_e = tmvn.orthant_probs_with_error(
        torch.from_numpy(mu), torch.from_numpy(chol), n_points=64, n_shifts=n_shifts, seed=2,
        normalize=normalize)
    assert got_p.shape == got_e.shape == (2 ** m,)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-6)
    if n_shifts == 1:
        assert not got_e.any()


def test_orthant_probs_with_error_rejects_two_shifts():
    with pytest.raises(ValueError, match="n_shifts=2"):
        tmvn.orthant_probs_with_error(torch.zeros(3), torch.eye(3), n_shifts=2)


def test_batched_shifts_equal_one_shift_at_a_time(rng):
    """A (batch, m-1) shift gives each batch element its own lattice shift."""
    mu, chol = _moments(rng, 4, n_cand=5)
    mu, chol = torch.from_numpy(mu.astype(np.float32)), torch.from_numpy(chol.astype(np.float32))
    shifts = torch.from_numpy(rng.random((5, 3)).astype(np.float32))
    got = tmvn.orthant_probs_all_configs_tree(mu, chol, n_points=32, shift=shifts)
    for i in range(5):
        one = tmvn.orthant_probs_all_configs_tree(mu[i], chol[i], n_points=32, shift=shifts[i])
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), atol=1e-7)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_one_configuration_orthant_matches_jax(rng, m, shifted):
    """``mvn_orthant_prob`` per candidate and sign configuration, and
    ``orthant_probs_all_configs`` over the sign table."""
    mu, chol = _moments(rng, m, n_cand=3)
    mu, chol = mu.astype(np.float32), chol.astype(np.float32)
    shift = rng.random(m - 1).astype(np.float32) if shifted else None
    table = np.array(list(itertools.product([-1.0, 1.0], repeat=m)), np.float32)
    jshift = None if shift is None else jnp.asarray(shift)
    tshift = None if shift is None else torch.from_numpy(shift)
    got = tmvn.orthant_probs_all_configs(torch.from_numpy(mu), torch.from_numpy(chol),
                                         torch.from_numpy(table), n_points=64, shift=tshift)
    for i in range(mu.shape[0]):
        for signs in table[:: max(1, len(table) // 4)]:
            want = float(jmvn.mvn_orthant_prob(jnp.asarray(mu[i]), jnp.asarray(chol[i]),
                                               jnp.asarray(signs), n_points=64, shift=jshift))
            one = tmvn.mvn_orthant_prob(torch.from_numpy(mu[i]), torch.from_numpy(chol[i]),
                                        torch.from_numpy(signs), n_points=64, shift=tshift)
            assert float(one) == pytest.approx(want, abs=2e-6)
        want = jmvn.orthant_probs_all_configs(jnp.asarray(mu[i]), jnp.asarray(chol[i]),
                                              jnp.asarray(table), n_points=64, shift=jshift)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("m", [2, 4, 6])
def test_prefix_tree_equals_the_per_configuration_form(rng, m):
    """The port's sign-prefix tree against its own per-configuration
    evaluation on the same lattice (``tests/test_mvn.py``'s check)."""
    a = rng.normal(size=(m, m))
    cov = (a @ a.T + m * np.eye(m)).astype(np.float32)
    mu = torch.from_numpy(rng.normal(size=(m,)).astype(np.float32))
    chol = torch.from_numpy(np.linalg.cholesky(cov))
    table = torch.tensor(list(itertools.product([-1.0, 1.0], repeat=m)), dtype=torch.float32)
    naive = tmvn.orthant_probs_all_configs(mu, chol, table, n_points=128)
    tree = tmvn.orthant_probs_all_configs_tree(mu, chol, n_points=128)
    np.testing.assert_allclose(tree.numpy(), naive.numpy(), atol=2e-6)
    raw = tmvn.orthant_probs_all_configs(mu, chol, table, n_points=128, normalize=False)
    np.testing.assert_allclose(tmvn.orthant_probs_all_configs_tree(
        mu, chol, n_points=128, normalize=False).numpy(), raw.numpy(), atol=2e-6)
