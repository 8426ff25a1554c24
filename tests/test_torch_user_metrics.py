"""The port's simulated user and retrieval metrics against ``ital_tpu``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu.data.user import simulate_feedback as jax_feedback
from ital_tpu.utils import metrics as jmetrics
from ital_tpu_torch.data.user import feedback_from_uniforms, simulate_feedback
from ital_tpu_torch.utils import metrics as tmetrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("seed,label_prob,mistake_prob", [
    (0, 0.8, 0.05), (1, 0.5, 0.3), (2, 1.0, 0.0),
])
def test_feedback_from_jax_uniforms_matches_jax(seed, label_prob, mistake_prob):
    """Fed the uniforms JAX draws from a key, the port answers as JAX does."""
    rng = np.random.default_rng(seed)
    relevant = rng.random(50) < 0.3
    batch = rng.choice(50, size=8, replace=False).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want_y, want_valid = jax_feedback(key, jnp.asarray(batch), jnp.asarray(relevant),
                                      label_prob, mistake_prob)
    k_label, k_flip = jax.random.split(key)
    u_label = np.array(jax.random.uniform(k_label, (8,)))
    u_flip = np.array(jax.random.uniform(k_flip, (8,)))
    y, valid = feedback_from_uniforms(
        torch.from_numpy(u_label), torch.from_numpy(u_flip), torch.from_numpy(batch).long(),
        torch.from_numpy(relevant), label_prob, mistake_prob)
    assert y.dtype == torch.float32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))


def test_simulate_feedback_draws_from_the_generator():
    relevant = torch.zeros(20, dtype=torch.bool)
    relevant[:10] = True
    batch = torch.arange(0, 20, 2)
    a = simulate_feedback(torch.Generator().manual_seed(3), batch, relevant, 0.7, 0.2)
    b = simulate_feedback(torch.Generator().manual_seed(3), batch, relevant, 0.7, 0.2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    y, valid = simulate_feedback(torch.Generator().manual_seed(3), batch, relevant, 1.0, 0.0)
    assert bool(valid.all())
    np.testing.assert_array_equal(y.numpy(), np.where(relevant[batch].numpy(), 1.0, -1.0))


def _tied_scores(rng, n=40):
    scores = np.round(rng.normal(size=n), 1).astype(np.float32)  # many ties
    relevant = rng.random(n) < 0.4
    exclude = np.zeros(n, bool)
    exclude[[3, 17]] = True
    return scores, relevant, exclude


@pytest.mark.parametrize("with_exclude", [False, True])
def test_average_precision_matches_jax_with_ties(rng, with_exclude):
    scores, relevant, exclude = _tied_scores(rng)
    ex_j = jnp.asarray(exclude) if with_exclude else None
    ex_t = torch.from_numpy(exclude) if with_exclude else None
    want = float(jmetrics.average_precision(jnp.asarray(scores), jnp.asarray(relevant), ex_j))
    got = float(tmetrics.average_precision(torch.from_numpy(scores),
                                           torch.from_numpy(relevant), ex_t))
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("k", [1, 5, 12])
def test_recall_at_k_matches_jax_with_ties(rng, k):
    scores, relevant, exclude = _tied_scores(rng)
    want = float(jmetrics.recall_at_k(jnp.asarray(scores), jnp.asarray(relevant), k,
                                      jnp.asarray(exclude)))
    got = float(tmetrics.recall_at_k(torch.from_numpy(scores), torch.from_numpy(relevant), k,
                                     torch.from_numpy(exclude)))
    assert got == pytest.approx(want, abs=1e-6)
