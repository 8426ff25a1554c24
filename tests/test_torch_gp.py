"""The port's GP model against ``ital_tpu.models.gp``, from the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu.models import gp as jgp
from ital_tpu_torch.models import gp as tgp

LS, VAR, NOISE = 12.0, 1.0, 0.1
FIELDS = ("mu", "sig2", "v", "l", "beta")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_state_arrays(st) -> dict:
    """A JAX GPState's leaves as NumPy arrays, keyed for ``state_from_arrays``."""
    out = {f: np.asarray(getattr(st, f))
           for f in ("x", "idx", "y", "valid", "count", "l", "beta", "v", "mu", "sig2")}
    out.update({f: np.asarray(getattr(st.hyper, f)) for f in ("length_scale", "var", "noise")})
    if st.x2 is not None:
        out["x2"] = np.asarray(st.x2)
    return out


def _corpus(rng, n=300, d=24):
    return np.abs(rng.normal(size=(n, d))).astype(np.float32) * 2.0


def _assert_states_close(js, ts, atol=1e-4):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=atol, err_msg=f)
    np.testing.assert_array_equal(ts.idx.numpy(), np.asarray(js.idx))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert ts.count == int(js.count)


@pytest.mark.parametrize("corpus_dtype", [None, "bfloat16"])
def test_init_set_query_update_match_jax(rng, corpus_dtype):
    x = _corpus(rng)
    js = jgp.gp_init(jnp.asarray(x), LS, VAR, NOISE, 16, corpus_dtype=corpus_dtype)
    ts = tgp.gp_init(torch.from_numpy(x), LS, VAR, NOISE, 16, corpus_dtype=corpus_dtype)
    assert str(ts.x.dtype).endswith(str(js.x.dtype))
    np.testing.assert_allclose(ts.x2.numpy(), np.asarray(js.x2), rtol=1e-6)
    _assert_states_close(js, ts)

    js = jgp.gp_set_query(js, jnp.asarray(7))
    ts = tgp.gp_set_query(ts, 7)
    _assert_states_close(js, ts)

    for picks, ys, valid in [([11, 40, 90, 130], [1., -1., 1., -1.], [1, 1, 0, 1]),
                             ([3, 250, 4, 0], [-1., 1., 1., 1.], [1, 1, 1, 0])]:
        js = jgp.gp_update(js, jnp.asarray(picks), jnp.asarray(ys, jnp.float32),
                           jnp.asarray(valid, bool))
        ts = tgp.gp_update(ts, torch.tensor(picks), torch.tensor(ys),
                           torch.tensor(valid, dtype=torch.bool))
        _assert_states_close(js, ts)


def test_update_equals_refit(rng):
    """The in-place block append gives the posterior a from-scratch fit gives."""
    x = _corpus(rng)
    st = tgp.gp_set_query(tgp.gp_init(torch.from_numpy(x), LS, VAR, NOISE, 16), 2)
    picks = torch.tensor([9, 31, 77, 150])
    ys = torch.tensor([1.0, -1.0, -1.0, 1.0])
    valid = torch.tensor([True, False, True, True])
    v_buffer = st.v
    st = tgp.gp_update(st, picks, ys, valid)
    assert st.v is v_buffer  # the session-owned buffer is written in place
    ref = tgp.gp_fit(tgp.state_from_arrays(tgp.state_to_arrays(st), "cpu"))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(ref, f).numpy(),
                                   atol=1e-4, err_msg=f)


def test_update_never_writes_the_corpus(rng):
    x = _corpus(rng)
    st = tgp.gp_set_query(tgp.gp_init(torch.from_numpy(x), LS, VAR, NOISE, 8), 0)
    x_before, x2_before = st.x.clone(), st.x2.clone()
    tgp.gp_update(st, torch.tensor([1, 2, 3, 4]), torch.ones(4), torch.ones(4, dtype=torch.bool))
    assert torch.equal(st.x, x_before) and torch.equal(st.x2, x2_before)


def test_update_past_capacity_raises(rng):
    x = _corpus(rng)
    st = tgp.gp_set_query(tgp.gp_init(torch.from_numpy(x), LS, VAR, NOISE, 8), 0)
    st = tgp.gp_update(st, torch.tensor([1, 2, 3, 4]), torch.ones(4),
                       torch.ones(4, dtype=torch.bool))
    mu_before = st.mu.clone()
    with pytest.raises(ValueError, match="capacity exceeded"):
        tgp.gp_update(st, torch.tensor([5, 6, 7, 8]), torch.ones(4),
                      torch.ones(4, dtype=torch.bool))
    assert st.count == 5 and torch.equal(st.mu, mu_before)


def test_predict_full_and_cov_columns_match_jax(rng):
    x = _corpus(rng)
    js = jgp.gp_set_query(jgp.gp_init(jnp.asarray(x), LS, VAR, NOISE, 8), jnp.asarray(4))
    js = jgp.gp_update(js, jnp.asarray([10, 20, 30, 40]), jnp.asarray([1., -1., 1., 1.]),
                       jnp.ones(4, bool))
    ts = tgp.state_from_arrays(jax_state_arrays(js), "cpu")
    ind = np.array([5, 17, 123])
    jm, jc = jgp.gp_predict_full(js, jnp.asarray(ind))
    tm, tc = tgp.gp_predict_full(ts, torch.from_numpy(ind))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(
        tgp.gp_posterior_cov_columns(ts, torch.from_numpy(ind)).numpy(),
        np.asarray(jgp.gp_posterior_cov_columns(js, jnp.asarray(ind))), atol=1e-5)


@pytest.mark.parametrize("corpus_dtype", [None, "bfloat16"])
def test_state_arrays_round_trip(rng, corpus_dtype):
    """JAX leaves -> port state -> arrays -> port state keeps every value."""
    x = _corpus(rng)
    js = jgp.gp_set_query(jgp.gp_init(jnp.asarray(x), LS, VAR, NOISE, 8,
                                      corpus_dtype=corpus_dtype), jnp.asarray(4))
    arrays = jax_state_arrays(js)
    ts = tgp.state_from_arrays(arrays, "cpu")
    assert ts.count == 1 and ts.idx.dtype == torch.int64 and ts.valid.dtype == torch.bool
    assert float(ts.hyper.length_scale) == LS
    _assert_states_close(js, ts, atol=0.0)
    back = tgp.state_to_arrays(ts)
    assert back["idx"].dtype == np.int32 and int(back["count"]) == 1
    np.testing.assert_array_equal(back["x"], np.asarray(js.x, np.float32))
    again = tgp.state_from_arrays(back, "cpu")
    for f in FIELDS + ("x2",):
        assert torch.equal(getattr(again, f), getattr(ts, f)), f
    # The arrays are copies: a later update leaves them as they were.
    mu_arr = back["mu"].copy()
    tgp.gp_update(again, torch.tensor([1, 2, 3, 5]), torch.ones(4), torch.ones(4, dtype=torch.bool))
    np.testing.assert_array_equal(back["mu"], mu_arr)
