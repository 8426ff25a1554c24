"""The port's padded Cholesky and block append against ``ital_tpu.ops.chol``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu.ops import chol as jchol
from ital_tpu_torch.ops import chol as tchol


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(rng, n, dtype):
    a = rng.normal(size=(n, n))
    return (a @ a.T / n + 0.5 * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_padded_cholesky_matches_jax(rng, dtype, atol):
    k = _spd(rng, 12, dtype)
    active = np.array([1, 1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0], bool)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jchol.padded_cholesky(jnp.asarray(k), jnp.asarray(active), 0.1))
    got = tchol.padded_cholesky(torch.from_numpy(k), torch.from_numpy(active), 0.1)
    assert got.dtype == torch.from_numpy(k).dtype
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def _append_inputs(rng, dtype, cap=12, count=5, b=4):
    k_full = _spd(rng, cap, dtype)
    valid = np.ones(cap, bool)
    valid[2] = False  # an inert slot among the existing ones
    active_old = (np.arange(cap) < count) & valid
    l0 = np.linalg.cholesky(np.where(active_old[:, None] & active_old[None, :],
                                     k_full + 0.1 * np.eye(cap), np.eye(cap))).astype(dtype)
    k_lb = np.where(active_old[:, None], k_full[:, count:count + b], 0.0).astype(dtype)
    k_bb = k_full[count:count + b, count:count + b].copy()
    active_new = np.array([True, False, True, True])
    return k_full, valid, l0, k_lb, k_bb, active_new, count


# f64: the reference forms S^T S with preferred_element_type=float32, so its
# factor carries f32 rounding (~1e-8) even under x64.
@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), (np.float64, 1e-7)])
def test_chol_append_block_matches_jax(rng, dtype, atol):
    _, _, l0, k_lb, k_bb, active_new, count = _append_inputs(rng, dtype)
    with jax.enable_x64(dtype == np.float64):
        jl, js, jlb = jchol.chol_append_block(
            jnp.asarray(l0), jnp.asarray(k_lb), jnp.asarray(k_bb),
            jnp.asarray(count), jnp.asarray(active_new), 0.1)
        jl, js, jlb = np.asarray(jl), np.asarray(js), np.asarray(jlb)
    tl, ts, tlb = tchol.chol_append_block(
        torch.from_numpy(l0.copy()), torch.from_numpy(k_lb), torch.from_numpy(k_bb),
        count, torch.from_numpy(active_new), 0.1)
    np.testing.assert_allclose(tl.numpy(), jl, atol=atol)
    np.testing.assert_allclose(ts.numpy(), js, atol=atol)
    np.testing.assert_allclose(tlb.numpy(), jlb, atol=atol)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5), (np.float64, 1e-12)])
def test_chol_append_equals_refactorization(rng, dtype, atol):
    """Appending a block in place equals refactorizing the padded system."""
    k_full, valid, l0, k_lb, k_bb, active_new, count = _append_inputs(rng, dtype)
    l = torch.from_numpy(l0.copy())
    out, _, _ = tchol.chol_append_block(l, torch.from_numpy(k_lb), torch.from_numpy(k_bb),
                                        count, torch.from_numpy(active_new), 0.1)
    assert out.data_ptr() == l.data_ptr()  # written in place
    valid_after = valid.copy()
    valid_after[count:count + 4] = active_new
    active_after = (np.arange(12) < count + 4) & valid_after
    ref = tchol.padded_cholesky(torch.from_numpy(k_full), torch.from_numpy(active_after), 0.1)
    np.testing.assert_allclose(l.numpy(), ref.numpy(), atol=atol)


def test_chol_append_past_capacity_raises(rng):
    _, _, l0, k_lb, k_bb, active_new, _ = _append_inputs(rng, np.float32)
    with pytest.raises(ValueError, match="overflows cap"):
        tchol.chol_append_block(torch.from_numpy(l0), torch.from_numpy(k_lb),
                                torch.from_numpy(k_bb), 10, torch.from_numpy(active_new), 0.1)


def test_tri_solve_matches_jax(rng):
    k = _spd(rng, 9, np.float32)
    l = np.linalg.cholesky(k).astype(np.float32)
    b = rng.normal(size=(9, 3)).astype(np.float32)
    want = np.asarray(jchol.tri_solve(jnp.asarray(l), jnp.asarray(b)))
    got = tchol.tri_solve(torch.from_numpy(l), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batched"])
def test_transposed_solve_and_cho_solve_match_jax(rng, dtype, atol, batch):
    """``tri_solve(..., trans=True)`` solves ``L^T x = b`` and ``cho_solve``
    ``L L^T x = b``, as the reference's; batched factors broadcast."""
    ks = [_spd(rng, 9, dtype) for _ in range(int(np.prod(batch)))]
    l = np.stack([np.linalg.cholesky(k) for k in ks]).reshape(*batch, 9, 9).astype(dtype)
    b = rng.normal(size=(*batch, 9, 3)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        jl, jb = jnp.asarray(l.reshape(-1, 9, 9)), jnp.asarray(b.reshape(-1, 9, 3))
        want_t = np.stack([np.asarray(jchol.tri_solve(jl[i], jb[i], trans=True))
                           for i in range(jl.shape[0])]).reshape(b.shape)
        want_c = np.stack([np.asarray(jchol.cho_solve(jl[i], jb[i]))
                           for i in range(jl.shape[0])]).reshape(b.shape)
    tl, tb = torch.from_numpy(l), torch.from_numpy(b)
    got_t = tchol.tri_solve(tl, tb, trans=True)
    got_c = tchol.cho_solve(tl, tb)
    np.testing.assert_allclose(got_t.numpy(), want_t, atol=atol)
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=atol * 10)
    np.testing.assert_allclose((tl.mT @ got_t).numpy(), b, atol=atol * 10)
    np.testing.assert_allclose((tl @ tl.mT @ got_c).numpy(), b, atol=atol * 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_padded_cholesky_differentiates_as_the_library_cholesky(dtype):
    """The factor through ``cholesky_ex`` and its gradient equal
    ``torch.linalg.cholesky``'s bit for bit (the ascent differentiates it)."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy(_spd(rng, 8, np.float64)).to(dtype)
    active = torch.tensor([1, 1, 0, 1, 1, 1, 0, 0], dtype=torch.bool)
    w = torch.from_numpy(rng.normal(size=(8, 8))).to(dtype)
    out = []
    for factor in (tchol.padded_cholesky,
                   lambda a, m, n: torch.linalg.cholesky(
                       tchol._identity_pad(a + n * torch.eye(8, dtype=dtype), m))):
        noise = torch.tensor(0.3, dtype=dtype, requires_grad=True)
        kk = k.clone().requires_grad_(True)
        l = factor(kk, active, noise)
        (l * w).sum().backward()
        out.append((l.detach(), kk.grad, noise.grad))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_padded_cholesky_ex_reports_without_raising():
    """``padded_cholesky_ex`` hands the flags back unchecked; the checked
    form raises the library's error."""
    k = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 2.0]]])
    active = torch.ones(2, 2, dtype=torch.bool)
    _, info = tchol.padded_cholesky_ex(k, active, 0.0)
    assert info.tolist() == [2, 0]
    with pytest.raises(torch.linalg.LinAlgError, match=r"Batch element 0.*order 2"):
        tchol.padded_cholesky(k, active, 0.0)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batched"])
@pytest.mark.parametrize("m", [4, 64], ids=["update", "fit"])
def test_wide_solve_matches_jax(rng, dtype, atol, batch, m):
    """``solve_from_right`` (``tri_solve``'s form on the card for a
    right-hand side wider than its factor: the update's (b, N) rows, the
    fit's (cap, N)) solves ``L x = b`` as the reference's ``tri_solve``, in
    ``b``'s row-major layout; at the update's 4 rows it gives the left-side
    solve's values bit for bit.  On the CPU ``tri_solve`` keeps the
    left-side solve.  Batched factors broadcast."""
    ks = [_spd(rng, m, dtype) for _ in range(int(np.prod(batch)))]
    l = np.stack([np.linalg.cholesky(k) for k in ks]).reshape(*batch, m, m).astype(dtype)
    b = rng.normal(size=(*batch, m, 500)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        jl, jb = jnp.asarray(l.reshape(-1, m, m)), jnp.asarray(b.reshape(-1, m, 500))
        want = np.stack([np.asarray(jchol.tri_solve(jl[i], jb[i]))
                         for i in range(jl.shape[0])]).reshape(b.shape)
    tl, tb = torch.from_numpy(l), torch.from_numpy(b)
    got = tchol.solve_from_right(tl, tb)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    left = torch.linalg.solve_triangular(tl, tb, upper=False)
    assert torch.equal(tchol.tri_solve(tl, tb), left)
    if m == 4:
        assert torch.equal(got, left)
    np.testing.assert_allclose(got.numpy(), left.numpy(), atol=atol)
    np.testing.assert_allclose((tl @ got).numpy(), b, atol=atol * 10)
