"""Multivariate-normal orthant probabilities via Genz's sequentially-conditioned QMC.

Port of ``ital_tpu.ops.mvn``: the clamped normal CDF, Acklam's inverse
normal, an unrolled small Cholesky, the Richtmyer lattice and shift tables,
the sign-prefix tree that yields all 2^m orthant probabilities of a candidate
batch at once (what ITAL's selection runs), its multi-shift error estimate
(:func:`orthant_probs_with_error`), and the one-configuration form
(:func:`mvn_orthant_prob`, :func:`orthant_probs_all_configs`) the tree is
held against.  The reference vmaps one candidate; here every function takes
leading batch dimensions.

Algorithm (rectangle P(a < z < b), z ~ N(0, Sigma), C = chol(Sigma)), per QMC
point w in [0,1]^(m-1) and dimension i: y_{i-1} = Phi^-1(d + w (e - d)),
t_i = (limit_i - sum_{j<i} c_ij y_j) / c_ii, then d, e = Phi at t_i's
one-sided limits; the estimate is the mean over points of prod_i (e_i - d_i).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# First 32 primes — square roots seed the Richtmyer lattice directions.
_PRIMES = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
     71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131],
    dtype=np.float64,
)

# Keep Phi outputs strictly inside (0, 1) so the inverse stays finite in f32.
_EPS = 1e-6


def norm_cdf(x: torch.Tensor, *, eps: float = _EPS) -> torch.Tensor:
    """Standard normal CDF via erfc, clamped to ``[eps, 1 - eps]``.

    The erfc runs in f64 and is rounded back to ``x``'s dtype: PyTorch's f32
    erfc on the CPU is off by up to ~6 ulp, by an amount that varies with the
    element's position in its vectorized loop, while the f64 result rounds to
    the correctly rounded f32 value on every device.
    """
    p = 0.5 * torch.special.erfc(-x.to(torch.float64) * (1.0 / math.sqrt(2.0)))
    return torch.clamp(p, eps, 1.0 - eps).to(x.dtype)


# Acklam's rational approximation to the inverse normal CDF (~1.2e-9 relative).
_ACK_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
          1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_ACK_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
          6.680131188771972e+01, -1.328068155288572e+01)
_ACK_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
          -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_ACK_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
          3.754408661907416e+00)


def fast_ndtri(p: torch.Tensor) -> torch.Tensor:
    """Branchless inverse standard-normal CDF (Acklam), for p in (0, 1).

    Inputs are expected pre-clipped to [_EPS, 1 - _EPS] (the QMC chain does).
    """
    a, b, c, d = _ACK_A, _ACK_B, _ACK_C, _ACK_D
    plow = 0.02425

    # Central region.
    q = p - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
    x_central = num * q / den

    # Tails (evaluated on the folded lower-tail variable).
    p_tail = torch.minimum(p, 1.0 - p)
    ql = torch.sqrt(-2.0 * torch.log(torch.clamp(p_tail, min=1e-38)))
    num_t = ((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]
    den_t = (((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1.0
    x_tail = num_t / den_t
    x_tail = torch.where(p < 0.5, x_tail, -x_tail)

    return torch.where(p_tail < plow, x_tail, x_central)


def small_cholesky(a: torch.Tensor, *, eps: float = 1e-10) -> torch.Tensor:
    """Unrolled Cholesky-Crout for batches of tiny (..., m, m) SPD matrices.

    Elementwise over the batch, so it costs a few passes over the candidate
    axis instead of one library factorization per candidate.  Diagonal pivots
    are clamped at ``eps`` so near-singular candidate covariances stay finite.
    """
    m = a.shape[-1]
    l = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                l[i][j] = s / l[j][j]
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [torch.stack([l[i][j] if j <= i else zero for j in range(m)], dim=-1)
            for i in range(m)]
    return torch.stack(rows, dim=-2)


def richtmyer_lattice(n_points: int, dim: int) -> np.ndarray:
    """(n_points, dim) Richtmyer rank-1 lattice in [0, 1)^dim (host-side, static)."""
    if dim == 0:
        return np.zeros((n_points, 0), dtype=np.float32)
    k = np.arange(1, n_points + 1, dtype=np.float64)[:, None]
    alphas = np.sqrt(_PRIMES[:dim])[None, :]
    return np.modf(k * alphas)[0].astype(np.float32)


@functools.cache
def device_lattice(n_points: int, dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`richtmyer_lattice` as a ``dtype`` tensor on ``device``, copied
    from the host once and cached: a copy from pageable memory waits for the
    stream, and inside a CUDA graph's capture it is refused, so the warm-up
    before a capture fills the cache.  Callers never write it."""
    return torch.as_tensor(richtmyer_lattice(n_points, dim), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def shift_table(n_shifts: int, dim: int, seed: int = 0) -> np.ndarray:
    """(n_shifts, dim) deterministic Cranley-Patterson shifts (host-side).

    Shift 0 is the zero shift, so the first replicate is the unshifted
    lattice estimate.
    """
    rng = np.random.default_rng(seed)
    t = rng.random((n_shifts, max(dim, 1))).astype(np.float32)[:, :dim]
    if n_shifts:
        t[0] = 0.0
    return t


@functools.cache
def device_shift_table(n_shifts: int, dim: int, seed: int, dtype: torch.dtype,
                       device) -> torch.Tensor:
    """:func:`shift_table` as a ``dtype`` tensor on ``device``, cached as
    :func:`device_lattice` is."""
    return torch.as_tensor(shift_table(n_shifts, dim, seed), dtype=dtype, device=device)


def mvn_orthant_prob(
    mu: torch.Tensor,
    chol_cov: torch.Tensor,
    signs: torch.Tensor,
    *,
    n_points: int = 128,
    shift: torch.Tensor | None = None,
) -> torch.Tensor:
    """P(signs_i z_i > 0 for all i), z ~ N(mu, C C^T), with C = ``chol_cov``.

    ``mu`` (..., m), ``chol_cov`` (..., m, m) and ``signs`` (..., m) in
    {-1, +1} broadcast over their leading dims; ``shift`` an optional (m-1,)
    Cranley-Patterson shift.  Returns (...) probabilities; m = 1 is the
    closed-form Phi.  The orthant is the rectangle whose finite limit in
    dimension i is -mu_i, above for s_i = +1 and below for s_i = -1, so each
    conditional factor is one Phi.
    """
    m = mu.shape[-1]
    c = chol_cov
    lim = -mu
    pos = signs > 0
    # Guard near-singular factors (a candidate on a labeled point).
    cdiag = torch.clamp(torch.diagonal(c, dim1=-2, dim2=-1), min=1e-6)

    p0 = norm_cdf(lim[..., 0] / cdiag[..., 0])
    d = torch.where(pos[..., 0], p0, 0.0)
    e = torch.where(pos[..., 0], 1.0, p0)
    if m == 1:
        return e - d

    w = device_lattice(n_points, m - 1, mu.dtype, mu.device)
    if shift is not None:
        w = torch.remainder(w + shift[..., None, :], 1.0)  # (P, m-1)
    d, e = d[..., None], e[..., None]
    f = e - d  # (..., P) running product of conditional probabilities
    ys = []
    for i in range(1, m):
        u = torch.clamp(d + w[..., i - 1] * (e - d), _EPS, 1.0 - _EPS)
        ys.append(fast_ndtri(u))
        acc = ys[0] * c[..., i, 0, None]
        for j in range(1, i):
            acc = acc + ys[j] * c[..., i, j, None]
        p = norm_cdf((lim[..., i, None] - acc) / cdiag[..., i, None])
        d = torch.where(pos[..., i, None], p, 0.0)
        e = torch.where(pos[..., i, None], 1.0, p)
        f = f * (e - d)
    return f.mean(-1)


def orthant_probs_all_configs(
    mu: torch.Tensor,
    chol_cov: torch.Tensor,
    sign_table: torch.Tensor,
    *,
    n_points: int = 128,
    shift: torch.Tensor | None = None,
    normalize: bool = True,
) -> torch.Tensor:
    """(..., 2^m) probabilities of every configuration of ``sign_table``
    (2^m, m), one :func:`mvn_orthant_prob` each on the shared factor;
    normalized to sum to one unless ``normalize`` is False (the 2^m orthants
    partition R^m, so normalizing absorbs QMC error)."""
    probs = mvn_orthant_prob(mu[..., None, :], chol_cov[..., None, :, :], sign_table,
                             n_points=n_points, shift=shift)
    if normalize:
        probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-12)
    return probs


def orthant_probs_all_configs_tree(
    mu: torch.Tensor,
    chol_cov: torch.Tensor,
    *,
    n_points: int = 128,
    shift: torch.Tensor | None = None,
    normalize: bool = True,
) -> torch.Tensor:
    """All 2^m orthant probabilities via a sign-prefix tree — shared conditioning.

    ``mu`` (..., m) and ``chol_cov`` (..., m, m) over any leading batch dims;
    ``shift``: optional Cranley-Patterson shift, (m-1,) shared by the batch or
    (..., m-1) with the batch's leading dims (one shift per batch element).
    Two sign configurations that agree on their first i signs share the Genz
    chain up to dimension i, so level i holds 2^i nodes and the tree costs
    2^m - 2 sampled-dimension evaluations.  Returns (..., 2^m) probabilities
    in ``sign_table(m)`` order (-1 before +1, first dimension slowest), normalized
    to sum to one unless ``normalize`` is False: the children of node n are 2n
    (sign -1) and 2n+1 (sign +1).
    """
    m = mu.shape[-1]
    c = chol_cov
    lim = -mu
    cdiag = torch.clamp(torch.diagonal(c, dim1=-2, dim2=-1), min=1e-6)

    def finish(probs):
        if not normalize:
            return probs
        return probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-12)

    p0 = norm_cdf(lim[..., 0] / cdiag[..., 0])
    d = torch.stack([torch.zeros_like(p0), p0], dim=-1)  # (..., 2)
    e = torch.stack([p0, torch.ones_like(p0)], dim=-1)
    f = e - d
    if m == 1:
        return finish(f)

    w = device_lattice(n_points, m - 1, mu.dtype, mu.device)  # (P, m-1)
    if shift is not None:
        w = torch.remainder(w + shift[..., None, :], 1.0)  # (..., P, m-1)

    batch = mu.shape[:-1]
    d = d[..., None].expand(*batch, 2, n_points)
    e = e[..., None].expand(*batch, 2, n_points)
    f = f[..., None].expand(*batch, 2, n_points)
    ys = []  # y history per node, one (..., nodes, P) tensor per level
    nodes = 2
    for i in range(1, m):
        u = torch.clamp(d + w[..., None, :, i - 1] * (e - d), _EPS, 1.0 - _EPS)
        ys.append(fast_ndtri(u))  # (..., nodes, P)
        acc = ys[0] * c[..., i, 0, None, None]
        for j in range(1, i):
            acc = acc + ys[j] * c[..., i, j, None, None]
        t = (lim[..., i, None, None] - acc) / cdiag[..., i, None, None]
        p = norm_cdf(t)
        # Split each node into (s_i = -1, s_i = +1) children, flat order 2n+b.
        d = torch.stack([torch.zeros_like(p), p], dim=-2).reshape(*batch, 2 * nodes, n_points)
        e = torch.stack([p, torch.ones_like(p)], dim=-2).reshape(*batch, 2 * nodes, n_points)
        f = torch.repeat_interleave(f, 2, dim=-2) * (e - d)
        ys = [torch.repeat_interleave(y, 2, dim=-2) for y in ys]
        nodes *= 2

    return finish(f.mean(-1))  # (..., 2^m)


def shifted_replicates(
    mu: torch.Tensor,
    chol_cov: torch.Tensor,
    *,
    n_points: int,
    n_shifts: int,
    seed: int,
    normalize: bool = True,
) -> torch.Tensor:
    """(R, 2^m) orthant probabilities of one batch under Cranley-Patterson shifts.

    R = ``n_shifts - 1``: the random shifts of ``shift_table(n_shifts, m - 1,
    seed)``, all in one batched tree; shift 0, the zero shift, is not a draw
    from the shift family and is left out.  ``n_shifts = 1`` gives the one
    unshifted estimate (R = 1).  ``n_shifts = 2`` would leave one random
    replicate, which has no sample std, and raises.
    """
    if n_shifts == 2:
        raise ValueError(
            "n_shifts=2 leaves a single random replicate — no sample std "
            "exists; use n_shifts=1 (unshifted, err=0) or n_shifts >= 3"
        )
    m = mu.shape[-1]
    shifts = device_shift_table(n_shifts, m - 1, seed, mu.dtype, mu.device)
    if n_shifts > 1:
        shifts = shifts[1:]
    r = shifts.shape[0]
    return orthant_probs_all_configs_tree(mu.expand(r, m), chol_cov.expand(r, m, m),
                                          n_points=n_points, shift=shifts, normalize=normalize)


def replicate_mean_and_error(rep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean over the leading replicate axis and its standard error,
    ``std(ddof=1) / sqrt(R)``; 0 for a single replicate."""
    if rep.shape[0] == 1:
        return rep[0], torch.zeros_like(rep[0])
    return rep.mean(0), rep.std(0, correction=1) / math.sqrt(rep.shape[0])


def orthant_probs_with_error(
    mu: torch.Tensor,
    chol_cov: torch.Tensor,
    *,
    n_points: int = 128,
    n_shifts: int = 4,
    seed: int = 0,
    normalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All 2^m orthant probabilities of one batch (``mu`` (m,), ``chol_cov``
    (m, m)) plus a QMC error estimate.

    Returns ``(probs (2^m,), err (2^m,))``: the mean over the random-shift
    replicates of :func:`shifted_replicates` and its standard error,
    ``std(ddof=1) / sqrt(n_shifts - 1)``.  ``n_shifts = 1`` returns the
    unshifted estimate with ``err = 0``; ``n_shifts = 2`` raises.
    """
    return replicate_mean_and_error(shifted_replicates(
        mu, chol_cov, n_points=n_points, n_shifts=n_shifts, seed=seed, normalize=normalize))
