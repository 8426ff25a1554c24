"""Plain reference of the ITAL selection: the greedy two-stage batch of
mutual information, and the number ``select_gap`` that judges served batches.

Written from the mathematics (the paper's mutual information, Genz's
sequentially conditioned estimator of the orthant probabilities on a
Richtmyer lattice), after ``tests/oracle/numpy_oracle.py``, over the GP
posterior of :mod:`benchmark.reference`; it imports nothing of the system
under test.

The selection it follows is the one the configuration states: a pool of the
``pool_size`` unlabeled rows of highest posterior mean; at each greedy step
every pool candidate scored at ``n_qmc`` lattice points, the ``refine_top``
best scored again at ``refine_n_qmc``, the best of those taken (ties to the
better first score).  A served pick is judged against the best refined MI
among the candidates every sound program re-scores (:meth:`Selection.best`):
a candidate within :data:`MARGIN` of the pool's or the first stage's cut
may fall on either side of it in a program whose arithmetic is sound.  The
estimator's guards are part of its definition and are kept: Phi clamped to
[1e-6, 1 - 1e-6], the candidate factor's diagonal floored at 1e-6, its
pivots at 1e-10, the orthant probabilities normalized, a jitter of 1e-6 on
the batch covariance.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch

from benchmark.reference import INVALID_GAP, Posterior

EPS_PHI = 1e-6
DIAG_FLOOR = 1e-6
PIVOT_FLOOR = 1e-10
JITTER = 1e-6
LOG_EPS = 1e-12
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53)
# How far a sound program's posterior mean and first-stage MI may lie from
# the reference's: the selection's two cuts (the pool, the first stage's
# top) part candidates whose scores differ by less, so a candidate within
# MARGIN of a cut may fall on either side in a sound program.  The programs
# read at most 1.9e-5 from the reference in posterior mean and variance
# (an H100, float32 and bfloat16 corpora).
MARGIN = 1e-4


def mi_tables(m: int, label_prob: float, mistake_prob: float, dtype, device):
    """(2^m, m) relevance signs and the (2^m, 3^m) table P(F=f | R=r) of the
    noisy, skipping user, both in ``itertools.product`` order."""
    signs = torch.tensor(list(itertools.product([-1.0, 1.0], repeat=m)), dtype=dtype,
                         device=device)
    fb = torch.tensor(list(itertools.product([-1.0, 0.0, 1.0], repeat=m)), dtype=dtype,
                      device=device)
    r, f = signs[:, None, :], fb[None, :, :]
    item = torch.where(f == 0.0, 1.0 - label_prob,
                       torch.where(f == r, label_prob * (1.0 - mistake_prob),
                                   label_prob * mistake_prob))
    return signs, item.to(dtype).prod(-1)


def richtmyer(n: int, dim: int, dtype, device) -> torch.Tensor:
    k = torch.arange(1, n + 1, dtype=torch.float64)[:, None]
    alphas = torch.tensor([math.sqrt(p) for p in PRIMES[:dim]], dtype=torch.float64)
    return torch.frac(k * alphas[None, :]).to(dtype=dtype, device=device)


def phi(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(0.5 * torch.special.erfc(-x / math.sqrt(2.0)), EPS_PHI, 1.0 - EPS_PHI)


def small_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factors of (..., m, m) matrices, pivots floored at 1e-10."""
    m = a.shape[-1]
    l = torch.zeros_like(a)
    for i in range(m):
        for j in range(i + 1):
            s = a[..., i, j] - (l[..., i, :j] * l[..., j, :j]).sum(-1)
            if i == j:
                l[..., i, j] = torch.sqrt(torch.clamp(s, min=PIVOT_FLOOR))
            else:
                l[..., i, j] = s / l[..., j, j]
    return l


def orthant_probs(mu: torch.Tensor, chol: torch.Tensor, signs: torch.Tensor,
                  n_qmc: int) -> torch.Tensor:
    """(nc, 2^m) normalized probabilities of every sign configuration of
    N(mu, chol chol^T), each by Genz's sequential conditioning on the
    n_qmc-point Richtmyer lattice."""
    nc, m = mu.shape
    lim = -mu
    cdiag = torch.clamp(torch.diagonal(chol, dim1=-2, dim2=-1), min=DIAG_FLOOR)
    pos = signs > 0  # (S, m)
    p0 = phi(lim[:, 0] / cdiag[:, 0])[:, None]  # (nc, 1)
    d = torch.where(pos[None, :, 0], p0, 0.0)  # (nc, S)
    e = torch.where(pos[None, :, 0], 1.0, p0)
    if m == 1:
        probs = e - d
    else:
        w = richtmyer(n_qmc, m - 1, mu.dtype, mu.device)  # (n, m-1)
        d, e = d[..., None], e[..., None]
        f = e - d
        ys = []
        for i in range(1, m):
            u = torch.clamp(d + w[:, i - 1] * (e - d), EPS_PHI, 1.0 - EPS_PHI)
            ys.append(torch.special.ndtri(u))
            acc = sum(ys[j] * chol[:, i, j, None, None] for j in range(i))
            p = phi((lim[:, i, None, None] - acc) / cdiag[:, i, None, None])
            d = torch.where(pos[None, :, i, None], p, 0.0)
            e = torch.where(pos[None, :, i, None], 1.0, p)
            f = f * (e - d)
        probs = f.mean(-1)
    return probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-12)


class Selection:
    """The greedy two-stage ITAL selection of one session's posterior."""

    def __init__(self, post: Posterior):
        self.post = post
        ref = post.ref
        self.ref = ref
        sel = ref.selection
        self.pool_size = int(sel["pool_size"])
        self.n_qmc = int(sel["n_qmc"])
        self.refine_top = int(sel["refine_top"])
        self.refine_n_qmc = int(sel["refine_n_qmc"])
        mu, _ = post.full(with_var=False)
        labeled = torch.zeros(ref.n, dtype=torch.bool, device=ref.device)
        labeled[post.idx] = True
        self.labeled = labeled
        ranked = torch.where(labeled, -torch.inf, mu)
        vals, order = torch.sort(ranked, descending=True, stable=True)
        p = min(self.pool_size, ref.n)
        self.pool = order[:p]
        self.pool_ok = torch.isfinite(vals[:p])
        # The rows a sound program's pool may hold, and which of them it
        # surely holds.
        cut = vals[p - 1]
        wide = int((vals >= cut - MARGIN).sum())
        self.wide = order[:wide]
        self.wide_ok = torch.isfinite(vals[:wide])
        self.wide_sure = vals[:wide] > cut + MARGIN

    def _scores(self, bt: Sequence[int], cand: torch.Tensor, n_qmc: int) -> torch.Tensor:
        """MI of appending each corpus row ``cand`` to the partial batch ``bt``."""
        ref, post, prec = self.ref, self.post, self.ref.prec
        dt, dev = prec.dtype, ref.device
        t = len(bt)
        xc = ref.rows(cand)
        mu_c, sig2_c, wc = post.moments(xc)
        nc = cand.shape[0]
        mu = torch.zeros((nc, t + 1), dtype=dt, device=dev)
        cov = torch.zeros((nc, t + 1, t + 1), dtype=dt, device=dev)
        if t:
            bidx = torch.as_tensor(list(bt), dtype=torch.int64, device=dev)
            xb = ref.rows(bidx)
            wb = post.whiten(xb)
            mu[:, :t] = prec.mm(wb.T, post.beta)[:, 0]
            cov_bb = (ref.rbf(xb, xb) - prec.mm(wb.T, wb)
                      + JITTER * torch.eye(t, dtype=dt, device=dev))
            cross = ref.rbf(xc, xb) - prec.mm(wc.T, wb)
            cov[:, :t, :t] = cov_bb
            cov[:, :t, t] = cross
            cov[:, t, :t] = cross
        mu[:, t] = mu_c
        cov[:, t, t] = sig2_c + JITTER
        signs, pfr = mi_tables(t + 1, ref.label_prob, ref.mistake_prob, dt, dev)
        p_r = orthant_probs(mu, small_cholesky(cov), signs, n_qmc)
        neg_h = (pfr * torch.log(pfr + LOG_EPS)).sum(-1)
        p_f = prec.mm(p_r, pfr)
        h_f = -(p_f * torch.log(p_f + LOG_EPS)).sum(-1)
        return h_f + prec.mm(p_r, neg_h[:, None])[:, 0]

    def pick(self, bt: Sequence[int]) -> int:
        """The corpus row this precision's selection takes after ``bt``."""
        ok = self.pool_ok.clone()
        for b in bt:
            ok &= self.pool != int(b)
        coarse = torch.where(ok, self._scores(bt, self.pool, self.n_qmc), -torch.inf)
        top = torch.sort(coarse, descending=True, stable=True).indices[:self.refine_top]
        fine = self._scores(bt, self.pool[top], self.refine_n_qmc)
        fine = torch.where(torch.isfinite(coarse[top]), fine, -torch.inf)
        return int(self.pool[top[int(torch.argmax(fine))]])

    def best(self, bt: Sequence[int]) -> float:
        """The largest refined MI after ``bt`` among the candidates that
        every sound program re-scores: surely in the pool, and in the first
        stage's top ``refine_top`` by more than :data:`MARGIN` (above the
        ``refine_top``-th first-stage score over every row the pool may
        hold)."""
        ok = self.wide_ok.clone()
        for b in bt:
            ok &= self.wide != int(b)
        coarse = torch.where(ok, self._scores(bt, self.wide, self.n_qmc), -torch.inf)
        cut = torch.sort(coarse, descending=True).values[self.refine_top - 1]
        cand = self.wide[ok & self.wide_sure & (coarse > cut + MARGIN)]
        if not len(cand):
            return -math.inf
        return float(self._scores(bt, cand, self.refine_n_qmc).max())

    def refined(self, bt: Sequence[int], rows: Sequence[int]) -> list[float]:
        """The refined MI of each of ``rows`` appended to ``bt``."""
        cand = torch.as_tensor(list(rows), dtype=torch.int64, device=self.ref.device)
        return [float(v) for v in self._scores(bt, cand, self.refine_n_qmc)]

    def selectable(self, bt: Sequence[int], row: int) -> bool:
        return self.ref.selectable(self.labeled, bt, row)


def readings(ref, low, sampled: list) -> dict:
    """``select_gap``: the widest amount by which a served pick's refined MI
    lies below the best refined MI after the same partial batch
    (:meth:`Selection.best`; :data:`INVALID_GAP` for a pick that is labeled,
    repeated or outside the corpus), over the ``sampled`` ``(idx, y,
    batch)``; with ``low`` (the reference in a lower precision), its own
    picks are judged in the program's place."""
    gap = 0.0
    for idx, y, batch in sampled:
        sel = Selection(ref.posterior(idx, y))
        other = Selection(low.posterior(idx, y)) if low is not None else None
        for t in range(len(batch)):
            bt = [int(b) for b in batch[:t]]
            served = other.pick(bt) if other is not None else int(batch[t])
            if not sel.selectable(bt, served):
                gap = INVALID_GAP
                continue
            gap = max(gap, sel.best(bt) - sel.refined(bt, [served])[0])
    return {"select_gap": gap}
