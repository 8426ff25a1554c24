"""ITAL — information-theoretic active learning batch selection (port of ``ital_tpu.select.ital``).

Each feedback round selects the batch of unlabeled candidates maximizing

    I(R; F | A) = sum_r sum_f P(R=r) P(F=f | R=r) log [ P(F=f|R=r) / P(F=f) ]

between the batch's joint relevance R and the noisy, possibly skipped
feedback F.  P(R=r) are orthant probabilities of the GP's joint predictive
Gaussian over the batch (:mod:`ital_tpu_torch.ops.mvn`); P(F|R) is the user
model, factorized across the batch.  The batch grows greedily; each step
scores every candidate at once, in blocks of ``block`` candidates.

Modes: the compact pool (``pool_size``, top items by posterior mean, or
``subsample_size``, a random subset) with and without two-stage refinement
(``refine_top``), the full-corpus scan with refinement, and the plain full
scan; each with the fixed lattice or a random shift per greedy step
(``randomize_qmc``).  Greedy picks never wait on the host: the batch stays on
the device until the caller reads it.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from ital_tpu_torch.models.gp import GPState, gp_posterior_cov_columns, gp_predict_full
from ital_tpu_torch.ops.blocking import blocked_map
from ital_tpu_torch.ops.kernels import rbf_kernel
from ital_tpu_torch.ops.mvn import (
    orthant_probs_all_configs_tree,
    replicate_mean_and_error,
    shifted_replicates,
    small_cholesky,
)
from ital_tpu_torch.select.base import (
    StrategyParams,
    greedy_argmax_batch,
    labeled_mask,
    register,
)
from ital_tpu_torch.utils.metrics import top_k_stable

# Largest supported MI batch: the 3^m feedback table and the reference's
# measured QMC accuracy (through m = 8) bound it.
MAX_MI_BATCH = 8

# Candidates scored per block of the MI scan.  Each block costs the same
# ~800 small launches whatever its size, so on the card fewer blocks win: a
# full-scan fetch over 25 000 candidates took 213-238 ms at block 1024 and
# 22-25 ms at 32768 (one block) on an H100 80GB HBM3 at 700 W (PERF.md).
MI_BLOCK = 32768


@functools.lru_cache(maxsize=None)
def sign_table(m: int) -> np.ndarray:
    """(2^m, m) all relevance sign configurations r in {-1, +1}^m."""
    return np.asarray(list(itertools.product([-1.0, 1.0], repeat=m)), np.float32)


@functools.lru_cache(maxsize=None)
def feedback_table(m: int) -> np.ndarray:
    """(3^m, m) all feedback configurations f in {-1, 0, +1}^m (0 = skipped)."""
    return np.asarray(list(itertools.product([-1.0, 0.0, 1.0], repeat=m)), np.float32)


def feedback_given_relevance(
    m: int, label_prob: torch.Tensor, mistake_prob: torch.Tensor
) -> torch.Tensor:
    """(2^m, 3^m) table P(F=f | R=r) under the noisy/skipping user model.

    Per item: P(f=0) = 1 - label_prob; P(f=r) = label_prob * (1 - mistake_prob);
    P(f=-r) = label_prob * mistake_prob — factorized across the batch.
    """
    dev, dt = label_prob.device, label_prob.dtype
    r = torch.as_tensor(sign_table(m), device=dev)[:, None, :]  # (2^m, 1, m)
    f = torch.as_tensor(feedback_table(m), device=dev)[None, :, :]  # (1, 3^m, m)
    one = torch.ones((), dtype=dt, device=dev)
    p_item = torch.where(
        f == 0.0,
        one - label_prob,
        torch.where(f == r, label_prob * (1.0 - mistake_prob), label_prob * mistake_prob),
    )
    return torch.prod(p_item, dim=-1)


def mutual_information_from_relevance(p_r: torch.Tensor, pfr: torch.Tensor) -> torch.Tensor:
    """I(R; F) from relevance-config probabilities ``p_r`` (..., 2^m).

    MI = H(F) - H(F|R); the conditional entropy is a fixed per-config row sum.
    """
    eps = 1e-12
    neg_h_f_given_r = (pfr * torch.log(pfr + eps)).sum(-1)  # (2^m,)
    p_f = p_r @ pfr  # (..., 3^m)
    h_f = -(p_f * torch.log(p_f + eps)).sum(-1)
    return h_f + p_r @ neg_h_f_given_r


def _joint_posterior(
    state: GPState, batch: torch.Tensor, t: int, jitter: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint predictive pieces over batch[:t] + each candidate.

    Returns (mu_b (t,), cov_bb (t,t), cross (N,t), jittered sig2 (N,)).
    """
    bsel = batch[:t]
    mu_b, cov_bb = gp_predict_full(state, bsel)
    cov_bb = cov_bb + jitter * torch.eye(t, dtype=cov_bb.dtype, device=cov_bb.device)
    cross = gp_posterior_cov_columns(state, bsel)  # (N, t)
    return mu_b, cov_bb, cross, state.sig2 + jitter


def mi_scores_from_moments(
    mu_cand: torch.Tensor,
    sig2_cand: torch.Tensor,
    cross: torch.Tensor,
    mu_b: torch.Tensor,
    cov_bb: torch.Tensor,
    params: StrategyParams,
    *,
    t: int,
    n_qmc: int = 128,
    block: int = MI_BLOCK,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MI of appending each candidate to the partial batch, from posterior moments.

    Args:
      mu_cand/sig2_cand: (Nc,) candidate posterior mean / (jittered) variance.
      cross: (Nc, t) posterior covariance candidate<->batch members.
      mu_b: (t,) batch posterior mean; cov_bb: (t, t) jittered batch covariance.
      shift: optional (t,) Cranley-Patterson lattice shift in [0,1), shared
        by every candidate; ``None`` uses the unshifted lattice.
    """
    m = t + 1
    pfr = feedback_given_relevance(m, params.label_prob, params.mistake_prob)

    def score_block(mu_c, sig2_c, cross_c):
        nb = mu_c.shape[0]
        mu = torch.cat([mu_b.expand(nb, t), mu_c[:, None]], dim=1)  # (nb, m)
        cov = torch.zeros((nb, m, m), dtype=mu.dtype, device=mu.device)
        if t > 0:
            cov[:, :t, :t] = cov_bb
            cov[:, :t, t] = cross_c
            cov[:, t, :t] = cross_c
        cov[:, t, t] = sig2_c
        p_r = orthant_probs_all_configs_tree(mu, small_cholesky(cov),
                                             n_points=n_qmc, shift=shift)
        return mutual_information_from_relevance(p_r, pfr)

    # Pad variance with 1.0 so the per-candidate Cholesky stays SPD on pad rows.
    return blocked_map(score_block, (mu_cand, sig2_cand, cross), block=block,
                       pad_values=(0.0, 1.0, 0.0))


def mi_with_error(
    mu: torch.Tensor,
    chol_cov: torch.Tensor,
    params: StrategyParams,
    *,
    n_qmc: int = 128,
    n_shifts: int = 8,
    seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MI of one candidate batch (``mu`` (m,), ``chol_cov`` (m, m)) plus a QMC error estimate.

    Each random-shift replicate of the orthant vector
    (:func:`ital_tpu_torch.ops.mvn.shifted_replicates`) gives an independent
    replicate of the MI; returns their mean and
    ``std(ddof=1) / sqrt(n_shifts - 1)``.  ``n_shifts = 1`` returns the
    unshifted MI with error 0; ``n_shifts = 2`` raises.
    """
    pfr = feedback_given_relevance(mu.shape[0], params.label_prob, params.mistake_prob)
    p_r = shifted_replicates(mu, chol_cov, n_points=n_qmc, n_shifts=n_shifts, seed=seed)
    return replicate_mean_and_error(mutual_information_from_relevance(p_r, pfr))


def refined_pick(
    scores_masked: torch.Tensor,
    mu_cand: torch.Tensor,
    sig2_cand: torch.Tensor,
    cross: torch.Tensor,
    mu_b: torch.Tensor,
    cov_bb: torch.Tensor,
    params: StrategyParams,
    *,
    t: int,
    refine_top: int,
    refine_n_qmc: int,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two-stage greedy pick: re-score the top candidates at higher accuracy.

    The ``refine_top`` best base-scan candidates (ineligible ones at -inf in
    ``scores_masked``) are re-scored at ``refine_n_qmc`` points and the argmax
    is taken over the refined estimates.  Returns the winner's local index
    into ``scores_masked`` as a 0-d tensor.
    """
    vals, top = top_k_stable(scores_masked, refine_top)
    refined = mi_scores_from_moments(
        mu_cand[top], sig2_cand[top], cross[top], mu_b, cov_bb, params,
        t=t, n_qmc=refine_n_qmc, shift=shift,
    )
    refined = torch.where(torch.isfinite(vals), refined, -torch.inf)
    return top[torch.argmax(refined)]


def score_candidates_mi(
    state: GPState,
    batch: torch.Tensor,
    t: int,
    params: StrategyParams,
    *,
    n_qmc: int = 128,
    block: int = MI_BLOCK,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(N,) mutual information of appending each corpus point to ``batch[:t]``."""
    mu_b, cov_bb, cross, sig2 = _joint_posterior(state, batch, t, params.jitter)
    return mi_scores_from_moments(
        state.mu, sig2, cross, mu_b, cov_bb, params, t=t, n_qmc=n_qmc,
        block=block, shift=shift,
    )


def candidate_pool_indices(
    state: GPState, ranking: torch.Tensor, pool_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``pool_size`` unlabeled candidates by ``ranking``, as indices.

    Returns ``(pool_idx (pool,) int64, pool_forbid (pool,) bool)``: the corpus
    indices in descending-``ranking`` order, plus a flag on slots that fell on
    excluded rows (only when the pool exceeds the selectable candidates).
    Ties go to the lowest index, as with ``jax.lax.top_k``.
    """
    ranked = torch.where(labeled_mask(state), -torch.inf, ranking)
    vals, pool_idx = top_k_stable(ranked, pool_size)
    return pool_idx, ~torch.isfinite(vals)


def _step_shift(
    qmc_shifts: Optional[Sequence[torch.Tensor]], t: int
) -> Optional[torch.Tensor]:
    """Greedy step ``t``'s (t,) lattice shift, or None for the fixed lattice."""
    return None if qmc_shifts is None else qmc_shifts[t]


def draw_qmc_shifts(
    generator: Optional[torch.Generator], batch_size: int, dtype: torch.dtype, device
) -> list[torch.Tensor]:
    """One uniform (t,) Cranley-Patterson shift per greedy step t, from ``generator``."""
    return [torch.rand(t, generator=generator, dtype=dtype, device=device)
            for t in range(batch_size)]


def pool_batch_moments(
    state: GPState,
    params: StrategyParams,
    x_pool: torch.Tensor,
    v_pool: torch.Tensor,
    bsel: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint moments of a pool against the partial batch ``bsel`` (t,).

    ``x_pool`` (pool, D) and ``v_pool`` (cap, pool) are the pool's features and
    whitened columns.  Returns (mu_b (t,), jittered cov_bb (t, t),
    cross (pool, t)).
    """
    dt = state.mu.dtype
    dev = state.mu.device
    t = bsel.shape[0]
    if t == 0:
        return (state.mu[bsel], torch.zeros((0, 0), dtype=dt, device=dev),
                torch.zeros((x_pool.shape[0], 0), dtype=dt, device=dev))
    h = state.hyper
    mu_b, cov_bb = gp_predict_full(state, bsel)
    cov_bb = cov_bb + params.jitter * torch.eye(t, dtype=dt, device=dev)
    k_pb = rbf_kernel(x_pool, state.x[bsel], h.length_scale, h.var)
    return mu_b, cov_bb, k_pb - v_pool.T @ state.v[:, bsel]


def _select_ital_pool(
    state: GPState,
    batch_size: int,
    params: StrategyParams,
    pool_idx: torch.Tensor,
    pool_forbid: torch.Tensor,
    *,
    n_qmc: int,
    block: int = MI_BLOCK,
    refine_top: int = 0,
    refine_n_qmc: int = 512,
    qmc_shifts: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Greedy ITAL over a compact candidate pool — cost scales with the pool.

    Only the pool's moments are gathered and scored; the picks equal those of
    the full scan masked to the pool, up to argmax tie order.
    """
    x_pool = state.x[pool_idx]  # (pool, D)
    v_pool = state.v[:, pool_idx]  # (cap, pool)
    mu_pool = state.mu[pool_idx]
    sig2_pool = state.sig2[pool_idx] + params.jitter

    batch = torch.zeros(batch_size, dtype=torch.int64, device=pool_idx.device)
    forbid = pool_forbid.clone()
    for t in range(batch_size):
        shift = _step_shift(qmc_shifts, t)
        mu_b, cov_bb, cross = pool_batch_moments(state, params, x_pool, v_pool, batch[:t])
        scores = mi_scores_from_moments(
            mu_pool, sig2_pool, cross, mu_b, cov_bb, params,
            t=t, n_qmc=n_qmc, block=block, shift=shift,
        )
        scores = torch.where(forbid, -torch.inf, scores)
        if refine_top:
            p = refined_pick(
                scores, mu_pool, sig2_pool, cross, mu_b, cov_bb, params,
                t=t, refine_top=min(refine_top, pool_idx.shape[0]),
                refine_n_qmc=refine_n_qmc, shift=shift,
            )
        else:
            p = torch.argmax(scores)
        batch[t] = pool_idx[p]
        forbid[p] = True
    return batch


@register("ital")
def select_ital(
    state: GPState,
    batch_size: int,
    generator: Optional[torch.Generator],
    params: StrategyParams,
    *,
    n_qmc: int = 128,
    block: int = MI_BLOCK,
    pool_size: int = 0,
    subsample_size: int = 0,
    refine_top: int = 0,
    refine_n_qmc: int = 512,
    qmc_shifts: Optional[Sequence[torch.Tensor]] = None,
    randomize_qmc: bool = False,
    subsample_uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy ITAL batch construction (reference ``ITAL.fetch_unlabelled``).

    ``pool_size > 0`` restricts selection to the top-ranked unlabeled items by
    posterior mean and scores only that pool; ``subsample_size > 0`` to a
    random subset of that many unlabeled items (the two exclude each other).
    ``refine_top > 0`` re-scores the ``refine_top`` best base-scan candidates
    at ``refine_n_qmc`` points before each greedy argmax.  ``block`` is the
    candidate-streaming width of the MI scan; scores do not depend on it
    beyond float associativity.

    ``qmc_shifts`` (default ``None``, the fixed lattice) gives each greedy
    step ``t`` its own (t,) Cranley-Patterson shift ``qmc_shifts[t]`` — the
    port's form of the reference's ``qmc_key``; ``randomize_qmc=True`` draws
    them from ``generator`` (:func:`draw_qmc_shifts`), and explicit
    ``qmc_shifts`` win.  The subset is the top ``subsample_size`` unlabeled
    items of an (N,) uniform draw, ``subsample_uniforms`` where given, else
    drawn from ``generator`` before the shifts.
    """
    if batch_size > MAX_MI_BATCH:
        raise ValueError(
            f"ITAL batch_size={batch_size} exceeds the supported maximum "
            f"{MAX_MI_BATCH}: the feedback-configuration table grows 3^m "
            f"(={3 ** batch_size}) and the fixed-lattice QMC accuracy is "
            f"measured only through m={MAX_MI_BATCH}; use a smaller batch or "
            f"multiple rounds"
        )
    if pool_size and subsample_size:
        raise ValueError(
            "pool_size and subsample_size are mutually exclusive candidate "
            "restrictions (reference ITAL applies one or the other)"
        )
    if qmc_shifts is not None and len(qmc_shifts) < batch_size:
        raise ValueError(
            f"qmc_shifts needs one shift per greedy step ({batch_size}), "
            f"got {len(qmc_shifts)}"
        )

    n = state.mu.shape[0]
    dt, dev = state.mu.dtype, state.mu.device
    if subsample_size and subsample_uniforms is None:
        subsample_uniforms = torch.rand(n, generator=generator, dtype=dt, device=dev)
    if randomize_qmc and qmc_shifts is None:
        qmc_shifts = draw_qmc_shifts(generator, batch_size, dt, dev)
    if pool_size or subsample_size:
        ranking = state.mu if pool_size else subsample_uniforms
        pool_idx, pool_forbid = candidate_pool_indices(
            state, ranking, min(pool_size or subsample_size, n))
        return _select_ital_pool(
            state, batch_size, params, pool_idx, pool_forbid, n_qmc=n_qmc,
            block=block, refine_top=refine_top, refine_n_qmc=refine_n_qmc,
            qmc_shifts=qmc_shifts,
        )
    if not refine_top:
        return greedy_argmax_batch(
            lambda batch, t: score_candidates_mi(
                state, batch, t, params, n_qmc=n_qmc, block=block,
                shift=_step_shift(qmc_shifts, t),
            ),
            state,
            batch_size,
        )
    # Full-corpus scan with two-stage refinement: the per-step moments are
    # kept so refined_pick re-scores the top candidates without recomputing
    # the corpus-wide cross-covariance.
    excluded = labeled_mask(state)
    batch = torch.zeros(batch_size, dtype=torch.int64, device=state.idx.device)
    for t in range(batch_size):
        shift = _step_shift(qmc_shifts, t)
        mu_b, cov_bb, cross, sig2 = _joint_posterior(state, batch, t, params.jitter)
        scores = mi_scores_from_moments(
            state.mu, sig2, cross, mu_b, cov_bb, params, t=t, n_qmc=n_qmc,
            block=block, shift=shift,
        )
        scores = torch.where(excluded, -torch.inf, scores)
        p = refined_pick(
            scores, state.mu, sig2, cross, mu_b, cov_bb, params,
            t=t, refine_top=min(refine_top, n), refine_n_qmc=refine_n_qmc,
            shift=shift,
        )
        batch[t] = p
        excluded[p] = True
    return batch
