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

:func:`select_ital_stacked` selects for K sessions over one corpus at once
(the reference's ``jax.vmap(select_ital)``): each greedy step gathers every
session's moments, scores all their candidates in one MI call and takes each
session's argmax.  :func:`select_ital` is its one-session case.  Both run as
programs (:mod:`ital_tpu_torch.graphs`) over :func:`_stacked_picks`.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.models.gp import (
    GPState,
    StackedGPState,
    cohort_program_inputs,
    program_inputs,
    program_state,
    program_stack,
    stacked_view,
)
from ital_tpu_torch.ops.blocking import blocked_map
from ital_tpu_torch.ops.kernels import rbf_sessions
from ital_tpu_torch.ops.mvn import (
    orthant_probs_all_configs_tree,
    replicate_mean_and_error,
    shifted_replicates,
    small_cholesky,
)
from ital_tpu_torch.select.base import (
    CohortProgram,
    StrategyParams,
    labeled_mask,
    per_session,
    register,
    register_cohort_program,
    register_stacked,
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


@functools.cache
def device_tables(m: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(:func:`sign_table`, :func:`feedback_table`) of ``m`` as f32 tensors on
    ``device``, copied from the host once and cached: a copy from pageable
    memory waits for the stream, and inside a CUDA graph's capture it is
    refused, so the warm-up before a capture fills the cache.  Callers never
    write them."""
    return (torch.as_tensor(sign_table(m), device=device),
            torch.as_tensor(feedback_table(m), device=device))


def feedback_given_relevance(
    m: int, label_prob: torch.Tensor, mistake_prob: torch.Tensor
) -> torch.Tensor:
    """(2^m, 3^m) table P(F=f | R=r) under the noisy/skipping user model;
    (K, 2^m, 3^m), one per session, from (K,) ``label_prob`` and
    ``mistake_prob``.

    Per item: P(f=0) = 1 - label_prob; P(f=r) = label_prob * (1 - mistake_prob);
    P(f=-r) = label_prob * mistake_prob — factorized across the batch.
    """
    dev, dt = label_prob.device, label_prob.dtype
    signs, feedback = device_tables(m, dev)
    r = signs[:, None, :]  # (2^m, 1, m)
    f = feedback[None, :, :]  # (1, 3^m, m)
    one = torch.ones((), dtype=dt, device=dev)
    lp, mp = label_prob[..., None, None, None], mistake_prob[..., None, None, None]
    p_item = torch.where(f == 0.0, one - lp, torch.where(f == r, lp * (1.0 - mp), lp * mp))
    return torch.prod(p_item, dim=-1)


def mutual_information_from_relevance(p_r: torch.Tensor, pfr: torch.Tensor,
                                      session: Optional[torch.Tensor] = None) -> torch.Tensor:
    """I(R; F) from relevance-config probabilities ``p_r`` (..., 2^m).

    MI = H(F) - H(F|R); the conditional entropy is a fixed per-config row sum.
    With K sessions' tables ``pfr`` (K, 2^m, 3^m), row c of ``p_r`` (Nc,
    2^m) takes table ``session[c]``.
    """
    if pfr.dim() == 3:
        mi = torch.stack([mutual_information_from_relevance(p_r, t) for t in pfr.unbind(0)])
        return mi.gather(0, session[None])[0]
    eps = 1e-12
    neg_h_f_given_r = (pfr * torch.log(pfr + eps)).sum(-1)  # (2^m,)
    p_f = p_r @ pfr  # (..., 3^m)
    h_f = -(p_f * torch.log(p_f + eps)).sum(-1)
    return h_f + p_r @ neg_h_f_given_r


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
    session: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MI of appending each candidate to the partial batch, from posterior moments.

    Args:
      mu_cand/sig2_cand: (Nc,) candidate posterior mean / (jittered) variance.
      cross: (Nc, t) posterior covariance candidate<->batch members.
      mu_b: (t,) batch posterior mean; cov_bb: (t, t) jittered batch
        covariance; both shared by every candidate, or (Nc, t) and
        (Nc, t, t), one partial batch per candidate (stacked sessions).
      shift: optional Cranley-Patterson lattice shift in [0,1), (t,) shared
        by every candidate or (Nc, t) with per-candidate moments; ``None``
        uses the unshifted lattice.
      session: (Nc,) int64, each candidate's session, where ``params``
        holds K sessions' (K,) user models.
    """
    m = t + 1
    pfr = feedback_given_relevance(m, params.label_prob, params.mistake_prob)
    # Streamed per candidate, by name, with their pads (variance 1.0 keeps
    # pad rows' Cholesky SPD); the rest is shared by every candidate.
    streamed = {"mu_c": (mu_cand, 0.0), "sig2_c": (sig2_cand, 1.0), "cross_c": (cross, 0.0)}
    if session is not None:
        streamed["session_c"] = (session, 0)
    if mu_b.dim() == 2:
        streamed.update(mu_bc=(mu_b, 0.0), cov_bbc=(cov_bb, 0.0))
        if shift is not None:
            streamed["shift_c"] = (shift, 0.0)

    def score_block(*blk):
        a = {"mu_bc": mu_b, "cov_bbc": cov_bb, "shift_c": shift, "session_c": None,
             **dict(zip(streamed, blk))}
        mu_c, sig2_c, cross_c = a["mu_c"], a["sig2_c"], a["cross_c"]
        mu_bc, cov_bbc, shift_c = a["mu_bc"], a["cov_bbc"], a["shift_c"]
        nb = mu_c.shape[0]
        mu = torch.cat([mu_bc.expand(nb, t), mu_c[:, None]], dim=1)  # (nb, m)
        cov = torch.zeros((nb, m, m), dtype=mu.dtype, device=mu.device)
        if t > 0:
            cov[:, :t, :t] = cov_bbc
            cov[:, :t, t] = cross_c
            cov[:, t, :t] = cross_c
        cov[:, t, t] = sig2_c
        p_r = orthant_probs_all_configs_tree(mu, small_cholesky(cov),
                                             n_points=n_qmc, shift=shift_c)
        return mutual_information_from_relevance(p_r, pfr, a["session_c"])

    return blocked_map(score_block, [v for v, _ in streamed.values()], block=block,
                       pad_values=[p for _, p in streamed.values()])


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


def _session_scores(
    mu_c: torch.Tensor,
    sig2_c: torch.Tensor,
    cross: torch.Tensor,
    mu_b: torch.Tensor,
    cov_bb: torch.Tensor,
    params: StrategyParams,
    *,
    t: int,
    n_qmc: int,
    block: int = MI_BLOCK,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(K, P) MI of K sessions' P candidates each, in one
    :func:`mi_scores_from_moments` call: the moments are (K, P), (K, P, t),
    (K, t) and (K, t, t), and ``shift`` (K, t); each candidate carries its
    session's partial batch, except for one session, whose candidates share
    it, and, where ``params`` holds (K,) user models, its session's."""
    k, p = mu_c.shape

    def each(a):
        if k == 1:
            return a[0]
        return a[:, None].expand(k, p, *a.shape[1:]).reshape(k * p, *a.shape[1:])

    session = None
    if params.label_prob.dim():
        session = torch.arange(k, device=mu_c.device)[:, None].expand(k, p).reshape(-1)
    scores = mi_scores_from_moments(
        mu_c.reshape(-1), sig2_c.reshape(-1), cross.reshape(k * p, t), each(mu_b),
        each(cov_bb), params, t=t, n_qmc=n_qmc, block=block,
        shift=None if shift is None else each(shift), session=session,
    )
    return scores.view(k, p)


def _refined_picks(
    scores_masked: torch.Tensor,
    mu_c: torch.Tensor,
    sig2_c: torch.Tensor,
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
    """(K,) two-stage greedy picks of K sessions: each session's
    ``refine_top`` best base-scan candidates (ineligible ones at -inf in
    ``scores_masked`` (K, P)) re-scored at ``refine_n_qmc`` points, all in one
    MI call, and each session's argmax over its refined estimates (ties to
    the better base score), as local indices into ``scores_masked``."""
    vals, top = top_k_stable(scores_masked, refine_top)  # (K, R)
    refined = _session_scores(
        mu_c.gather(1, top), sig2_c.gather(1, top),
        cross.gather(1, top[..., None].expand(-1, -1, t)), mu_b, cov_bb, params,
        t=t, n_qmc=refine_n_qmc, shift=shift,
    )
    refined = torch.where(torch.isfinite(vals), refined, -torch.inf)
    return top.gather(1, torch.argmax(refined, dim=1, keepdim=True))[:, 0]


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
    return _refined_picks(
        scores_masked[None], mu_cand[None], sig2_cand[None], cross[None], mu_b[None],
        cov_bb[None], params, t=t, refine_top=refine_top, refine_n_qmc=refine_n_qmc,
        shift=None if shift is None else shift[None],
    )[0]


def _session_moments(
    st: StackedGPState,
    params: StrategyParams,
    bsel: torch.Tensor,
    pool: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint moments of K sessions' candidates against their partial batches
    ``bsel`` (K, t).

    ``pool``: the candidates' features (K, P, D) and whitened columns
    (K, cap, P); ``None`` takes the whole corpus as every session's
    candidates.  Returns (mu_b (K, t), jittered cov_bb (K, t, t),
    cross (K, P, t)).  The RBF blocks take one kernel launch per group of
    sessions with equal hyperparameters: the batch block (t, t) and the
    candidates' block, (P, t) per session from the stacked (K P, K t) block's
    diagonal for a pool, or (N, K t) against the shared corpus.
    """
    k, t = bsel.shape
    dt, dev = st.mu.dtype, st.mu.device
    n_cand = st.x.shape[0] if pool is None else pool[0].shape[1]
    if t == 0:
        return (torch.zeros((k, 0), dtype=dt, device=dev),
                torch.zeros((k, 0, 0), dtype=dt, device=dev),
                torch.zeros((k, n_cand, 0), dtype=dt, device=dev))
    h, groups = st.hyper, st.hyper_groups
    mu_b = st.mu.gather(1, bsel)
    xs = st.x[bsel]  # (K, t, D)
    vs = st.v.gather(2, bsel[:, None, :].expand(-1, st.cap, -1))  # (K, cap, t)
    k_bb = rbf_sessions(xs, xs, h.length_scale, h.var, groups)
    eye = torch.eye(t, dtype=dt, device=dev)
    cov_bb = k_bb - vs.mT @ vs + per_session(params.jitter, 2) * eye
    if pool is None:
        k_cb = rbf_sessions(st.x, xs, h.length_scale, h.var, groups, a2=st.x2)
        return mu_b, cov_bb, k_cb - st.v.mT @ vs
    x_pool, v_pool = pool
    k_cb = rbf_sessions(x_pool, xs, h.length_scale, h.var, groups)
    return mu_b, cov_bb, k_cb - v_pool.mT @ vs


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
    out = _session_moments(stacked_view(state), params, bsel[None],
                           (x_pool[None], v_pool[None]))
    return tuple(a[0] for a in out)


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
    st = stacked_view(state)
    mu_b, cov_bb, cross = _session_moments(st, params, batch[None, :t])
    return _session_scores(st.mu, st.sig2 + params.jitter, cross, mu_b, cov_bb, params,
                           t=t, n_qmc=n_qmc, block=block,
                           shift=None if shift is None else shift[None])[0]


def candidate_pool_indices(
    state: GPState | StackedGPState, ranking: torch.Tensor, pool_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``pool_size`` unlabeled candidates by ``ranking``, as indices.

    Returns ``(pool_idx (pool,) int64, pool_forbid (pool,) bool)``: the corpus
    indices in descending-``ranking`` order, plus a flag on slots that fell on
    excluded rows (only when the pool exceeds the selectable candidates).
    Ties go to the lowest index, as with ``jax.lax.top_k``.  For a stack of K
    sessions, ``ranking`` is (K, N) and both results (K, pool).
    """
    ranked = torch.where(labeled_mask(state), -torch.inf, ranking)
    vals, pool_idx = top_k_stable(ranked, pool_size)
    return pool_idx, ~torch.isfinite(vals)


def candidate_pool_mask(
    state: GPState | StackedGPState, ranking: torch.Tensor, pool_size: int
) -> torch.Tensor:
    """(N,) bool, True OUTSIDE the top-``pool_size`` unlabeled candidates by
    ``ranking`` (labeled items take no pool slot); (K, N) for a stack of K
    sessions.  The mask form of :func:`candidate_pool_indices`."""
    pool_idx, _ = candidate_pool_indices(state, ranking, pool_size)
    return torch.ones(ranking.shape, dtype=torch.bool, device=ranking.device).scatter_(
        -1, pool_idx, False)


def _check_options(batch_size: int, pool_size: int, subsample_size: int,
                   qmc_shifts: Optional[Sequence]) -> None:
    """Refuse options no ITAL selection takes, before anything is drawn."""
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


def draw_qmc_shifts(
    generator: Optional[torch.Generator], batch_size: int, dtype: torch.dtype, device
) -> list[torch.Tensor]:
    """One uniform (t,) Cranley-Patterson shift per greedy step t, from ``generator``."""
    return [torch.rand(t, generator=generator, dtype=dtype, device=device)
            for t in range(batch_size)]


def draw_selection_inputs(
    generator: Optional[torch.Generator], n: int, batch_size: int, dtype: torch.dtype, device,
    *, subsample: bool, randomize: bool,
) -> tuple[Optional[torch.Tensor], Optional[list[torch.Tensor]]]:
    """One session's random inputs to an ITAL selection, from ``generator`` in
    the order the selection draws them: the (n,) subsample uniforms first
    where ``subsample``, then one (t,) shift per greedy step t where
    ``randomize`` (:func:`draw_qmc_shifts`).  Returns (uniforms or None,
    shifts or None)."""
    u = torch.rand(n, generator=generator, dtype=dtype, device=device) if subsample else None
    shifts = draw_qmc_shifts(generator, batch_size, dtype, device) if randomize else None
    return u, shifts


def _greedy_picks(
    st: StackedGPState,
    batch_size: int,
    params: StrategyParams,
    pool_idx: Optional[torch.Tensor],
    forbid: torch.Tensor,
    *,
    n_qmc: int,
    block: int,
    refine_top: int,
    refine_n_qmc: int,
    qmc_shifts: Optional[Sequence[torch.Tensor]],
) -> torch.Tensor:
    """(K, batch_size) greedy ITAL batches of K sessions.

    Candidates are each session's pool ``pool_idx`` (K, P), or the whole
    corpus where it is None; ``forbid`` (K, P) marks the ineligible ones.
    Only the candidates' moments are gathered and scored, so a pool's picks
    equal those of the full scan masked to the pool, up to argmax tie order.
    """
    k = st.k
    if pool_idx is None:
        pool = None
        mu_c, sig2_c = st.mu, st.sig2 + per_session(params.jitter)
    else:
        pool = (st.x[pool_idx], st.v.gather(2, pool_idx[:, None, :].expand(-1, st.cap, -1)))
        mu_c = st.mu.gather(1, pool_idx)
        sig2_c = st.sig2.gather(1, pool_idx) + per_session(params.jitter)
    batch = torch.zeros((k, batch_size), dtype=torch.int64, device=st.idx.device)
    forbid = forbid.clone()
    for t in range(batch_size):
        shift = None if qmc_shifts is None else qmc_shifts[t]
        mu_b, cov_bb, cross = _session_moments(st, params, batch[:, :t], pool)
        scores = _session_scores(mu_c, sig2_c, cross, mu_b, cov_bb, params, t=t,
                                 n_qmc=n_qmc, block=block, shift=shift)
        scores = torch.where(forbid, -torch.inf, scores)
        if refine_top:
            p = _refined_picks(scores, mu_c, sig2_c, cross, mu_b, cov_bb, params, t=t,
                               refine_top=min(refine_top, forbid.shape[1]),
                               refine_n_qmc=refine_n_qmc, shift=shift)
        else:
            p = torch.argmax(scores, dim=1)
        batch[:, t] = p if pool_idx is None else pool_idx.gather(1, p[:, None])[:, 0]
        forbid.scatter_(1, p[:, None], True)
    return batch


def draw_cohort_inputs(
    generators: Sequence[Optional[torch.Generator]], n: int, dtype: torch.dtype, device, *,
    batch_size: int, subsample: bool, randomize: bool,
) -> dict:
    """K sessions' random inputs to a stacked ITAL selection, session k's
    from ``generators[k]`` in the order its own selection draws
    (:func:`draw_selection_inputs`): ``subsample_uniforms`` (K, n) and
    ``qmc_shifts`` packed (K, batch_size, batch_size) (:func:`_pack_shifts`),
    each None where it is not drawn."""
    drawn = [draw_selection_inputs(g, n, batch_size, dtype, device, subsample=subsample,
                                   randomize=randomize)
             for g in (generators if subsample or randomize else ())]
    return {"subsample_uniforms": torch.stack([u for u, _ in drawn]) if subsample else None,
            "qmc_shifts": (torch.stack([_pack_shifts(q, batch_size) for _, q in drawn])
                           if randomize else None)}


def _stacked_picks(
    st: StackedGPState,
    params: StrategyParams,
    *,
    batch_size: int,
    n_qmc: int = 128,
    block: int = MI_BLOCK,
    pool_size: int = 0,
    subsample_size: int = 0,
    refine_top: int = 0,
    refine_n_qmc: int = 512,
    subsample_uniforms: Optional[torch.Tensor] = None,
    qmc_shifts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(K, batch_size) ITAL batches of the K sessions of ``st``, from fed
    draws: ``subsample_uniforms`` (K, N) and ``qmc_shifts`` packed
    (K, batch_size, batch_size) (:func:`_pack_shifts` per session).  The
    body of every ITAL selection program."""
    n = st.x.shape[0]
    if pool_size or subsample_size:
        ranking = st.mu if pool_size else subsample_uniforms
        pool_idx, forbid = candidate_pool_indices(st, ranking, min(pool_size or subsample_size, n))
    else:
        pool_idx, forbid = None, labeled_mask(st)
    shifts = None if qmc_shifts is None else [qmc_shifts[:, t, :t] for t in range(batch_size)]
    return _greedy_picks(st, batch_size, params, pool_idx, forbid, n_qmc=n_qmc, block=block,
                         refine_top=refine_top, refine_n_qmc=refine_n_qmc, qmc_shifts=shifts)


@register_cohort_program("ital")
def ital_cohort_program(batch_size: int, options: dict) -> CohortProgram:
    """ITAL's stacked selection with ``options`` (a config's ``[METHOD]``
    section) as a cohort program's body: the subsample uniforms and QMC
    shifts are drawn before the program (:func:`draw_cohort_inputs`) and
    fed to :func:`_stacked_picks` inside it."""
    options = dict(options)
    randomize = bool(options.pop("randomize_qmc", False))
    _check_options(batch_size, options.get("pool_size", 0), options.get("subsample_size", 0),
                   None)
    return CohortProgram(
        static=tuple(sorted(options.items())),
        draw=functools.partial(draw_cohort_inputs, batch_size=batch_size,
                               subsample=bool(options.get("subsample_size")),
                               randomize=randomize),
        picks=functools.partial(_stacked_picks, batch_size=batch_size, **options))


@register_stacked("ital")
def select_ital_stacked(
    states: Sequence[GPState],
    batch_size: int,
    generators: Sequence[Optional[torch.Generator]],
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
    """(K, batch_size) ITAL batches of the K sessions ``states`` (the
    reference's ``jax.vmap(select_ital)``), each the batch
    :func:`select_ital` picks for that session alone.

    Options as :func:`select_ital`.  ``params``: one user model for all
    sessions (0-d fields) or each session's own ((K,) fields,
    :meth:`StrategyParams.stack`): the MI scan then weighs each session's
    candidates with its own feedback table.  Session k draws from
    ``generators[k]`` in the order its own selection draws: its subsample
    uniforms first, then one shift per greedy step.  Fed draws:
    ``subsample_uniforms`` (K, N) and ``qmc_shifts``, one (K, t) shift per
    step t.

    The selection is one program (:func:`ital_tpu_torch.graphs.run`), the
    counterpart of the reference's ``_batched_select``: on the card a graph
    captured once per K, batch size, options, group plan and corpus, which
    stacks the sessions' buffers inside, its draws made first and fed in.
    On the CPU, or in ``graphs.eager()``, the same body runs eagerly.
    """
    _check_options(batch_size, pool_size, subsample_size, qmc_shifts)
    x = states[0].x
    drawn = draw_cohort_inputs(generators, x.shape[0], states[0].mu.dtype, x.device,
                               batch_size=batch_size,
                               subsample=bool(subsample_size) and subsample_uniforms is None,
                               randomize=randomize_qmc and qmc_shifts is None)
    if subsample_size and subsample_uniforms is not None:
        drawn["subsample_uniforms"] = subsample_uniforms
    if qmc_shifts is not None:
        drawn["qmc_shifts"] = _pack_shifts(qmc_shifts, batch_size)
    options = {"batch_size": batch_size, "n_qmc": n_qmc, "block": block,
               "pool_size": pool_size, "subsample_size": subsample_size,
               "refine_top": refine_top, "refine_n_qmc": refine_n_qmc}
    inputs, groups = cohort_program_inputs(states)
    inputs.update(params.program_inputs(), **drawn)
    (batch,) = graphs.run(
        "select_ital_stacked",
        functools.partial(_stacked_select_body, options=options, groups=groups),
        inputs, shared={"x": x}, static=(tuple(options.items()), groups))
    return batch


def _stacked_select_body(x: torch.Tensor, *, options: dict, groups: tuple,
                         subsample_uniforms: Optional[torch.Tensor],
                         qmc_shifts: Optional[torch.Tensor], **inputs) -> tuple[torch.Tensor]:
    """The stacked selection program's body: :func:`_stacked_picks` of the
    stack of the inputs, with its draws fed in."""
    return (_stacked_picks(program_stack(x, inputs, groups), StrategyParams.from_inputs(inputs),
                           **options, subsample_uniforms=subsample_uniforms,
                           qmc_shifts=qmc_shifts),)


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

    The selection is one program (:func:`ital_tpu_torch.graphs.run`), the
    counterpart of the reference's ``_jit_select``: on a CUDA state a graph
    captured once per batch size, options, corpus and shapes and shared by
    every session; the draws are made first and fed in.  On the CPU, or in
    ``graphs.eager()``, the same body runs eagerly.
    """
    _check_options(batch_size, pool_size, subsample_size, qmc_shifts)
    u, shifts = draw_selection_inputs(
        generator, state.x.shape[0], batch_size, state.mu.dtype, state.mu.device,
        subsample=bool(subsample_size) and subsample_uniforms is None,
        randomize=randomize_qmc and qmc_shifts is None)
    if u is not None:
        subsample_uniforms = u
    if shifts is not None:
        qmc_shifts = shifts
    options = {"n_qmc": n_qmc, "block": block, "pool_size": pool_size,
               "subsample_size": subsample_size, "refine_top": refine_top,
               "refine_n_qmc": refine_n_qmc}
    inputs = {
        **program_inputs(state), **params.program_inputs(),
        "subsample_uniforms": subsample_uniforms if subsample_size else None,
        "qmc_shifts": None if qmc_shifts is None else _pack_shifts(qmc_shifts, batch_size),
    }
    (batch,) = graphs.run(
        "select_ital", functools.partial(_select_body, batch_size=batch_size, options=options),
        inputs, shared={"x": state.x}, static=(batch_size, tuple(options.items())))
    return batch


def _pack_shifts(qmc_shifts: Sequence[torch.Tensor], batch_size: int) -> torch.Tensor:
    """(batch_size, batch_size) rows of the greedy steps' shifts, step t's (t,)
    shift in row t's first t columns: one input for a program; from (K, t)
    shifts of K sessions, (K, batch_size, batch_size)."""
    return torch.stack([torch.nn.functional.pad(s, (0, batch_size - s.shape[-1]))
                        for s in qmc_shifts[:batch_size]], dim=-2)


def _select_body(x: torch.Tensor, *, batch_size: int, options: dict,
                 subsample_uniforms: Optional[torch.Tensor],
                 qmc_shifts: Optional[torch.Tensor], **inputs) -> tuple[torch.Tensor]:
    """The selection program's body: :func:`_stacked_picks` of one session
    with its draws fed in."""
    return (_stacked_picks(
        stacked_view(program_state(x, inputs)), StrategyParams.from_inputs(inputs),
        batch_size=batch_size, **options,
        qmc_shifts=None if qmc_shifts is None else qmc_shifts[None],
        subsample_uniforms=None if subsample_uniforms is None else subsample_uniforms[None],
    )[0],)
