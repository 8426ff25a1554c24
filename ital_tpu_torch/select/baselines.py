"""Classical active-learning baseline selectors (port of ``ital_tpu.select.baselines``).

The methods the ITAL paper (arXiv:1809.02337) compares against: random,
top-scoring, variance sampling, uncertainty sampling, border(line) sampling
and its diversity-augmented variant, entropy, EMOC and its batch form,
MCMI[min], SUD, TCAL, RBMAL, AdaptAL and USDM.  Each is registered under the
reference's name as a program (:func:`ital_tpu_torch.select.base.
register_program`): a body that picks the batches of K sessions of a
:class:`~ital_tpu_torch.models.gp.StackedGPState` at once, the reference's
``jax.vmap`` of the strategy, and serves one session as a stack of one.
``params`` fields are 0-d or (K,), one value per session.

The heavy ones (``emoc``, ``emoc_batch``, ``mcmi_min``) stream whole-corpus
(N, block) kernel blocks, one per hyperparameter group and block, shared by
the group's sessions, and the diversity penalties (N, cap) and (N, t)
similarity blocks: on the card these go through the CUDA RBF kernel.

Density-weighted strategies (SUD, TCAL, AdaptAL) read ``state.density``
(:func:`ital_tpu_torch.models.gp.corpus_density`, computed once per corpus
and shared by the stack); without it they take a uniform density.
"""

from __future__ import annotations

import torch

from ital_tpu_torch.models.gp import (
    GPState,
    StackedGPState,
    gp_posterior_cov_blocks,
    gp_updated_whitening_stacked,
    max_sim_stacked,
    stacked_view,
)
from ital_tpu_torch.ops.kernels import blockwise_reduce_abs_kpost_stacked
from ital_tpu_torch.ops.mvn import norm_cdf
from ital_tpu_torch.select.base import greedy_argmax_stacked, per_session, register_program

_EPS = 1e-12


def _phi(z: torch.Tensor) -> torch.Tensor:
    return norm_cdf(z, eps=1e-7)


def _binary_entropy(p: torch.Tensor) -> torch.Tensor:
    return -(p * torch.log(p + _EPS) + (1 - p) * torch.log(1 - p + _EPS))


def _p_relevant(state: GPState | StackedGPState) -> torch.Tensor:
    """P(R=+1) per corpus point: Phi(mu / sigma) under the latent GP."""
    return _phi(state.mu / torch.sqrt(state.sig2))


def _density(state: GPState | StackedGPState) -> torch.Tensor:
    return torch.ones_like(state.mu) if state.density is None else state.density


def _max_sim_to_labeled(st: StackedGPState) -> torch.Tensor:
    """(K, N) max similarity of each point to each session's labeled rows."""
    return max_sim_stacked(st, st.idx, st.active)


def _greedy(st: StackedGPState, batch_size: int, scores: torch.Tensor) -> torch.Tensor:
    """The batch of batch-independent (K, N) scores."""
    return greedy_argmax_stacked(lambda b, t: scores, st, batch_size)


# ---------------------------------------------------------------------------
# Cheap posterior-statistic strategies
# ---------------------------------------------------------------------------


def draw_uniforms(generators, n: int, dtype, device) -> dict:
    """``random``'s draws: each session's (n,) uniforms from its own
    generator, as ``uniforms`` (K, n)."""
    return {"uniforms": torch.stack([torch.rand(n, generator=g, dtype=dtype, device=device)
                                     for g in generators])}


def _random(st, params, *, batch_size, uniforms):
    """Uniform random among unlabeled items (reference ``RandomRetrieval``).

    Draws N uniforms from ``generator`` (on the state's device) and keeps the
    ``batch_size`` unlabeled items of largest draw.
    """
    return _greedy(st, batch_size, uniforms)


def random_from_uniforms(state: GPState, batch_size: int, uniforms: torch.Tensor) -> torch.Tensor:
    """The ``random`` pick from given (N,) uniforms: the unlabeled items of largest draw."""
    return _random(stacked_view(state), None, batch_size=batch_size, uniforms=uniforms[None])[0]


def _topscoring(st, params, *, batch_size):
    """Pure exploitation: highest posterior relevance mean."""
    return _greedy(st, batch_size, st.mu)


def _variance(st, params, *, batch_size):
    """Maximum posterior variance (reference ``VarianceSampling``)."""
    return _greedy(st, batch_size, st.sig2)


def _uncertainty(st, params, *, batch_size):
    """Minimum |mu|/sigma — closest to the boundary in units of uncertainty."""
    return _greedy(st, batch_size, -st.mu.abs() / torch.sqrt(st.sig2))


def _borderline(st, params, *, batch_size):
    """Minimum |mu| — closest to the decision boundary."""
    return _greedy(st, batch_size, -st.mu.abs())


def _entropy(st, params, *, batch_size):
    """Maximum binary entropy of P(R=+1)."""
    return _greedy(st, batch_size, _binary_entropy(_p_relevant(st)))


# ---------------------------------------------------------------------------
# Diversity-augmented strategies (greedy with a similarity penalty)
# ---------------------------------------------------------------------------


def _diversity_greedy(st, batch_size, base_scores, weight):
    """Greedy argmax of ``base - weight * max_sim(candidate, chosen + labeled)``.

    The penalty is the max over the union of the labeled and the already
    chosen items; summing the two maxes would double-penalize candidates
    near both sets.  ``weight``: 0-d or one per session (K,).
    """
    sim_lab = torch.clamp(_max_sim_to_labeled(st), min=0.0)
    weight = per_session(weight)

    def score(batch, t):
        sim = sim_lab
        if t > 0:
            sim = torch.maximum(sim, max_sim_stacked(st, batch[:, :t]))
        return base_scores - weight * sim

    return greedy_argmax_stacked(score, st, batch_size)


def _borderline_diversity(st, params, *, batch_size):
    """Borderline sampling with a redundancy penalty against labeled and chosen items."""
    return _diversity_greedy(st, batch_size, -st.mu.abs(), params.tradeoff)


def _usdm(st, params, *, batch_size):
    """Uncertainty sampling with diversity maximization: uncertainty minus
    max-similarity to the labeled items and the growing batch."""
    unc = -st.mu.abs() / torch.sqrt(st.sig2)
    return _diversity_greedy(st, batch_size, unc, params.tradeoff)


def _rbmal(st, params, *, batch_size):
    """Ranked batch-mode AL (Cardoso et al. 2017):
    score = alpha * (1 - max_sim_to_labeled_or_chosen) + (1 - alpha) * uncertainty,
    with alpha = |U| / (|U| + |L|) recomputed as the batch grows."""
    n = st.x.shape[0]
    dt = st.mu.dtype
    n_lab = st.active.sum(-1)[:, None]  # (K, 1): each session's labels
    unc = 1.0 - torch.tanh(st.mu).abs()  # uncertainty in [0, 1]
    sim_lab = torch.clamp(_max_sim_to_labeled(st), min=0.0)

    def score(batch, t):
        alpha = (n - n_lab - t).to(dt) / n
        sim = sim_lab
        if t > 0:
            sim = torch.maximum(sim, max_sim_stacked(st, batch[:, :t]))
        return alpha * (1.0 - sim) + (1.0 - alpha) * unc

    return greedy_argmax_stacked(score, st, batch_size)


# ---------------------------------------------------------------------------
# Density-weighted strategies
# ---------------------------------------------------------------------------


def _sud(st, params, *, batch_size):
    """Sampling by uncertainty and density: entropy x density."""
    return _greedy(st, batch_size, _binary_entropy(_p_relevant(st)) * _density(st))


def _tcal(st, params, *, batch_size):
    """Density-weighted border sampling with a diversity-greedy batch
    (triple-criteria AL: uncertainty, density, diversity)."""
    base = -st.mu.abs() * _density(st)
    return _diversity_greedy(st, batch_size, base, params.tradeoff)


def _adapt_al(st, params, *, batch_size):
    """Adaptive AL: entropy^beta * density^(1-beta) with ``beta = params.tradeoff``."""
    ent = _binary_entropy(_p_relevant(st))
    beta = per_session(params.tradeoff)
    scores = torch.pow(ent + _EPS, beta) * torch.pow(_density(st) + _EPS, 1.0 - beta)
    return _greedy(st, batch_size, scores)


# ---------------------------------------------------------------------------
# Hypothetical-update strategies (the GP's closed-form update)
# ---------------------------------------------------------------------------


def emoc_scores_from_moments(mu, sig2, noise, colabs):
    """EMOC scores from posterior moments and covariance column-abs-sums.

    EMOC(c) = E_{y ~ P(R_c)} || mu' - mu ||_1
            = [ P(+1) |1 - mu_c| + P(-1) |-1 - mu_c| ] / (sig2_c + noise)
              * sum_x |k_post(x, c)|
    """
    p_pos = _phi(mu / torch.sqrt(sig2))
    exp_change = p_pos * (1.0 - mu).abs() + (1 - p_pos) * (-1.0 - mu).abs()
    return exp_change / (sig2 + noise) * colabs


def _colabs(st: StackedGPState, v: torch.Tensor) -> torch.Tensor:
    """(K, N) column-abs-sums of each session's posterior covariance whose
    whitened rows are ``v`` (K, r, N)."""
    h = st.hyper
    return blockwise_reduce_abs_kpost_stacked(st.x, v, h.length_scale, h.var, st.hyper_groups,
                                              x2=st.x2)


def _emoc(st, params, *, batch_size):
    """Expected model output change (reference ``EMOC``), over the whole corpus."""
    scores = emoc_scores_from_moments(st.mu, st.sig2, per_session(st.hyper.noise),
                                      _colabs(st, st.v))
    return _greedy(st, batch_size, scores)


def _emoc_batch(st, params, *, batch_size):
    """Batch EMOC: greedy expected model output change given the partial batch.

    Each greedy step re-scores every candidate against the posterior as if
    the chosen members were labeled with their most probable labels
    (``sign(mu)``), through the block hypothetical update
    (:func:`~ital_tpu_torch.models.gp.gp_updated_whitening`): ``t`` extra
    rows on ``v``.  At t=0 this is ``emoc``.
    """
    noise = per_session(st.hyper.noise)

    def score(batch, t):
        if t == 0:
            mu_h, sig2_h, v_aug = st.mu, st.sig2, st.v
        else:
            ind = batch[:, :t]
            y_hyp = torch.where(st.mu.gather(1, ind) >= 0.0, 1.0, -1.0)
            g, w = gp_updated_whitening_stacked(st, ind, y_hyp)  # (K, t), (K, t, N)
            mu_h = st.mu + (w.mT @ g[..., None])[..., 0]
            sig2_h = torch.clamp(st.sig2 - (w * w).sum(-2), min=1e-8)
            v_aug = torch.cat([st.v, w], dim=-2)
        return emoc_scores_from_moments(mu_h, sig2_h, noise, _colabs(st, v_aug))

    return greedy_argmax_stacked(score, st, batch_size)


def _mcmi_min(st, params, *, batch_size, block: int = 512):
    """MCMI[min] (Guo & Greiner): pick the candidate whose worst-case label
    most reduces the total label entropy of the corpus.

    score(c) = min_{y in {-1,+1}} [ -sum_x H_b( Phi(mu'_x / sigma'_x) ) ]

    with (mu', sigma') the closed-form one-point hypothetical posterior.  The
    N x N computation streams in blocks of ``block`` candidates: per block
    one (N, block) kernel block per hyperparameter group, which each of its
    sessions turns into its posterior covariance columns, one session after
    another.
    """
    noise = st.hyper.noise
    n = st.x.shape[0]
    scores = torch.empty_like(st.mu)
    for lo in range(0, n, block):
        c = slice(lo, min(lo + block, n))
        for k, k_post in gp_posterior_cov_blocks(st, c):  # (N, block)
            mu, sig2 = st.mu[k], st.sig2[k]
            denom = sig2[c] + noise[k]  # (block,)
            # The variance shrink does not depend on the label.
            sig_new = torch.sqrt(torch.clamp(sig2[:, None] - k_post**2 / denom, min=1e-8))

            def total_entropy(y):
                gain = (y - mu[c]) / denom  # (block,)
                mu_new = mu[:, None] + k_post * gain
                return _binary_entropy(_phi(mu_new / sig_new)).sum(0)

            scores[k, c] = -torch.maximum(total_entropy(1.0), total_entropy(-1.0))
    return _greedy(st, batch_size, scores)


select_random = register_program("random", _random, draw=draw_uniforms, drawn=("uniforms",))
select_topscoring = register_program("topscoring", _topscoring)
select_variance = register_program("variance_sampling", _variance)
select_uncertainty = register_program("uncertainty_sampling", _uncertainty)
select_borderline = register_program("borderline_sampling", _borderline)
select_entropy = register_program("entropy_sampling", _entropy)
select_borderline_diversity = register_program("borderline_diversity_sampling",
                                               _borderline_diversity)
select_usdm = register_program("usdm", _usdm)
select_rbmal = register_program("rbmal", _rbmal)
select_sud = register_program("sud", _sud)
select_tcal = register_program("tcal", _tcal)
select_adapt_al = register_program("adapt_al", _adapt_al)
select_emoc = register_program("emoc", _emoc)
select_emoc_batch = register_program("emoc_batch", _emoc_batch)
select_mcmi_min = register_program("mcmi_min", _mcmi_min)
