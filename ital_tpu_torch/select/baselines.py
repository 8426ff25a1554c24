"""Classical active-learning baseline selectors (port of ``ital_tpu.select.baselines``).

The methods the ITAL paper (arXiv:1809.02337) compares against: random,
top-scoring, variance sampling, uncertainty sampling, border(line) sampling
and its diversity-augmented variant, entropy, EMOC and its batch form,
MCMI[min], SUD, TCAL, RBMAL, AdaptAL and USDM.  Each is a function of the GP
posterior registered under the reference's name.

The heavy ones (``emoc``, ``emoc_batch``, ``mcmi_min``) stream whole-corpus
(N, block) kernel blocks, and the diversity penalties (N, cap) and (N, t)
similarity blocks: on the card these go through the CUDA RBF kernel.

Density-weighted strategies (SUD, TCAL, AdaptAL) read ``state.density``
(:func:`ital_tpu_torch.models.gp.corpus_density`, computed once per corpus);
without it they take a uniform density.
"""

from __future__ import annotations

import torch

from ital_tpu_torch.models.gp import GPState, gp_posterior_cov_columns, gp_updated_whitening
from ital_tpu_torch.ops.kernels import blockwise_reduce_abs_kpost, rbf_kernel
from ital_tpu_torch.ops.mvn import norm_cdf
from ital_tpu_torch.select.base import StrategyParams, greedy_argmax_batch, register

_EPS = 1e-12


def _phi(z: torch.Tensor) -> torch.Tensor:
    return norm_cdf(z, eps=1e-7)


def _binary_entropy(p: torch.Tensor) -> torch.Tensor:
    return -(p * torch.log(p + _EPS) + (1 - p) * torch.log(1 - p + _EPS))


def _p_relevant(state: GPState) -> torch.Tensor:
    """P(R=+1) per corpus point: Phi(mu / sigma) under the latent GP."""
    return _phi(state.mu / torch.sqrt(state.sig2))


def _density(state: GPState) -> torch.Tensor:
    return torch.ones_like(state.mu) if state.density is None else state.density


def _max_sim_to(state: GPState, members: torch.Tensor, keep=None) -> torch.Tensor:
    """(N,) max RBF similarity (var 1) of each point to the corpus rows ``members``,
    counting only those where the optional (len(members),) mask ``keep`` holds
    (-inf where none does)."""
    sims = rbf_kernel(state.x, state.x[members], state.hyper.length_scale, 1.0,
                      a2=state.x2)  # (N, len(members))
    if keep is not None:
        sims = torch.where(keep[None, :], sims, -torch.inf)
    return sims.amax(1)


def _max_sim_to_labeled(state: GPState) -> torch.Tensor:
    return _max_sim_to(state, state.idx, state.active)


# ---------------------------------------------------------------------------
# Cheap posterior-statistic strategies
# ---------------------------------------------------------------------------


def random_from_uniforms(state: GPState, batch_size: int, uniforms: torch.Tensor) -> torch.Tensor:
    """The ``random`` pick from given (N,) uniforms: the unlabeled items of largest draw."""
    return greedy_argmax_batch(lambda b, t: uniforms, state, batch_size)


@register("random")
def select_random(state, batch_size, generator, params: StrategyParams):
    """Uniform random among unlabeled items (reference ``RandomRetrieval``).

    Draws N uniforms from ``generator`` (on the state's device) and keeps the
    ``batch_size`` unlabeled items of largest draw.
    """
    n = state.x.shape[0]
    u = torch.rand(n, generator=generator, dtype=state.mu.dtype, device=state.mu.device)
    return random_from_uniforms(state, batch_size, u)


@register("topscoring")
def select_topscoring(state, batch_size, generator, params: StrategyParams):
    """Pure exploitation: highest posterior relevance mean."""
    return greedy_argmax_batch(lambda b, t: state.mu, state, batch_size)


@register("variance_sampling")
def select_variance(state, batch_size, generator, params: StrategyParams):
    """Maximum posterior variance (reference ``VarianceSampling``)."""
    return greedy_argmax_batch(lambda b, t: state.sig2, state, batch_size)


@register("uncertainty_sampling")
def select_uncertainty(state, batch_size, generator, params: StrategyParams):
    """Minimum |mu|/sigma — closest to the boundary in units of uncertainty."""
    scores = -state.mu.abs() / torch.sqrt(state.sig2)
    return greedy_argmax_batch(lambda b, t: scores, state, batch_size)


@register("borderline_sampling")
def select_borderline(state, batch_size, generator, params: StrategyParams):
    """Minimum |mu| — closest to the decision boundary."""
    scores = -state.mu.abs()
    return greedy_argmax_batch(lambda b, t: scores, state, batch_size)


@register("entropy_sampling")
def select_entropy(state, batch_size, generator, params: StrategyParams):
    """Maximum binary entropy of P(R=+1)."""
    scores = _binary_entropy(_p_relevant(state))
    return greedy_argmax_batch(lambda b, t: scores, state, batch_size)


# ---------------------------------------------------------------------------
# Diversity-augmented strategies (greedy with a similarity penalty)
# ---------------------------------------------------------------------------


def _diversity_greedy(state, batch_size, base_scores, weight):
    """Greedy argmax of ``base - weight * max_sim(candidate, chosen + labeled)``.

    The penalty is the max over the union of the labeled and the already
    chosen items; summing the two maxes would double-penalize candidates
    near both sets.
    """
    sim_lab = torch.clamp(_max_sim_to_labeled(state), min=0.0)

    def score(batch, t):
        sim = sim_lab
        if t > 0:
            sim = torch.maximum(sim, _max_sim_to(state, batch[:t]))
        return base_scores - weight * sim

    return greedy_argmax_batch(score, state, batch_size)


@register("borderline_diversity_sampling")
def select_borderline_diversity(state, batch_size, generator, params: StrategyParams):
    """Borderline sampling with a redundancy penalty against labeled and chosen items."""
    return _diversity_greedy(state, batch_size, -state.mu.abs(), params.tradeoff)


@register("usdm")
def select_usdm(state, batch_size, generator, params: StrategyParams):
    """Uncertainty sampling with diversity maximization: uncertainty minus
    max-similarity to the labeled items and the growing batch."""
    unc = -state.mu.abs() / torch.sqrt(state.sig2)
    return _diversity_greedy(state, batch_size, unc, params.tradeoff)


@register("rbmal")
def select_rbmal(state, batch_size, generator, params: StrategyParams):
    """Ranked batch-mode AL (Cardoso et al. 2017):
    score = alpha * (1 - max_sim_to_labeled_or_chosen) + (1 - alpha) * uncertainty,
    with alpha = |U| / (|U| + |L|) recomputed as the batch grows."""
    n = state.x.shape[0]
    dt = state.mu.dtype
    n_lab = state.active.sum()
    unc = 1.0 - torch.tanh(state.mu).abs()  # uncertainty in [0, 1]
    sim_lab = torch.clamp(_max_sim_to_labeled(state), min=0.0)

    def score(batch, t):
        alpha = (n - n_lab - t).to(dt) / n
        sim = sim_lab
        if t > 0:
            sim = torch.maximum(sim, _max_sim_to(state, batch[:t]))
        return alpha * (1.0 - sim) + (1.0 - alpha) * unc

    return greedy_argmax_batch(score, state, batch_size)


# ---------------------------------------------------------------------------
# Density-weighted strategies
# ---------------------------------------------------------------------------


@register("sud")
def select_sud(state, batch_size, generator, params: StrategyParams):
    """Sampling by uncertainty and density: entropy x density."""
    scores = _binary_entropy(_p_relevant(state)) * _density(state)
    return greedy_argmax_batch(lambda b, t: scores, state, batch_size)


@register("tcal")
def select_tcal(state, batch_size, generator, params: StrategyParams):
    """Density-weighted border sampling with a diversity-greedy batch
    (triple-criteria AL: uncertainty, density, diversity)."""
    base = -state.mu.abs() * _density(state)
    return _diversity_greedy(state, batch_size, base, params.tradeoff)


@register("adapt_al")
def select_adapt_al(state, batch_size, generator, params: StrategyParams):
    """Adaptive AL: entropy^beta * density^(1-beta) with ``beta = params.tradeoff``."""
    ent = _binary_entropy(_p_relevant(state))
    beta = params.tradeoff
    scores = torch.pow(ent + _EPS, beta) * torch.pow(_density(state) + _EPS, 1.0 - beta)
    return greedy_argmax_batch(lambda b, t: scores, state, batch_size)


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


def _colabs(state: GPState, v: torch.Tensor) -> torch.Tensor:
    """(N,) column-abs-sums of the posterior covariance whose whitened rows are ``v``."""
    n = state.x.shape[0]
    return blockwise_reduce_abs_kpost(
        state.x, v, torch.arange(n, device=state.x.device),
        state.hyper.length_scale, state.hyper.var, x2=state.x2,
    )


@register("emoc")
def select_emoc(state, batch_size, generator, params: StrategyParams):
    """Expected model output change (reference ``EMOC``), over the whole corpus."""
    scores = emoc_scores_from_moments(state.mu, state.sig2, state.hyper.noise,
                                      _colabs(state, state.v))
    return greedy_argmax_batch(lambda b, t: scores, state, batch_size)


@register("emoc_batch")
def select_emoc_batch(state, batch_size, generator, params: StrategyParams):
    """Batch EMOC: greedy expected model output change given the partial batch.

    Each greedy step re-scores every candidate against the posterior as if
    the chosen members were labeled with their most probable labels
    (``sign(mu)``), through the block hypothetical update
    (:func:`gp_updated_whitening`): ``t`` extra rows on ``v``.  At t=0 this is
    :func:`select_emoc`.
    """
    def score(batch, t):
        if t == 0:
            mu_h, sig2_h, v_aug = state.mu, state.sig2, state.v
        else:
            ind = batch[:t]
            y_hyp = torch.where(state.mu[ind] >= 0.0, 1.0, -1.0)
            g, w = gp_updated_whitening(state, ind, y_hyp)
            mu_h = state.mu + w.T @ g
            sig2_h = torch.clamp(state.sig2 - (w * w).sum(0), min=1e-8)
            v_aug = torch.cat([state.v, w])
        return emoc_scores_from_moments(mu_h, sig2_h, state.hyper.noise, _colabs(state, v_aug))

    return greedy_argmax_batch(score, state, batch_size)


@register("mcmi_min")
def select_mcmi_min(state, batch_size, generator, params: StrategyParams, *, block: int = 512):
    """MCMI[min] (Guo & Greiner): pick the candidate whose worst-case label
    most reduces the total label entropy of the corpus.

    score(c) = min_{y in {-1,+1}} [ -sum_x H_b( Phi(mu'_x / sigma'_x) ) ]

    with (mu', sigma') the closed-form one-point hypothetical posterior.  The
    N x N computation streams in blocks of ``block`` candidates, each one
    (N, block) kernel block.
    """
    noise = state.hyper.noise

    def one_block(cands):
        k_post = gp_posterior_cov_columns(state, cands)  # (N, block)
        denom = state.sig2[cands] + noise  # (block,)
        # The variance shrink does not depend on the label.
        sig_new = torch.sqrt(torch.clamp(state.sig2[:, None] - k_post**2 / denom, min=1e-8))

        def total_entropy(y):
            gain = (y - state.mu[cands]) / denom  # (block,)
            mu_new = state.mu[:, None] + k_post * gain
            return _binary_entropy(_phi(mu_new / sig_new)).sum(0)

        return -torch.maximum(total_entropy(1.0), total_entropy(-1.0))  # min over y

    cand = torch.arange(state.x.shape[0], device=state.x.device)
    scores = torch.cat([one_block(c) for c in cand.split(block)])
    return greedy_argmax_batch(lambda b, t: scores, state, batch_size)
