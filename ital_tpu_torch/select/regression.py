"""ITAL for active GP regression (port of ``ital_tpu.select.regression``).

For continuous targets observed through Gaussian noise sn^2, the mutual
information between the latent function at a batch B and its noisy
observations is closed form:

    I(f_B; y_B | A) = 1/2 log det( I + Sigma_B / sn^2 )

Greedy maximization picks, at each step, the candidate with the largest
variance conditional on the batch chosen so far:

    score(c | B) = 1/2 log(1 + (sig2_c - k_cB (Sigma_BB + sn^2 I)^-1 k_Bc) / sn^2)
"""

from __future__ import annotations

import torch

from ital_tpu_torch.models.gp import GPState, gp_posterior_cov_columns, gp_predict_full
from ital_tpu_torch.select.base import StrategyParams, greedy_argmax_batch, register


@register("ital_regression")
def select_ital_regression(
    state: GPState, batch_size: int, generator, params: StrategyParams
) -> torch.Tensor:
    """Greedy batch maximizing I(f_B; y_B | A) = 1/2 log det(I + Sigma_B / sn^2)."""
    noise = state.hyper.noise

    def score(batch, t):
        if t == 0:
            cond_var = state.sig2
        else:
            bsel = batch[:t]
            _, cov_bb = gp_predict_full(state, bsel)
            eye = torch.eye(t, dtype=cov_bb.dtype, device=cov_bb.device)
            cov_bb = cov_bb + (noise + params.jitter) * eye
            cross = gp_posterior_cov_columns(state, bsel)  # (N, t)
            chol = torch.linalg.cholesky(cov_bb)
            w = torch.linalg.solve_triangular(chol, cross.T, upper=False)  # (t, N)
            cond_var = torch.clamp(state.sig2 - (w * w).sum(0), min=1e-10)
        return 0.5 * torch.log1p(cond_var / noise)

    return greedy_argmax_batch(score, state, batch_size)
