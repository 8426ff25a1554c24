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

from ital_tpu_torch import graphs
from ital_tpu_torch.models.gp import gp_posterior_cov_columns_stacked
from ital_tpu_torch.ops import chol as chol_ops
from ital_tpu_torch.ops.kernels import rbf_sessions
from ital_tpu_torch.select.base import greedy_argmax_stacked, per_session, register_program


def _ital_regression(st, params, *, batch_size):
    """Greedy batch maximizing I(f_B; y_B | A) = 1/2 log det(I + Sigma_B / sn^2)."""
    h = st.hyper
    noise = per_session(h.noise)

    def score(batch, t):
        if t == 0:
            cond_var = st.sig2
        else:
            bsel = batch[:, :t]
            xs = st.x[bsel]  # (K, t, D)
            vs = st.v.gather(2, bsel[:, None, :].expand(-1, st.cap, -1))  # (K, cap, t)
            eye = torch.eye(t, dtype=st.mu.dtype, device=st.mu.device)
            cov_bb = (rbf_sessions(xs, xs, h.length_scale, h.var, st.hyper_groups) - vs.mT @ vs
                      + per_session(h.noise + params.jitter, 2) * eye)
            cross = gp_posterior_cov_columns_stacked(st, bsel)  # (K, N, t)
            chol, info = torch.linalg.cholesky_ex(cov_bb)
            graphs.check_after(info, chol_ops.check_cholesky_info)
            w = chol_ops.tri_solve(chol, cross.mT)  # (K, t, N)
            cond_var = torch.clamp(st.sig2 - (w * w).sum(-2), min=1e-10)
        return 0.5 * torch.log1p(cond_var / noise)

    return greedy_argmax_stacked(score, st, batch_size)


select_ital_regression = register_program("ital_regression", _ital_regression)
