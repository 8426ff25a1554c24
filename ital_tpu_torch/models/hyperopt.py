"""GP hyperparameter learning by marginal-likelihood ascent (port of ``ital_tpu.models.hyperopt``).

Online type-II maximum likelihood on a session's own labeled set: the log
marginal likelihood is differentiated through the padded Cholesky with
autograd, and through the RBF block with
:class:`ital_tpu_torch.ops.kernels.RBFHyperGrad` (on the card the block is a
hand-written kernel), and ascended with Adam in log-parameter space, so the
parameters stay positive.  The labeled set is the usual padded (cap,) buffer
with an ``active`` mask: inactive slots are identity-padded, so they add
``log 1 = 0`` to the log-determinant and nothing to the quadratic form.
Cost per call is O(steps * cap^3).

Enable in the harness with ``[GP] learn_every = k`` (re-learn every k feedback
rounds from the labels so far, then refit the posterior).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ital_tpu_torch.models.gp import GPHyper
from ital_tpu_torch.ops.chol import padded_cholesky, tri_solve
from ital_tpu_torch.ops.kernels import rbf_kernel

_LOG2PI = 1.8378770664093453

# Adam's constants, as optax.adam's defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# The band the log-parameters are clipped to after every step: extreme length
# scales or a vanishing noise make the Cholesky ill-conditioned mid-ascent.
_THETA_MIN, _THETA_MAX = -7.0, 9.0


def log_marginal_likelihood(
    xl: torch.Tensor, y: torch.Tensor, active: torch.Tensor, hyper: GPHyper
) -> torch.Tensor:
    """log p(y | X, theta) of the active labeled slots under the RBF GP.

    Args:
      xl: (cap, D) labeled-slot features (padding rows may be anything).
      y: (cap,) labels; ignored on inactive slots.
      active: (cap,) bool participation mask.

    Identity padding makes the padded system block-diagonal with an identity
    block on inactive slots, so ``logdet`` and the quadratic form reduce to
    the active principal block exactly.
    """
    y = torch.where(active, y, 0.0)
    k_ll = rbf_kernel(xl, xl, hyper.length_scale, hyper.var).to(y.dtype)
    l = padded_cholesky(k_ll, active, hyper.noise)
    alpha = tri_solve(l, y[:, None])[:, 0]  # L^-1 y
    quad = (alpha * alpha).sum()  # y^T K^-1 y
    diag = torch.diagonal(l)
    logdet = 2.0 * torch.where(active, torch.log(diag), 0.0).sum()
    n = active.sum().to(y.dtype)
    return -0.5 * (quad + logdet + n * _LOG2PI)


def _log_theta(h: GPHyper) -> torch.Tensor:
    """(3,) float32 log (length_scale, var, noise)."""
    return torch.log(torch.stack([h.length_scale, h.var, h.noise]).detach().to(torch.float32))


def fit_hyperparams(
    xl: torch.Tensor,
    y: torch.Tensor,
    active: torch.Tensor,
    hyper0: GPHyper,
    *,
    steps: int = 50,
    lr: float = 0.05,
    learn_noise: bool = True,
    prior_strength: float = 0.0,
    prior_center: Optional[GPHyper] = None,
    noise_floor: float = 0.0,
) -> GPHyper:
    """Adam ascent of the log marginal likelihood from ``hyper0``.

    Returns new hyperparameters in the labels' dtype.  The iterate
    ``theta = log(ls, var, noise)`` is float32 whatever that dtype, as in the
    reference.  ``learn_noise=False`` zeroes the noise's gradient and returns
    ``hyper0.noise`` itself, bit-exact.

    ``prior_strength > 0`` switches to MAP type-II: independent Gaussian
    priors on the log-parameters, ``0.5 * s * ||theta - theta_c||^2`` added to
    the objective, centered at ``prior_center`` (default ``hyper0``; callers
    that re-learn repeatedly should pass the session's initial values, or the
    anchor wanders with the estimate).  ``noise_floor > 0`` projects the
    noise onto ``log(noise) >= log(noise_floor)`` after every step.  Both
    default off.

    Adam is written out to optax's formulas (bias-corrected, b1 0.9,
    b2 0.999, eps 1e-8), each step making a new iterate.  A labeled block
    that is not positive definite raises from the Cholesky.
    """
    dt, dev = y.dtype, y.device
    theta = _log_theta(hyper0).to(dev)
    theta_c = None
    if prior_strength:
        theta_c = _log_theta(prior_center if prior_center is not None else hyper0).to(dev)
    floor = None
    if noise_floor:
        floor = torch.log(torch.tensor(noise_floor, dtype=torch.float32, device=dev))

    def unpack(th: torch.Tensor) -> GPHyper:
        e = torch.exp(th).to(dt)
        return GPHyper(length_scale=e[0], var=e[1], noise=e[2])

    def neg_obj(th: torch.Tensor) -> torch.Tensor:
        neg = -log_marginal_likelihood(xl, y, active, unpack(th))
        if theta_c is not None:
            neg = neg + 0.5 * prior_strength * ((th - theta_c) ** 2).sum()
        return neg

    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    for t in range(1, steps + 1):
        th = theta.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(neg_obj(th), th)
        if not learn_noise:
            g = torch.cat([g[:2], torch.zeros_like(g[2:])])
        m = (1 - _B1) * g + _B1 * m
        v = (1 - _B2) * g * g + _B2 * v
        m_hat = m / (1 - _B1**t)
        v_hat = v / (1 - _B2**t)
        theta = theta + (-lr) * (m_hat / (torch.sqrt(v_hat) + _EPS))
        theta = torch.clamp(theta, _THETA_MIN, _THETA_MAX)
        if floor is not None:
            theta = torch.cat([theta[:2], torch.maximum(theta[2:], floor)])
    h = unpack(theta)
    if not learn_noise:
        h.noise = hyper0.noise  # bit-exact pin (exp/log round trips)
    return h


@dataclasses.dataclass(frozen=True)
class LearnConfig:
    """Online re-learning in the harness: every ``every`` rounds, ``steps``
    of :func:`fit_hyperparams` at ``lr`` (the ``[GP] learn_*`` keys; the
    reference's ``parallel.sharded.LearnConfig``).

    ``prior_strength`` > 0 is MAP type-II with log-normal priors anchored at
    ``center``, the configuration's initial (length_scale, var, noise), not
    the current iterate, which would let the anchor wander with the
    estimate; ``noise_floor`` bounds the learned noise from below.
    """

    every: int
    steps: int = 50
    lr: float = 0.05
    learn_noise: bool = True
    prior_strength: float = 0.0
    noise_floor: float = 0.0
    center: tuple = ()

    @classmethod
    def from_gp(cls, gp) -> "LearnConfig":
        """The knobs of a ``utils.config.GPConfig``."""
        return cls(gp.learn_every, gp.learn_steps, gp.learn_lr, gp.learn_noise,
                   prior_strength=float(gp.learn_prior_strength),
                   noise_floor=float(gp.learn_noise_floor),
                   center=(gp.length_scale, gp.var, gp.noise))

    def fit_kwargs(self, like: torch.Tensor) -> Dict[str, Any]:
        """:func:`fit_hyperparams`' options, the prior's center in ``like``'s
        dtype and device."""
        kw: Dict[str, Any] = dict(steps=int(self.steps), lr=float(self.lr),
                                  learn_noise=bool(self.learn_noise),
                                  prior_strength=float(self.prior_strength),
                                  noise_floor=float(self.noise_floor))
        if kw["prior_strength"]:
            ls, var, noise = (torch.tensor(v, dtype=like.dtype, device=like.device)
                              for v in self.center)
            kw["prior_center"] = GPHyper(length_scale=ls, var=var, noise=noise)
        return kw
