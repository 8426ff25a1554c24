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

The ascent is one program (:func:`ital_tpu_torch.graphs.run`), the
counterpart of the reference's jitted ``lax.scan``: on the card its steps,
backward passes included, are one captured CUDA graph, unrolled, replayed
at every call of the same shapes and options.  The Cholesky flags of all
the steps are checked once, after the program has run.
:func:`fit_hyperparams_stacked` ascends K sessions at once (the reference's
``jax.vmap`` of the re-learn in its cohort programs); :func:`relearn` and
:func:`relearn_stacked` are a re-learn followed by the posterior's refit,
the first as one program of its own, the second as a step of a cohort
program's body.

Enable in the harness with ``[GP] learn_every = k`` (re-learn every k feedback
rounds from the labels so far, then refit the posterior).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.gp import GPHyper
from ital_tpu_torch.ops.chol import check_cholesky_info, padded_cholesky_ex, tri_solve
from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_sessions

_LOG2PI = 1.8378770664093453

# Adam's constants, as optax.adam's defaults.
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# The band the log-parameters are clipped to after every step: extreme length
# scales or a vanishing noise make the Cholesky ill-conditioned mid-ascent.
_THETA_MIN, _THETA_MAX = -7.0, 9.0


def _mll(k_ll: torch.Tensor, y: torch.Tensor, active: torch.Tensor,
         noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """log p(y | X, theta) of each labeled set from its kernel block ``k_ll``
    (..., cap, cap), the noise not included, and the Cholesky's unchecked
    ``info``."""
    y = torch.where(active, y, 0.0)
    l, info = padded_cholesky_ex(k_ll.to(y.dtype), active, noise)
    alpha = tri_solve(l, y[..., None])[..., 0]  # L^-1 y
    quad = (alpha * alpha).sum(-1)  # y^T K^-1 y
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.where(active, torch.log(diag), 0.0).sum(-1)
    n = active.sum(-1).to(y.dtype)
    return -0.5 * (quad + logdet + n * _LOG2PI), info


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
    mll, info = _mll(rbf_kernel(xl, xl, hyper.length_scale, hyper.var), y, active, hyper.noise)
    graphs.check_after(info, check_cholesky_info)
    return mll


def _log_theta(h: GPHyper) -> torch.Tensor:
    """(..., 3) float32 log (length_scale, var, noise)."""
    return torch.log(torch.stack([h.length_scale, h.var, h.noise], -1).detach()
                     .to(torch.float32))


def _unpack(theta: torch.Tensor, dtype: torch.dtype) -> GPHyper:
    e = torch.exp(theta).to(dtype)
    return GPHyper(length_scale=e[..., 0], var=e[..., 1], noise=e[..., 2])


def _ascend(theta: torch.Tensor, theta_c: Optional[torch.Tensor],
            neg_mll: Callable[[torch.Tensor], tuple], *, steps: int, lr: float,
            learn_noise: bool, prior_strength: float, noise_floor: float) -> tuple:
    """``steps`` Adam steps (optax's formulas: bias-corrected, b1 0.9, b2
    0.999, eps 1e-8) descending ``neg_mll(theta) -> (objective, info)`` plus
    the prior, from ``theta`` (3,) or (K, 3).  Each step makes a new iterate;
    the bias corrections are host floats.  Returns the last iterate, the
    list of each step's gradient and the first nonzero Cholesky ``info`` of
    the steps (per session; None without steps)."""
    floor = None
    if noise_floor:
        floor = torch.full((), noise_floor, dtype=torch.float32, device=theta.device).log()
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    grads, info = [], None
    for t in range(1, steps + 1):
        th = theta.clone().requires_grad_(True)
        neg, step_info = neg_mll(th)
        if theta_c is not None:
            neg = neg + 0.5 * prior_strength * ((th - theta_c) ** 2).sum()
        (g,) = torch.autograd.grad(neg, th)
        if not learn_noise:
            g = torch.cat([g[..., :2], torch.zeros_like(g[..., 2:])], -1)
        m = (1 - _B1) * g + _B1 * m
        v = (1 - _B2) * g * g + _B2 * v
        m_hat = m / (1 - _B1**t)
        v_hat = v / (1 - _B2**t)
        theta = theta + (-lr) * (m_hat / (torch.sqrt(v_hat) + _EPS))
        theta = torch.clamp(theta, _THETA_MIN, _THETA_MAX)
        if floor is not None:
            theta = torch.cat([theta[..., :2], torch.maximum(theta[..., 2:], floor)], -1)
        grads.append(g)
        info = step_info if info is None else torch.where(info != 0, info, step_info)
    return theta, grads, info


def ascent_options(steps: int, lr: float, learn_noise: bool, prior_strength: float,
                   noise_floor: float) -> tuple:
    """The ascent's options as a hashable tuple of (name, value) pairs, part
    of a program's static signature: the one place they are normalized."""
    return (("steps", int(steps)), ("lr", float(lr)), ("learn_noise", bool(learn_noise)),
            ("prior_strength", float(prior_strength)), ("noise_floor", float(noise_floor)))


def _fit_body(xl, y, active, theta0, theta_c, *, stacked: bool, gradients: bool,
              options: tuple) -> tuple:
    """The ascent as a program's body: the last iterate, and with
    ``gradients`` each step's gradient (steps, *theta0.shape).  ``stacked``:
    K sessions' labeled sets, each its own hyperparameters, so each step
    forms K RBF blocks, one launch each.  Runs under autograd whatever the
    caller's grad mode."""
    dt = y.dtype
    groups = [[k] for k in range(xl.shape[0])] if stacked else None

    def neg_mll(th):
        h = _unpack(th, dt)
        if stacked:
            k_ll = rbf_sessions(xl, xl, h.length_scale, h.var, groups)
        else:
            k_ll = rbf_kernel(xl, xl, h.length_scale, h.var)
        mll, info = _mll(k_ll, y, active, h.noise)
        return -mll.sum(), info

    with torch.enable_grad():
        theta, grads, info = _ascend(theta0, theta_c, neg_mll, **dict(options))
    if info is not None:
        graphs.check_after(info, check_cholesky_info)
    if not gradients:
        return (theta,)
    return theta, torch.stack(grads) if grads else theta.new_zeros((0, *theta.shape))


def _fit_program(xl, y, active, theta0, theta_c, *, stacked: bool, gradients: bool,
                 options: tuple) -> tuple:
    name = "fit_hyperparams_stacked" if stacked else "fit_hyperparams"
    prior = dict(options)["prior_strength"]
    return graphs.run(name, functools.partial(_fit_body, stacked=stacked, gradients=gradients,
                                              options=options),
                      {"xl": xl, "y": y, "active": active, "theta0": theta0,
                       "theta_c": theta_c if prior else None},
                      static=(gradients, options))


def _fit(xl, y, active, hyper0: GPHyper, *, gradients: bool, steps: int, lr: float,
         learn_noise: bool, prior_strength: float, prior_center: Optional[GPHyper],
         noise_floor: float) -> tuple:
    theta0 = _log_theta(hyper0)
    theta_c = None
    if prior_strength:
        theta_c = _log_theta(prior_center if prior_center is not None else hyper0)
    options = ascent_options(steps, lr, learn_noise, prior_strength, noise_floor)
    theta, *grads = _fit_program(xl, y, active, theta0, theta_c, stacked=False,
                                 gradients=gradients, options=options)
    h = _unpack(theta, y.dtype)
    if not learn_noise:
        h.noise = hyper0.noise  # bit-exact pin (exp/log round trips)
    return (h, *grads)


def fit_with_gradients(
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
) -> tuple[GPHyper, torch.Tensor]:
    """:func:`fit_hyperparams` and the gradient of every step, (steps, 3)
    float32 in log-parameter space, which let a replay be held to an eager
    run step by step.  The gradients are an output only here: this is a
    program of its own, beside :func:`fit_hyperparams`' (same body)."""
    return _fit(xl, y, active, hyper0, gradients=True, steps=steps, lr=lr,
                learn_noise=learn_noise, prior_strength=prior_strength,
                prior_center=prior_center, noise_floor=noise_floor)


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
    """Adam ascent of the log marginal likelihood from ``hyper0``, as one
    program (on the card a graph captured once per shape and options).

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

    A labeled block that is not positive definite at any step raises
    ``torch.linalg.LinAlgError`` once the ascent has run.
    """
    return _fit(xl, y, active, hyper0, gradients=False, steps=steps, lr=lr,
                learn_noise=learn_noise, prior_strength=prior_strength,
                prior_center=prior_center, noise_floor=noise_floor)[0]


def fit_hyperparams_stacked(
    xl: torch.Tensor,
    y: torch.Tensor,
    active: torch.Tensor,
    theta0: torch.Tensor,
    *,
    steps: int = 50,
    lr: float = 0.05,
    learn_noise: bool = True,
    prior_strength: float = 0.0,
    theta_c: Optional[torch.Tensor] = None,
    noise_floor: float = 0.0,
) -> torch.Tensor:
    """:func:`fit_hyperparams` of K sessions at once, as one program: the
    counterpart of the reference's ``jax.vmap`` of the re-learn in its
    cohort programs.

    ``xl`` (K, cap, D), ``y`` and ``active`` (K, cap); ``theta0`` (K, 3)
    float32 log (length_scale, var, noise) of each session; ``theta_c`` the
    prior's center in the same terms, (3,) or (K, 3) (default ``theta0``).
    The objective is the sum of the K sessions' objectives, so their
    gradients are independent, and Adam is elementwise: session k follows
    its own :func:`fit_hyperparams` trajectory.  Each step forms K RBF
    blocks, one kernel launch each (the kernel reads one length scale and
    one variance).  Returns the (K, 3) float32 log-parameters.  A block
    that is not positive definite raises once the ascent has run.
    ``learn_noise=False`` keeps each noise's iterate where it starts."""
    if prior_strength and theta_c is None:
        theta_c = theta0
    options = ascent_options(steps, lr, learn_noise, prior_strength, noise_floor)
    (theta,) = _fit_program(xl, y, active, theta0, theta_c, stacked=True, gradients=False,
                            options=options)
    return theta


def _relearn_body(x, *, options: tuple, center, **inputs) -> tuple:
    st = gp_mod.program_state(x, inputs)
    prior = None if center is None else GPHyper(*center.unbind())
    h = fit_hyperparams(st.x[st.idx], st.y, st.active, st.hyper, prior_center=prior,
                        **dict(options))
    st.hyper = h
    gp_mod.gp_refit(st)
    return (torch.stack([h.length_scale, h.var, h.noise]),)


def relearn(
    state: gp_mod.GPState,
    *,
    steps: int = 50,
    lr: float = 0.05,
    learn_noise: bool = True,
    prior_strength: float = 0.0,
    prior_center: Optional[GPHyper] = None,
    noise_floor: float = 0.0,
) -> GPHyper:
    """Re-learn ``state``'s hyperparameters from its labels
    (:func:`fit_hyperparams`) and refit its posterior with them, as one
    program (on the card a graph captured once per capacity, corpus and
    options).  The refit is written into the session's buffers once the
    program and its checks have run, and ``state.hyper`` is replaced by new
    0-d tensors (a session's hyperparameters may be shared with others): a
    block that is not positive definite raises and leaves ``state`` as it
    was.  Returns the new hyperparameters."""
    options = ascent_options(steps, lr, learn_noise, prior_strength, noise_floor)
    center = None
    if prior_strength and prior_center is not None:
        center = torch.stack([prior_center.length_scale, prior_center.var, prior_center.noise])
    (h,) = graphs.run("relearn", functools.partial(_relearn_body, options=options),
                      {**gp_mod.program_inputs(state), "center": center},
                      shared={"x": state.x}, static=options, writes=gp_mod.POSTERIOR_FIELDS)
    hyper = GPHyper(length_scale=h[0], var=h[1], noise=h[2])
    if not learn_noise:
        hyper.noise = state.hyper.noise  # bit-exact pin, as fit_hyperparams'
    state.hyper = hyper
    return hyper


def relearn_stacked(
    st: gp_mod.StackedGPState,
    *,
    center: Optional[torch.Tensor] = None,
    gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    agree: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    steps: int = 50,
    lr: float = 0.05,
    learn_noise: bool = True,
    prior_strength: float = 0.0,
    noise_floor: float = 0.0,
) -> None:
    """:func:`relearn` of K stacked sessions, in place on ``st``: their
    ascents as one (:func:`fit_hyperparams_stacked`) from their own
    labels, then the refit of every posterior with its own hyperparameters
    (:func:`ital_tpu_torch.models.gp.gp_fit_stacked`).  ``st.hyper`` is
    replaced by new (K,) tensors and every session becomes a hyperparameter
    group of its own, decided without reading the values back.  ``center``:
    the prior's (3,) center (length_scale, var, noise), default each
    session's current values.  ``gather`` fetches the labeled rows (a
    mesh's collective gather), ``agree`` maps the (K, 3) learned
    log-parameters to the ones every rank goes on with (a mesh's broadcast
    of rank 0's).  A step of a cohort program's body (the reference's
    ``lax.cond(do_learn, _relearn_hyperparams)`` under ``jax.vmap``);
    raises as :func:`relearn` once the program has run."""
    theta0 = _log_theta(st.hyper)
    theta_c = None if center is None else torch.log(center.detach().to(torch.float32))
    xl = st.x[st.idx] if gather is None else gather(st.idx)
    theta = fit_hyperparams_stacked(xl, st.y, st.active, theta0, steps=steps, lr=lr,
                                    learn_noise=learn_noise, prior_strength=prior_strength,
                                    theta_c=theta_c, noise_floor=noise_floor)
    if agree is not None:
        theta = agree(theta)
    hyper = _unpack(theta, st.mu.dtype)
    if not learn_noise:
        hyper.noise = st.hyper.noise
    st.hyper, st.hyper_groups = hyper, [[k] for k in range(st.k)]
    gp_mod.gp_fit_stacked(st, gather=gather)


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

    def options(self) -> tuple:
        """The ascent's options as a hashable tuple of (name, value) pairs
        (part of a program's static signature)."""
        return ascent_options(self.steps, self.lr, self.learn_noise, self.prior_strength,
                              self.noise_floor)

    def center_of(self, like: torch.Tensor) -> Optional[torch.Tensor]:
        """The prior's center (length_scale, var, noise) as a (3,) tensor in
        ``like``'s dtype and device; None without a prior."""
        if not self.prior_strength:
            return None
        return torch.tensor(self.center, dtype=like.dtype, device=like.device)

    def fit_kwargs(self, like: torch.Tensor) -> Dict[str, Any]:
        """:func:`fit_hyperparams`' options, the prior's center in ``like``'s
        dtype and device."""
        kw: Dict[str, Any] = dict(self.options())
        center = self.center_of(like)
        if center is not None:
            kw["prior_center"] = GPHyper(*center.unbind())
        return kw
