"""Gaussian-process relevance model over a fixed corpus (port of ``ital_tpu.models.gp``).

An exact GP with an RBF kernel, fit on user labels in {-1, +1} (the query
counts as +1).  The corpus ``x`` (N, D) stays on the device; the labeled set
lives in fixed-capacity padded buffers (``cap`` slots, ``count`` used), and
the state carries the whitened cross-kernel ``v = L^-1 K_l,corpus`` (cap, N)::

    mu      = v^T beta              (beta = L^-1 y)
    sig2    = k(x,x) - sum_r v_r^2
    cov(i,j)= k(x_i,x_j) - v_i . v_j

New labels are absorbed with the incremental block Cholesky append
(:func:`gp_update`), equal to a refit (:func:`gp_fit`) to tolerance.

Where the reference needed pure functions, :func:`gp_set_query` and
:func:`gp_update` write the session-owned buffers (``idx``, ``y``, ``valid``,
``l``, ``beta``, ``v``, ``mu``, ``sig2``) in place.  They never write the
corpus ``x``, its norms ``x2`` or its ``density``: those may be shared by
every session over the same corpus, and :func:`gp_session_copy` gives a new
session its own buffers.  The prediction surface and the hypothetical
updates (:func:`gp_updated_prediction` and its kin) write nothing.

A cohort of K sessions over one corpus is a :class:`StackedGPState`: the
session buffers and hyperparameters gain a leading session axis, the corpus
stays shared, and :func:`gp_update_stacked` absorbs one feedback block per
session in one pass (the reference's ``jax.vmap(gp_update)``), each session
at its own count and with its own hyperparameters.

:func:`gp_fit`, :func:`gp_set_query` and :func:`gp_update` take a ``gather``
hook that fetches corpus rows by global index: the corpus-sharded path
(:mod:`ital_tpu_torch.parallel.sharded`) passes a collective gather, and the
rest of the code, shard-local, is the single-device path's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.ops import chol as chol_ops
from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_sessions


@dataclasses.dataclass
class GPHyper:
    """RBF-GP hyperparameters as 0-d tensors on the state's device."""

    length_scale: torch.Tensor
    var: torch.Tensor  # kernel variance sigma^2
    noise: torch.Tensor  # observation noise added on the labeled diagonal


@dataclasses.dataclass
class GPState:
    """Padded GP posterior state over a corpus.

    Shapes (cap = labeled-slot capacity, N = corpus rows):
      x (N, D) | idx (cap,) int64 | y (cap,) | valid (cap,) bool | count int |
      l (cap, cap) | beta (cap,) | v (cap, N) | mu (N,) | sig2 (N,) |
      density (N,) or None | x2 (N,)

    ``count`` is a host integer; inside a captured program it is a 0-d int64
    tensor on the device (:func:`program_state`).  Slots < ``count`` with
    ``valid == False`` are occupied-but-inert (the user skipped that item).
    ``density`` is the optional corpus information density of the
    density-weighted baselines (:func:`corpus_density`).  ``x2`` caches the
    corpus' squared row norms in f32 (or wider), computed from the stored
    values.
    """

    x: torch.Tensor
    idx: torch.Tensor
    y: torch.Tensor
    valid: torch.Tensor
    count: int
    l: torch.Tensor
    beta: torch.Tensor
    v: torch.Tensor
    mu: torch.Tensor
    sig2: torch.Tensor
    hyper: GPHyper
    density: Optional[torch.Tensor] = None
    x2: Optional[torch.Tensor] = None

    @property
    def active(self) -> torch.Tensor:
        """(cap,) bool — slots that really participate in the posterior."""
        slots = torch.arange(self.cap, device=self.idx.device)
        return (slots < self.count) & self.valid

    @property
    def cap(self) -> int:
        return self.idx.shape[0]


@dataclasses.dataclass
class StackedGPState:
    """K sessions' GP states over one corpus, on a leading session axis.

    Shapes: x (N, D), x2 (N,) and density (N,) or None are the shared
    corpus's | idx, y, valid (K, cap) | l (K, cap, cap) | beta (K, cap) |
    v (K, cap, N) | mu, sig2 (K, N) | hyper: :class:`GPHyper` of (K,) tensors.

    ``counts`` holds the K sessions' host counts; inside a captured program
    it is a (K,) int64 tensor on the device (:func:`program_stack`).
    ``hyper_groups`` lists the sessions in groups of equal length scale and
    variance, decided once from host values (:func:`hyper_groups`): each
    group's RBF blocks take one kernel launch, which reads one length scale
    and one variance.
    """

    x: torch.Tensor
    idx: torch.Tensor
    y: torch.Tensor
    valid: torch.Tensor
    counts: list
    l: torch.Tensor
    beta: torch.Tensor
    v: torch.Tensor
    mu: torch.Tensor
    sig2: torch.Tensor
    hyper: GPHyper
    hyper_groups: list
    density: Optional[torch.Tensor] = None
    x2: Optional[torch.Tensor] = None

    @property
    def active(self) -> torch.Tensor:
        """(K, cap) bool — slots that really participate in each posterior."""
        slots = torch.arange(self.cap, device=self.idx.device)
        if isinstance(self.counts, torch.Tensor):
            return (slots < self.counts[:, None]) & self.valid
        if len(set(self.counts)) == 1:
            return (slots < self.counts[0]) & self.valid
        return (slots < chol_ops.slot_rows(self.counts, 1, self.idx.device)) & self.valid

    @property
    def cap(self) -> int:
        return self.idx.shape[1]

    @property
    def k(self) -> int:
        return self.idx.shape[0]


SESSION_FIELDS = ("idx", "y", "valid", "l", "beta", "v", "mu", "sig2")
# The fields a refit replaces: the factor and the whitened posterior.
POSTERIOR_FIELDS = ("l", "beta", "v", "mu", "sig2")
_HYPER = ("length_scale", "var", "noise")


def program_inputs(state: GPState) -> dict:
    """``state`` as a program's inputs (:func:`ital_tpu_torch.graphs.run`):
    its host count, which a graph takes as a 0-d device tensor, the session
    buffers, the hyperparameters and the corpus norms.  The corpus and its
    density are shared by the sessions and go in by address
    (:func:`program_shared`)."""
    return {"count": state.count, **{f: getattr(state, f) for f in SESSION_FIELDS},
            **{f: getattr(state.hyper, f) for f in _HYPER}, "x2": state.x2}


def program_shared(state: GPState) -> dict:
    """The tensors of ``state`` a program reads where they are, keyed by
    their address (``graphs.run``'s ``shared``): the corpus and, where the
    state carries one, its density."""
    return {"x": state.x, **({} if state.density is None else {"density": state.density})}


def program_state(x: torch.Tensor, inputs: dict,
                  density: Optional[torch.Tensor] = None) -> GPState:
    """The state a program's body works on: corpus ``x``, its ``density``
    and the fields of :func:`program_inputs` from ``inputs``, its count a
    0-d device tensor."""
    return GPState(x=x, count=inputs["count"], x2=inputs["x2"], density=density,
                   hyper=GPHyper(**{f: inputs[f] for f in _HYPER}),
                   **{f: inputs[f] for f in SESSION_FIELDS})


def cohort_program_inputs(states: Sequence[GPState], groups: Optional[list] = None
                          ) -> tuple[dict, tuple]:
    """K sessions' own states as a program's inputs, and their group plan (a
    tuple of tuples, part of the program's static signature).

    Each session's buffers go in as they are, and the program stacks them
    inside (:func:`ital_tpu_torch.graphs.run`'s list inputs, the reference's
    ``_stack_gpstates`` inside its jit), so no stack is made outside it.
    The counts go in as a (K,) int64 device tensor, the hyperparameters as
    (K,) tensors.  ``groups``: the plan where the caller knows it, else read
    from the hyperparameters on the host here (:func:`hyper_groups`), before
    the program runs."""
    states = list(states)
    hyper = _stacked_hyper(states)
    if groups is None:
        groups = hyper_groups(hyper)
    counts = chol_ops.host_index([s.count for s in states], hyper.length_scale.device)
    return ({"counts": counts, **{f: [getattr(s, f) for s in states] for f in SESSION_FIELDS},
             **{f: getattr(hyper, f) for f in _HYPER}, "x2": states[0].x2},
            tuple(tuple(g) for g in groups))


def program_stack(x: torch.Tensor, inputs: dict, groups: tuple,
                  density: Optional[torch.Tensor] = None) -> StackedGPState:
    """The stack a cohort program's body works on: corpus ``x``, its
    ``density`` and the fields of :func:`cohort_program_inputs` from
    ``inputs``, its counts a (K,) device tensor and ``groups`` its group
    plan."""
    return StackedGPState(x=x, counts=inputs["counts"], x2=inputs["x2"], density=density,
                          hyper=GPHyper(**{f: inputs[f] for f in _HYPER}),
                          hyper_groups=[list(g) for g in groups],
                          **{f: inputs[f] for f in SESSION_FIELDS})


def _stacked_hyper(states: Sequence[GPState]) -> GPHyper:
    """The K sessions' hyperparameters as (K,) tensors."""
    return GPHyper(**{f: torch.stack([getattr(s.hyper, f) for s in states]) for f in _HYPER})


def hyper_groups(hyper: GPHyper) -> list:
    """Session indices grouped by equal (length scale, variance), in order of
    first appearance, from (K,) hyperparameters: one read to the host."""
    if hyper.length_scale.shape[0] == 1:
        return [[0]]
    groups: dict = {}
    for k, key in enumerate(zip(*torch.stack([hyper.length_scale, hyper.var]).tolist())):
        groups.setdefault(key, []).append(k)
    return list(groups.values())


def hyper_group_order(states: Sequence[GPState]) -> list:
    """An order of K sessions that puts those of equal length scale and
    variance together, the larger groups first (ties in order of first
    appearance): stacked in it, a cohort's group plan depends only on its
    group sizes, so cohorts of any order replay one program per partition of
    K.  One read to the host."""
    groups = hyper_groups(_stacked_hyper(states))
    return [k for g in sorted(groups, key=len, reverse=True) for k in g]


def stack_states(states) -> StackedGPState:
    """A copy of K same-corpus session states on a leading session axis
    (the reference's ``stack_session_states``).

    The corpus (``x``, ``x2``) is the first session's, shared; the density
    too, which the caller has checked the group shares.  Nothing written to
    the stack reaches the sessions until :func:`unstack_into`.
    """
    sts = list(states)
    hyper = _stacked_hyper(sts)
    return StackedGPState(
        x=sts[0].x, counts=[s.count for s in sts], hyper=hyper,
        hyper_groups=hyper_groups(hyper), density=sts[0].density, x2=sts[0].x2,
        **{f: torch.stack([getattr(s, f) for s in sts]) for f in SESSION_FIELDS},
    )


def stacked_view(state: GPState) -> StackedGPState:
    """One session as a stack of one, on views of its own buffers: what a
    stacked function writes lands in the session (its count excepted)."""
    return StackedGPState(
        x=state.x, counts=[state.count], hyper_groups=[[0]], density=state.density,
        x2=state.x2,
        hyper=GPHyper(**{f: getattr(state.hyper, f).reshape(1) for f in _HYPER}),
        **{f: getattr(state, f)[None] for f in SESSION_FIELDS},
    )


def session_state(st: StackedGPState, k: int) -> GPState:
    """Session ``k`` of a stack as a :class:`GPState` on views of the stack."""
    return GPState(
        x=st.x, count=st.counts[k], density=st.density, x2=st.x2,
        hyper=GPHyper(**{f: getattr(st.hyper, f)[k] for f in _HYPER}),
        **{f: getattr(st, f)[k] for f in SESSION_FIELDS},
    )


def unstack_into(st: StackedGPState, states) -> None:
    """Write each session of ``st`` back into the buffers of ``states``, in
    place (the hyperparameters and the corpus are not written)."""
    for k, s in enumerate(states):
        for f in SESSION_FIELDS:
            getattr(s, f).copy_(getattr(st, f)[k])
        s.count = st.counts[k]


def refit_stacked(st: StackedGPState, refit: Callable[[GPState], GPState]) -> None:
    """Replace each session of ``st`` by ``refit`` of it (a re-learn of its
    hyperparameters and a refit of its posterior), in place.  The stack's
    hyperparameters are replaced, not written, since a session's may be
    shared with others, and each session becomes a group of its own, decided
    without reading the values back."""
    hyper = {f: getattr(st.hyper, f).clone() for f in _HYPER}
    for k in range(st.k):
        fitted = refit(session_state(st, k))
        for f in POSTERIOR_FIELDS:
            getattr(st, f)[k].copy_(getattr(fitted, f))
        for f in hyper:
            hyper[f][k] = getattr(fitted.hyper, f)
    st.hyper = GPHyper(**hyper)
    st.hyper_groups = [[k] for k in range(st.k)]


def _state_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def gp_init(
    x: torch.Tensor,
    length_scale: float,
    var: float,
    noise: float,
    cap: int,
    *,
    corpus_dtype: Optional[str] = None,
) -> GPState:
    """Fresh GP over corpus ``x`` (on its device) with an empty labeled set.

    ``corpus_dtype`` (e.g. ``"bfloat16"``) stores the corpus in a narrower
    dtype while the posterior buffers keep at least f32.  ``x2`` is computed
    in f32 from the stored values, so self-distances stay exactly zero.
    """
    n = x.shape[0]
    dev = x.device
    dt = _state_dtype(x)
    if corpus_dtype:
        x = x.to(getattr(torch, corpus_dtype))
    xf = x.to(_state_dtype(x))
    hyper = GPHyper(
        length_scale=torch.tensor(length_scale, dtype=dt, device=dev),
        var=torch.tensor(var, dtype=dt, device=dev),
        noise=torch.tensor(noise, dtype=dt, device=dev),
    )
    return GPState(
        x=x,
        idx=torch.zeros(cap, dtype=torch.int64, device=dev),
        y=torch.zeros(cap, dtype=dt, device=dev),
        valid=torch.zeros(cap, dtype=torch.bool, device=dev),
        count=0,
        l=torch.eye(cap, dtype=dt, device=dev),
        beta=torch.zeros(cap, dtype=dt, device=dev),
        v=torch.zeros((cap, n), dtype=dt, device=dev),
        mu=torch.zeros(n, dtype=dt, device=dev),
        sig2=torch.full((n,), float(var), dtype=dt, device=dev),
        hyper=hyper,
        x2=(xf * xf).sum(-1),
    )


def gp_session_copy(state: GPState, device=None) -> GPState:
    """``state`` with its own session buffers; the corpus stays shared.

    :func:`gp_set_query` and :func:`gp_update` write the session buffers in
    place, so each session started from one template state takes a copy
    first, and a snapshot copies them to the host (``device="cpu"``) before
    another update can write them.  ``x``, ``x2``, ``density`` and ``hyper``
    are not copied: nothing writes them in place.
    """
    return dataclasses.replace(
        state, **{f: getattr(state, f).to(device or getattr(state, f).device, copy=True)
                  for f in SESSION_FIELDS}
    )


# Corpus rows by global index: (k,) int64 -> (k, D).
GatherFn = Callable[[torch.Tensor], torch.Tensor]


def _rows(state, idx: torch.Tensor, gather: Optional[GatherFn]) -> torch.Tensor:
    return state.x[idx] if gather is None else gather(idx)


def gp_fit(state: GPState, *, gather: Optional[GatherFn] = None) -> GPState:
    """Refit the posterior from the label buffers (from-scratch Cholesky).

    Replaces ``l``, ``beta``, ``v``, ``mu`` and ``sig2`` of ``state`` with
    fresh tensors and returns it.  ``gather`` fetches the labeled rows (the
    sharded path's collective gather); everything else is local.
    """
    h = state.hyper
    active = state.active
    xl = _rows(state, state.idx, gather)  # (cap, D)

    k_ll = rbf_kernel(xl, xl, h.length_scale, h.var)
    l = chol_ops.padded_cholesky(k_ll, active, h.noise)

    k_l_all = rbf_kernel(xl, state.x, h.length_scale, h.var, b2=state.x2)
    k_l_all = torch.where(active[:, None], k_l_all, 0.0)
    v = chol_ops.tri_solve(l, k_l_all)
    beta = chol_ops.tri_solve(l, torch.where(active, state.y, 0.0)[:, None])[:, 0]

    state.l = l
    state.beta = beta
    state.v = v
    state.mu = v.T @ beta
    state.sig2 = torch.clamp(h.var - (v * v).sum(0), min=1e-8)
    return state


def gp_refit(state: GPState, *, gather: Optional[GatherFn] = None) -> GPState:
    """:func:`gp_fit` into the session's own buffers: ``l``, ``beta``, ``v``,
    ``mu`` and ``sig2`` are written in place, each in its layout, as a
    program's body writes them (its writes are copied back once its checks
    have passed).  Returns ``state``."""
    fitted = gp_fit(dataclasses.replace(state), gather=gather)
    for f in POSTERIOR_FIELDS:
        getattr(state, f).copy_(getattr(fitted, f))
    return state


def gp_fit_stacked(st: StackedGPState) -> StackedGPState:
    """:func:`gp_refit` of K sessions at once, each with its own
    hyperparameters, in place on ``st`` (the reference's ``jax.vmap`` of
    ``gp_fit``): the RBF blocks through
    :func:`~ital_tpu_torch.ops.kernels.rbf_sessions` (one launch per
    hyperparameter group and block), one batched Cholesky and batched
    triangular solves.  A labeled block that is not positive definite
    raises before anything is written or, inside a program's capture, once
    the program has run.  Returns ``st``."""
    h, groups = st.hyper, st.hyper_groups
    active = st.active
    xl = st.x[st.idx]  # (K, cap, D)
    k_ll = rbf_sessions(xl, xl, h.length_scale, h.var, groups)
    l = chol_ops.padded_cholesky(k_ll, active, h.noise)
    k_l_all = rbf_sessions(xl, st.x, h.length_scale, h.var, groups, b2=st.x2)  # (K, cap, N)
    k_l_all = torch.where(active[..., None], k_l_all, 0.0)
    v = chol_ops.tri_solve(l, k_l_all)
    beta = chol_ops.tri_solve(l, torch.where(active, st.y, 0.0)[..., None])[..., 0]
    st.l.copy_(l)
    st.beta.copy_(beta)
    st.v.copy_(v)
    st.mu.copy_((v.mT @ beta[..., None])[..., 0])
    st.sig2.copy_(torch.clamp(h.var[:, None] - (v * v).sum(-2), min=1e-8))
    return st


def gp_set_query(state: GPState, query_idx: int, *,
                 gather: Optional[GatherFn] = None) -> GPState:
    """Reset the session to a single positive label at the query image, and refit."""
    state.idx.zero_()
    state.idx[0] = int(query_idx)
    state.y.zero_()
    state.y[0] = 1.0
    state.valid.zero_()
    state.valid[0] = True
    state.count = 1
    return gp_fit(state, gather=gather)


def check_capacity(counts, b: int, cap: int) -> None:
    """Raise ``ValueError`` where a block of ``b`` slots overflows one of the
    host ``counts`` at capacity ``cap``."""
    for c in counts:
        if c + b > cap:
            raise ValueError(f"labeled-slot capacity exceeded: {c} used + {b} new > cap={cap}")


def gp_update(
    state: GPState,
    new_idx: torch.Tensor,
    new_y: torch.Tensor,
    new_valid: torch.Tensor,
    *,
    gather: Optional[GatherFn] = None,
) -> GPState:
    """Absorb a feedback block of ``b`` slots with an incremental Cholesky append.

    O(b * cap * N) instead of a refit; equal to appending to the buffers and
    calling :func:`gp_fit` (tested to tolerance).  Writes the session-owned
    buffers of ``state`` in place and returns it.  The same steps as
    :func:`gp_update_stacked` on one session, without a stack around it.
    Where ``state.count`` is a 0-d device tensor (a captured program's
    state) the slots are written by index and nothing is read to the host:
    the caller checks the capacity, and a block that is not positive
    definite raises once the program has run.

    Args:
      new_idx: (b,) corpus indices shown to the user this round.
      new_y: (b,) labels in {-1, +1} (ignored where ``new_valid`` is False).
      new_valid: (b,) bool — False where the user skipped the item.
      gather: fetches the labeled and the new rows (see :func:`gp_fit`).

    Raises ``ValueError`` when ``count + b > cap``.
    """
    h = state.hyper
    b = new_idx.shape[0]
    c = state.count
    if isinstance(c, int):
        check_capacity([c], b, state.cap)
    active_old = state.active
    new_idx = new_idx.to(torch.int64)
    new_valid = new_valid.to(torch.bool)
    new_y = torch.where(new_valid, new_y.to(state.mu.dtype), 0.0)

    xl = _rows(state, state.idx, gather)  # (cap, D) current slots
    xb = _rows(state, new_idx, gather)  # (b, D)
    k_lb = torch.where(active_old[:, None], rbf_kernel(xl, xb, h.length_scale, h.var), 0.0)
    k_bb = rbf_kernel(xb, xb, h.length_scale, h.var)
    _, s, l_b = chol_ops.chol_append_block(state.l, k_lb, k_bb, c, new_valid, h.noise)

    # Extend the whitened quantities by the same block.
    k_b_all = rbf_kernel(xb, state.x, h.length_scale, h.var, b2=state.x2)  # (b, N)
    k_b_all = torch.where(new_valid[:, None], k_b_all, 0.0)
    v_b = chol_ops.tri_solve(l_b, k_b_all - s.T @ state.v)  # (b, N)
    beta_b = chol_ops.tri_solve(l_b, new_y[:, None] - s.T @ state.beta[:, None])[:, 0]

    for buf, vals in ((state.v, v_b), (state.beta, beta_b), (state.idx, new_idx),
                      (state.y, new_y), (state.valid, new_valid)):
        chol_ops.write_rows(buf, c, vals)
    state.mu += (v_b.T @ beta_b[:, None])[:, 0]
    state.sig2.sub_((v_b * v_b).sum(0)).clamp_(min=1e-8)
    state.count = c + b
    return state


def gp_update_stacked(
    st: StackedGPState,
    new_idx: torch.Tensor,
    new_y: torch.Tensor,
    new_valid: torch.Tensor,
    *,
    gather: Optional[GatherFn] = None,
) -> StackedGPState:
    """:func:`gp_update` of K sessions at once, each at its own count and with
    its own hyperparameters; writes ``st`` in place and returns it.

    ``new_idx``, ``new_y``, ``new_valid``: (K, b), one feedback block per
    session.  The RBF blocks take one kernel launch per group of sessions
    with equal hyperparameters (:func:`ital_tpu_torch.ops.kernels.rbf_sessions`),
    the algebra one batched call per step.  ``gather`` fetches the labeled
    and the new rows of every session in one call, (K, cap + b) indices to
    (K, cap + b, D) rows (the sharded path's collective gather).  Raises
    ``ValueError``, before anything is written, when a session's
    ``count + b > cap``.  Where ``st.counts`` is a (K,) device tensor (a
    captured program's stack) nothing is read to the host: the caller
    checks the capacity, and a block that is not positive definite raises
    once the program has run.
    """
    h = st.hyper
    dt = st.mu.dtype
    b = new_idx.shape[-1]
    on_device = isinstance(st.counts, torch.Tensor)
    if not on_device:
        check_capacity(st.counts, b, st.cap)
    active_old = st.active
    new_idx = new_idx.to(torch.int64)
    new_valid = new_valid.to(torch.bool)
    new_y = torch.where(new_valid, new_y.to(dt), 0.0)

    # (K, cap, D) current slots and (K, b, D) new rows, fetched together.
    xl, xb = _rows(st, torch.cat([st.idx, new_idx], -1), gather).split([st.cap, b], dim=-2)
    groups = st.hyper_groups
    k_lb = rbf_sessions(xl, xb, h.length_scale, h.var, groups)
    k_lb = torch.where(active_old[..., None], k_lb, 0.0)
    k_bb = rbf_sessions(xb, xb, h.length_scale, h.var, groups)
    _, s, l_b = chol_ops.chol_append_block(st.l, k_lb, k_bb, st.counts, new_valid, h.noise)

    # Extend the whitened quantities by the same block.
    k_b_all = rbf_sessions(xb, st.x, h.length_scale, h.var, groups, b2=st.x2)  # (K, b, N)
    k_b_all = torch.where(new_valid[..., None], k_b_all, 0.0)
    v_b = chol_ops.tri_solve(l_b, k_b_all - s.mT @ st.v)  # (K, b, N)
    beta_b = chol_ops.tri_solve(l_b, new_y[..., None] - s.mT @ st.beta[..., None])[..., 0]

    for buf, vals in ((st.v, v_b), (st.beta, beta_b), (st.idx, new_idx), (st.y, new_y),
                      (st.valid, new_valid)):
        chol_ops.write_slots(buf, st.counts, vals)
    st.mu += (v_b.mT @ beta_b[..., None])[..., 0]
    st.sig2.sub_((v_b * v_b).sum(-2)).clamp_(min=1e-8)
    st.counts = st.counts + b if on_device else [c + b for c in st.counts]
    return st


def _update_stacked_body(x, *, groups, new_idx, new_y, new_valid, **inputs) -> tuple:
    gp_update_stacked(program_stack(x, inputs, groups), new_idx, new_y, new_valid)
    return ()


def update_stacked(states: Sequence[GPState], new_idx: torch.Tensor, new_y: torch.Tensor,
                   new_valid: torch.Tensor) -> None:
    """:func:`gp_update_stacked` of K sessions as one program (the
    reference's jitted cohort update, ``ital_tpu/serve.py::_cohort_update``):
    on the card a graph captured once per K, block width, capacity, group
    plan and corpus.  The program stacks the sessions' own buffers inside;
    what it writes is copied back into them once the program and its checks
    have run, so a block that is not positive definite raises and leaves
    every session as it was.  Raises ``ValueError`` before anything runs
    when a session's ``count + b > cap``.  ``new_*`` (K, b) lie on the
    sessions' device."""
    b = new_idx.shape[-1]
    check_capacity([s.count for s in states], b, states[0].cap)
    inputs, groups = cohort_program_inputs(states)
    graphs.run("gp_update_stacked", functools.partial(_update_stacked_body, groups=groups),
               {**inputs, "new_idx": new_idx, "new_y": new_y, "new_valid": new_valid},
               shared={"x": states[0].x}, static=(groups,), writes=SESSION_FIELDS)
    for s in states:
        s.count += b


def gp_predict_full(state: GPState, ind: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and full covariance over the subset ``ind`` (k,)."""
    xi = state.x[ind]
    k_ii = rbf_kernel(xi, xi, state.hyper.length_scale, state.hyper.var)
    vi = state.v[:, ind]
    return state.mu[ind], k_ii - vi.T @ vi


def gp_posterior_cov_columns(state: GPState, ind: torch.Tensor) -> torch.Tensor:
    """Posterior covariance between every corpus point and each of ``ind`` (N, k)."""
    xi = state.x[ind]
    k_cross = rbf_kernel(state.x, xi, state.hyper.length_scale, state.hyper.var,
                         a2=state.x2)
    return k_cross - state.v.T @ state.v[:, ind]


def gp_posterior_cov_columns_stacked(st: StackedGPState, ind: torch.Tensor) -> torch.Tensor:
    """:func:`gp_posterior_cov_columns` of each session of ``st``: (K, N, k)
    for its own corpus indices ``ind`` (K, k), the RBF columns one
    :func:`~ital_tpu_torch.ops.kernels.rbf_sessions` call per
    hyperparameter group."""
    h = st.hyper
    k_cross = rbf_sessions(st.x, st.x[ind], h.length_scale, h.var, st.hyper_groups, a2=st.x2)
    return k_cross - st.v.mT @ st.v.gather(2, ind[:, None, :].expand(-1, st.cap, -1))


def gp_posterior_cov_blocks(st: StackedGPState, cols: slice):
    """Each session's posterior covariance between every corpus point and
    the corpus columns ``cols``, as ``(k, (N, cols) block)`` pairs, one
    session after another: each hyperparameter group forms one RBF block,
    which its sessions share, and each subtracts its own ``v^T v[:, cols]``
    from it.  A generator, so that one session's block is held at a time."""
    h = st.hyper
    for group in st.hyper_groups:
        k_cross = rbf_kernel(st.x, st.x[cols], h.length_scale[group[0]], h.var[group[0]],
                             a2=st.x2)
        for k in group:
            yield k, k_cross - st.v[k].T @ st.v[k][:, cols]


def max_sim_stacked(st: StackedGPState, members: torch.Tensor,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K, N) max RBF similarity (var 1) of each corpus point to each
    session's own corpus rows ``members`` (K, m), counting only those where
    ``keep`` (K, m) holds (-inf where none does): a (K, m, D) gather and one
    :func:`~ital_tpu_torch.ops.kernels.rbf_sessions` call per
    hyperparameter group."""
    h = st.hyper
    sims = rbf_sessions(st.x, st.x[members], h.length_scale, torch.ones_like(h.var),
                        st.hyper_groups, a2=st.x2)  # (K, N, m)
    if keep is not None:
        sims = torch.where(keep[:, None, :], sims, -torch.inf)
    return sims.amax(-1)


def gp_predict_mean(state: GPState, ind: torch.Tensor) -> torch.Tensor:
    """Posterior mean at corpus indices ``ind``."""
    return state.mu[ind]


def gp_predict_diag(state: GPState, ind: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and marginal variance at ``ind``."""
    return state.mu[ind], state.sig2[ind]


def corpus_density(state: GPState, *, block_rows: int = 2048) -> torch.Tensor:
    """(N,) information density: mean RBF similarity (var 1) of each point to the corpus.

    Depends only on the features: compute it once per corpus and attach it
    as ``state.density``.  Streams over blocks of ``block_rows`` rows, so the
    N x N similarity is never held at once; the cached norms ``x2`` ride along.
    """
    x = state.x
    x2 = state.x2
    if x2 is None:
        xf = x.to(_state_dtype(x))
        x2 = (xf * xf).sum(-1)
    ls = state.hyper.length_scale
    return torch.cat([
        rbf_kernel(blk, x, ls, 1.0, a2=blk2, b2=x2).mean(1)
        for blk, blk2 in zip(x.split(block_rows), x2.split(block_rows))
    ])


def gp_updated_whitening(
    state: GPState,
    ind: torch.Tensor,
    y_hyp: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whitened form of the k-point block hypothetical update; writes nothing.

    Labelling ``(ind, y_hyp)`` with the GP's noise adds k rows to ``v``::

        A  = K_post(ind, ind) + noise * I = La La^T        (k, k)
        w  = La^-1 K_post(ind, corpus)                      (k, N)
        g  = La^-1 (y_hyp - mu[ind])                        (k,)
        mu'   = mu   + w^T g
        sig2' = sig2 - sum_r w_r^2
        v_aug = cat([v, w])

    ``valid``: optional (k,) bool; False rows get a zero ``w`` row and no
    mean shift, as skipped items in :func:`gp_update`.  Returns ``(g, w)``.
    """
    h = state.hyper
    _, cov = gp_predict_full(state, ind)  # (k, k) posterior block
    cross = gp_posterior_cov_columns(state, ind).T  # (k, N)
    resid = y_hyp.to(state.mu.dtype) - state.mu[ind]
    if valid is None:
        valid = torch.ones(ind.shape[0], dtype=torch.bool, device=ind.device)
    cross = torch.where(valid[:, None], cross, 0.0)
    resid = torch.where(valid, resid, 0.0)
    la = chol_ops.padded_cholesky(cov, valid, h.noise)
    w = chol_ops.tri_solve(la, cross)
    g = chol_ops.tri_solve(la, resid[:, None])[:, 0]
    return g, w


def gp_updated_whitening_stacked(st: StackedGPState, ind: torch.Tensor,
                                 y_hyp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gp_updated_whitening` of each session of ``st`` with its own
    block ``ind``, ``y_hyp`` (K, k), one session after another; writes
    nothing.  Returns ``(g (K, k), w (K, k, N))``."""
    gs, ws = zip(*(gp_updated_whitening(session_state(st, k), ind[k], y_hyp[k])
                   for k in range(st.k)))
    return torch.stack(gs), torch.stack(ws)


def gp_updated_prediction(
    state: GPState,
    ind: torch.Tensor,
    y_hyp: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Corpus-wide ``(mu', sig2')`` if the block ``(ind, y_hyp)`` were labeled.

    Closed form against the whitened state; equals :func:`gp_update` of the
    same block to tolerance, and writes nothing.
    """
    g, w = gp_updated_whitening(state, ind, y_hyp, valid)
    mu = state.mu + w.T @ g
    sig2 = torch.clamp(state.sig2 - (w * w).sum(0), min=1e-8)
    return mu, sig2


def gp_updated_mean_delta(
    state: GPState, cand: torch.Tensor | int, y_hyp: torch.Tensor | float
) -> torch.Tensor:
    """(N,) change of the posterior mean if the one point ``cand`` were labeled ``y_hyp``.

    ``delta_mu(x) = k_post(x, c) * (y - mu_c) / (sig2_c + noise)``; writes nothing.
    """
    cand = torch.as_tensor(cand, device=state.mu.device).reshape(1)
    kcol = gp_posterior_cov_columns(state, cand)[:, 0]
    gain = (y_hyp - state.mu[cand]) / (state.sig2[cand] + state.hyper.noise)
    return kcol * gain


# ---------------------------------------------------------------------------
# Exchange with NumPy: the reference's GPState leaves, by field name.
# ---------------------------------------------------------------------------

_TENSOR_FIELDS = ("x", "idx", "y", "valid", "l", "beta", "v", "mu", "sig2")
_HYPER_FIELDS = ("length_scale", "var", "noise")
_OPTIONAL_FIELDS = ("density", "x2")


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_arrays(arrays: dict, device) -> GPState:
    """A port state from NumPy arrays keyed by the reference's field names.

    Keys: ``x``, ``idx``, ``y``, ``valid``, ``count``, ``l``, ``beta``, ``v``,
    ``mu``, ``sig2``, ``length_scale``, ``var``, ``noise`` and, optionally,
    ``density`` and ``x2``.  A JAX ``GPState``'s leaves (``np.asarray`` of
    each, with the hyperparameters flattened) fit as they are, bfloat16
    corpora included.
    """
    t = {f: _to_tensor(arrays[f], device) for f in _TENSOR_FIELDS}
    t["idx"] = t["idx"].to(torch.int64)
    t["valid"] = t["valid"].to(torch.bool)
    hyper = GPHyper(**{f: _to_tensor(arrays[f], device).reshape(()) for f in _HYPER_FIELDS})
    optional = {f: (None if arrays.get(f) is None else _to_tensor(arrays[f], device))
                for f in _OPTIONAL_FIELDS}
    return GPState(count=int(np.asarray(arrays["count"])), hyper=hyper, **optional, **t)


def state_to_arrays(state: GPState) -> dict:
    """The inverse of :func:`state_from_arrays`: NumPy arrays on the host.

    ``idx`` comes back as int32 and ``count`` as a 0-d int32, as the
    reference stores them; a bfloat16 corpus comes back as float32, which
    holds its values exactly.
    """
    def host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        # A copy: on the CPU .numpy() would alias buffers that updates write.
        return t.detach().cpu().numpy().copy()

    out = {f: host(getattr(state, f)) for f in _TENSOR_FIELDS}
    out["idx"] = out["idx"].astype(np.int32)
    out["count"] = np.asarray(state.count, dtype=np.int32)
    out.update({f: host(getattr(state.hyper, f)) for f in _HYPER_FIELDS})
    out.update({f: host(getattr(state, f)) for f in _OPTIONAL_FIELDS
                if getattr(state, f) is not None})
    return out
