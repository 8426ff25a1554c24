"""Sharded feedback rounds over the corpus mesh (port of ``ital_tpu.parallel.sharded``).

The corpus axis is sharded over the ranks of a :class:`~ital_tpu_torch.parallel.mesh.Mesh`:

=====================  =========================  ======================
array                  shape                      layout
=====================  =========================  ======================
features ``x``, ``x2``  (N, D), (N,)               rows sharded
whitened kernel ``v``  (cap, N)                   columns sharded
``mu``, ``sig2``,      (N,)                       sharded
``density``
label buffers, ``l``,  (cap, ...), scalars        replicated
``beta``, ``count``,
hyperparameters
=====================  =========================  ======================

(The large-cap path, :mod:`ital_tpu_torch.parallel.bigcap`, holds ``l`` in
block-rows instead.)

Every rank runs the same shard-local code on its shard (SPMD) and must make
the same calls in the same order with the same replicated arguments.  The
reference's collectives become ``torch.distributed`` calls on the mesh's
group: ``psum`` is ``all_reduce`` (:func:`psum`), ``all_gather`` is
:func:`all_gather_cat`, ``ppermute`` is the ring of
:mod:`ital_tpu_torch.parallel.ring` and ``axis_index`` is ``mesh.rank``.

Each rank scores its own candidates with the single-device code
(:func:`ital_tpu_torch.select.ital.mi_scores_from_moments`, the baselines'
score formulas); a greedy step moves only the partial batch's rows, kernel
columns and means (masked sums) and one (value, index) pair per rank for the
argmax.  The GP update runs :func:`ital_tpu_torch.models.gp.gp_update` with a
collective ``gather``, so the sharded and single-device posteriors are one
code path.  Random draws are made in full on every rank (each rank's
generator seeded alike) and each rank takes its rows, so a sharded run draws
what the single-device run draws.

A cohort of K sessions over one shard is a ``StackedGPState`` laid out the
same way (:func:`shard_cohort_state`): ``v`` (K, cap, N/p), ``mu`` and
``sig2`` (K, N/p).  Every strategy selects for a stack with one body, one
session being a stack of one: a greedy step exchanges every session's
partial batch in one sum and every session's argmax in one gather, and a
ring strategy passes the corpus round once for all of them, so a cohort
round pays its collectives once, not once per session
(:func:`make_sharded_cohort_select`).  :func:`make_sharded_session` and
:func:`make_sharded_cohort` run all of a session's or a cohort's rounds
with no host read between them.

Every factory's function is a program of the mesh
(:func:`ital_tpu_torch.graphs.run` with ``mesh=``, the reference's
``jax.jit(shard_map(...))``): on the card one captured CUDA graph per rank
and signature, its NCCL collectives inside; on gloo its body runs eagerly.
Random draws are made before a program, in the eager order, and fed in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ital_tpu_torch import graphs
from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.gp import GPHyper, GPState, StackedGPState
from ital_tpu_torch.models.hyperopt import LearnConfig, relearn_stacked
from ital_tpu_torch.ops import chol as chol_ops
from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_sessions
from ital_tpu_torch.parallel.mesh import Mesh
from ital_tpu_torch.parallel.ring import ring_reduce_over_corpus
from ital_tpu_torch.select import STRATEGIES
from ital_tpu_torch.select import baselines as bl
from ital_tpu_torch.select.base import StrategyParams, per_session
from ital_tpu_torch.select.ital import (
    MAX_MI_BATCH,
    _pack_shifts,
    _session_scores,
    draw_qmc_shifts,
)
from ital_tpu_torch.utils.checkpoint import load_session, save_session
from ital_tpu_torch.utils.metrics import average_precision, recall_at_k, top_k_stable

# Candidates per kernel block in the ring passes: the single-device
# consumers' blocks (blockwise_reduce_abs_kpost, select_mcmi_min,
# corpus_density), so a mesh of one forms the same blocks.
COLABS_BLOCK = 2048
MCMI_BLOCK = 512
DENSITY_BLOCK = 2048

# Newer torch names all_gather_into_tensor all_gather_single and deprecates
# the old name; older releases have only the old one.
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def pad_to_devices(x: np.ndarray, n_dev: int, *, axis: int = 0) -> tuple[np.ndarray, int]:
    """``x`` with zero rows appended along ``axis`` until it divides into
    ``n_dev`` shards; returns ``(padded, n_real)``.  Pad rows must be kept
    out of selection and metrics (:func:`make_masks`)."""
    n = x.shape[axis]
    n_pad = (-n) % n_dev
    if n_pad == 0:
        return x, n
    width = [(0, 0)] * x.ndim
    width[axis] = (0, n_pad)
    return np.pad(np.asarray(x), width), n


def make_masks(n_padded: int, n_real: int, query: int, device=None):
    """``(sel_forbid, ap_exclude)``, replicated (N,) bools: pad rows are
    unselectable and outside the metric; the query is also left out of the
    AP ranking."""
    pad = torch.arange(n_padded, device=device) >= n_real
    ap_exclude = pad.clone()
    ap_exclude[int(query)] = True
    return pad, ap_exclude


def _bounds(mesh: Mesh, shard_n: int) -> tuple[int, int]:
    return mesh.rank * shard_n, (mesh.rank + 1) * shard_n


def _copy(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(dev, copy=True, memory_format=torch.contiguous_format)


def shard_state(state: GPState, mesh: Mesh) -> GPState:
    """This rank's shard of a full port state, on the mesh's device.

    Rows of ``x``, ``x2``, ``mu``, ``sig2`` and ``density`` and columns of
    ``v`` are this rank's; everything else is replicated.  The corpus must
    already divide into the mesh (:func:`pad_to_devices` before ``gp_init``).
    A state built by ``models.gp.state_from_arrays`` from the reference's
    arrays shards as it is.
    """
    n = state.x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} corpus rows do not divide into {mesh.size} shards: pad first")
    lo, hi = _bounds(mesh, n // mesh.size)
    dev = mesh.device
    x2 = state.x2
    if x2 is None:
        xf = state.x.to(torch.promote_types(state.x.dtype, torch.float32))
        x2 = (xf * xf).sum(-1)
    rows = {f: _copy(t[lo:hi], dev) for f, t in
            (("x", state.x), ("x2", x2), ("mu", state.mu), ("sig2", state.sig2))}
    return GPState(
        idx=_copy(state.idx, dev), y=_copy(state.y, dev), valid=_copy(state.valid, dev),
        count=state.count, l=_copy(state.l, dev), beta=_copy(state.beta, dev),
        v=_copy(state.v[:, lo:hi], dev),
        hyper=gp_mod.GPHyper(**{f: _copy(getattr(state.hyper, f), dev)
                                for f in ("length_scale", "var", "noise")}),
        density=None if state.density is None else _copy(state.density[lo:hi], dev),
        **rows,
    )


def shard_cohort_state(st: StackedGPState, mesh: Mesh) -> StackedGPState:
    """This rank's shard of a full stack of K sessions, on the mesh's device
    (the reference's ``cohort_pspecs`` layout): ``v`` (K, cap, N/p), ``mu``
    and ``sig2`` (K, N/p), the shared ``x``, ``x2`` and ``density``'s rows;
    the label buffers, factors, counts and hyperparameters replicated."""
    n = st.x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} corpus rows do not divide into {mesh.size} shards: pad first")
    lo, hi = _bounds(mesh, n // mesh.size)
    dev = mesh.device
    x2 = st.x2
    if x2 is None:
        xf = st.x.to(torch.promote_types(st.x.dtype, torch.float32))
        x2 = (xf * xf).sum(-1)
    return StackedGPState(
        x=_copy(st.x[lo:hi], dev), x2=_copy(x2[lo:hi], dev),
        density=None if st.density is None else _copy(st.density[lo:hi], dev),
        idx=_copy(st.idx, dev), y=_copy(st.y, dev), valid=_copy(st.valid, dev),
        counts=list(st.counts), l=_copy(st.l, dev), beta=_copy(st.beta, dev),
        v=_copy(st.v[..., lo:hi], dev), mu=_copy(st.mu[:, lo:hi], dev),
        sig2=_copy(st.sig2[:, lo:hi], dev),
        hyper=GPHyper(**{f: _copy(getattr(st.hyper, f), dev)
                         for f in ("length_scale", "var", "noise")}),
        hyper_groups=[list(g) for g in st.hyper_groups],
    )


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the ranks, in place; the reference's ``psum``."""
    dist.all_reduce(x, group=mesh.group)
    return x


def all_gather_cat(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order; the
    reference's ``all_gather(..., tiled=True)``."""
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
    _all_gather_into(out, x, group=mesh.group)
    return out


def _owned(mesh: Mesh, shard_n: int, gidx: torch.Tensor):
    """Local positions of the global indices ``gidx`` (clamped into the
    shard) and whether this rank owns each."""
    rel = gidx.to(torch.int64) - mesh.rank * shard_n
    return rel.clamp(0, shard_n - 1), (rel >= 0) & (rel < shard_n)


def gather_rows(mesh: Mesh, x_local: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """Global indices (any shape, e.g. (k,) or (K, t)) -> their rows of a
    row-sharded array, replicated: each rank contributes the rows it owns
    and zeros elsewhere, and one sum assembles them (exactly: each entry is
    one value plus zeros).  Sums in at least f32, so a bf16 corpus crosses
    gloo too."""
    rel, ok = _owned(mesh, x_local.shape[0], gidx)
    wide = torch.promote_types(x_local.dtype, torch.float32)
    rows = x_local[rel].to(wide)
    rows = torch.where(ok.reshape(*ok.shape, *[1] * (x_local.dim() - 1)), rows, 0.0)
    return psum(mesh, rows).to(x_local.dtype)


def _psum_parts(mesh: Mesh, parts: Sequence[torch.Tensor], ok: torch.Tensor) -> list:
    """One sum for several gathers: ``parts`` (..., w_i) are this rank's
    entries at indices whose ownership is ``ok`` (...); they cross as one
    buffer in their widest dtype (at least f32) and come back replicated,
    each in that dtype."""
    wide = functools.reduce(torch.promote_types, [p.dtype for p in parts], torch.float32)
    buf = torch.where(ok[..., None], torch.cat([p.to(wide) for p in parts], -1), 0.0)
    return list(psum(mesh, buf).split([p.shape[-1] for p in parts], -1))


def _all_gather_sessions(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(K, n, ...) per rank -> (K, p n, ...): every rank's entries along
    axis 1, in rank order, in one gather."""
    out = all_gather_cat(mesh, x[None])  # (p, K, n, ...)
    return out.movedim(0, 1).reshape(x.shape[0], -1, *x.shape[2:])


def gather_mu(mesh: Mesh, mu_local: torch.Tensor) -> torch.Tensor:
    """The posterior means over the whole padded corpus, replicated: (N,)
    from (N/p,), or (K, N) from a stack's (K, N/p), in one gather."""
    if mu_local.dim() == 1:
        return all_gather_cat(mesh, mu_local)
    return _all_gather_sessions(mesh, mu_local)


def global_argmax(mesh: Mesh, scores_local: torch.Tensor, *,
                  offset: Optional[int] = None) -> torch.Tensor:
    """The global index (int64) of the largest score over every shard, along
    the last axis: 0-d for (n,) scores, (K,) for K sessions' (K, n); ties go
    to the lowest global index, as ``torch.argmax`` on the whole vector.
    ``offset``: this shard's first global index (default
    ``rank * n``)."""
    off = mesh.rank * scores_local.shape[-1] if offset is None else offset
    li = torch.argmax(scores_local, dim=-1, keepdim=True)
    # One gather of (value, index) pairs for every session; f64 holds both
    # exactly.
    pair = torch.cat([scores_local.gather(-1, li).to(torch.float64),
                      (li + off).to(torch.float64)], -1)
    pairs = all_gather_cat(mesh, pair[None])  # (p, ..., 2)
    best = torch.argmax(pairs[..., 0], dim=0, keepdim=True)
    return pairs[..., 1].gather(0, best)[0].to(torch.int64)


def local_slot_mask(mesh: Mesh, state, *, extra_forbid: torch.Tensor) -> torch.Tensor:
    """This shard's do-not-select mask: the labeled rows it owns, and
    ``extra_forbid`` (its pad rows); (K, N/p) for a stack of K sessions."""
    shard_n = state.x.shape[0]
    rel, ok = _owned(mesh, shard_n, state.idx)
    hits = torch.zeros((*state.idx.shape[:-1], shard_n), dtype=torch.int32,
                       device=state.idx.device)
    hits.scatter_add_(-1, rel, (ok & state.active).to(torch.int32))
    return (hits > 0) | extra_forbid


def _forbid_pick(mesh: Mesh, forbid: torch.Tensor, gidx: torch.Tensor) -> None:
    """Mark the picked global index ``gidx`` (0-d, or (K,) for the K rows of
    a stack's ``forbid``) on the shard that owns it."""
    rel, ok = _owned(mesh, forbid.shape[-1], gidx.reshape(*forbid.shape[:-1], 1))
    forbid.scatter_(-1, rel, forbid.gather(-1, rel) | ok)


def _row_gather(mesh: Mesh, state) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda gidx: gather_rows(mesh, state.x, gidx)


# ---------------------------------------------------------------------------
# ITAL on the shard
# ---------------------------------------------------------------------------


def _batch_block(mesh: Mesh, st: StackedGPState, bsel: torch.Tensor):
    """Replicated ``(xs, vs, mu_b, k_bb - vs^T vs)`` of K sessions' partial
    batches ``bsel`` (K, t): their rows, kernel columns, means and posterior
    covariances, gathered in one sum."""
    h = st.hyper
    xs, vs, mu_b = _gather_moments(mesh, st, bsel)
    return xs, vs, mu_b, rbf_sessions(xs, xs, h.length_scale, h.var, st.hyper_groups) - vs.mT @ vs


def _gather_moments(mesh: Mesh, st: StackedGPState, gidx: torch.Tensor, *,
                    with_sig2: bool = False) -> tuple:
    """Replicated moments of K sessions at their global indices ``gidx``
    (K, t), in one sum: rows (K, t, D), whitened columns (K, cap, t), means
    (K, t) and, ``with_sig2``, variances (K, t)."""
    rel, ok = _owned(mesh, st.x.shape[0], gidx)
    parts = [st.x[rel], st.v.gather(2, rel[:, None, :].expand(-1, st.cap, -1)).mT,
             st.mu.gather(1, rel)[..., None]]
    if with_sig2:
        parts.append(st.sig2.gather(1, rel)[..., None])
    xs, vt, *rest = _psum_parts(mesh, parts, ok)
    # The rows leave the packed buffer contiguous: the CUDA kernel reads them.
    return (xs.to(st.x.dtype).contiguous(), vt.mT, *(r[..., 0] for r in rest))


def _batch_moments(st: StackedGPState, xs, vs, mu_b, params, x_cand, v_cand, a2=None):
    """``(mu_b, jittered cov_bb (K, t, t), cross (K, P, t))`` of K partial
    batches (rows ``xs`` (K, t, D), whitened columns ``vs`` (K, cap, t))
    against candidates ``x_cand`` ((P, D) shared or (K, P, D)) with
    whitened columns ``v_cand`` ((K, cap, P))."""
    h, groups = st.hyper, st.hyper_groups
    t = xs.shape[1]
    eye = torch.eye(t, dtype=st.mu.dtype, device=st.mu.device)
    cov_bb = (rbf_sessions(xs, xs, h.length_scale, h.var, groups) - vs.mT @ vs
              + per_session(params.jitter, 2) * eye)
    cross = rbf_sessions(x_cand, xs, h.length_scale, h.var, groups, a2=a2) - v_cand.mT @ vs
    return mu_b, cov_bb, cross


def _no_moments(st: StackedGPState, n_cand: int):
    k, dt, dev = st.k, st.mu.dtype, st.mu.device
    return (torch.zeros((k, 0), dtype=dt, device=dev), torch.zeros((k, 0, 0), dtype=dt, device=dev),
            torch.zeros((k, n_cand, 0), dtype=dt, device=dev))


def _sharded_pool_indices(mesh: Mesh, ranking_local: torch.Tensor, pool_size: int,
                          pool_padded: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Replicated ``(pool_gidx, pool_forbid)``: the global top-``pool_size``
    rows by ``ranking_local`` ((N/p,), or (K, N/p) for K sessions, each
    ranked apart; ineligible rows already at -inf), padded to
    ``pool_padded`` slots with forbidden ones.

    Each shard's stable top-k is gathered in rank order as (value, index)
    pairs, one gather for every session, and stably sorted, so ties go to
    the lowest global index, as ``top_k_stable`` (and ``jax.lax.top_k``) on
    the whole vector; slots on -inf rows come back flagged in
    ``pool_forbid``.
    """
    lead = ranking_local.shape[:-1]
    ranking = ranking_local.reshape(-1, ranking_local.shape[-1])
    shard_n = ranking.shape[1]
    vals_l, idx_l = top_k_stable(ranking, min(pool_size, shard_n))
    pairs = _all_gather_sessions(mesh, torch.stack(
        [vals_l.to(torch.float64), (idx_l + mesh.rank * shard_n).to(torch.float64)], -1))
    vals, order = torch.sort(pairs[..., 0], dim=1, descending=True, stable=True)
    pool_gidx = pairs[..., 1].gather(1, order[:, :pool_size]).to(torch.int64)
    pool_forbid = ~torch.isfinite(vals[:, :pool_size])
    pad = pool_padded - pool_gidx.shape[1]
    if pad > 0:
        pool_gidx = torch.cat([pool_gidx, pool_gidx[:, :1].expand(-1, pad)], 1)
        pool_forbid = torch.cat([pool_forbid, pool_forbid.new_ones((pool_forbid.shape[0], pad))], 1)
    return pool_gidx.reshape(*lead, -1), pool_forbid.reshape(*lead, -1)


def _sharded_scan_greedy(mesh, st, params, forbid, batch_size, *, n_qmc, block, refine_top,
                         refine_n_qmc, shifts) -> torch.Tensor:
    """(K, batch_size) full-scan greedy ITAL batches on the mesh: each rank
    scores its shard's candidates for every session in one MI call a step
    (:func:`ital_tpu_torch.select.ital._session_scores`), and a step moves
    the partial batches' moments in one sum and K (value, index) pairs in
    one gather, whatever K.  With refinement the global top ``refine_top``
    of each session are gathered (one gather, one sum) and re-scored on
    every rank alike, so every rank takes the same winner without a second
    argmax exchange."""
    n_loc = st.x.shape[0]
    mu_c, sig2_c = st.mu, st.sig2 + per_session(params.jitter)
    batch = torch.zeros((st.k, batch_size), dtype=torch.int64, device=st.idx.device)
    forbid = forbid.clone()
    for t in range(batch_size):
        shift = None if shifts is None else shifts[t]
        if t > 0:
            xs, vs, mu_b = _gather_moments(mesh, st, batch[:, :t])
            moments = _batch_moments(st, xs, vs, mu_b, params, st.x, st.v, a2=st.x2)
        else:
            moments = _no_moments(st, n_loc)
        scores = _session_scores(mu_c, sig2_c, moments[2], *moments[:2], params, t=t,
                                 n_qmc=n_qmc, block=block, shift=shift)
        masked = torch.where(forbid, -torch.inf, scores)
        if refine_top:
            top_gidx, top_forbid = _sharded_pool_indices(mesh, masked, refine_top, refine_top)
            rel, ok = _owned(mesh, n_loc, top_gidx)
            mu_t, sig2_t, cross_t = _psum_parts(
                mesh, [mu_c.gather(1, rel)[..., None], sig2_c.gather(1, rel)[..., None],
                       moments[2].gather(1, rel[..., None].expand(-1, -1, t))], ok)
            refined = _session_scores(mu_t[..., 0], sig2_t[..., 0], cross_t, *moments[:2], params,
                                      t=t, n_qmc=refine_n_qmc, shift=shift)
            refined = torch.where(top_forbid, -torch.inf, refined)
            nxt = top_gidx.gather(1, torch.argmax(refined, dim=1, keepdim=True))[:, 0]
        else:
            nxt = global_argmax(mesh, masked)
        batch[:, t] = nxt
        _forbid_pick(mesh, forbid, nxt)
    return batch


def _sharded_pool_greedy(mesh, st, params, pool_gidx, pool_forbid, batch_size, *, n_qmc, block,
                         refine_top, refine_n_qmc, shifts) -> torch.Tensor:
    """(K, batch_size) compact-pool greedy ITAL batches on the mesh
    (``select.ital``'s pool path).

    The pools' rows, kernel columns and moments are gathered once per
    selection, in one sum; each rank scores its slice of every session's
    pool at each greedy step, and the argmax runs in pool positions (lowest
    position on ties, as the single-device pool vector), one gather for all
    sessions.  With refinement the slices' scores and cross-covariances are
    gathered (one gather) and the re-score of each session's top runs on
    every rank alike.
    """
    k, n_pool = pool_gidx.shape
    pp = n_pool // mesh.size
    lo = mesh.rank * pp
    x_pool, v_pool, mu_pool, sig2_pool = _gather_moments(mesh, st, pool_gidx, with_sig2=True)
    sig2_pool = sig2_pool + per_session(params.jitter)
    x_my, v_my = x_pool[:, lo:lo + pp], v_pool[:, :, lo:lo + pp]
    mu_my, sig2_my = mu_pool[:, lo:lo + pp], sig2_pool[:, lo:lo + pp]
    dev = pool_gidx.device
    forbid = pool_forbid.clone()
    batch = torch.zeros((k, batch_size), dtype=torch.int64, device=dev)
    pos = torch.zeros((k, batch_size), dtype=torch.int64, device=dev)
    for t in range(batch_size):
        shift = None if shifts is None else shifts[t]
        if t > 0:
            p = pos[:, :t]
            xb = x_pool.gather(1, p[..., None].expand(-1, -1, x_pool.shape[-1]))
            vb = v_pool.gather(2, p[:, None, :].expand(-1, st.cap, -1))
            moments = _batch_moments(st, xb, vb, mu_pool.gather(1, p), params, x_my, v_my)
        else:
            moments = _no_moments(st, pp)
        scores = _session_scores(mu_my, sig2_my, moments[2], *moments[:2], params, t=t,
                                 n_qmc=n_qmc, block=block, shift=shift)
        scores = torch.where(forbid[:, lo:lo + pp], -torch.inf, scores)
        if refine_top:
            both = _all_gather_sessions(mesh, torch.cat([scores[..., None], moments[2]], -1))
            vals, top = top_k_stable(both[..., 0], min(refine_top, n_pool))
            cross_top = both[..., 1:].gather(1, top[..., None].expand(-1, -1, t))
            refined = _session_scores(mu_pool.gather(1, top), sig2_pool.gather(1, top), cross_top,
                                      *moments[:2], params, t=t, n_qmc=refine_n_qmc, shift=shift)
            refined = torch.where(torch.isfinite(vals), refined, -torch.inf)
            win = top.gather(1, torch.argmax(refined, dim=1, keepdim=True))[:, 0]
        else:
            win = global_argmax(mesh, scores, offset=lo)
        pos[:, t] = win
        batch[:, t] = pool_gidx.gather(1, win[:, None])[:, 0]
        forbid.scatter_(1, win[:, None], True)
    return batch


def _sharded_ital(mesh, st, sel_forbid, params, batch_size, *, n_qmc, block, pool_size,
                  subsample_size, refine_top, refine_n_qmc, qmc_shifts=None,
                  subsample_uniforms=None) -> torch.Tensor:
    """(K, batch_size) ITAL batches of the K sessions of the stack ``st`` on
    the mesh, each the batch the single-device ``select_ital`` picks for
    that session alone (``select_ital_stacked`` on the mesh), from fed
    draws: ``subsample_uniforms`` (K, N) and ``qmc_shifts``, one (K, t)
    shift per step t."""
    n_pad, n_loc = sel_forbid.shape[0], st.x.shape[0]
    lo, hi = _bounds(mesh, n_loc)
    forbid = local_slot_mask(mesh, st, extra_forbid=sel_forbid[lo:hi])
    kw = dict(n_qmc=n_qmc, block=block, refine_top=refine_top, refine_n_qmc=refine_n_qmc,
              shifts=qmc_shifts)
    if pool_size or subsample_size:
        ranking = st.mu if pool_size else subsample_uniforms[:, lo:hi]
        size = min(pool_size or subsample_size, n_pad)
        pool_gidx, pool_forbid = _sharded_pool_indices(
            mesh, torch.where(forbid, -torch.inf, ranking), size, -(-size // mesh.size) * mesh.size)
        return _sharded_pool_greedy(mesh, st, params, pool_gidx, pool_forbid, batch_size, **kw)
    kw["refine_top"] = min(refine_top, n_pad)
    return _sharded_scan_greedy(mesh, st, params, forbid, batch_size, **kw)


# ---------------------------------------------------------------------------
# Ring strategies: EMOC, batch EMOC, MCMI[min], the corpus density
# ---------------------------------------------------------------------------


def _as_stack(state) -> tuple[StackedGPState, bool]:
    """A stack of K sessions as it is, or one session's state as a stack of
    one; and whether it was one session's."""
    if isinstance(state, StackedGPState):
        return state, False
    return gp_mod.stacked_view(state), True


def _ring_colabs(mesh: Mesh, st: StackedGPState, v: torch.Tensor, valid_local: torch.Tensor):
    """(K, N/p) ``sum_x |k_post(x, c)|`` over every shard's real rows ``x``,
    for this shard's candidates ``c``, of each of K sessions, by one ring
    pass for all of them.

    Each rank keeps its candidates' columns of ``v`` (K, r, N/p) (the
    sessions' whitened kernels, or batch EMOC's augmented ones) and takes
    each visiting shard's rows in blocks of ``COLABS_BLOCK`` of its
    candidates, as the single-device ``blockwise_reduce_abs_kpost`` does, so
    no (N/p, N/p) block is ever held.  The visiting rows, their norms,
    ``valid_local`` (1 on real rows, 0 on pads, which weighs them) and the
    sessions' columns of ``v`` travel together; each block forms one kernel
    block per hyperparameter group, which its sessions share.
    """
    h, groups = st.hyper, st.hyper_groups
    n_loc = st.x.shape[0]

    def acc_fn(acc, blk):
        xb, x2b, vb, valid_b = blk
        parts = []
        for lo in range(0, n_loc, COLABS_BLOCK):
            c = slice(lo, lo + COLABS_BLOCK)
            cols = [None] * st.k
            for group in groups:
                k = rbf_kernel(xb, st.x[c], h.length_scale[group[0]], h.var[group[0]], a2=x2b,
                               b2=st.x2[c])
                for s in group:
                    k_post = (k - vb[s].T @ v[s][:, c]).abs_()
                    cols[s] = k_post.mul_(valid_b[:, None]).sum(0)
            parts.append(torch.stack(cols))
        return acc + torch.cat(parts, -1)

    zero = torch.zeros((st.k, n_loc), dtype=st.mu.dtype, device=st.mu.device)
    return ring_reduce_over_corpus(mesh, (st.x, st.x2, v, valid_local), acc_fn, zero)


def _sharded_emoc_scores(mesh, state, valid_local):
    """EMOC on the mesh (``baselines.select_emoc``), of one session (N/p,)
    or of a stack's K sessions (K, N/p)."""
    st, one = _as_stack(state)
    colabs = _ring_colabs(mesh, st, st.v, valid_local)
    scores = bl.emoc_scores_from_moments(st.mu, st.sig2, per_session(st.hyper.noise), colabs)
    return scores[0] if one else scores


def _sharded_emoc_batch_scores(mesh, st, batch, t, valid_local):
    """Batch EMOC on the mesh (``baselines.select_emoc_batch``) of K
    sessions: the block hypothetical update from the partial batches'
    gathered moments (their (t, t) factors replicated, the whitening rows
    ``w`` shard-local), then one ring with each ``v`` augmented by its
    ``w``."""
    if t == 0:
        return _sharded_emoc_scores(mesh, st, valid_local)
    h = st.hyper
    xs, vs, mu_b, cov = _batch_block(mesh, st, batch[:, :t])
    cross = (rbf_sessions(st.x, xs, h.length_scale, h.var, st.hyper_groups, a2=st.x2)
             - st.v.mT @ vs).mT  # (K, t, N/p)
    valid = torch.ones(mu_b.shape, dtype=torch.bool, device=mu_b.device)
    y_hyp = torch.where(mu_b >= 0.0, 1.0, -1.0)
    resid = y_hyp.to(st.mu.dtype) - mu_b
    la = chol_ops.padded_cholesky(cov, valid, h.noise)
    w = chol_ops.tri_solve(la, cross)  # (K, t, N/p)
    g = chol_ops.tri_solve(la, resid[..., None])[..., 0]
    mu_h = st.mu + (w.mT @ g[..., None])[..., 0]
    sig2_h = torch.clamp(st.sig2 - (w * w).sum(-2), min=1e-8)
    colabs = _ring_colabs(mesh, st, torch.cat([st.v, w], -2), valid_local)
    return bl.emoc_scores_from_moments(mu_h, sig2_h, per_session(h.noise), colabs)


def _sharded_mcmi_scores(mesh, state, valid_local):
    """MCMI[min] on the mesh (``baselines.select_mcmi_min``), of one session
    (N/p,) or of a stack's K sessions (K, N/p): for each of this shard's
    candidates and both hypothetical labels, the binary entropy of the
    one-point-updated posterior summed over every shard's real rows by one
    ring pass for all sessions, in blocks of ``MCMI_BLOCK`` candidates (one
    kernel block per hyperparameter group); the score is ``-max_y`` of the
    two sums."""
    st, one = _as_stack(state)
    h, groups = st.hyper, st.hyper_groups
    n_loc = st.x.shape[0]

    def acc_fn(acc, blk):
        xb, x2b, vb, mub, sig2b, valid_b = blk
        pos, neg = [], []
        for lo in range(0, n_loc, MCMI_BLOCK):
            c = slice(lo, lo + MCMI_BLOCK)
            pk, nk = [None] * st.k, [None] * st.k
            for group in groups:
                k = rbf_kernel(xb, st.x[c], h.length_scale[group[0]], h.var[group[0]], a2=x2b)
                for s in group:
                    k_post = k - vb[s].T @ st.v[s][:, c]
                    denom = st.sig2[s][c] + h.noise[s]
                    # The variance shrink does not depend on the label.
                    sig_new = torch.sqrt(torch.clamp(sig2b[s][:, None] - k_post**2 / denom,
                                                     min=1e-8))

                    def total_entropy(y):
                        mu_new = mub[s][:, None] + k_post * ((y - st.mu[s][c]) / denom)
                        return (bl._binary_entropy(bl._phi(mu_new / sig_new))
                                * valid_b[:, None]).sum(0)

                    pk[s], nk[s] = total_entropy(1.0), total_entropy(-1.0)
            pos.append(torch.stack(pk))
            neg.append(torch.stack(nk))
        return acc[0] + torch.cat(pos, -1), acc[1] + torch.cat(neg, -1)

    zero = torch.zeros((st.k, n_loc), dtype=st.mu.dtype, device=st.mu.device)
    h_pos, h_neg = ring_reduce_over_corpus(
        mesh, (st.x, st.x2, st.v, st.mu, st.sig2, valid_local), acc_fn, (zero, zero.clone()))
    scores = -torch.maximum(h_pos, h_neg)
    return scores[0] if one else scores


def _sharded_density_local(mesh: Mesh, x: torch.Tensor, x2: torch.Tensor, ls: torch.Tensor,
                           pad_local: torch.Tensor) -> torch.Tensor:
    """(n_loc,) mean RBF similarity (var 1) of each of this shard's rows to
    every real corpus row, by a ring pass (``models.gp.corpus_density``):
    pad rows count in neither the sum nor the denominator."""
    n_loc = x.shape[0]
    valid_local = 1.0 - pad_local.to(x2.dtype)

    def acc_fn(acc, blk):
        xb, x2b, valid_b = blk
        sums = [rbf_kernel(x[r], xb, ls, 1.0, a2=x2[r], b2=x2b).mul_(valid_b).sum(1)
                for r in (slice(lo, lo + DENSITY_BLOCK) for lo in range(0, n_loc, DENSITY_BLOCK))]
        return acc[0] + torch.cat(sums), acc[1] + valid_b.sum()

    zero = torch.zeros(n_loc, dtype=x2.dtype, device=x2.device)
    s, cnt = ring_reduce_over_corpus(mesh, (x, x2, valid_local), acc_fn,
                                     (zero, zero.new_zeros(())))
    return s / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# The baselines on the shard
# ---------------------------------------------------------------------------


def _max_sim(mesh: Mesh, st: StackedGPState, members: torch.Tensor, keep=None) -> torch.Tensor:
    """(K, n_loc) max RBF similarity (var 1) of each local row to each
    session's corpus rows ``members`` (K, m) (those where ``keep`` holds),
    gathered in one sum: ``models.gp.max_sim_stacked`` on the mesh."""
    h = st.hyper
    xm = gather_rows(mesh, st.x, members)
    sims = rbf_sessions(st.x, xm, h.length_scale, torch.ones_like(h.var), st.hyper_groups,
                        a2=st.x2)
    if keep is not None:
        sims = torch.where(keep[:, None, :], sims, -torch.inf)
    return sims.amax(-1)


def _sharded_regression_scores(mesh, st, batch, t, params):
    """Greedy log-det MI on the mesh (``select.regression``) of K sessions:
    each local candidate's variance conditional on its session's partial
    batch."""
    h = st.hyper
    if t == 0:
        cond_var = st.sig2
    else:
        xs, vs, _, cov_bb = _batch_block(mesh, st, batch[:, :t])
        eye = torch.eye(t, dtype=cov_bb.dtype, device=cov_bb.device)
        cov_bb = cov_bb + per_session(h.noise + params.jitter, 2) * eye
        cross = (rbf_sessions(st.x, xs, h.length_scale, h.var, st.hyper_groups, a2=st.x2)
                 - st.v.mT @ vs)
        chol, info = torch.linalg.cholesky_ex(cov_bb)
        graphs.check_after(info, chol_ops.check_cholesky_info)
        w = chol_ops.tri_solve(chol, cross.mT)
        cond_var = torch.clamp(st.sig2 - (w * w).sum(-2), min=1e-10)
    return 0.5 * torch.log1p(cond_var / per_session(h.noise))


# Batch-independent scores of the cheap baselines, from the local stack.
_LOCAL_SCORES = {
    "topscoring": lambda s, p: s.mu,
    "variance_sampling": lambda s, p: s.sig2,
    "uncertainty_sampling": lambda s, p: -s.mu.abs() / torch.sqrt(s.sig2),
    "borderline_sampling": lambda s, p: -s.mu.abs(),
    "entropy_sampling": lambda s, p: bl._binary_entropy(bl._p_relevant(s)),
    "sud": lambda s, p: bl._binary_entropy(bl._p_relevant(s)) * bl._density(s),
    "adapt_al": lambda s, p: (
        torch.pow(bl._binary_entropy(bl._p_relevant(s)) + bl._EPS, per_session(p.tradeoff))
        * torch.pow(bl._density(s) + bl._EPS, 1.0 - per_session(p.tradeoff))),
}

# Strategies whose step score is ``base - tradeoff * max-sim`` diversity
# greedy (``baselines._diversity_greedy``), by their base.
_DIVERSITY_BASES = {
    "borderline_diversity_sampling": lambda s: -s.mu.abs(),
    "usdm": lambda s: -s.mu.abs() / torch.sqrt(s.sig2),
    "tcal": lambda s: -s.mu.abs() * bl._density(s),
}

SHARDED_STRATEGIES = frozenset(_LOCAL_SCORES) | frozenset(_DIVERSITY_BASES) | {
    "ital", "random", "rbmal", "emoc", "emoc_batch", "mcmi_min", "ital_regression"}


def _sharded_baseline(mesh, st, params, sel_forbid, n_real, *, strategy, batch_size,
                      uniforms=None) -> torch.Tensor:
    """(K, batch_size) picks of a strategy other than ITAL for the K
    sessions of ``st``, each the batch the strategy picks for that session
    alone: every greedy step's gathers and its (value, index) argmax serve
    all K sessions in one collective, and the ring strategies pass the
    corpus blocks round once for all of them.  ``n_real``: the real rows
    (0-d), ``uniforms`` (K, N) ``random``'s draws."""
    n_loc = st.x.shape[0]
    lo, hi = _bounds(mesh, n_loc)
    pad_local = sel_forbid[lo:hi]
    forbid = local_slot_mask(mesh, st, extra_forbid=pad_local)
    valid_local = 1.0 - pad_local.to(st.mu.dtype)
    scores = None
    if strategy in _LOCAL_SCORES:
        scores = _LOCAL_SCORES[strategy](st, params)
    elif strategy == "random":
        scores = uniforms[:, lo:hi]
    elif strategy == "emoc":
        scores = _sharded_emoc_scores(mesh, st, valid_local)
    elif strategy == "mcmi_min":
        scores = _sharded_mcmi_scores(mesh, st, valid_local)
    diversity = strategy in _DIVERSITY_BASES or strategy == "rbmal"
    if diversity:
        # Invariant over the greedy steps: one gather a selection.
        sim_lab = torch.clamp(_max_sim(mesh, st, st.idx, st.active), min=0.0)
    if strategy in _DIVERSITY_BASES:
        div_base = _DIVERSITY_BASES[strategy](st)
    if strategy == "rbmal":
        n_lab = st.active.sum(-1)[:, None]
        unc = 1.0 - torch.tanh(st.mu).abs()

    batch = torch.zeros((st.k, batch_size), dtype=torch.int64, device=st.mu.device)
    for t in range(batch_size):
        if strategy == "ital_regression":
            scores = _sharded_regression_scores(mesh, st, batch, t, params)
        elif strategy == "emoc_batch":
            scores = _sharded_emoc_batch_scores(mesh, st, batch, t, valid_local)
        elif diversity:
            sim = sim_lab
            if t > 0:
                sim = torch.maximum(sim, _max_sim(mesh, st, batch[:, :t]))
            if strategy == "rbmal":
                alpha = (n_real - n_lab - t).to(st.mu.dtype) / n_real
                scores = alpha * (1.0 - sim) + (1.0 - alpha) * unc
            else:
                scores = div_base - per_session(params.tradeoff) * sim
        nxt = global_argmax(mesh, torch.where(forbid, -torch.inf, scores))
        batch[:, t] = nxt
        _forbid_pick(mesh, forbid, nxt)
    return batch


def _padded_uniforms(generator, n_real: int, n_pad: int, like: torch.Tensor) -> torch.Tensor:
    """The single-device path's (n_real,) uniform draw, zero-padded to the
    mesh's rows: every rank draws it whole from a generator seeded alike."""
    u = torch.rand(n_real, generator=generator, dtype=like.dtype, device=like.device)
    return torch.cat([u, u.new_zeros(n_pad - n_real)])


# ---------------------------------------------------------------------------
# The selection: one stacked body for every strategy, its draws made first
# ---------------------------------------------------------------------------

_DRAWN = ("subsample_uniforms", "qmc_shifts", "uniforms")


def _ital_options(*, n_qmc: int = 128, block: Optional[int] = None, pool_size: int = 0,
                  subsample_size: int = 0, refine_top: int = 0, refine_n_qmc: int = 512,
                  randomize_qmc: bool = False) -> dict:
    """ITAL's options with the defaults of :func:`make_sharded_select`."""
    return dict(n_qmc=n_qmc, block=block, pool_size=pool_size, subsample_size=subsample_size,
                refine_top=refine_top, refine_n_qmc=refine_n_qmc, randomize_qmc=randomize_qmc)


@dataclasses.dataclass(frozen=True)
class _Selection:
    """A strategy's mesh selection of ``batch_size`` with ITAL's ``options``
    (:func:`_ital_options`): ``static`` keys its programs, :meth:`draws`
    makes its random inputs before a program, :meth:`picks` is its body."""

    strategy: str
    batch_size: int
    options: tuple  # ITAL's, sorted (name, value) pairs; () for the others

    @classmethod
    def make(cls, strategy: str, batch_size: int, options: dict) -> "_Selection":
        if strategy not in STRATEGIES:
            raise KeyError(f"unknown strategy {strategy!r}; available: {sorted(STRATEGIES)}")
        if strategy not in SHARDED_STRATEGIES:
            raise NotImplementedError(f"strategy {strategy!r} has no sharded form")
        if strategy == "ital" and batch_size > MAX_MI_BATCH:
            raise ValueError(f"ITAL batch_size={batch_size} exceeds the supported maximum "
                             f"{MAX_MI_BATCH} (3^m feedback table and QMC accuracy)")
        opts = _ital_options(**options)
        if opts["pool_size"] and opts["subsample_size"]:
            raise ValueError("pool_size and subsample_size are mutually exclusive candidate "
                             "restrictions (reference ITAL applies one or the other)")
        return cls(strategy, int(batch_size),
                   tuple(sorted(opts.items())) if strategy == "ital" else ())

    @property
    def static(self) -> tuple:
        return (self.strategy, self.batch_size, self.options)

    def draws(self, generators, n_real: int, n_pad: int, like: torch.Tensor, *,
              qmc_shifts=None, subsample_uniforms=None, uniforms=None) -> dict:
        """K sessions' random inputs, session k's from ``generators[k]`` in
        the single-device selection's order (``random``'s or ITAL's
        subsample uniforms over the real rows, padded, then one QMC shift
        per greedy step), as (K, ...) tensors: ``uniforms``,
        ``subsample_uniforms`` (K, N) and ``qmc_shifts`` packed (K, b, b).
        Fed draws (``qmc_shifts`` one (K, t) shift per step t) replace
        them.  ``n_real`` of the ``n_pad`` rows are real."""
        b = self.batch_size
        if self.strategy == "random":
            if uniforms is None:
                uniforms = torch.stack([_padded_uniforms(g, n_real, n_pad, like)
                                        for g in generators])
            return {"uniforms": uniforms}
        if self.strategy != "ital":
            return {}
        opts = dict(self.options)
        draw_u = bool(opts["subsample_size"]) and subsample_uniforms is None
        draw_s = opts["randomize_qmc"] and qmc_shifts is None
        us, shifts = [], []
        for g in generators if draw_u or draw_s else ():
            if draw_u:
                us.append(_padded_uniforms(g, n_real, n_pad, like))
            if draw_s:
                shifts.append(draw_qmc_shifts(g, b, like.dtype, like.device))
        if draw_u:
            subsample_uniforms = torch.stack(us)
        if draw_s:
            qmc_shifts = [torch.stack([s[t] for s in shifts]) for t in range(b)]
        return {"subsample_uniforms": subsample_uniforms if opts["subsample_size"] else None,
                "qmc_shifts": None if qmc_shifts is None else _pack_shifts(qmc_shifts, b)}

    def picks(self, mesh, st, params, sel_forbid, n_real, *, subsample_uniforms=None,
              qmc_shifts=None, uniforms=None) -> torch.Tensor:
        """(K, b) picks of the stack ``st`` with its draws fed in: the body
        of every mesh selection, of one session or of K."""
        if self.strategy == "ital":
            opts = dict(self.options)
            opts.pop("randomize_qmc")
            shifts = (None if qmc_shifts is None
                      else [qmc_shifts[:, t, :t] for t in range(self.batch_size)])
            return _sharded_ital(mesh, st, sel_forbid, params, self.batch_size, **opts,
                                 qmc_shifts=shifts, subsample_uniforms=subsample_uniforms)
        return _sharded_baseline(mesh, st, params, sel_forbid, n_real, strategy=self.strategy,
                                 batch_size=self.batch_size, uniforms=uniforms)


def _one(drawn: dict) -> dict:
    """A single session's fed draws as a stack of one's."""
    out = dict(drawn)
    if out.get("qmc_shifts") is not None:
        out["qmc_shifts"] = [s[None] for s in out["qmc_shifts"]]
    for k in ("subsample_uniforms", "uniforms"):
        if out.get(k) is not None:
            out[k] = out[k][None]
    return out


# ---------------------------------------------------------------------------
# Programs: every call below runs its body through graphs.run on the mesh
# ---------------------------------------------------------------------------


def _program(mesh: Mesh, name: str, body, inputs: dict, shared: dict, *, static: tuple = (),
             writes: tuple = ()) -> tuple:
    """``body(mesh=mesh, **shared, **inputs)`` as program ``name`` of the
    mesh (:func:`ital_tpu_torch.graphs.run`): on the card one graph per rank
    with the collectives inside, captured once per signature."""
    return graphs.run(name, functools.partial(body, mesh=mesh), inputs, shared=shared,
                      static=static, writes=writes, mesh=mesh)


def _stack_inputs(states) -> tuple[dict, tuple, dict]:
    """A cohort as a program's inputs, its group plan and its shared
    tensors: a :class:`StackedGPState`'s (K, ...) buffers as they are (the
    program writes into them), or K sessions' own states, which the program
    stacks inside (``models.gp.cohort_program_inputs``)."""
    if not isinstance(states, StackedGPState):
        states = list(states)
        inputs, groups = gp_mod.cohort_program_inputs(states)
        return inputs, groups, gp_mod.program_shared(states[0])
    st = states
    counts = (st.counts if isinstance(st.counts, torch.Tensor)
              else chol_ops.host_index(st.counts, st.mu.device))
    inputs = {"counts": counts, **{f: getattr(st, f) for f in gp_mod.SESSION_FIELDS},
              **{f: getattr(st.hyper, f) for f in ("length_scale", "var", "noise")}, "x2": st.x2}
    shared = {"x": st.x, **({} if st.density is None else {"density": st.density})}
    return inputs, tuple(tuple(g) for g in st.hyper_groups), shared


def _add_counts(states, b: int) -> None:
    """The host counts of a cohort after a program absorbed ``b`` slots each."""
    if isinstance(states, StackedGPState):
        states.counts = [c + b for c in states.counts]
    else:
        for s in states:
            s.count += b


def _body_state(x, density=None, *, groups, **inputs) -> GPState | StackedGPState:
    """The state a body works on: K sessions' stack where ``groups`` is their
    plan, else one session's state."""
    if groups is None:
        return gp_mod.program_state(x, inputs, density)
    return gp_mod.program_stack(x, inputs, groups, density)


def _select_body(x, density=None, *, mesh, sel: _Selection, groups, sel_forbid, n_real,
                 **inputs) -> tuple:
    drawn = {k: inputs.pop(k) for k in _DRAWN if k in inputs}
    params = StrategyParams.from_inputs(inputs)
    state = _body_state(x, density, groups=groups, **inputs)
    if groups is None:
        drawn = {k: None if v is None else v[None] for k, v in drawn.items()}
        return (sel.picks(mesh, gp_mod.stacked_view(state), params, sel_forbid, n_real,
                          **drawn)[0],)
    return (sel.picks(mesh, state, params, sel_forbid, n_real, **drawn),)


def _run_select(mesh, sel: _Selection, states, generators, sel_forbid, params, n_real, fed,
                *, one: bool) -> torch.Tensor:
    """The selection program of one session (``one``) or of a cohort."""
    if one:
        inputs, groups = gp_mod.program_inputs(states), None
        shared, like = gp_mod.program_shared(states), states.mu
        fed = _one(fed)
    else:
        inputs, groups, shared = _stack_inputs(states)
        like = inputs["mu"] if isinstance(inputs["mu"], torch.Tensor) else inputs["mu"][0]
    n_real = _count_real(sel_forbid) if n_real is None else n_real
    drawn = sel.draws(generators, n_real, sel_forbid.shape[0], like, **fed)
    if one:
        drawn = {k: None if v is None else v[0] for k, v in drawn.items()}
    inputs.update(params.program_inputs(), **drawn, sel_forbid=sel_forbid, n_real=int(n_real))
    (batch,) = _program(mesh, "sharded_select" if one else "sharded_cohort_select",
                        functools.partial(_select_body, sel=sel, groups=groups), inputs, shared,
                        static=(sel.static, groups))
    return batch


def make_sharded_select(
    mesh: Mesh,
    *,
    strategy: str = "ital",
    batch_size: int = 4,
    n_qmc: int = 128,
    block: Optional[int] = None,
    pool_size: int = 0,
    subsample_size: int = 0,
    refine_top: int = 0,
    refine_n_qmc: int = 512,
    randomize_qmc: bool = False,
):
    """The selection step on the mesh, as one program (the reference's
    ``jax.jit(shard_map(select))``).

    Returns ``select(state, generator, sel_forbid, params, *, qmc_shifts=None,
    subsample_uniforms=None, uniforms=None, n_real=None) -> (batch_size,)``
    replicated global indices.  ``state`` is this rank's shard
    (:func:`shard_state`), ``sel_forbid`` the replicated (N,) bool mask of
    rows never to select (the pad rows; labeled rows are excluded as on
    every path), and ``generator`` (on the mesh's device, seeded alike on
    every rank) feeds the random draws in the single-device order, drawn
    before the program: ``random``'s and ITAL's subsample uniforms over the
    real rows, then one QMC shift per greedy step.  Fed draws replace them:
    ``qmc_shifts`` (one (t,) shift per step t), ``subsample_uniforms`` or
    ``uniforms`` (``random``), each (N,) over the padded rows.  ``n_real``:
    the real rows, where the caller knows them (else one read of
    ``sel_forbid`` before the program).  Options are ITAL's
    (``select.ital.select_ital``); every registered strategy runs, as the
    stack of one of :func:`make_sharded_cohort_select`'s body.
    """
    sel = _Selection.make(strategy, batch_size, dict(
        n_qmc=n_qmc, block=block, pool_size=pool_size, subsample_size=subsample_size,
        refine_top=refine_top, refine_n_qmc=refine_n_qmc, randomize_qmc=randomize_qmc))

    def select(state: GPState, generator, sel_forbid: torch.Tensor, params: StrategyParams, *,
               qmc_shifts: Optional[Sequence[torch.Tensor]] = None,
               subsample_uniforms: Optional[torch.Tensor] = None,
               uniforms: Optional[torch.Tensor] = None,
               n_real: Optional[int] = None) -> torch.Tensor:
        fed = dict(qmc_shifts=qmc_shifts, subsample_uniforms=subsample_uniforms,
                   uniforms=uniforms)
        return _run_select(mesh, sel, state, [generator], sel_forbid, params, n_real, fed,
                           one=True)

    return select


def make_sharded_cohort_select(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                               **options):
    """The selection of K sessions over one corpus shard at once, as one
    program (the reference's session-batched ``make_sharded_cohort_select``).

    Returns ``select(states, generators, sel_forbid, params, *,
    qmc_shifts=None, subsample_uniforms=None, uniforms=None, n_real=None) ->
    (K, batch_size)``.  ``states``: this rank's shard of a
    :class:`~gp_mod.StackedGPState` (:func:`shard_cohort_state`), or K
    sessions' own states over one shard, which the program stacks inside.
    Each row is the batch :func:`make_sharded_select` picks for that session
    alone with its own generator, hyperparameters and, where ``params``
    holds (K,) fields (:meth:`StrategyParams.stack`, the reference's
    ``params_b``), its own user model.  Fed draws are (K, ...):
    ``qmc_shifts`` one (K, t) shift per step, ``subsample_uniforms`` and
    ``uniforms`` (K, N).  ``options`` as :func:`make_sharded_select`.  For
    every strategy a greedy step's gathers and argmax serve all K sessions
    in one collective, and a ring strategy passes the corpus round once for
    the cohort, so a round pays its collectives once, not once per session.
    """
    sel = _Selection.make(strategy, batch_size, options)

    def select(states, generators, sel_forbid: torch.Tensor, params: StrategyParams,
               *, qmc_shifts=None, subsample_uniforms=None, uniforms=None,
               n_real: Optional[int] = None) -> torch.Tensor:
        fed = dict(qmc_shifts=qmc_shifts, subsample_uniforms=subsample_uniforms,
                   uniforms=uniforms)
        return _run_select(mesh, sel, states, generators, sel_forbid, params, n_real, fed,
                           one=False)

    return select


def _span(timer, name: str):
    return contextlib.nullcontext() if timer is None else timer.span(name)


def _absorb_body(x, *, mesh, recall_ks, batch, u_label, u_flip, relevant, ap_exclude,
                 **inputs) -> tuple:
    """The round's update as a program's body: the simulated user, the GP
    update (in place) and AP and recall@k of the gathered mean."""
    params = StrategyParams.from_inputs(inputs)
    state = gp_mod.program_state(x, inputs)
    y, valid = feedback_from_uniforms(u_label, u_flip, batch, relevant, params.label_prob,
                                      params.mistake_prob)
    gp_mod.gp_update(state, batch, y, valid, gather=_row_gather(mesh, state))
    mu = all_gather_cat(mesh, state.mu)
    return (average_precision(mu, relevant, ap_exclude),
            *(recall_at_k(mu, relevant, min(k, mu.shape[0]), ap_exclude) for k in recall_ks))


def make_sharded_round(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                       recall_ks: tuple = (), **options):
    """One feedback round on the mesh: select, the simulated user, the GP
    update, then AP and recall@k of the gathered posterior mean, as two
    programs (the selection's and the update's).

    Returns ``round_fn(state, generator, u_label, u_flip, relevant,
    sel_forbid, ap_exclude, params, *, timer=None, **draws) -> (state,
    batch, ap, recalls)``; ``state`` is updated in place.  ``generator``
    and ``draws`` are the selection's (:func:`make_sharded_select`, whose
    ``options`` this takes; ``n_real`` among them); ``u_label``/``u_flip``
    (b,) the user's uniforms (``data.user.feedback_from_uniforms``);
    ``relevant``, ``sel_forbid`` and ``ap_exclude`` replicated (N,) bools
    over the padded rows.  ``recalls`` holds one 0-d tensor per k of
    ``recall_ks``.  With a ``timer`` (``utils.logging.Timer``) the selection
    is its "select" span and the rest its "update" span, as in the
    single-device runner.
    """
    select = make_sharded_select(mesh, strategy=strategy, batch_size=batch_size, **options)
    recall_ks = tuple(recall_ks)

    def round_fn(state, generator, u_label, u_flip, relevant, sel_forbid, ap_exclude, params,
                 *, timer=None, **draws):
        with _span(timer, "select"):
            batch = select(state, generator, sel_forbid, params, **draws)
        with _span(timer, "update"):
            gp_mod.check_capacity([state.count], batch.shape[0], state.cap)
            ap, *recalls = _program(
                mesh, "sharded_absorb", functools.partial(_absorb_body, recall_ks=recall_ks),
                {**gp_mod.program_inputs(state), **params.program_inputs(), "batch": batch,
                 "u_label": u_label, "u_flip": u_flip, "relevant": relevant,
                 "ap_exclude": ap_exclude},
                {"x": state.x}, static=(recall_ks,), writes=gp_mod.SESSION_FIELDS)
            state.count += batch.shape[0]
        return state, batch, ap, recalls

    return round_fn


def _update_body(x, *, mesh, groups, new_idx, new_y, new_valid, **inputs) -> tuple:
    state = _body_state(x, groups=groups, **inputs)
    gather = _row_gather(mesh, state)
    if groups is None:
        gp_mod.gp_update(state, new_idx, new_y, new_valid, gather=gather)
    else:
        gp_mod.gp_update_stacked(state, new_idx, new_y, new_valid, gather=gather)
    return ()


def make_sharded_update(mesh: Mesh):
    """``update(state, idx, y, valid) -> state``: ``gp_update`` of real
    feedback on the mesh as one program, the rows gathered across ranks;
    ``state`` is written in place.  A block that is not positive definite
    raises on every rank once the program has run and leaves ``state`` as it
    was."""

    def update(state, idx, y, valid):
        gp_mod.check_capacity([state.count], idx.shape[-1], state.cap)
        _program(mesh, "sharded_update", functools.partial(_update_body, groups=None),
                 {**gp_mod.program_inputs(state), "new_idx": idx, "new_y": y, "new_valid": valid},
                 {"x": state.x}, writes=gp_mod.SESSION_FIELDS)
        state.count += idx.shape[-1]
        return state

    return update


def _set_query_body(x, *, mesh, query, **inputs) -> tuple:
    state = gp_mod.program_state(x, inputs)
    for buf, val in ((state.idx, None), (state.y, 1.0), (state.valid, True)):
        buf.zero_()
        if val is not None:
            buf[:1].fill_(val)
    state.idx[:1].copy_(query.reshape(1))
    state.count = 1
    gp_mod.gp_refit(state, gather=_row_gather(mesh, state))
    return ()


def make_sharded_set_query(mesh: Mesh):
    """``set_query(state, query_idx) -> state``: ``gp_set_query`` on the
    mesh as one program, ``state`` written in place."""

    def set_query(state, q):
        _program(mesh, "sharded_set_query", _set_query_body,
                 {**gp_mod.program_inputs(state), "query": int(q)}, {"x": state.x},
                 writes=gp_mod.SESSION_FIELDS)
        state.count = 1
        return state

    return set_query


def _fit_body(x, *, mesh, **inputs) -> tuple:
    state = gp_mod.program_state(x, inputs)
    gp_mod.gp_refit(state, gather=_row_gather(mesh, state))
    return ()


def make_sharded_fit(mesh: Mesh):
    """``fit(state) -> state``: ``gp_fit`` on the mesh (a refit after the
    hyperparameters change) as one program, written into ``state``'s
    posterior buffers in place."""

    def fit(state):
        _program(mesh, "sharded_fit", _fit_body, gp_mod.program_inputs(state), {"x": state.x},
                 writes=gp_mod.POSTERIOR_FIELDS)
        return state

    return fit


def _density_body(x, *, mesh, x2, length_scale, pad) -> tuple:
    lo, hi = _bounds(mesh, x.shape[0])
    return (_sharded_density_local(mesh, x, x2, length_scale, pad[lo:hi]),)


def make_sharded_density(mesh: Mesh):
    """``density(state, pad_mask) -> (N/p,)`` this shard's rows of the corpus
    density over the real rows (``pad_mask``: the replicated (N,) pad
    flags), as one program; attach it as ``state.density``."""

    def density(state, pad):
        (dens,) = _program(mesh, "sharded_density", _density_body,
                           {"x2": state.x2, "length_scale": state.hyper.length_scale, "pad": pad},
                           {"x": state.x})
        return dens

    return density


def _labeled_rows_body(x, *, mesh, idx) -> tuple:
    return (gather_rows(mesh, x, idx),)


def labeled_rows(mesh: Mesh, state) -> torch.Tensor:
    """The (cap, D) rows of ``state``'s labeled slots, gathered (one sum), as
    one program (the reference's ``_jit_gather_labeled``)."""
    (rows,) = _program(mesh, "sharded_labeled_rows", _labeled_rows_body, {"idx": state.idx},
                       {"x": state.x})
    return rows


# ---------------------------------------------------------------------------
# Fused sessions and cohorts: every round of a session, or of K sessions, as
# one program
# ---------------------------------------------------------------------------


def _relearn_stack(mesh: Mesh, st: StackedGPState, options: tuple, center) -> None:
    """Re-learn K sessions' hyperparameters from their labels and refit them
    on the mesh, in place (``hyperopt.relearn_stacked`` with the collective
    gather): the labeled rows of every session are gathered in one sum,
    every rank runs the ascents, and rank 0's log-parameters are broadcast,
    so the ranks go on with one fit bit for bit whatever their
    arithmetic."""

    def agree(theta):
        theta = theta.detach().contiguous()
        dist.broadcast(theta, src=0, group=mesh.group)
        return theta

    relearn_stacked(st, center=center, gather=_row_gather(mesh, st), agree=agree,
                    **dict(options))


def _relearn_body(x, *, mesh, options, center, **inputs) -> tuple:
    st = gp_mod.stacked_view(gp_mod.program_state(x, inputs))
    _relearn_stack(mesh, st, options, center)
    h = st.hyper
    return (torch.stack([h.length_scale, h.var, h.noise], -1)[0],)


def _hyper_of(values: torch.Tensor, old: GPHyper, learn_noise: bool) -> GPHyper:
    """New 0-d (or (K,)) hyperparameters from a program's (..., 3) values;
    the noise stays ``old``'s where it is not learned (bit-exact pin)."""
    h = GPHyper(*values.unbind(-1))
    if not learn_noise:
        h.noise = old.noise
    return h


def make_sharded_relearn(mesh: Mesh, learn: LearnConfig):
    """``relearn(state) -> state``: re-learn the session's hyperparameters
    from its labels and refit it on the mesh, as one program (the serial
    runner's re-learn on a mesh): the refit is written into ``state``'s
    posterior buffers and ``state.hyper`` replaced by new 0-d tensors."""

    def relearn(state):
        (vals,) = _program(mesh, "sharded_relearn", functools.partial(
            _relearn_body, options=learn.options()),
            {**gp_mod.program_inputs(state), "center": learn.center_of(state.mu)},
            {"x": state.x}, static=learn.options(), writes=gp_mod.POSTERIOR_FIELDS)
        state.hyper = _hyper_of(vals, state.hyper, learn.learn_noise)
        return state

    return relearn


def _learn_after(n_rounds: int, learn: Optional[LearnConfig]) -> tuple:
    """The rounds after whose AP a fused program re-learns (the serial
    cadence)."""
    if not (learn and learn.every):
        return ()
    return tuple(r for r in range(n_rounds) if (r + 1) % learn.every == 0)


def _fused_body(x, density=None, *, mesh, sel: _Selection, groups, rounds, learn_after, options,
                u_label, u_flip, relevant, sel_forbid, ap_exclude, n_real, center,
                **inputs) -> tuple:
    """``rounds`` rounds of one session (``groups`` None) or of a cohort as
    a program's body: each round's selection with round r of the fed draws
    (R, K, ...), the users' answers from the fed uniforms (R, [K,] b), the
    update (in place) and the APs of the gathered mean, the re-learn after
    the AP of each round in ``learn_after``.  Returns the APs ((R,) or
    (K, R)), the picks ((R, b) or (R, K, b)) and, where it re-learns, the
    final ((3,) or (K, 3)) (length_scale, var, noise)."""
    fed = {k: inputs.pop(k) for k in _DRAWN if k in inputs}
    params = StrategyParams.from_inputs(inputs)
    state = _body_state(x, density, groups=groups, **inputs)
    one = groups is None
    gather = _row_gather(mesh, state)
    label_prob, mistake_prob = per_session(params.label_prob), per_session(params.mistake_prob)
    aps, picks = [], []
    for r in range(rounds):
        st = gp_mod.stacked_view(state) if one else state
        batch = sel.picks(mesh, st, params, sel_forbid, n_real,
                          **{k: None if v is None else v[r] for k, v in fed.items()})
        if one:
            batch = batch[0]
        y, valid = feedback_from_uniforms(u_label[r], u_flip[r], batch, relevant, label_prob,
                                          mistake_prob)
        if one:
            gp_mod.gp_update(state, batch, y, valid, gather=gather)
        else:
            gp_mod.gp_update_stacked(state, batch, y, valid, gather=gather)
        aps.append(average_precision(gather_mu(mesh, state.mu), relevant, ap_exclude))
        picks.append(batch)
        if r in learn_after:
            st = gp_mod.stacked_view(state) if one else state
            _relearn_stack(mesh, st, options, center)
            if one:
                state.hyper = GPHyper(*(getattr(st.hyper, f)[0]
                                        for f in ("length_scale", "var", "noise")))
    out = (torch.stack(aps, -1), torch.stack(picks))
    if learn_after:
        h = state.hyper
        out += (torch.stack([h.length_scale, h.var, h.noise], -1),)
    return out


def _count_real(sel_forbid: torch.Tensor) -> int:
    """The real rows of a padded corpus, read once before a program."""
    return int(sel_forbid.shape[0] - int(sel_forbid.sum()))


def _fused_program(mesh, sel, name, states, draws, relevant, sel_forbid, ap_exclude, params,
                   fed, n_rounds, learn, *, one: bool):
    """Every round of one session (``one``) or of a cohort as one program,
    its draws made first in the eager order: round by round, each session's
    selection draws from its round's generator."""
    n_real = _count_real(sel_forbid)
    b = sel.batch_size
    if one:
        inputs, groups, shared = gp_mod.program_inputs(states), None, gp_mod.program_shared(states)
        counts, cap, like = [states.count], states.cap, states.mu
    else:
        inputs, groups, shared = _stack_inputs(states)
        counts, cap, like = list(states.counts), states.cap, states.mu
    gp_mod.check_capacity(counts, b * n_rounds, cap)
    per_round = []
    for rnd, (generators, _, _) in enumerate(draws[:n_rounds]):
        given = (fed[rnd] if fed else {})
        per_round.append(sel.draws([generators] if one else generators, n_real,
                                   sel_forbid.shape[0], like,
                                   **(_one(given) if one else given)))
    drawn = {k: None if per_round[0][k] is None else torch.stack([d[k] for d in per_round])
             for k in per_round[0]}
    after = _learn_after(n_rounds, learn)
    options = learn.options() if after else ()
    inputs.update(params.program_inputs(), **drawn,
                  u_label=torch.stack([d[1] for d in draws[:n_rounds]]),
                  u_flip=torch.stack([d[2] for d in draws[:n_rounds]]), relevant=relevant,
                  sel_forbid=sel_forbid, ap_exclude=ap_exclude, n_real=n_real,
                  center=learn.center_of(like) if after else None)
    aps, picks, *hyper = _program(
        mesh, name, functools.partial(_fused_body, sel=sel, groups=groups, rounds=n_rounds,
                                      learn_after=after, options=options),
        inputs, shared, static=(sel.static, groups, n_rounds, after, options),
        writes=gp_mod.SESSION_FIELDS)
    if one:
        states.count += b * n_rounds
        if hyper:
            states.hyper = _hyper_of(hyper[0], states.hyper, learn.learn_noise)
    else:
        _add_counts(states, b * n_rounds)
        if hyper:
            states.hyper = _hyper_of(hyper[0], states.hyper, learn.learn_noise)
            states.hyper_groups = [[k] for k in range(states.k)]
    return states, aps, picks


def make_sharded_session(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                         n_rounds: int = 10, learn: Optional[LearnConfig] = None, **options):
    """A whole session on the mesh: all ``n_rounds`` rounds of
    :func:`make_sharded_round` as one program with no host read between
    them (the reference's ``make_sharded_session``).

    Returns ``session_fn(state, draws, relevant, sel_forbid, ap_exclude,
    params, *, fed=None, picks=False) -> (state, aps)``, and the
    (n_rounds, b) picks last with ``picks``: ``draws[r]`` is round r's
    ``(generator, u_label, u_flip)`` (``runner.round_draws``, made before the
    first round; every round's selection draws are made from them before
    the program, in the eager order), ``fed[r]`` optional fed draws of round
    r's selection, and ``aps`` the (n_rounds,) AP curve on the device, which
    the caller reads once.  ``state`` is written in place.  ``learn``
    re-learns every ``learn.every`` rounds inside the program, rank 0's fit
    broadcast to every rank.  The rounds are the per-round path's, so the
    curves are its curves.
    """
    sel = _Selection.make(strategy, batch_size, options)

    def session(state, draws, relevant, sel_forbid, ap_exclude, params, *, fed=None,
                picks=False):
        out = _fused_program(mesh, sel, "sharded_session", state, draws, relevant, sel_forbid,
                             ap_exclude, params, fed, n_rounds, learn, one=True)
        return out if picks else out[:2]

    return session


def make_sharded_cohort_update(mesh: Mesh):
    """``update(states, idx, y, valid) -> states``: ``gp_update_stacked`` of K
    sessions' feedback blocks (K, b) on the mesh as one program, each at its
    own count and with its own hyperparameters; the rows of every session
    are gathered in one sum.  ``states``: a :class:`StackedGPState` shard,
    written in place, or K sessions' own states, which the program stacks
    inside and writes back into once it and its checks have run.  The
    density plays no part in an update, so sessions with different vectors
    share the program."""

    def update(states, idx, y, valid):
        inputs, groups, _ = _stack_inputs(states)
        x = states.x if isinstance(states, StackedGPState) else states[0].x
        caps = states.cap if isinstance(states, StackedGPState) else states[0].cap
        counts = (states.counts if isinstance(states, StackedGPState)
                  else [s.count for s in states])
        gp_mod.check_capacity(counts, idx.shape[-1], caps)
        _program(mesh, "sharded_cohort_update", functools.partial(_update_body, groups=groups),
                 {**inputs, "new_idx": idx, "new_y": y, "new_valid": valid}, {"x": x},
                 static=(groups,), writes=gp_mod.SESSION_FIELDS)
        _add_counts(states, idx.shape[-1])
        return states

    return update


def make_sharded_cohort(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                        n_rounds: int = 10, learn: Optional[LearnConfig] = None, **options):
    """A cohort of K sessions on the mesh, every round of all of them as one
    program with no host read between rounds (the reference's
    ``make_sharded_cohort``).

    Returns ``cohort_fn(st, draws, relevant, sel_forbid, ap_exclude, params,
    *, fed=None, picks=False) -> (st, aps)``, and the (n_rounds, K, b) picks
    last with ``picks``: ``st`` is this rank's shard of a
    :class:`~gp_mod.StackedGPState` (written in place), ``draws[r]`` round
    r's ``(generators, u_label, u_flip)`` (one generator per session, (K, b)
    uniforms), ``relevant`` and ``ap_exclude`` (K, N), ``sel_forbid`` (N,),
    and ``aps`` the (K, n_rounds) AP curves on the device.  A round is one
    cohort selection (:func:`make_sharded_cohort_select`'s body, every
    strategy), the users, one stacked update and the APs of one gathered
    (K, N) mean: its collectives are paid once for the cohort, not once per
    session.  ``learn`` re-learns the K sessions at once (one gather, one
    broadcast).  Each session's curve is its own session's.
    """
    sel = _Selection.make(strategy, batch_size, options)

    def cohort(st, draws, relevant, sel_forbid, ap_exclude, params, *, fed=None, picks=False):
        out = _fused_program(mesh, sel, "sharded_cohort", st, draws, relevant, sel_forbid,
                             ap_exclude, params, fed, n_rounds, learn, one=False)
        return out if picks else out[:2]

    return cohort


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def gather_session(mesh: Mesh, state: GPState) -> GPState:
    """The session with ``v``, ``mu``, ``sig2`` and ``density`` gathered over
    the padded corpus (the corpus stays the shard), and a factor ``l`` held
    in block-rows (the large-cap layout, ``parallel.bigcap``) gathered whole;
    every rank takes part."""
    l = state.l if state.l.shape[0] == state.cap else all_gather_cat(mesh, state.l)
    return dataclasses.replace(
        state, l=l, v=all_gather_cat(mesh, state.v.T).T, mu=all_gather_cat(mesh, state.mu),
        sig2=all_gather_cat(mesh, state.sig2),
        density=None if state.density is None else all_gather_cat(mesh, state.density))


def save_sharded_session(mesh: Mesh, path: str, state: GPState, extra=None) -> None:
    """Write the gathered session (:func:`gather_session`) in the
    single-device snapshot layout (``utils.checkpoint.save_session``).
    Every rank takes part in the gathers; rank 0 writes."""
    full = gather_session(mesh, state)
    if mesh.rank == 0:
        save_session(path, full, extra)


def load_sharded_session(mesh: Mesh, path: str, template: GPState):
    """A snapshot of :func:`save_sharded_session` re-sharded onto this rank,
    over ``template``'s shard of the corpus, with the factor ``l``
    replicated (the large-cap path lays it out again with
    ``bigcap.shard_state_bigcap``); returns ``(state, extras)``."""
    full, extras = load_session(path, template)
    lo, hi = _bounds(mesh, template.x.shape[0])
    density = full.density
    if density is not None and density is not template.density:
        density = density[lo:hi].contiguous()
    return dataclasses.replace(full, v=full.v[:, lo:hi].contiguous(), mu=full.mu[lo:hi].clone(),
                               sig2=full.sig2[lo:hi].clone(), density=density), extras
