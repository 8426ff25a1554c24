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
``sig2`` (K, N/p).  Its ITAL greedy step exchanges every session's partial
batch in one sum and every session's argmax in one gather, so a cohort
round pays its collectives once, not once per session
(:func:`make_sharded_cohort_select`).  :func:`make_sharded_session` and
:func:`make_sharded_cohort` run all of a session's or a cohort's rounds
with no host read between them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.gp import GPHyper, GPState, StackedGPState
from ital_tpu_torch.models.hyperopt import LearnConfig, fit_hyperparams
from ital_tpu_torch.ops import chol as chol_ops
from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_sessions
from ital_tpu_torch.parallel.mesh import Mesh
from ital_tpu_torch.parallel.ring import ring_reduce_over_corpus
from ital_tpu_torch.select import STRATEGIES
from ital_tpu_torch.select import baselines as bl
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.select.ital import MAX_MI_BATCH, MI_BLOCK, _session_scores, draw_qmc_shifts
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


def gather_cols(mesh: Mesh, v_local: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """(k,) global indices -> (cap, k) columns of the column-sharded ``v``."""
    rel, ok = _owned(mesh, v_local.shape[1], gidx)
    return psum(mesh, torch.where(ok[None, :], v_local[:, rel], 0.0))


def gather_scalars(mesh: Mesh, s_local: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """(k,) global indices -> (k,) entries of a sharded vector, replicated."""
    rel, ok = _owned(mesh, s_local.shape[0], gidx)
    return psum(mesh, torch.where(ok, s_local[rel], 0.0))


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


def _sel_forbid_local(mesh: Mesh, state: GPState, sel_forbid: torch.Tensor) -> torch.Tensor:
    """The replicated (N,) forbid mask's rows of this shard."""
    lo, hi = _bounds(mesh, state.x.shape[0])
    return sel_forbid[lo:hi]


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


def _batch_block(mesh: Mesh, state: GPState, bsel: torch.Tensor):
    """Replicated ``(xb, vb, mu_b, k_bb - vb^T vb)`` of the partial batch
    ``bsel`` (t,): its rows, kernel columns, means and posterior covariance."""
    h = state.hyper
    xb = gather_rows(mesh, state.x, bsel)
    vb = gather_cols(mesh, state.v, bsel)
    mu_b = gather_scalars(mesh, state.mu, bsel)
    return xb, vb, mu_b, rbf_kernel(xb, xb, h.length_scale, h.var) - vb.T @ vb


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
    cov_bb = rbf_sessions(xs, xs, h.length_scale, h.var, groups) - vs.mT @ vs + params.jitter * eye
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
    mu_c, sig2_c = st.mu, st.sig2 + params.jitter
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
    sig2_pool = sig2_pool + params.jitter
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


def _sharded_ital(mesh, st, generators, sel_forbid, params, batch_size, *, n_qmc, block,
                  pool_size, subsample_size, refine_top, refine_n_qmc, randomize_qmc,
                  qmc_shifts=None, subsample_uniforms=None, n_real=None) -> torch.Tensor:
    """(K, batch_size) ITAL batches of the K sessions of the stack ``st`` on
    the mesh, each the batch the single-device ``select_ital`` picks for
    that session alone (``select_ital_stacked`` on the mesh).  Session k
    draws from ``generators[k]`` in the single-device order: its subsample
    uniforms over the real rows (padded), then one shift per greedy step.
    Fed draws: ``subsample_uniforms`` (K, N) and ``qmc_shifts``, one (K, t)
    shift per step t.  ``n_real``: the real rows, where the caller knows
    them (else one read of ``sel_forbid``)."""
    n_pad, n_loc = sel_forbid.shape[0], st.x.shape[0]
    lo, hi = _bounds(mesh, n_loc)
    dt, dev = st.mu.dtype, st.mu.device
    draw_u = subsample_size and subsample_uniforms is None
    draw_shifts = randomize_qmc and qmc_shifts is None
    if draw_u or draw_shifts:
        if draw_u and n_real is None:
            n_real = int(n_pad - int(sel_forbid.sum()))
        us, shifts = [], []
        for g in generators:
            if draw_u:
                us.append(_padded_uniforms(g, n_real, n_pad, st.mu))
            if draw_shifts:
                shifts.append(draw_qmc_shifts(g, batch_size, dt, dev))
        if draw_u:
            subsample_uniforms = torch.stack(us)
        if draw_shifts:
            qmc_shifts = [torch.stack([s[t] for s in shifts]) for t in range(batch_size)]
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


def _ring_colabs(mesh: Mesh, state: GPState, v: torch.Tensor, valid_local: torch.Tensor):
    """``sum_x |k_post(x, c)|`` over every shard's real rows ``x``, for this
    shard's candidates ``c``, by a ring pass.

    Each rank keeps its candidates' columns of ``v`` (the state's whitened
    kernel, or batch EMOC's augmented one) and takes each visiting shard's
    rows in blocks of ``COLABS_BLOCK`` of its candidates, as the
    single-device ``blockwise_reduce_abs_kpost`` does, so no (N/p, N/p)
    block is ever held.  ``valid_local`` (1 on real rows, 0 on pads)
    travels with the rows and weighs them.
    """
    h = state.hyper
    n_loc = state.x.shape[0]

    def acc_fn(acc, blk):
        xb, x2b, vb, valid_b = blk
        parts = []
        for lo in range(0, n_loc, COLABS_BLOCK):
            c = slice(lo, lo + COLABS_BLOCK)
            k = rbf_kernel(xb, state.x[c], h.length_scale, h.var, a2=x2b, b2=state.x2[c])
            k_post = (k - vb.T @ v[:, c]).abs_()
            parts.append(k_post.mul_(valid_b[:, None]).sum(0))
        return acc + torch.cat(parts)

    zero = torch.zeros(n_loc, dtype=state.mu.dtype, device=state.mu.device)
    return ring_reduce_over_corpus(mesh, (state.x, state.x2, v, valid_local), acc_fn, zero)


def _sharded_emoc_scores(mesh, state, valid_local):
    """EMOC on the mesh (``baselines.select_emoc``)."""
    colabs = _ring_colabs(mesh, state, state.v, valid_local)
    return bl.emoc_scores_from_moments(state.mu, state.sig2, state.hyper.noise, colabs)


def _sharded_emoc_batch_scores(mesh, state, batch, t, valid_local):
    """Batch EMOC on the mesh (``baselines.select_emoc_batch``): the block
    hypothetical update from the partial batch's gathered moments (its
    (t, t) factor replicated, the whitening rows ``w`` shard-local), then
    the ring with ``v`` augmented by ``w``."""
    if t == 0:
        return _sharded_emoc_scores(mesh, state, valid_local)
    h = state.hyper
    xb, vb, mu_b, cov = _batch_block(mesh, state, batch[:t])
    cross = (rbf_kernel(state.x, xb, h.length_scale, h.var, a2=state.x2) - state.v.T @ vb).T
    valid = torch.ones(t, dtype=torch.bool, device=mu_b.device)
    y_hyp = torch.where(mu_b >= 0.0, 1.0, -1.0)
    resid = torch.where(valid, y_hyp.to(state.mu.dtype) - mu_b, 0.0)
    cross = torch.where(valid[:, None], cross, 0.0)
    la = chol_ops.padded_cholesky(cov, valid, h.noise)
    w = chol_ops.tri_solve(la, cross)  # (t, n_loc)
    g = chol_ops.tri_solve(la, resid[:, None])[:, 0]
    mu_h = state.mu + w.T @ g
    sig2_h = torch.clamp(state.sig2 - (w * w).sum(0), min=1e-8)
    colabs = _ring_colabs(mesh, state, torch.cat([state.v, w]), valid_local)
    return bl.emoc_scores_from_moments(mu_h, sig2_h, h.noise, colabs)


def _sharded_mcmi_scores(mesh, state, valid_local):
    """MCMI[min] on the mesh (``baselines.select_mcmi_min``): for each of
    this shard's candidates and both hypothetical labels, the binary entropy
    of the one-point-updated posterior summed over every shard's real rows
    by a ring pass, in blocks of ``MCMI_BLOCK`` candidates; the score is
    ``-max_y`` of the two sums."""
    h = state.hyper
    n_loc = state.x.shape[0]

    def acc_fn(acc, blk):
        xb, x2b, vb, mub, sig2b, valid_b = blk
        pos, neg = [], []
        for lo in range(0, n_loc, MCMI_BLOCK):
            c = slice(lo, lo + MCMI_BLOCK)
            k_post = rbf_kernel(xb, state.x[c], h.length_scale, h.var, a2=x2b) - vb.T @ state.v[:, c]
            denom = state.sig2[c] + h.noise
            # The variance shrink does not depend on the label.
            sig_new = torch.sqrt(torch.clamp(sig2b[:, None] - k_post**2 / denom, min=1e-8))

            def total_entropy(y):
                mu_new = mub[:, None] + k_post * ((y - state.mu[c]) / denom)
                return (bl._binary_entropy(bl._phi(mu_new / sig_new)) * valid_b[:, None]).sum(0)

            pos.append(total_entropy(1.0))
            neg.append(total_entropy(-1.0))
        return acc[0] + torch.cat(pos), acc[1] + torch.cat(neg)

    zero = torch.zeros(n_loc, dtype=state.mu.dtype, device=state.mu.device)
    h_pos, h_neg = ring_reduce_over_corpus(
        mesh, (state.x, state.x2, state.v, state.mu, state.sig2, valid_local), acc_fn,
        (zero, zero.clone()))
    return -torch.maximum(h_pos, h_neg)


def _sharded_density_local(mesh: Mesh, state: GPState, pad_local: torch.Tensor) -> torch.Tensor:
    """(n_loc,) mean RBF similarity (var 1) of each of this shard's rows to
    every real corpus row, by a ring pass (``models.gp.corpus_density``):
    pad rows count in neither the sum nor the denominator."""
    ls = state.hyper.length_scale
    n_loc = state.x.shape[0]
    valid_local = 1.0 - pad_local.to(state.mu.dtype)

    def acc_fn(acc, blk):
        xb, x2b, valid_b = blk
        sums = [rbf_kernel(state.x[r], xb, ls, 1.0, a2=state.x2[r], b2=x2b).mul_(valid_b).sum(1)
                for r in (slice(lo, lo + DENSITY_BLOCK) for lo in range(0, n_loc, DENSITY_BLOCK))]
        return acc[0] + torch.cat(sums), acc[1] + valid_b.sum()

    zero = torch.zeros(n_loc, dtype=state.mu.dtype, device=state.mu.device)
    s, cnt = ring_reduce_over_corpus(mesh, (state.x, state.x2, valid_local), acc_fn,
                                     (zero, zero.new_zeros(())))
    return s / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# The baselines on the shard
# ---------------------------------------------------------------------------


def _max_sim(mesh: Mesh, state: GPState, members: torch.Tensor, keep=None) -> torch.Tensor:
    """(n_loc,) max RBF similarity (var 1) of each local row to the corpus
    rows ``members`` (those where ``keep`` holds): ``baselines._max_sim_to``."""
    xm = gather_rows(mesh, state.x, members)
    sims = rbf_kernel(state.x, xm, state.hyper.length_scale, 1.0, a2=state.x2)
    if keep is not None:
        sims = torch.where(keep[None, :], sims, -torch.inf)
    return sims.amax(1)


def _sharded_regression_scores(mesh, state, batch, t, params):
    """Greedy log-det MI on the mesh (``select.regression``): each local
    candidate's variance conditional on the partial batch."""
    h = state.hyper
    if t == 0:
        cond_var = state.sig2
    else:
        xb, vb, _, cov_bb = _batch_block(mesh, state, batch[:t])
        eye = torch.eye(t, dtype=cov_bb.dtype, device=cov_bb.device)
        cov_bb = cov_bb + (h.noise + params.jitter) * eye
        cross = rbf_kernel(state.x, xb, h.length_scale, h.var, a2=state.x2) - state.v.T @ vb
        w = torch.linalg.solve_triangular(torch.linalg.cholesky(cov_bb), cross.T, upper=False)
        cond_var = torch.clamp(state.sig2 - (w * w).sum(0), min=1e-10)
    return 0.5 * torch.log1p(cond_var / h.noise)


# Batch-independent scores of the cheap baselines, from the local state.
_LOCAL_SCORES = {
    "topscoring": lambda s, p: s.mu,
    "variance_sampling": lambda s, p: s.sig2,
    "uncertainty_sampling": lambda s, p: -s.mu.abs() / torch.sqrt(s.sig2),
    "borderline_sampling": lambda s, p: -s.mu.abs(),
    "entropy_sampling": lambda s, p: bl._binary_entropy(bl._p_relevant(s)),
    "sud": lambda s, p: bl._binary_entropy(bl._p_relevant(s)) * bl._density(s),
    "adapt_al": lambda s, p: (torch.pow(bl._binary_entropy(bl._p_relevant(s)) + bl._EPS, p.tradeoff)
                              * torch.pow(bl._density(s) + bl._EPS, 1.0 - p.tradeoff)),
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


def _padded_uniforms(generator, n_real: int, n_pad: int, like: torch.Tensor) -> torch.Tensor:
    """The single-device path's (n_real,) uniform draw, zero-padded to the
    mesh's rows: every rank draws it whole from a generator seeded alike."""
    u = torch.rand(n_real, generator=generator, dtype=like.dtype, device=like.device)
    return torch.cat([u, u.new_zeros(n_pad - n_real)])


# ---------------------------------------------------------------------------
# The round and its entry points
# ---------------------------------------------------------------------------


def make_sharded_select(
    mesh: Mesh,
    *,
    strategy: str = "ital",
    batch_size: int = 4,
    n_qmc: int = 128,
    block: int = MI_BLOCK,
    pool_size: int = 0,
    subsample_size: int = 0,
    refine_top: int = 0,
    refine_n_qmc: int = 512,
    randomize_qmc: bool = False,
):
    """The selection step on the mesh.

    Returns ``select(state, generator, sel_forbid, params, *, qmc_shifts=None,
    subsample_uniforms=None, uniforms=None) -> (batch_size,)`` replicated
    global indices.  ``state`` is this rank's shard (:func:`shard_state`),
    ``sel_forbid`` the replicated (N,) bool mask of rows never to select
    (the pad rows; labeled rows are excluded as on every path), and
    ``generator`` (on the mesh's device, seeded alike on every rank) feeds
    the random draws in the single-device order: ``random``'s and ITAL's
    subsample uniforms over the real rows, then one QMC shift per greedy
    step.  Fed draws replace them: ``qmc_shifts`` (one (t,) shift per step
    t), ``subsample_uniforms`` or ``uniforms`` (``random``), each (N,) over
    the padded rows.  Options are ITAL's (``select.ital.select_ital``);
    every registered strategy runs.
    """
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy!r}; available: {sorted(STRATEGIES)}")
    if strategy not in SHARDED_STRATEGIES:
        raise NotImplementedError(f"strategy {strategy!r} has no sharded form")
    if strategy == "ital" and batch_size > MAX_MI_BATCH:
        raise ValueError(f"ITAL batch_size={batch_size} exceeds the supported maximum "
                         f"{MAX_MI_BATCH} (3^m feedback table and QMC accuracy)")
    if pool_size and subsample_size:
        raise ValueError("pool_size and subsample_size are mutually exclusive candidate "
                         "restrictions (reference ITAL applies one or the other)")
    ital_kw = _ital_options(n_qmc=n_qmc, block=block, pool_size=pool_size,
                            subsample_size=subsample_size, refine_top=refine_top,
                            refine_n_qmc=refine_n_qmc, randomize_qmc=randomize_qmc)

    def select(state: GPState, generator, sel_forbid: torch.Tensor, params: StrategyParams, *,
               qmc_shifts: Optional[Sequence[torch.Tensor]] = None,
               subsample_uniforms: Optional[torch.Tensor] = None,
               uniforms: Optional[torch.Tensor] = None,
               n_real: Optional[int] = None) -> torch.Tensor:
        if strategy == "ital":
            return _sharded_ital(
                mesh, gp_mod.stacked_view(state), [generator], sel_forbid, params, batch_size,
                qmc_shifts=None if qmc_shifts is None else [s[None] for s in qmc_shifts],
                subsample_uniforms=None if subsample_uniforms is None else subsample_uniforms[None],
                n_real=n_real, **ital_kw)[0]
        n_pad = sel_forbid.shape[0]
        lo, hi = _bounds(mesh, state.x.shape[0])
        pad_local = _sel_forbid_local(mesh, state, sel_forbid)
        forbid = local_slot_mask(mesh, state, extra_forbid=pad_local)
        valid_local = 1.0 - pad_local.to(state.mu.dtype)
        if n_real is None and strategy in ("random", "rbmal"):
            n_real = int(n_pad - int(sel_forbid.sum()))

        if strategy == "random" and uniforms is None:
            uniforms = _padded_uniforms(generator, n_real, n_pad, state.mu)
        scores = None
        if strategy in _LOCAL_SCORES:
            scores = _LOCAL_SCORES[strategy](state, params)
        elif strategy == "random":
            scores = uniforms[lo:hi]
        elif strategy == "emoc":
            scores = _sharded_emoc_scores(mesh, state, valid_local)
        elif strategy == "mcmi_min":
            scores = _sharded_mcmi_scores(mesh, state, valid_local)
        if strategy in _DIVERSITY_BASES or strategy == "rbmal":
            # Invariant over the greedy steps: one gather a selection.
            sim_lab = torch.clamp(_max_sim(mesh, state, state.idx, state.active), min=0.0)
        if strategy in _DIVERSITY_BASES:
            div_base = _DIVERSITY_BASES[strategy](state)
        if strategy == "rbmal":
            n_lab = state.active.sum()
            unc = 1.0 - torch.tanh(state.mu).abs()

        batch = torch.zeros(batch_size, dtype=torch.int64, device=state.mu.device)
        for t in range(batch_size):
            if strategy == "ital_regression":
                scores = _sharded_regression_scores(mesh, state, batch, t, params)
            elif strategy == "emoc_batch":
                scores = _sharded_emoc_batch_scores(mesh, state, batch, t, valid_local)
            elif strategy in _DIVERSITY_BASES or strategy == "rbmal":
                sim = sim_lab
                if t > 0:
                    sim = torch.maximum(sim, _max_sim(mesh, state, batch[:t]))
                if strategy == "rbmal":
                    alpha = (n_real - n_lab - t).to(state.mu.dtype) / n_real
                    scores = alpha * (1.0 - sim) + (1.0 - alpha) * unc
                else:
                    scores = div_base - params.tradeoff * sim
            nxt = global_argmax(mesh, torch.where(forbid, -torch.inf, scores))
            batch[t] = nxt
            _forbid_pick(mesh, forbid, nxt)
        return batch

    return select


def _ital_options(*, n_qmc: int = 128, block: int = MI_BLOCK, pool_size: int = 0,
                  subsample_size: int = 0, refine_top: int = 0, refine_n_qmc: int = 512,
                  randomize_qmc: bool = False) -> dict:
    """ITAL's options with the defaults of :func:`make_sharded_select`."""
    return dict(n_qmc=n_qmc, block=block, pool_size=pool_size, subsample_size=subsample_size,
                refine_top=refine_top, refine_n_qmc=refine_n_qmc, randomize_qmc=randomize_qmc)


def make_sharded_cohort_select(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                               **options):
    """The selection of K sessions over one corpus shard at once (the
    reference's session-batched ``make_sharded_cohort_select``).

    Returns ``select(st, generators, sel_forbid, params, *, qmc_shifts=None,
    subsample_uniforms=None, uniforms=None, n_real=None) -> (K, batch_size)``
    for this rank's shard ``st`` of a :class:`~gp_mod.StackedGPState`
    (:func:`shard_cohort_state`), each row the batch
    :func:`make_sharded_select` picks for that session alone with its own
    generator and hyperparameters.  Fed draws are (K, ...): ``qmc_shifts``
    one (K, t) shift per step, ``subsample_uniforms`` and ``uniforms``
    (K, N).  ``options`` as :func:`make_sharded_select`.  For ITAL a greedy
    step's exchanges serve every session at once (:func:`_sharded_ital`),
    so a round pays its collectives once for the cohort; the other
    strategies select session by session.
    """
    select_one = make_sharded_select(mesh, strategy=strategy, batch_size=batch_size, **options)
    ital_kw = _ital_options(**options)

    def select(st: StackedGPState, generators, sel_forbid: torch.Tensor, params: StrategyParams,
               *, qmc_shifts=None, subsample_uniforms=None, uniforms=None,
               n_real: Optional[int] = None) -> torch.Tensor:
        if strategy == "ital":
            return _sharded_ital(mesh, st, generators, sel_forbid, params, batch_size,
                                 qmc_shifts=qmc_shifts, subsample_uniforms=subsample_uniforms,
                                 n_real=n_real, **ital_kw)
        return torch.stack([
            select_one(gp_mod.session_state(st, k), g, sel_forbid, params, n_real=n_real,
                       uniforms=None if uniforms is None else uniforms[k])
            for k, g in enumerate(generators)])

    return select


def _span(timer, name: str):
    return contextlib.nullcontext() if timer is None else timer.span(name)


def make_sharded_round(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                       recall_ks: tuple = (), **options):
    """One feedback round on the mesh: select, the simulated user, the GP
    update, then AP and recall@k of the gathered posterior mean.

    Returns ``round_fn(state, generator, u_label, u_flip, relevant,
    sel_forbid, ap_exclude, params, *, timer=None, **draws) -> (state,
    batch, ap, recalls)``.  ``generator`` and ``draws`` are the selection's
    (:func:`make_sharded_select`, whose ``options`` this takes);
    ``u_label``/``u_flip`` (b,) the user's uniforms
    (``data.user.feedback_from_uniforms``); ``relevant``, ``sel_forbid`` and
    ``ap_exclude`` replicated (N,) bools over the padded rows.  ``recalls``
    holds one 0-d tensor per k of ``recall_ks``.  With a ``timer``
    (``utils.logging.Timer``) the selection is its "select" span and the rest
    its "update" span, as in the single-device runner.
    """
    select = make_sharded_select(mesh, strategy=strategy, batch_size=batch_size, **options)

    def round_fn(state, generator, u_label, u_flip, relevant, sel_forbid, ap_exclude, params,
                 *, timer=None, **draws):
        with _span(timer, "select"):
            batch = select(state, generator, sel_forbid, params, **draws)
        with _span(timer, "update"):
            y, valid = feedback_from_uniforms(u_label, u_flip, batch, relevant,
                                              params.label_prob, params.mistake_prob)
            state = gp_mod.gp_update(state, batch, y, valid, gather=_row_gather(mesh, state))
            mu = all_gather_cat(mesh, state.mu)
            ap = average_precision(mu, relevant, ap_exclude)
            recalls = [recall_at_k(mu, relevant, min(k, mu.shape[0]), ap_exclude)
                       for k in recall_ks]
        return state, batch, ap, recalls

    return round_fn


def make_sharded_update(mesh: Mesh):
    """``update(state, idx, y, valid) -> state``: ``gp_update`` of real
    feedback on the mesh, the rows gathered across ranks."""
    return lambda state, idx, y, valid: gp_mod.gp_update(state, idx, y, valid,
                                                         gather=_row_gather(mesh, state))


def make_sharded_set_query(mesh: Mesh):
    """``set_query(state, query_idx) -> state``: ``gp_set_query`` on the mesh."""
    return lambda state, q: gp_mod.gp_set_query(state, q, gather=_row_gather(mesh, state))


def make_sharded_fit(mesh: Mesh):
    """``fit(state) -> state``: ``gp_fit`` on the mesh (a refit after the
    hyperparameters change)."""
    return lambda state: gp_mod.gp_fit(state, gather=_row_gather(mesh, state))


def make_sharded_density(mesh: Mesh):
    """``density(state, pad_mask) -> (N/p,)`` this shard's rows of the corpus
    density over the real rows (``pad_mask``: the replicated (N,) pad
    flags); attach it as ``state.density``."""
    return lambda state, pad: _sharded_density_local(
        mesh, state, _sel_forbid_local(mesh, state, pad))


# ---------------------------------------------------------------------------
# Fused sessions and cohorts: every round of a session, or of K sessions, with
# no host read between rounds
# ---------------------------------------------------------------------------


def relearn(mesh: Mesh, state: GPState, learn: LearnConfig) -> GPState:
    """Re-learn a session's hyperparameters from its labels and refit it on
    the mesh (the reference's ``_relearn`` in the fused loop).

    The labeled rows are gathered (one sum), every rank runs the ascent on
    them, and rank 0's three values are broadcast, so the ranks go on with
    one fit bit for bit whatever their arithmetic; the refit is ``gp_fit``
    with the collective gather.
    """
    rows = gather_rows(mesh, state.x, state.idx)
    h = fit_hyperparams(rows, state.y, state.active, state.hyper, **learn.fit_kwargs(state.mu))
    vals = torch.stack([h.length_scale, h.var, h.noise]).detach().to(state.mu.dtype).contiguous()
    dist.broadcast(vals, src=0, group=mesh.group)
    state.hyper = GPHyper(length_scale=vals[0], var=vals[1], noise=vals[2])
    return gp_mod.gp_fit(state, gather=_row_gather(mesh, state))


def _fused(n_rounds: int, advance, learn: Optional[LearnConfig], relearn_fn, state):
    """``n_rounds`` of ``advance(state, rnd) -> (state, ap)``, the re-learn
    after the AP of every ``learn.every``-th round (the serial cadence); the
    APs stay on the device, stacked along the last axis."""
    aps = []
    for rnd in range(n_rounds):
        state, ap = advance(state, rnd)
        if learn and learn.every and (rnd + 1) % learn.every == 0:
            state = relearn_fn(state)
        aps.append(ap)
    return state, torch.stack(aps, -1)


def _count_real(sel_forbid: torch.Tensor) -> int:
    """The real rows of a padded corpus, read once before a session's rounds."""
    return int(sel_forbid.shape[0] - int(sel_forbid.sum()))


def make_sharded_session(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                         n_rounds: int = 10, learn: Optional[LearnConfig] = None, **options):
    """A whole session on the mesh: all ``n_rounds`` rounds of
    :func:`make_sharded_round` with no host read between them (the
    reference's ``make_sharded_session``).

    Returns ``session_fn(state, draws, relevant, sel_forbid, ap_exclude,
    params, *, fed=None) -> (state, aps)``: ``draws[r]`` is round r's
    ``(generator, u_label, u_flip)`` (``runner.round_draws``, made before the
    first round), ``fed[r]`` optional fed draws of round r's selection, and
    ``aps`` the (n_rounds,) AP curve on the device, which the caller reads
    once.  ``learn`` re-learns every ``learn.every`` rounds (:func:`relearn`).
    The rounds are the per-round path's, so the curves are its curves.
    """
    round_fn = make_sharded_round(mesh, strategy=strategy, batch_size=batch_size, **options)

    def session(state, draws, relevant, sel_forbid, ap_exclude, params, *, fed=None):
        n_real = _count_real(sel_forbid)

        def advance(st, rnd):
            st, _, ap, _ = round_fn(st, *draws[rnd], relevant, sel_forbid, ap_exclude, params,
                                    n_real=n_real, **(fed[rnd] if fed else {}))
            return st, ap

        return _fused(n_rounds, advance, learn, lambda st: relearn(mesh, st, learn), state)

    return session


def make_sharded_cohort_update(mesh: Mesh):
    """``update(st, idx, y, valid) -> st``: ``gp_update_stacked`` of K
    sessions' feedback blocks (K, b) on the mesh, each at its own count and
    with its own hyperparameters; the rows of every session are gathered in
    one sum.  The density plays no part in an update: a caller that stacked
    sessions with different vectors writes the results back into each
    session (``models.gp.unstack_into``), which keeps its own."""
    return lambda st, idx, y, valid: gp_mod.gp_update_stacked(st, idx, y, valid,
                                                              gather=_row_gather(mesh, st))


def make_sharded_cohort(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                        n_rounds: int = 10, learn: Optional[LearnConfig] = None, **options):
    """A cohort of K sessions on the mesh, every round of all of them with no
    host read between rounds (the reference's ``make_sharded_cohort``).

    Returns ``cohort_fn(st, draws, relevant, sel_forbid, ap_exclude, params,
    *, fed=None) -> (st, aps)``: ``st`` is this rank's shard of a
    :class:`~gp_mod.StackedGPState`, ``draws[r]`` round r's ``(generators,
    u_label, u_flip)`` (one generator per session, (K, b) uniforms),
    ``relevant`` and ``ap_exclude`` (K, N), ``sel_forbid`` (N,), and ``aps``
    the (K, n_rounds) AP curves on the device.  A round is one cohort
    selection (:func:`make_sharded_cohort_select`), the users, one
    :func:`make_sharded_cohort_update` and the APs of one gathered (K, N)
    mean: for ITAL its collectives are paid once for the cohort, not once
    per session.  ``learn`` re-learns each session apart
    (:func:`relearn`).  Each session's curve is its own session's.
    """
    select = make_sharded_cohort_select(mesh, strategy=strategy, batch_size=batch_size, **options)
    update = make_sharded_cohort_update(mesh)

    def cohort(st, draws, relevant, sel_forbid, ap_exclude, params, *, fed=None):
        n_real = _count_real(sel_forbid)

        def advance(stk, rnd):
            generators, u_label, u_flip = draws[rnd]
            batch = select(stk, generators, sel_forbid, params, n_real=n_real,
                           **(fed[rnd] if fed else {}))
            y, valid = feedback_from_uniforms(u_label, u_flip, batch, relevant,
                                              params.label_prob, params.mistake_prob)
            update(stk, batch, y, valid)
            return stk, average_precision(gather_mu(mesh, stk.mu), relevant, ap_exclude)

        def relearn_all(stk):
            gp_mod.refit_stacked(stk, lambda one: relearn(mesh, one, learn))
            return stk

        return _fused(n_rounds, advance, learn, relearn_all, st)

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
