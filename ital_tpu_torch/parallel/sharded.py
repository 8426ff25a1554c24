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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.gp import GPState
from ital_tpu_torch.ops import chol as chol_ops
from ital_tpu_torch.ops.kernels import rbf_kernel
from ital_tpu_torch.parallel.mesh import Mesh
from ital_tpu_torch.parallel.ring import ring_reduce_over_corpus
from ital_tpu_torch.select import STRATEGIES
from ital_tpu_torch.select import baselines as bl
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.select.ital import MAX_MI_BATCH, MI_BLOCK, draw_qmc_shifts, mi_scores_from_moments
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
    """(k,) global indices -> (k, ...) rows of a row-sharded array, replicated:
    each rank contributes the rows it owns and zeros elsewhere, and one sum
    assembles them (exactly: each entry is one value plus zeros).  Sums in at
    least f32, so a bf16 corpus crosses gloo too."""
    rel, ok = _owned(mesh, x_local.shape[0], gidx)
    wide = torch.promote_types(x_local.dtype, torch.float32)
    rows = x_local[rel].to(wide)
    rows = torch.where(ok.view(-1, *[1] * (rows.dim() - 1)), rows, 0.0)
    return psum(mesh, rows).to(x_local.dtype)


def gather_cols(mesh: Mesh, v_local: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """(k,) global indices -> (cap, k) columns of the column-sharded ``v``."""
    rel, ok = _owned(mesh, v_local.shape[1], gidx)
    return psum(mesh, torch.where(ok[None, :], v_local[:, rel], 0.0))


def gather_scalars(mesh: Mesh, s_local: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """(k,) global indices -> (k,) entries of a sharded vector, replicated."""
    rel, ok = _owned(mesh, s_local.shape[0], gidx)
    return psum(mesh, torch.where(ok, s_local[rel], 0.0))


def global_argmax(mesh: Mesh, scores_local: torch.Tensor, *,
                  offset: Optional[int] = None) -> torch.Tensor:
    """The global index (0-d int64) of the largest score over every shard;
    ties go to the lowest global index, as ``torch.argmax`` on the whole
    vector.  ``offset``: this shard's first global index (default
    ``rank * len(scores_local)``)."""
    off = mesh.rank * scores_local.shape[0] if offset is None else offset
    li = torch.argmax(scores_local)
    # One gather of (value, index) pairs; f64 holds both exactly.
    pair = torch.stack([scores_local[li].to(torch.float64), (li + off).to(torch.float64)])
    pairs = all_gather_cat(mesh, pair).view(mesh.size, 2)
    return pairs[torch.argmax(pairs[:, 0]), 1].to(torch.int64)


def local_slot_mask(mesh: Mesh, state: GPState, *, extra_forbid: torch.Tensor) -> torch.Tensor:
    """This shard's do-not-select mask: the labeled rows it owns, and
    ``extra_forbid`` (its pad rows)."""
    shard_n = state.x.shape[0]
    rel, ok = _owned(mesh, shard_n, state.idx)
    hits = torch.zeros(shard_n, dtype=torch.int32, device=state.idx.device)
    hits.index_add_(0, rel, (ok & state.active).to(torch.int32))
    return (hits > 0) | extra_forbid


def _sel_forbid_local(mesh: Mesh, state: GPState, sel_forbid: torch.Tensor) -> torch.Tensor:
    """The replicated (N,) forbid mask's rows of this shard."""
    lo, hi = _bounds(mesh, state.x.shape[0])
    return sel_forbid[lo:hi]


def _forbid_pick(mesh: Mesh, forbid: torch.Tensor, gidx: torch.Tensor) -> None:
    """Mark the picked global index ``gidx`` on the shard that owns it."""
    rel, ok = _owned(mesh, forbid.shape[0], gidx.reshape(1))
    forbid.index_put_((rel,), forbid[rel] | ok)


def _row_gather(mesh: Mesh, state: GPState) -> Callable[[torch.Tensor], torch.Tensor]:
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


def _empty_moments(state: GPState, n_cand: int):
    dt, dev = state.mu.dtype, state.mu.device
    return (torch.zeros((0,), dtype=dt, device=dev), torch.zeros((0, 0), dtype=dt, device=dev),
            torch.zeros((n_cand, 0), dtype=dt, device=dev))


def _sharded_ital_scores(mesh, state, batch, t, params, *, n_qmc, block, shift):
    """This shard's MI scores for greedy step ``t`` — the sharded full scan.
    Returns the scores and the step's moments ``(mu_b, cov_bb, cross)``,
    which the refinement reuses."""
    h = state.hyper
    if t > 0:
        xb, vb, mu_b, cov_bb = _batch_block(mesh, state, batch[:t])
        cov_bb = cov_bb + params.jitter * torch.eye(t, dtype=cov_bb.dtype, device=cov_bb.device)
        cross = rbf_kernel(state.x, xb, h.length_scale, h.var, a2=state.x2) - state.v.T @ vb
    else:
        mu_b, cov_bb, cross = _empty_moments(state, state.x.shape[0])
    scores = mi_scores_from_moments(state.mu, state.sig2 + params.jitter, cross, mu_b, cov_bb,
                                    params, t=t, n_qmc=n_qmc, block=block, shift=shift)
    return scores, (mu_b, cov_bb, cross)


def _sharded_pool_indices(mesh: Mesh, ranking_local: torch.Tensor, pool_size: int,
                          pool_padded: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Replicated ``(pool_gidx, pool_forbid)``: the global top-``pool_size``
    rows by ``ranking_local`` (ineligible rows already at -inf), padded to
    ``pool_padded`` slots with forbidden ones.

    Each shard's stable top-k is gathered in rank order and stably sorted,
    so ties go to the lowest global index, as ``top_k_stable`` (and
    ``jax.lax.top_k``) on the whole vector; slots on -inf rows come back
    flagged in ``pool_forbid``.
    """
    shard_n = ranking_local.shape[0]
    vals_l, idx_l = top_k_stable(ranking_local, min(pool_size, shard_n))
    vals = all_gather_cat(mesh, vals_l)
    gidx = all_gather_cat(mesh, idx_l + mesh.rank * shard_n)
    vals, order = torch.sort(vals, descending=True, stable=True)
    pool_gidx = gidx[order[:pool_size]]
    pool_forbid = ~torch.isfinite(vals[:pool_size])
    pad = pool_padded - pool_gidx.shape[0]
    if pad > 0:
        pool_gidx = torch.cat([pool_gidx, pool_gidx[:1].expand(pad)])
        pool_forbid = torch.cat([pool_forbid, pool_forbid.new_ones(pad)])
    return pool_gidx, pool_forbid


def _sharded_refined_pick(mesh, state, scores_masked, moments, params, *, t, refine_top,
                          refine_n_qmc, shift) -> torch.Tensor:
    """Two-stage greedy pick on the mesh (``select.ital.refined_pick``): the
    global top ``refine_top`` candidates by base score, their moments
    gathered, re-scored at ``refine_n_qmc`` points on every rank alike, so
    every rank takes the same winner without a second argmax exchange."""
    mu_b, cov_bb, cross = moments
    top_gidx, top_forbid = _sharded_pool_indices(mesh, scores_masked, refine_top, refine_top)
    mu_c = gather_scalars(mesh, state.mu, top_gidx)
    sig2_c = gather_scalars(mesh, state.sig2, top_gidx) + params.jitter
    cross_c = gather_rows(mesh, cross, top_gidx) if t else cross.new_zeros((refine_top, 0))
    refined = mi_scores_from_moments(mu_c, sig2_c, cross_c, mu_b, cov_bb, params, t=t,
                                     n_qmc=refine_n_qmc, shift=shift)
    refined = torch.where(top_forbid, -torch.inf, refined)
    return top_gidx[torch.argmax(refined)]


def _sharded_ital_pool_greedy(mesh, state, params, pool_gidx, pool_forbid, batch_size, *,
                              n_qmc, block, refine_top, refine_n_qmc, shifts) -> torch.Tensor:
    """Compact-pool greedy ITAL on the mesh (``select.ital``'s pool path).

    The pool's rows, kernel columns and moments are gathered once per
    selection; each rank scores its slice of the pool at each greedy step,
    and the argmax runs in pool positions (lowest position on ties, as the
    single-device pool vector).  With refinement the slices' scores are
    gathered and the re-score of the top runs on every rank alike.
    """
    h = state.hyper
    n_pool = pool_gidx.shape[0]
    pp = n_pool // mesh.size
    lo = mesh.rank * pp
    x_pool = gather_rows(mesh, state.x, pool_gidx)
    v_pool = gather_cols(mesh, state.v, pool_gidx)
    mu_pool = gather_scalars(mesh, state.mu, pool_gidx)
    sig2_pool = gather_scalars(mesh, state.sig2, pool_gidx) + params.jitter
    x_my, v_my = x_pool[lo:lo + pp], v_pool[:, lo:lo + pp]
    dev = pool_gidx.device
    forbid = pool_forbid.clone()
    batch = torch.zeros(batch_size, dtype=torch.int64, device=dev)
    pos = torch.zeros(batch_size, dtype=torch.int64, device=dev)
    for t in range(batch_size):
        shift = None if shifts is None else shifts[t]
        if t > 0:
            p = pos[:t]
            xb, vb, mu_b = x_pool[p], v_pool[:, p], mu_pool[p]
            cov_bb = (rbf_kernel(xb, xb, h.length_scale, h.var) - vb.T @ vb
                      + params.jitter * torch.eye(t, dtype=vb.dtype, device=dev))
            cross = rbf_kernel(x_my, xb, h.length_scale, h.var) - v_my.T @ vb
        else:
            mu_b, cov_bb, cross = _empty_moments(state, pp)
        scores = mi_scores_from_moments(mu_pool[lo:lo + pp], sig2_pool[lo:lo + pp], cross, mu_b,
                                        cov_bb, params, t=t, n_qmc=n_qmc, block=block,
                                        shift=shift)
        scores = torch.where(forbid[lo:lo + pp], -torch.inf, scores)
        if refine_top:
            vals, top = top_k_stable(all_gather_cat(mesh, scores), min(refine_top, n_pool))
            cross_top = all_gather_cat(mesh, cross)[top] if t else cross.new_zeros((top.shape[0], 0))
            refined = mi_scores_from_moments(mu_pool[top], sig2_pool[top], cross_top, mu_b, cov_bb,
                                             params, t=t, n_qmc=refine_n_qmc, shift=shift)
            win = top[torch.argmax(torch.where(torch.isfinite(vals), refined, -torch.inf))]
        else:
            win = global_argmax(mesh, scores, offset=lo)
        pos[t] = win
        batch[t] = pool_gidx[win]
        forbid[win] = True
    return batch


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
    ital_kw = dict(n_qmc=n_qmc, block=block)

    def select(state: GPState, generator, sel_forbid: torch.Tensor, params: StrategyParams, *,
               qmc_shifts: Optional[Sequence[torch.Tensor]] = None,
               subsample_uniforms: Optional[torch.Tensor] = None,
               uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_pad = sel_forbid.shape[0]
        lo, hi = _bounds(mesh, state.x.shape[0])
        pad_local = _sel_forbid_local(mesh, state, sel_forbid)
        forbid = local_slot_mask(mesh, state, extra_forbid=pad_local)
        valid_local = 1.0 - pad_local.to(state.mu.dtype)
        dev = state.mu.device

        def n_real() -> int:
            return int(n_pad - int(sel_forbid.sum()))

        if strategy == "random" and uniforms is None:
            uniforms = _padded_uniforms(generator, n_real(), n_pad, state.mu)
        if strategy == "ital":
            if subsample_size and subsample_uniforms is None:
                subsample_uniforms = _padded_uniforms(generator, n_real(), n_pad, state.mu)
            if randomize_qmc and qmc_shifts is None:
                qmc_shifts = draw_qmc_shifts(generator, batch_size, state.mu.dtype, dev)
            if pool_size or subsample_size:
                ranking = state.mu if pool_size else subsample_uniforms[lo:hi]
                size = min(pool_size or subsample_size, n_pad)
                pool_gidx, pool_forbid = _sharded_pool_indices(
                    mesh, torch.where(forbid, -torch.inf, ranking), size,
                    -(-size // mesh.size) * mesh.size)
                return _sharded_ital_pool_greedy(
                    mesh, state, params, pool_gidx, pool_forbid, batch_size,
                    refine_top=refine_top, refine_n_qmc=refine_n_qmc, shifts=qmc_shifts,
                    **ital_kw)

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
            n_corpus = n_real()
            n_lab = state.active.sum()
            unc = 1.0 - torch.tanh(state.mu).abs()

        batch = torch.zeros(batch_size, dtype=torch.int64, device=dev)
        for t in range(batch_size):
            moments = shift = None
            if strategy == "ital":
                shift = None if qmc_shifts is None else qmc_shifts[t]
                scores, moments = _sharded_ital_scores(mesh, state, batch, t, params,
                                                       shift=shift, **ital_kw)
            elif strategy == "ital_regression":
                scores = _sharded_regression_scores(mesh, state, batch, t, params)
            elif strategy == "emoc_batch":
                scores = _sharded_emoc_batch_scores(mesh, state, batch, t, valid_local)
            elif strategy in _DIVERSITY_BASES or strategy == "rbmal":
                sim = sim_lab
                if t > 0:
                    sim = torch.maximum(sim, _max_sim(mesh, state, batch[:t]))
                if strategy == "rbmal":
                    alpha = (n_corpus - n_lab - t).to(state.mu.dtype) / n_corpus
                    scores = alpha * (1.0 - sim) + (1.0 - alpha) * unc
                else:
                    scores = div_base - params.tradeoff * sim
            masked = torch.where(forbid, -torch.inf, scores)
            if strategy == "ital" and refine_top:
                nxt = _sharded_refined_pick(mesh, state, masked, moments, params, t=t,
                                            refine_top=min(refine_top, n_pad),
                                            refine_n_qmc=refine_n_qmc, shift=shift)
            else:
                nxt = global_argmax(mesh, masked)
            batch[t] = nxt
            _forbid_pick(mesh, forbid, nxt)
        return batch

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
# Checkpoints
# ---------------------------------------------------------------------------


def save_sharded_session(mesh: Mesh, path: str, state: GPState, extra=None) -> None:
    """Write the gathered session (``v``, ``mu``, ``sig2`` and ``density``
    over the padded corpus) in the single-device snapshot layout
    (``utils.checkpoint.save_session``).  Every rank takes part in the
    gathers; rank 0 writes."""
    full = dataclasses.replace(
        state, v=all_gather_cat(mesh, state.v.T).T, mu=all_gather_cat(mesh, state.mu),
        sig2=all_gather_cat(mesh, state.sig2),
        density=None if state.density is None else all_gather_cat(mesh, state.density))
    if mesh.rank == 0:
        save_session(path, full, extra)


def load_sharded_session(mesh: Mesh, path: str, template: GPState):
    """A snapshot of :func:`save_sharded_session` re-sharded onto this rank,
    over ``template``'s shard of the corpus; returns ``(state, extras)``."""
    full, extras = load_session(path, template)
    lo, hi = _bounds(mesh, template.x.shape[0])
    density = full.density
    if density is not None and density is not template.density:
        density = density[lo:hi].contiguous()
    return dataclasses.replace(full, v=full.v[:, lo:hi].contiguous(), mu=full.mu[lo:hi].clone(),
                               sig2=full.sig2[lo:hi].clone(), density=density), extras
