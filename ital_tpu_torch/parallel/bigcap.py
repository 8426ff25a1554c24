"""Large-capacity sharded sessions: the distributed GP refit (port of
``ital_tpu.parallel.bigcap``).

When a session's labeled-slot capacity reaches ``GPConfig.chol2d_threshold``,
the runner's per-round mesh swaps its round for :func:`make_bigcap_round`:

* **Selection** is the sharded one (``parallel.sharded.make_sharded_select``),
  which reads only the corpus-sharded ``v``, ``mu`` and ``sig2``, so every
  strategy of the mesh runs at any cap.
* **Label absorption** replaces the replicated incremental append with a
  distributed refit (:func:`make_bigcap_fit`): each rank forms its block-row
  of K_ll and its columns of the cross-kernel, the distributed Cholesky
  (:mod:`ital_tpu_torch.parallel.chol2d`) factors K_ll, ``beta`` is a block
  forward substitution and ``v`` the 2-D whitening: O(cap^3 / p) flops and
  O(cap^2) bytes exchanged a round, and no rank holds the (cap, cap) factor.

The layout is ``parallel.sharded.shard_state``'s with ``l`` replaced by this
rank's (cap / p, cap) block-row (:func:`shard_state_bigcap`).  A snapshot
gathers the block-rows (``sharded.save_sharded_session``), so checkpoints
are interchangeable with the replicated path and the single-device one.
"""

from __future__ import annotations

import dataclasses

import torch

from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.gp import GPState
from ital_tpu_torch.ops.kernels import rbf_kernel
from ital_tpu_torch.parallel import sharded as sh
from ital_tpu_torch.parallel.chol2d import _check_divisible, _whiten_, chol2d_local, solve2d_local
from ital_tpu_torch.parallel.mesh import Mesh
from ital_tpu_torch.utils.metrics import average_precision, recall_at_k


def _rows_of(mesh: Mesh, cap: int) -> slice:
    cb = cap // mesh.size
    return slice(mesh.rank * cb, (mesh.rank + 1) * cb)


def shard_state_bigcap(state: GPState, mesh: Mesh, *, corpus_sharded: bool = False) -> GPState:
    """This rank's state in the large-cap layout: ``sharded.shard_state``'s, with
    ``l`` this rank's (cap / p, cap) block-row.

    ``corpus_sharded``: ``state`` is already this rank's corpus shard (as
    ``gp_set_query`` with the collective gather leaves it, or a load of a
    snapshot) whose ``l`` may still be replicated; only ``l`` is laid out.
    An ``l`` already in block-rows stays as it is.
    """
    _check_divisible(state.cap, mesh)
    if not corpus_sharded:
        state = sh.shard_state(state, mesh)
    if state.l.shape[0] == state.cap and mesh.size > 1:
        state = dataclasses.replace(state, l=state.l[_rows_of(mesh, state.cap)].clone())
    return state


def _bigcap_fit_local(mesh: Mesh, state: GPState) -> GPState:
    """The distributed refit of ``state`` (this rank's shard) from its label
    buffers: ``models.gp.gp_fit`` step by step, with the (cap, cap) system in
    block-rows.  Replaces ``l``, ``beta``, ``v``, ``mu`` and ``sig2`` and
    returns the state."""
    h = state.hyper
    active = state.active
    xl = sh.gather_rows(mesh, state.x, state.idx)  # (cap, D) replicated
    # A block of whole rows: contiguous, as the CUDA kernel needs.
    k_row = rbf_kernel(xl[_rows_of(mesh, state.cap)], xl, h.length_scale, h.var)
    l = chol2d_local(mesh, k_row, active, h.noise)  # (cb, cap)
    beta = solve2d_local(mesh, l, torch.where(active, state.y, 0.0)[:, None])[:, 0]

    k_cols = rbf_kernel(xl, state.x, h.length_scale, h.var, b2=state.x2)  # (cap, N/p)
    v = _whiten_(mesh, l, k_cols.masked_fill_(~active[:, None], 0.0))

    state.l = l
    state.beta = beta
    state.v = v
    state.mu = v.T @ beta
    state.sig2 = torch.clamp(h.var - (v * v).sum(0), min=1e-8)
    return state


def make_bigcap_fit(mesh: Mesh):
    """``fit(state) -> state``: the distributed refit from the label buffers
    (the large-cap ``gp_fit``; the runner's refit after a re-learn)."""

    def fit(state: GPState) -> GPState:
        _check_divisible(state.cap, mesh)
        return _bigcap_fit_local(mesh, state)

    return fit


def make_bigcap_round(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                      recall_ks: tuple = (), **options):
    """One feedback round of a large-cap session on the mesh.

    The signature and returns of ``parallel.sharded.make_sharded_round``
    (``round_fn(state, generator, u_label, u_flip, relevant, sel_forbid,
    ap_exclude, params, *, timer=None, **draws) -> (state, batch, ap,
    recalls)``), with ``state`` in the large-cap layout
    (:func:`shard_state_bigcap`).  The selection is the sharded one; the
    labels are written into the replicated buffers at ``count`` and absorbed
    by the distributed refit.  "select" times the selection and "update"
    the rest.
    """
    select = sh.make_sharded_select(mesh, strategy=strategy, batch_size=batch_size, **options)
    fit = make_bigcap_fit(mesh)

    def round_fn(state, generator, u_label, u_flip, relevant, sel_forbid, ap_exclude, params,
                 *, timer=None, **draws):
        if state.cap % mesh.size:
            raise ValueError(
                f"bigcap path: cap={state.cap} must divide the {mesh.size}-device mesh "
                f"(block-row layout); round the capacity up to a multiple of {mesh.size}")
        with sh._span(timer, "select"):
            batch = select(state, generator, sel_forbid, params, **draws)
        with sh._span(timer, "update"):
            y, valid = feedback_from_uniforms(u_label, u_flip, batch, relevant,
                                              params.label_prob, params.mistake_prob)
            c, b = state.count, batch.shape[0]
            gp_mod.check_capacity([c], b, state.cap)
            state.idx[c:c + b] = batch
            state.y[c:c + b] = torch.where(valid, y.to(state.y.dtype), 0.0)
            state.valid[c:c + b] = valid
            state.count = c + b
            state = fit(state)
            mu = sh.all_gather_cat(mesh, state.mu)
            ap = average_precision(mu, relevant, ap_exclude)
            recalls = [recall_at_k(mu, relevant, min(k, mu.shape[0]), ap_exclude)
                       for k in recall_ks]
        return state, batch, ap, recalls

    return round_fn
