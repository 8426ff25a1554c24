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

The refit and the round's absorption are programs of the mesh (the
reference's two ``jax.jit``s; ``graphs.run(..., mesh=mesh)``): on the card
one CUDA graph per rank with the collectives inside, each writing the
session's buffers in place.  The cross-kernel is formed in ``v``'s own
buffer and whitened there, so the body leaves no (cap, N/p) temporary in
the graph pool.  The program's static inputs are another matter: like every
program of ``graphs.run`` it keeps its own copy of each input, ``v``
included, copies the session's ``v`` in before a replay and back out after
it.  So each large-cap program holds one more (cap, N/p) block per rank for
the life of the process, and every call moves two.

The layout is ``parallel.sharded.shard_state``'s with ``l`` replaced by this
rank's (cap / p, cap) block-row (:func:`shard_state_bigcap`).  A snapshot
gathers the block-rows (``sharded.save_sharded_session``), so checkpoints
are interchangeable with the replicated path and the single-device one.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.gp import GPState
from ital_tpu_torch.ops.chol import write_rows
from ital_tpu_torch.ops.kernels import rbf_kernel
from ital_tpu_torch.parallel import sharded as sh
from ital_tpu_torch.parallel.chol2d import _check_divisible, _whiten_, chol2d_local, solve2d_local
from ital_tpu_torch.parallel.mesh import Mesh
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.utils.metrics import average_precision, recall_at_k


# Rows of v squared at a time for sig2: a (128, N/p) temporary, not (cap, N/p).
SQ_ROWS = 128


def _rows_of(mesh: Mesh, cap: int) -> slice:
    cb = cap // mesh.size
    return slice(mesh.rank * cb, (mesh.rank + 1) * cb)


def shard_state_bigcap(state: GPState, mesh: Mesh, *, corpus_sharded: bool = False) -> GPState:
    """This rank's state in the large-cap layout: ``sharded.shard_state``'s, with
    ``l`` this rank's (cap / p, cap) block-row, row-major as the programs
    take it.

    ``corpus_sharded``: ``state`` is already this rank's corpus shard (as
    ``gp_set_query`` with the collective gather leaves it, or a load of a
    snapshot) whose ``l`` may still be replicated; only ``l`` is laid out.
    An ``l`` already in block-rows keeps its values.
    """
    _check_divisible(state.cap, mesh)
    if not corpus_sharded:
        state = sh.shard_state(state, mesh)
    if state.l.shape[0] == state.cap and mesh.size > 1:
        state = dataclasses.replace(
            state, l=state.l[_rows_of(mesh, state.cap)].clone(
                memory_format=torch.contiguous_format))
    elif not state.l.is_contiguous():
        state = dataclasses.replace(state, l=state.l.contiguous())
    return state


def _refit_(mesh: Mesh, state: GPState) -> None:
    """The distributed refit of ``state`` (this rank's shard) from its label
    buffers: ``models.gp.gp_fit`` step by step, with the (cap, cap) system in
    block-rows, written into ``l``, ``beta``, ``v``, ``mu`` and ``sig2`` in
    place.  Reads nothing to the host: a program's body."""
    h = state.hyper
    active = state.active
    xl = sh.gather_rows(mesh, state.x, state.idx)  # (cap, D) replicated
    # A block of whole rows: contiguous, as the CUDA kernel needs.
    k_row = rbf_kernel(xl[_rows_of(mesh, state.cap)], xl, h.length_scale, h.var)
    state.l.copy_(chol2d_local(mesh, k_row, active, h.noise))  # (cb, cap)
    state.beta.copy_(solve2d_local(mesh, state.l,
                                   torch.where(active, state.y, 0.0)[:, None])[:, 0])
    v = rbf_kernel(xl, state.x, h.length_scale, h.var, b2=state.x2, out=state.v)  # (cap, N/p)
    _whiten_(mesh, state.l, v.masked_fill_(~active[:, None], 0.0))
    torch.matmul(v.T, state.beta, out=state.mu)
    torch.clamp(h.var - _column_sq_sums(v), min=1e-8, out=state.sig2)


def _column_sq_sums(v: torch.Tensor) -> torch.Tensor:
    """``(v * v).sum(0)`` over :data:`SQ_ROWS` rows at a time, so that no
    second (cap, N/p) block is allocated."""
    out = v.new_zeros(v.shape[1])
    for r in range(0, v.shape[0], SQ_ROWS):
        part = v[r:r + SQ_ROWS]
        out += (part * part).sum(0)
    return out


def _check_layout(state: GPState, mesh: Mesh) -> None:
    """Raise unless ``state.l`` is this rank's block-row (the programs write
    it in place)."""
    want = (state.cap // mesh.size, state.cap)
    if tuple(state.l.shape) != want:
        raise ValueError(f"the large-cap layout holds l in {want} block-rows, got "
                         f"{tuple(state.l.shape)}: lay the state out (shard_state_bigcap)")


def _fit_body(x, *, mesh, **inputs) -> tuple:
    _refit_(mesh, gp_mod.program_state(x, inputs))
    return ()


def make_bigcap_fit(mesh: Mesh):
    """``fit(state) -> state``: the distributed refit from the label buffers
    (the large-cap ``gp_fit``; the runner's refit after a re-learn), one
    program of the mesh written into ``state``'s posterior buffers in place.
    ``state`` is in the large-cap layout (:func:`shard_state_bigcap`).  A
    labeled block that is not positive definite raises on every rank once
    the program has run and leaves ``state`` as it was."""

    def fit(state: GPState) -> GPState:
        _check_divisible(state.cap, mesh)
        _check_layout(state, mesh)
        sh._program(mesh, "bigcap_fit", _fit_body, gp_mod.program_inputs(state),
                    {"x": state.x}, writes=gp_mod.POSTERIOR_FIELDS)
        return state

    return fit


def _absorb_body(x, *, mesh, recall_ks, batch, u_label, u_flip, relevant, ap_exclude,
                 **inputs) -> tuple:
    """The large-cap round's absorption as a program's body: the simulated
    user, the labels written at the device count, the distributed refit (in
    place), then AP and recall@k of the gathered mean.  The labels go into
    copies first and into the session once the refit's factor has passed
    its check, so that an eager run that raises writes nothing either."""
    params = StrategyParams.from_inputs(inputs)
    state = gp_mod.program_state(x, inputs)
    y, valid = feedback_from_uniforms(u_label, u_flip, batch, relevant, params.label_prob,
                                      params.mistake_prob)
    c = state.count  # 0-d on the device
    labels = {f: getattr(state, f).clone() for f in ("idx", "y", "valid")}
    write_rows(labels["idx"], c, batch.to(state.idx.dtype))
    write_rows(labels["y"], c, torch.where(valid, y.to(state.y.dtype), 0.0))
    write_rows(labels["valid"], c, valid)
    _refit_(mesh, dataclasses.replace(state, count=c + batch.shape[0], **labels))
    for f, t in labels.items():
        getattr(state, f).copy_(t)
    mu = sh.all_gather_cat(mesh, state.mu)
    return (average_precision(mu, relevant, ap_exclude),
            *(recall_at_k(mu, relevant, min(k, mu.shape[0]), ap_exclude) for k in recall_ks))


def make_bigcap_round(mesh: Mesh, *, strategy: str = "ital", batch_size: int = 4,
                      recall_ks: tuple = (), **options):
    """One feedback round of a large-cap session on the mesh, as two
    programs: the sharded selection's and the absorption's
    (``bigcap_absorb``: the user, the labels, the distributed refit, AP).

    The signature and returns of ``parallel.sharded.make_sharded_round``
    (``round_fn(state, generator, u_label, u_flip, relevant, sel_forbid,
    ap_exclude, params, *, timer=None, **draws) -> (state, batch, ap,
    recalls)``), with ``state`` in the large-cap layout
    (:func:`shard_state_bigcap`) and updated in place.  "select" times the
    selection and "update" the rest.
    """
    select = sh.make_sharded_select(mesh, strategy=strategy, batch_size=batch_size, **options)
    recall_ks = tuple(recall_ks)

    def round_fn(state, generator, u_label, u_flip, relevant, sel_forbid, ap_exclude, params,
                 *, timer=None, **draws):
        if state.cap % mesh.size:
            raise ValueError(
                f"bigcap path: cap={state.cap} must divide the {mesh.size}-device mesh "
                f"(block-row layout); round the capacity up to a multiple of {mesh.size}")
        _check_layout(state, mesh)
        with sh._span(timer, "select"):
            batch = select(state, generator, sel_forbid, params, **draws)
        with sh._span(timer, "update"):
            gp_mod.check_capacity([state.count], batch.shape[0], state.cap)
            ap, *recalls = sh._program(
                mesh, "bigcap_absorb", functools.partial(_absorb_body, recall_ks=recall_ks),
                {**gp_mod.program_inputs(state), **params.program_inputs(), "batch": batch,
                 "u_label": u_label, "u_flip": u_flip, "relevant": relevant,
                 "ap_exclude": ap_exclude},
                {"x": state.x}, static=(recall_ks,), writes=gp_mod.SESSION_FIELDS)
            state.count += batch.shape[0]
        return state, batch, ap, recalls

    return round_fn
