"""Cap-axis-sharded Cholesky and triangular solves (port of ``ital_tpu.parallel.chol2d``).

The labeled block of a session with a very large capacity is laid out
block-row over the corpus mesh, so that no rank holds the whole (cap, cap)
factor.  With p ranks and ``cb = cap / p``:

=========================  ==============  ====================
operand                    shape per rank  layout
=========================  ==============  ====================
K_ll, its factor L         (cb, cap)       block-row ``rank``
right-hand sides, x        (cap, r)        replicated
whitening RHS, V           (cap, N/p)      corpus columns
=========================  ==============  ====================

* **Cholesky** (:func:`chol2d_local`): right-looking and blocked, one panel
  per rank.  At panel j the owner's diagonal block reaches every rank (one
  broadcast), every rank factors it (redundant flops are cheaper than a
  second exchange), solves its own panel block ``L_ij = A_ij L_jj^-T``
  locally (the owner keeps ``L_jj``), and, after one all-gather of the
  (cap, cb) panel column, updates the columns right of the panel.
* **Solves** (:func:`solve2d_local`): block substitution over the panels.
  Forward, the owner's solved block is broadcast; for ``L^T x = b`` the
  correction ``sum_i L_ij^T x_i`` is one sum over the ranks.
* **Whitening** (:func:`whiten2d_local`): ``V = L^-1 K`` with L row-sharded
  and K column-sharded over the corpus: each panel of L is broadcast once
  and every rank substitutes its own columns; no traffic grows with the
  corpus.

The reference writes a broadcast as ``psum(where(me == j, a, 0))``; a
``dist.broadcast`` from rank j moves the same values exactly.  Inactive slots
are identity rows (``ops.chol._identity_pad``), so solves against a right-hand
side that is zero on them stay zero there.  Every rank must make the same
calls in the same order.

The bodies read nothing to the host, so the factories run them as programs
of the mesh (the reference's ``jax.jit(shard_map(...))``): on the card one
CUDA graph per rank with its broadcasts, gathers and sums inside.  A panel
that is not positive definite raises on every rank once the program has
run (its flags are replicated).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ital_tpu_torch import graphs
from ital_tpu_torch.ops import chol as chol_ops
from ital_tpu_torch.parallel import sharded as sh
from ital_tpu_torch.parallel.mesh import Mesh
from ital_tpu_torch.parallel.sharded import all_gather_cat, psum


def _broadcast_from(mesh: Mesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` from rank ``src`` on every rank (the others pass a buffer of its
    shape and dtype)."""
    t = t.contiguous()
    dist.broadcast(t, src=src, group=mesh.group)
    return t


def _identity_pad_local(mesh: Mesh, a: torch.Tensor, active: torch.Tensor,
                        noise) -> torch.Tensor:
    """This rank's block-row of ``ops.chol._identity_pad(k + noise * I, active)``.

    ``a``: (cb, cap) block-row; ``active``: (cap,) replicated mask.
    """
    cb, cap = a.shape
    r0 = mesh.rank * cb
    eye_rows = (torch.arange(cap, device=a.device)[None, :]
                == torch.arange(r0, r0 + cb, device=a.device)[:, None]).to(a.dtype)
    a = a + noise * eye_rows
    keep = active[r0:r0 + cb, None] & active[None, :]
    return torch.where(keep, a, eye_rows)


def chol2d_local(mesh: Mesh, a: torch.Tensor, active: torch.Tensor, noise) -> torch.Tensor:
    """This rank's (cb, cap) block-row of the lower factor of ``a + noise I``
    restricted to ``active`` (identity elsewhere), from its (cb, cap)
    block-row ``a`` of the symmetric kernel matrix; ``active`` (cap,) is
    replicated.  A diagonal block that is not positive definite raises
    ``torch.linalg.LinAlgError`` on every rank once the panels are done (or,
    inside a program, once it has run)."""
    cb, cap = a.shape
    if cb * mesh.size != cap:
        raise ValueError(f"a ({cb}, {cap}) block-row is not cap / {mesh.size} rows")
    me = mesh.rank
    a = _identity_pad_local(mesh, a, active, noise)
    l = torch.zeros_like(a)
    infos = []
    # The branches on ``me`` pick what a rank computes, never which
    # collectives it calls: every rank issues one broadcast from rank j and
    # one all-gather for panel j, in panel order.
    for j in range(mesh.size):
        c0, c1 = j * cb, (j + 1) * cb
        # Only the owner's diagonal block of its block-row is read: it alone
        # crosses (the reference sums the whole row; the values are the same).
        ajj = _broadcast_from(mesh, a[:, c0:c1] if me == j else a.new_empty((cb, cb)), j)
        ljj, info = torch.linalg.cholesky_ex(ajj)  # replicated
        infos.append(info)
        if me > j:
            lij = torch.linalg.solve_triangular(ljj.mT, a[:, c0:c1], upper=True, left=False)
        elif me == j:
            # A_jj L_jj^-T is L_jj: taken as it is, exactly lower triangular.
            lij = ljj
        else:
            # Rows i < j lie above the panel's diagonal block: zero there.
            lij = a.new_zeros((cb, cb))
        l[:, c0:c1] = lij
        panel = all_gather_cat(mesh, lij)  # (cap, cb): L_{:, j}
        if me > j:
            # The trailing update A -= L_:j L_:j^T on the columns right of
            # the panel; columns at or left of it are never read again.
            a[:, c1:] -= lij @ panel[c1:].T
    # The flags are replicated: every rank raises alike, after the panels'
    # collectives (graphs.uniform_failure marks it so).
    graphs.check_after(torch.stack(infos), chol_ops.check_cholesky_info)
    return l


def solve2d_local(mesh: Mesh, l: torch.Tensor, b: torch.Tensor, *,
                  trans: bool = False) -> torch.Tensor:
    """Solve ``L x = b`` (or ``L^T x = b``) with L row-sharded (this rank's
    (cb, cap) block-row ``l``) and ``b`` (cap, r) replicated; returns the
    replicated (cap, r) solution.  One (cb, r) exchange per panel."""
    cb, cap = l.shape
    me = mesh.rank
    x = torch.zeros_like(b)
    if not trans:
        for j in range(mesh.size):
            c0, c1 = j * cb, (j + 1) * cb
            if me == j:
                # x is still zero past c0, so the prefix product is the
                # reference's full-width one.
                rhs = b[c0:c1] - l[:, :c0] @ x[:c0]
                # b is beta's (cap, 1) here: 0.075 ms at cap 1024 on an H100
                # (scripts/wide_solve_torch.py); no wide-column cliff either,
                # 86 ms on (1024, 1M) rows against tri_solve's 54.
                xj = torch.linalg.solve_triangular(l[:, c0:c1], rhs, upper=False)
            else:
                xj = b.new_empty((cb, b.shape[1]))
            x[c0:c1] = _broadcast_from(mesh, xj, j)
        return x

    for j in reversed(range(mesh.size)):
        c0, c1 = j * cb, (j + 1) * cb
        # Each rank's L_{me,j}^T x_me: zero for me < j (lower triangular)
        # and for the unsolved me == j (its x block is still zero), so the
        # sum is exactly the solved suffix's correction sum_{i>j} L_ij^T x_i.
        corr = psum(mesh, l[:, c0:c1].T @ x[me * cb:(me + 1) * cb])
        if me == j:
            # 0.072 ms on beta's (1024, 1) (scripts/wide_solve_torch.py).
            xj = torch.linalg.solve_triangular(l[:, c0:c1].T, b[c0:c1] - corr, upper=True)
        else:
            xj = b.new_empty((cb, b.shape[1]))
        x[c0:c1] = _broadcast_from(mesh, xj, j)
    return x


def _whiten_(mesh: Mesh, l: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`whiten2d_local` in place: ``v`` (cap, n_loc) holds K on entry
    and ``L^-1 K`` on return."""
    cb, cap = l.shape
    me = mesh.rank
    for j in range(mesh.size):
        c0, c1 = j * cb, (j + 1) * cb
        # Columns past the panel are zero in L: only its (cb, c1) prefix crosses.
        lj = _broadcast_from(mesh, l[:, :c1] if me == j else l.new_empty((cb, c1)), j)
        # Rows of v from c0 on still hold K, so the prefix product over the
        # solved rows is the reference's full-width dot(lj, v), without the
        # (cb, cap) x (cap, n_loc) product of zeros.
        if c0:
            v[c0:c1].addmm_(lj[:, :c0], v[:c0], alpha=-1.0)
        # Solved into its own rows: no (cb, n_loc) block is allocated.  At
        # cap 1024 on (1024, 1M) rows this took 51 ms on an H100, as fast as
        # tri_solve's right-side form (54 ms): no cliff at 1024-row panels
        # (scripts/wide_solve_torch.py).
        torch.linalg.solve_triangular(lj[:, c0:c1], v[c0:c1], upper=False, out=v[c0:c1])
    return v


def whiten2d_local(mesh: Mesh, l: torch.Tensor, k_cols: torch.Tensor) -> torch.Tensor:
    """``V = L^-1 K`` with L row-sharded (this rank's (cb, cap) block-row
    ``l``) and K column-sharded (this rank's (cap, n_loc) columns
    ``k_cols``, the layout of the state's ``v``); returns this rank's
    (cap, n_loc) columns of V.  Each panel of L is broadcast once."""
    return _whiten_(mesh, l, k_cols.clone())


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------


def _check_divisible(cap: int, mesh: Mesh) -> None:
    if cap % mesh.size != 0:
        raise ValueError(
            f"cap={cap} must divide evenly over the {mesh.size}-device mesh for "
            f"the block-row layout; round the capacity up to a multiple of "
            f"{mesh.size} (GPConfig.cap already pads to a multiple of 8)"
        )


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A number as a 0-d tensor of ``like``'s dtype and device, made by a
    fill (a program's inputs are tensors); a tensor as it is."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def _cholesky_body(*, mesh, k_rows, active, noise) -> tuple:
    return (chol2d_local(mesh, k_rows, active, noise),)


def _cho_solve_body(*, mesh, l, b) -> tuple:
    return (solve2d_local(mesh, l, solve2d_local(mesh, l, b), trans=True),)


def _whiten_body(*, mesh, l, k_cols) -> tuple:
    return (whiten2d_local(mesh, l, k_cols),)


def make_sharded_cholesky(mesh: Mesh):
    """``(k_rows (cb, cap) this rank's block-row, active (cap,), noise) ->
    this rank's (cb, cap) block-row of L``, as one program of the mesh."""

    def cholesky(k_rows: torch.Tensor, active: torch.Tensor, noise) -> torch.Tensor:
        _check_divisible(active.shape[0], mesh)
        (l,) = sh._program(mesh, "chol2d_cholesky", _cholesky_body,
                           {"k_rows": k_rows, "active": active,
                            "noise": _scalar(noise, k_rows)}, {})
        return l

    return cholesky


def make_sharded_cho_solve(mesh: Mesh):
    """``(L's block-row, b (cap, r) replicated) -> K_ll^-1 b`` replicated, as
    one program of the mesh."""

    def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        _check_divisible(b.shape[0], mesh)
        (x,) = sh._program(mesh, "chol2d_cho_solve", _cho_solve_body, {"l": l, "b": b}, {})
        return x

    return cho_solve


def make_sharded_whiten(mesh: Mesh):
    """``(L's block-row, K's (cap, N/p) columns) -> V's (cap, N/p) columns``,
    as one program of the mesh; ``K`` is left as it was."""

    def whiten(l: torch.Tensor, k_cols: torch.Tensor) -> torch.Tensor:
        _check_divisible(k_cols.shape[0], mesh)
        (v,) = sh._program(mesh, "chol2d_whiten", _whiten_body, {"l": l, "k_cols": k_cols}, {})
        return v

    return whiten


def shard_rows(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block-row of a (cap, ...) tensor, on the mesh's device."""
    _check_divisible(a.shape[0], mesh)
    cb = a.shape[0] // mesh.size
    return a[mesh.rank * cb:(mesh.rank + 1) * cb].to(mesh.device, copy=True,
                                                       memory_format=torch.contiguous_format)
