"""Padded Cholesky factorization and the incremental block append.

Port of ``ital_tpu.ops.chol``.  The labeled set lives in a fixed-capacity
padded buffer: slots ``>= count`` are padding and slots ``< count`` with
``valid == False`` are occupied-but-inert; both are forced to identity rows,
so the factor is the identity there and solves stay zero on those rows.

Appending a block B to a factored system (Schur complement)::

    K_new = [[K_ll, K_lB], [K_Bl, K_BB]]
    L_new = [[L, 0], [S^T, L_B]],  S = L^-1 K_lB,  L_B = chol(K_BB - S^T S)

Every function takes leading batch dimensions: a stack of K sessions'
factors is factored, solved and appended in one call each, the append of
session k at its own offset ``count[k]``.  The append is a write into the
factor, in place, at a count known on the host or, inside a captured
program, held on the device: a 0-d tensor for one factor, a (K,) tensor for
K stacked factors.  The Schur block's factorization error is then checked
once the program has run.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ital_tpu_torch import graphs


def _per_matrix(s):
    """A scalar, a 0-d tensor or a (...,) tensor of per-matrix scalars,
    shaped to scale (..., n, n) matrices."""
    return s[..., None, None] if isinstance(s, torch.Tensor) else s


def _identity_pad(k: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Replace rows/cols of ``k`` (..., n, n) where ``active`` (..., n) is
    False with identity rows."""
    m2 = active[..., :, None] & active[..., None, :]
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    return torch.where(m2, k, eye)


def padded_cholesky_ex(
    k_ll: torch.Tensor, active: torch.Tensor, noise: torch.Tensor | float
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`padded_cholesky` and its unchecked ``info`` (one per matrix, as
    ``torch.linalg.cholesky_ex`` gives it), for a caller that checks several
    factorizations at once.  Nothing is read to the host."""
    eye = torch.eye(k_ll.shape[-1], dtype=k_ll.dtype, device=k_ll.device)
    return torch.linalg.cholesky_ex(_identity_pad(k_ll + _per_matrix(noise) * eye, active))


def padded_cholesky(
    k_ll: torch.Tensor, active: torch.Tensor, noise: torch.Tensor | float
) -> torch.Tensor:
    """Cholesky of ``k_ll + noise*I`` restricted to ``active`` slots, identity
    elsewhere; ``noise`` is one value or one per leading batch element.  A
    matrix that is not positive definite raises ``torch.linalg.LinAlgError``
    at once or, inside a program's capture, once the program has run
    (:func:`ital_tpu_torch.graphs.check_after`)."""
    l, info = padded_cholesky_ex(k_ll, active, noise)
    graphs.check_after(info, check_cholesky_info)
    return l


def tri_solve(l: torch.Tensor, b: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve ``L x = b`` (or ``L^T x = b``) with ``L`` lower triangular
    (leading dims broadcast).  On the card a right-hand side wider than
    ``L`` (a factor's corpus-wide rows) is solved from the right
    (:func:`solve_from_right`): cuBLAS's left-side solve falls off a cliff
    there.  On the CPU, where LAPACK has none, the left-side solve stays."""
    if trans:
        return torch.linalg.solve_triangular(l.mT, b, upper=True)
    if b.is_cuda and b.shape[-1] > l.shape[-1]:
        return solve_from_right(l, b)
    return torch.linalg.solve_triangular(l, b, upper=False)


def solve_from_right(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``L^-1 b`` as the right-side solve ``x^T L^T = b^T`` on ``b``'s
    transpose, which is ``b``'s own row-major buffer; the result is
    row-major too.  On an H100 cuBLAS took 9729 ms for the left-side solve
    of a (4, 1M) right-hand side and 0.162 ms for this one
    (``scripts/wide_solve_torch.py``, PERF.md).  The values are the
    left-side solve's bit for bit at the update's 4 rows, but not past 8
    rows in f32 on the CPU, where they would move picks at MI ties off the
    reference's."""
    return torch.linalg.solve_triangular(l.mT, b.mT, upper=True, left=False).mT


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = b``."""
    return tri_solve(l, tri_solve(l, b), trans=True)


def host_copy(values, device, dtype=None) -> torch.Tensor:
    """Host values (an array or a list) as a tensor on ``device``, copied
    without waiting for the device: a copy from pageable memory would wait
    for its stream, so a CUDA copy goes through pinned memory."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def host_index(values, device) -> torch.Tensor:
    """Host integers as an int64 index tensor on ``device``, copied without
    waiting for the device (:func:`host_copy`)."""
    return host_copy(values, device, torch.int64)


def slot_rows(counts: Sequence[int] | torch.Tensor, b: int, device) -> torch.Tensor:
    """(K, b) int64 slots ``[counts[k], counts[k] + b)`` of each session, on
    ``device``: from host counts copied without waiting for the device, from
    (K,) device counts computed there."""
    if isinstance(counts, torch.Tensor):
        return counts[:, None] + torch.arange(b, device=counts.device)
    return host_index(torch.tensor(counts, dtype=torch.int64)[:, None] + torch.arange(b), device)


def write_rows(buf: torch.Tensor, count: int | torch.Tensor, vals: torch.Tensor) -> None:
    """Write ``vals`` (b, ...) into rows ``[count, count + b)`` of ``buf``
    (cap, ...), in place: a slice write at a host count, an indexed write at
    a 0-d device count."""
    b = vals.shape[0]
    if isinstance(count, torch.Tensor):
        buf.index_copy_(0, count + torch.arange(b, device=buf.device), vals)
    else:
        buf[count:count + b] = vals


def check_cholesky_info(info: torch.Tensor) -> None:
    """Raise what ``torch.linalg.cholesky`` raises where ``info`` (from
    ``torch.linalg.cholesky_ex``, one per matrix of a batch) says a matrix is
    not positive definite.  Reads ``info`` to the host."""
    if not bool((info != 0).any()):
        return
    flat = info.reshape(-1).tolist()
    k = next(i for i, v in enumerate(flat) if v != 0)
    batch = f"(Batch element {k}): " if info.dim() else ""
    raise torch.linalg.LinAlgError(
        f"linalg.cholesky: {batch}The factorization could not be completed because the "
        f"input is not positive-definite (the leading minor of order {flat[k]} is not "
        f"positive-definite).")


def _write_new_rows(l: torch.Tensor, s: torch.Tensor, l_b: torch.Tensor,
                    rows: torch.Tensor) -> None:
    """Write the new rows ``[S^T | L_B | 0]`` of each of K factors ``l``
    (K, cap, cap) at its slots ``rows`` (K, b), in place: one indexed write
    of whole rows."""
    k, b = rows.shape
    cols = torch.arange(l.shape[-1], device=l.device)
    new_rows = torch.where(cols < rows[:, :1, None], s.mT, 0.0)  # (K, b, cap)
    new_rows.scatter_(2, rows[:, None, :].expand(-1, b, -1), l_b)
    l[torch.arange(k, device=l.device)[:, None], rows] = new_rows


def write_slots(buf: torch.Tensor, counts: Sequence[int] | torch.Tensor,
                vals: torch.Tensor) -> None:
    """Write ``vals`` (K, b, ...) into slots ``[counts[k], counts[k] + b)`` of
    ``buf`` (K, cap, ...), in place: one slice write where every session has
    one host count (no index tensor to build), else one indexed write (host
    counts or (K,) device counts)."""
    b = vals.shape[1]
    if not isinstance(counts, torch.Tensor) and len(set(counts)) == 1:
        buf[:, counts[0]:counts[0] + b] = vals
        return
    rows = slot_rows(counts, b, buf.device)
    buf[torch.arange(buf.shape[0], device=buf.device)[:, None], rows] = vals


def chol_append_block(
    l: torch.Tensor,
    k_lb: torch.Tensor,
    k_bb: torch.Tensor,
    count: int | Sequence[int] | torch.Tensor,
    active_new: torch.Tensor,
    noise: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append a block of ``b`` slots at rows ``[count, count+b)`` of ``l``, in place.

    Args:
      l: (cap, cap) factor, or (K, cap, cap) factors of K sessions, with
        identity padding from slot ``count`` on; rows ``[count, count+b)``
        are overwritten.
      k_lb: (..., cap, b) kernel between existing slots and the new block,
        already zeroed on rows ``>= count`` and on rows of inert slots.
      k_bb: (..., b, b) kernel among the new block's points.
      count: first free slot, or (K stacked factors) one per session;
        ``count + b <= cap`` or this raises.  A 0-d int64 tensor on the
        device of one factor, or a (K,) one of K factors, is the same held
        on the device: nothing is read to the host, and the caller has
        checked the capacity.
      active_new: (..., b) bool — False entries become identity (inert) slots.
      noise: observation noise added to the active diagonal of the new block,
        one value or (K,) one per session.

    Returns ``(l, s, l_b)``: the updated factor (the same tensor), equal to
    refactorizing with :func:`padded_cholesky` to tolerance, plus
    ``s = L^-1 K_lB`` (..., cap, b) and ``l_b = chol(Schur)`` (..., b, b).
    A Schur block that is not positive definite raises
    ``torch.linalg.LinAlgError`` before ``l`` is written or, inside a
    program's capture, once the program has run
    (:func:`ital_tpu_torch.graphs.check_after`).
    """
    cap = l.shape[-1]
    b = k_bb.shape[-1]
    on_device = isinstance(count, torch.Tensor)
    if not on_device:
        counts = [count] if isinstance(count, int) else [int(c) for c in count]
        if max(counts) + b > cap:
            raise ValueError(f"block of {b} slots at {max(counts)} overflows cap={cap}")
    k_lb = torch.where(active_new[..., None, :], k_lb, 0.0)
    eye_b = torch.eye(b, dtype=l.dtype, device=l.device)
    k_bb = _identity_pad(k_bb + _per_matrix(noise) * eye_b, active_new)

    # Rows >= count of K_lB are zero and L is identity there, so S is too.
    s = tri_solve(l, k_lb)  # (..., cap, b)
    c_b = _identity_pad(k_bb - s.mT @ s, active_new)
    l_b, info = torch.linalg.cholesky_ex(c_b)
    graphs.check_after(info, check_cholesky_info)

    # New rows: [S^T | L_B | 0] in the cap-wide coordinates (L_B from column
    # count on); columns past count+b are zero in the identity padding they
    # replace.  One host count for all: two slice writes; else one indexed
    # write of the whole rows.
    if on_device and count.dim() == 0:
        _write_new_rows(l[None], s[None], l_b[None],
                        (count + torch.arange(b, device=l.device))[None])
        return l, s, l_b
    if on_device:
        _write_new_rows(l, s, l_b, slot_rows(count, b, l.device))
        return l, s, l_b
    if len(set(counts)) == 1:
        c = counts[0]
        l[..., c:c + b, :c] = s[..., :c, :].mT
        l[..., c:c + b, c:c + b] = l_b
        return l, s, l_b
    _write_new_rows(l, s, l_b, slot_rows(counts, b, l.device))
    return l, s, l_b
