"""Padded Cholesky factorization and the incremental block append.

Port of ``ital_tpu.ops.chol``.  The labeled set lives in a fixed-capacity
padded buffer: slots ``>= count`` are padding and slots ``< count`` with
``valid == False`` are occupied-but-inert; both are forced to identity rows,
so the factor is the identity there and solves stay zero on those rows.

Appending a block B to a factored system (Schur complement)::

    K_new = [[K_ll, K_lB], [K_Bl, K_BB]]
    L_new = [[L, 0], [S^T, L_B]],  S = L^-1 K_lB,  L_B = chol(K_BB - S^T S)

``count`` is a host integer here, so the append is plain slice writes into
the session's factor.
"""

from __future__ import annotations

import torch


def _identity_pad(k: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Replace rows/cols of ``k`` where ``active`` is False with identity rows."""
    m2 = active[:, None] & active[None, :]
    eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
    return torch.where(m2, k, eye)


def padded_cholesky(
    k_ll: torch.Tensor, active: torch.Tensor, noise: torch.Tensor | float
) -> torch.Tensor:
    """Cholesky of ``k_ll + noise*I`` restricted to ``active`` slots, identity elsewhere."""
    k = k_ll + noise * torch.eye(k_ll.shape[0], dtype=k_ll.dtype, device=k_ll.device)
    return torch.linalg.cholesky(_identity_pad(k, active))


def tri_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L x = b`` with ``L`` lower triangular."""
    return torch.linalg.solve_triangular(l, b, upper=False)


def chol_append_block(
    l: torch.Tensor,
    k_lb: torch.Tensor,
    k_bb: torch.Tensor,
    count: int,
    active_new: torch.Tensor,
    noise: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append a block of ``b`` slots at rows ``[count, count+b)`` of ``l``, in place.

    Args:
      l: (cap, cap) factor with identity padding from slot ``count`` on; its
        rows ``[count, count+b)`` are overwritten.
      k_lb: (cap, b) kernel between existing slots and the new block, already
        zeroed on rows ``>= count`` and on rows of inert slots.
      k_bb: (b, b) kernel among the new block's points.
      count: first free slot; ``count + b <= cap`` or this raises.
      active_new: (b,) bool — False entries become identity (inert) slots.
      noise: observation noise added to the active diagonal of the new block.

    Returns ``(l, s, l_b)``: the updated factor (the same tensor), equal to
    refactorizing with :func:`padded_cholesky` to tolerance, plus
    ``s = L^-1 K_lB`` (cap, b) and ``l_b = chol(Schur)`` (b, b).
    """
    cap = l.shape[0]
    b = k_bb.shape[0]
    if count + b > cap:
        raise ValueError(f"block of {b} slots at {count} overflows cap={cap}")
    k_lb = torch.where(active_new[None, :], k_lb, 0.0)
    eye_b = torch.eye(b, dtype=l.dtype, device=l.device)
    k_bb = _identity_pad(k_bb + noise * eye_b, active_new)

    # Rows >= count of K_lB are zero and L is identity there, so S is too.
    s = tri_solve(l, k_lb)  # (cap, b)
    c_b = _identity_pad(k_bb - s.T @ s, active_new)
    l_b = torch.linalg.cholesky(c_b)

    # New rows: [S^T | L_B | 0]; columns past count+b are already zero in the
    # identity padding being overwritten.
    l[count:count + b, :count] = s[:count].T
    l[count:count + b, count:count + b] = l_b
    return l, s, l_b
