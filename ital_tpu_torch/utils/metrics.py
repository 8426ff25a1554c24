"""Retrieval metrics: average precision and recall@k, on the scores' device."""

from __future__ import annotations

from typing import Optional

import torch


def top_k_stable(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest scores; ties go to the lower index.

    ``jax.lax.top_k`` breaks ties that way and ``torch.topk`` promises no
    order, so the reference's pools and rankings are reproduced with a stable
    descending sort.
    """
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def average_precision(
    scores: torch.Tensor,
    relevant: torch.Tensor,
    exclude: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """AP of ranking ``scores`` (desc) against boolean ``relevant``.

    ``exclude``: optional (N,) bool — items removed from the ranking (the query
    itself).  Ties broken by index (stable sort).
    """
    if exclude is not None:
        scores = torch.where(exclude, -torch.inf, scores)
        relevant = relevant & ~exclude
    order = torch.argsort(-scores, stable=True)
    rel_sorted = relevant[order].to(scores.dtype)
    cum = torch.cumsum(rel_sorted, 0)
    ranks = torch.arange(1, scores.shape[0] + 1, dtype=scores.dtype,
                         device=scores.device)
    precision_at_hit = cum / ranks * rel_sorted
    n_rel = torch.clamp(rel_sorted.sum(), min=1.0)
    return precision_at_hit.sum() / n_rel


def recall_at_k(
    scores: torch.Tensor,
    relevant: torch.Tensor,
    k: int,
    exclude: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fraction of relevant items in the top k of the ranking."""
    if exclude is not None:
        scores = torch.where(exclude, -torch.inf, scores)
        relevant = relevant & ~exclude
    _, top = top_k_stable(scores, k)
    hits = relevant[top].to(scores.dtype).sum()
    return hits / torch.clamp(relevant.to(scores.dtype).sum(), min=1.0)
