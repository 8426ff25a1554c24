"""Retrieval metrics: average precision and recall@k, on the scores' device."""

from __future__ import annotations

from typing import Optional

import torch


def top_k_stable(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest scores along the last axis; ties
    go to the lower index.

    ``jax.lax.top_k`` breaks ties that way and ``torch.topk`` promises no
    order, so the reference's pools and rankings are reproduced with a stable
    descending sort.
    """
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def average_precision(
    scores: torch.Tensor,
    relevant: torch.Tensor,
    exclude: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """AP of ranking ``scores`` (desc) against boolean ``relevant``.

    ``exclude``: optional (N,) bool — items removed from the ranking (the query
    itself).  Ties broken by index (stable sort).  With leading axes on all
    three ((K, N) for K sessions), one AP per row.
    """
    if exclude is not None:
        scores = torch.where(exclude, -torch.inf, scores)
        relevant = relevant & ~exclude
    order = torch.argsort(-scores, dim=-1, stable=True)
    rel_sorted = relevant.gather(-1, order).to(scores.dtype)
    cum = torch.cumsum(rel_sorted, -1)
    ranks = torch.arange(1, scores.shape[-1] + 1, dtype=scores.dtype,
                         device=scores.device)
    precision_at_hit = cum / ranks * rel_sorted
    n_rel = torch.clamp(rel_sorted.sum(-1), min=1.0)
    return precision_at_hit.sum(-1) / n_rel


def recall_at_k(
    scores: torch.Tensor,
    relevant: torch.Tensor,
    k: int,
    exclude: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fraction of relevant items in the top k of the ranking (one per row
    under leading axes, as :func:`average_precision`)."""
    if exclude is not None:
        scores = torch.where(exclude, -torch.inf, scores)
        relevant = relevant & ~exclude
    _, top = top_k_stable(scores, k)
    hits = relevant.gather(-1, top).to(scores.dtype).sum(-1)
    return hits / torch.clamp(relevant.to(scores.dtype).sum(-1), min=1.0)
