"""The seeded noisy/skipping simulated user.

For each item shown, the user annotates with probability ``label_prob``
(otherwise the item is skipped) and an annotation is flipped with probability
``mistake_prob`` (``ital_tpu.data.user``).  The decision is split from the
random draw: :func:`feedback_from_uniforms` takes the two uniform vectors, so
tests can feed it the uniforms JAX draws and compare exactly.
"""

from __future__ import annotations

import torch


def feedback_from_uniforms(
    u_label: torch.Tensor,
    u_flip: torch.Tensor,
    batch: torch.Tensor,
    relevant: torch.Tensor,
    label_prob: torch.Tensor | float,
    mistake_prob: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Noisy feedback for ``batch`` from uniforms ``u_label``/``u_flip`` (b,).

    Returns ``(y, valid)``: (b,) float32 labels in {-1, +1} (meaningless where
    invalid) and the (b,) bool mask of items the user annotated.  For K
    sessions every argument but the two probabilities gains a leading axis:
    uniforms and ``batch`` (K, b), ``relevant`` (K, N).
    """
    truth = torch.where(relevant.gather(-1, batch), 1.0, -1.0)
    labeled = u_label < label_prob
    flipped = u_flip < mistake_prob
    y = torch.where(flipped, -truth, truth)
    return y.to(torch.float32), labeled


def simulate_feedback(
    generator: torch.Generator,
    batch: torch.Tensor,
    relevant: torch.Tensor,
    label_prob: torch.Tensor | float,
    mistake_prob: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Noisy feedback for the shown ``batch`` (b,), drawn from ``generator``.

    ``relevant``: (N,) bool ground truth for the current query's class.  The
    generator must live on ``batch``'s device.
    """
    b = batch.shape[0]
    u_label = torch.rand(b, generator=generator, device=batch.device)
    u_flip = torch.rand(b, generator=generator, device=batch.device)
    return feedback_from_uniforms(u_label, u_flip, batch, relevant,
                                  label_prob, mistake_prob)
