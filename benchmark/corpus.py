"""The benchmark's corpus, made on the device from the run's seed.

Frozen rewrite, in PyTorch, of ``ital_tpu_torch/data/datasets.py::
_synthetic_surrogate`` (the shape-matched stand-in for CNN features that the
repository uses wherever stored features are absent): sparse non-negative
activations over a shared low-rank latent basis, every row a mixture of its
class's topics times a Gamma(2, 0.5) weight, plus Gaussian noise of scale 1.2,
then a ReLU.  Same shapes and distributions as the NumPy original; the draws
come from a ``torch.Generator`` on the device, in blocks of rows, so a 1M-row
corpus takes a few large calls and never passes through the host.

Gamma(2, 0.5) is drawn as 0.5 (E1 + E2) with E = -log(U): the sum of two unit
exponentials is Gamma(2, 1) exactly.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 17  # rows drawn per call


def surrogate(n: int, dim: int, n_classes: int, seed: int, device,
              dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x, labels)``: the (n, dim) corpus in ``dtype`` (drawn in float32,
    then rounded once) and its (n,) int64 class labels, both on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed % 2**64)
    rank = max(8, dim // 32)
    basis = torch.randn(rank, dim, generator=g, device=device)
    class_mix = torch.clamp(0.3 + torch.randn(n_classes, rank, generator=g, device=device),
                            min=0.0)
    labels = torch.randint(0, n_classes, (n,), generator=g, device=device)
    x = torch.empty((n, dim), dtype=dtype, device=device)
    for lo in range(0, n, BLOCK_ROWS):
        hi = min(n, lo + BLOCK_ROWS)
        u = 1.0 - torch.rand(hi - lo, rank, 2, generator=g, device=device)  # (0, 1]
        z = class_mix[labels[lo:hi]] * (-0.5 * torch.log(u).sum(-1))
        noise = torch.randn(hi - lo, dim, generator=g, device=device)
        x[lo:hi] = torch.relu(z @ basis + 1.2 * noise).to(dtype)
    return x, labels
