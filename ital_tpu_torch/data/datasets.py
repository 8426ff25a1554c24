"""Dataset loaders: toy Gaussians, digits/USPS, Natural Scenes, MIRFLICKR-25K,
the 100k scale corpus and the regression toy.

A copy of the NumPy-only loaders of ``ital_tpu.data.datasets`` (importing
``ital_tpu`` would import JAX).  The arrays are bit-identical to the
reference's for the same arguments; ``tests/test_torch_session.py`` and
``tests/test_torch_data.py`` check it.  Loaders return NumPy arrays: callers
move them to their device.  Stored-feature loaders fall back to a flagged
synthetic surrogate of the same shape when their files are absent.

Feature matrices are float32; relevance for a query of class c is "same
class" (multi-label for MIRFLICKR-style topic matrices).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Dataset:
    """A retrieval corpus: features + binary relevance per query class.

    ``labels``: (N,) int class ids, or -1 when only ``relevance`` (multi-label
    topic matrix, (N, C) bool) is available.
    """

    name: str
    x: np.ndarray  # (N, D) float32
    labels: np.ndarray  # (N,) int64
    relevance: np.ndarray  # (N, C) bool — relevance[i, c] = item i relevant to class c
    classes: np.ndarray  # (C,) class ids usable as queries
    synthetic: bool = False  # True when a stored dataset fell back to a surrogate

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def queries_for_class(self, c: int, rng: np.random.Generator, k: int) -> np.ndarray:
        """Draw k query indices that are relevant to class ``c``."""
        pool = np.flatnonzero(self.relevance[:, c])
        return rng.choice(pool, size=min(k, pool.size), replace=False)


def _class_relevance(labels: np.ndarray, classes: np.ndarray) -> np.ndarray:
    return labels[:, None] == classes[None, :]


def toy_gaussians(
    n_per_class: int = 400,
    n_classes: int = 4,
    dim: int = 2,
    spread: float = 4.0,
    scale: float = 1.0,
    seed: int = 0,
) -> Dataset:
    """Synthetic Gaussian clusters (the reference's CPU-runnable toy dataset)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, spread, size=(n_classes, dim))
    x = np.concatenate(
        [rng.normal(c, scale, size=(n_per_class, dim)) for c in centers]
    ).astype(np.float32)
    labels = np.repeat(np.arange(n_classes), n_per_class)
    perm = rng.permutation(x.shape[0])
    x, labels = x[perm], labels[perm]
    classes = np.arange(n_classes)
    return Dataset("toy", x, labels, _class_relevance(labels, classes), classes)


def digits(normalize: bool = True) -> Dataset:
    """scikit-learn's bundled 8x8 digits, an offline USPS stand-in (1797 x 64),
    scaled to [0, 1] when ``normalize`` (raw 0-16 counts otherwise).

    Needs scikit-learn, which is imported only here.
    """
    from sklearn.datasets import load_digits

    d = load_digits()
    x = d.data.astype(np.float32)
    if normalize:
        x = x / 16.0
    classes = np.arange(10)
    return Dataset("digits", x, d.target.astype(np.int64),
                   _class_relevance(d.target, classes), classes)


def _synthetic_surrogate(
    name: str, n: int, dim: int, n_classes: int, seed: int = 0
) -> Dataset:
    """Shape-matched synthetic surrogate for an absent stored-feature dataset.

    CNN-feature-like: sparse non-negative activations over a shared low-rank
    latent basis, with heavy class overlap (mixtures of shared topics) so
    retrieval is genuinely hard.
    """
    rng = np.random.default_rng(seed)
    rank = max(8, dim // 32)
    basis = rng.normal(0.0, 1.0, size=(rank, dim))
    class_mix = np.maximum(rng.normal(0.3, 1.0, size=(n_classes, rank)), 0.0)
    labels = rng.integers(0, n_classes, size=n)
    z = class_mix[labels] * rng.gamma(2.0, 0.5, size=(n, rank))
    x = z @ basis + rng.normal(0.0, 1.2, size=(n, dim))
    x = np.maximum(x, 0.0).astype(np.float32)  # ReLU-like
    classes = np.arange(n_classes)
    return Dataset(f"{name}(synthetic)", x, labels,
                   _class_relevance(labels, classes), classes, synthetic=True)


def _load_stored(
    name: str,
    path: Optional[str],
    feature_file: str,
    label_file: str,
    fallback_shape: tuple[int, int, int],
) -> Dataset:
    """Load ``<path>/<feature_file>`` + labels; fall back to a synthetic surrogate.

    Labels may be (N,) int class ids or an (N, C) binary topic matrix
    (MIRFLICKR's multi-label ground truth).
    """
    if path is not None:
        fpath = os.path.join(path, feature_file)
        lpath = os.path.join(path, label_file)
        if os.path.exists(fpath) and os.path.exists(lpath):
            x = np.load(fpath).astype(np.float32)
            lab = np.load(lpath)
            if lab.ndim == 2:  # multi-label topic matrix
                relevance = lab.astype(bool)
                labels = np.full(x.shape[0], -1, dtype=np.int64)
                classes = np.arange(relevance.shape[1])
            else:
                labels = lab.astype(np.int64)
                classes = np.unique(labels)
                relevance = _class_relevance(labels, classes)
            return Dataset(name, x, labels, relevance, classes)
    n, dim, n_classes = fallback_shape
    return _synthetic_surrogate(name, n, dim, n_classes)


def usps(path: Optional[str] = None) -> Dataset:
    """USPS digit features (stored .npy); surrogate: 7291 x 256, 10 classes."""
    return _load_stored("usps", path, "usps_features.npy", "usps_labels.npy",
                        (7291, 256, 10))


def natural_scenes(path: Optional[str] = None) -> Dataset:
    """Natural Scenes features; surrogate: 6600 x 512, 13 scene topics."""
    return _load_stored("natural_scenes", path, "scenes_features.npy",
                        "scenes_labels.npy", (6600, 512, 13))


def mirflickr(path: Optional[str] = None) -> Dataset:
    """MIRFLICKR-25K precomputed CNN features; surrogate: 25000 x 512, 14 topics."""
    return _load_stored("mirflickr", path, "mirflickr_features.npy",
                        "mirflickr_labels.npy", (25000, 512, 14))


@dataclasses.dataclass
class RegressionDataset:
    """Active-regression corpus: features + continuous targets."""

    name: str
    x: np.ndarray  # (N, D) float32
    y: np.ndarray  # (N,) float32 true latent values

    @property
    def n(self) -> int:
        return self.x.shape[0]


def regression_toy(
    n: int = 500, dim: int = 1, seed: int = 0, noise: float = 0.05
) -> RegressionDataset:
    """Smooth synthetic function for the GP-regression active-learning variant."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, size=(n, dim)).astype(np.float32)
    r = np.linalg.norm(x, axis=1)
    y = (np.sin(2.0 * r) + 0.3 * x[:, 0] + noise * rng.normal(size=n)).astype(np.float32)
    return RegressionDataset("regression_toy", x, y)


def corpus100k(n: int = 100_000, dim: int = 512, n_classes: int = 20, seed: int = 0) -> Dataset:
    """Synthetic 100k-image corpus for the scale-out scenario."""
    return _synthetic_surrogate("corpus100k", n, dim, n_classes, seed)


_FACTORIES = {
    "toy": toy_gaussians,
    "digits": digits,
    "usps": usps,
    "natural_scenes": natural_scenes,
    "mirflickr": mirflickr,
    "corpus100k": corpus100k,
}


def load_dataset(name: str, **kwargs) -> Dataset:
    """Factory by config name (reference ``load_dataset``)."""
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(_FACTORIES)}") from None
    return factory(**kwargs)
