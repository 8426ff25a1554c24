"""The port's dataset factories, bit-equal to ``ital_tpu.data.datasets``."""

import numpy as np
import pytest

from ital_tpu.data import datasets as jds
from ital_tpu_torch.data import datasets as tds


def test_factories_are_the_reference_ones():
    assert sorted(tds._FACTORIES) == sorted(jds._FACTORIES)


@pytest.mark.parametrize("name,kwargs", [
    ("digits", {}),
    ("digits", {"normalize": True}),
    ("digits", {"normalize": False}),
    ("usps", {}),
    ("natural_scenes", {}),
    ("corpus100k", {"n": 3000, "dim": 64, "n_classes": 7, "seed": 3}),
])
def test_dataset_bit_equal_to_jax_package(name, kwargs, tmp_path):
    want = jds.load_dataset(name, **kwargs)
    got = tds.load_dataset(name, **kwargs)
    assert got.name == want.name and got.synthetic == want.synthetic
    for f in ("x", "labels", "relevance", "classes"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("labels_2d", [False, True])
def test_stored_features_load_as_in_jax(tmp_path, labels_2d):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "usps_features.npy", rng.random((60, 8)))
    lab = rng.random((60, 3)) > 0.5 if labels_2d else rng.integers(0, 4, 60)
    np.save(tmp_path / "usps_labels.npy", lab)
    want = jds.usps(str(tmp_path))
    got = tds.usps(str(tmp_path))
    assert not got.synthetic and got.name == want.name == "usps"
    for f in ("x", "labels", "relevance", "classes"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("kwargs", [{}, {"n": 200, "dim": 3, "seed": 5, "noise": 0.0}])
def test_regression_toy_bit_equal(kwargs):
    want = jds.regression_toy(**kwargs)
    got = tds.regression_toy(**kwargs)
    assert got.name == want.name and got.n == want.n
    for f in ("x", "y"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
