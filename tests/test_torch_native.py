"""The port's native C++ MVNDST (``ital_tpu_torch.utils.native``) against the
reference's and against the port's own orthant probabilities.

Both libraries compute the same Genz QMC over the same Richtmyer lattice in
double precision, so they agree to rounding; the port's ``ops.mvn`` does it
in f32, held within the reference test's 5e-4 at the same lattice.  The
reference's library is built in a directory of this test's own, so that its
build cannot race the reference test's builds under parallel workers.
"""

import itertools
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ital_tpu_torch.ops.mvn import mvn_orthant_prob
from ital_tpu_torch.utils import native



@pytest.fixture(autouse=True)
def _gxx():
    """Decided per test, never at import: the native build needs ``g++``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")

SAME_LATTICE_ATOL = 5e-4  # tests/test_native.py, f32 against f64 at 128 points
NATIVE_ATOL = 1e-12  # the two libraries: one source, double precision


def _case(rng, m):
    a = rng.normal(size=(m, m))
    cov = a @ a.T + m * np.eye(m)
    mu = rng.normal(size=(m,)) * 0.7
    return mu, np.linalg.cholesky(cov)


@pytest.fixture(scope="module")
def reference_native(tmp_path_factory):
    """``ital_tpu.utils.native.mvn_orthant_probs_native`` built in a
    directory of its own (its cached state restored afterwards)."""
    from ital_tpu.utils import native as jnative

    saved = jnative._LIB, jnative._TRIED
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ITAL_TPU_NATIVE_DIR", str(tmp_path_factory.mktemp("reference_native")))
        jnative._LIB, jnative._TRIED = None, False
        try:
            assert jnative.load_mvndst() is not None
            yield jnative.mvn_orthant_probs_native
        finally:
            jnative._LIB, jnative._TRIED = saved


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_native_matches_reference_and_ops_mvn(reference_native, m):
    rng = np.random.default_rng(10 + m)
    mu, chol = _case(rng, m)
    signs = np.asarray(list(itertools.product([-1.0, 1.0], repeat=m)))
    got = native.mvn_orthant_probs_native(mu, chol, signs, n_points=128)
    assert got.shape == (2**m,) and got.dtype == np.float64
    np.testing.assert_allclose(got, reference_native(mu, chol, signs, n_points=128),
                               rtol=0, atol=NATIVE_ATOL)
    ours = mvn_orthant_prob(torch.tensor(mu, dtype=torch.float32)[None],
                            torch.tensor(chol, dtype=torch.float32)[None],
                            torch.tensor(signs, dtype=torch.float32), n_points=128)
    np.testing.assert_allclose(got, ours.numpy(), rtol=0, atol=SAME_LATTICE_ATOL)


def test_concurrent_builds_both_load(tmp_path):
    """Two processes build into one empty directory at once: both load the
    library, one file stays and no temporary file is left behind."""
    script = ("import sys, ctypes; from pathlib import Path; "
              "from ital_tpu_torch.utils import native; "
              "lib = native.build(Path(sys.argv[1])); ctypes.CDLL(str(lib)); print(lib)")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert {out.strip() for out, _ in outs} == {str(native.library_path(tmp_path))}
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path(tmp_path).name]


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """Where ``g++`` is missing the build raises (the reference returns None)."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(tmp_path)
