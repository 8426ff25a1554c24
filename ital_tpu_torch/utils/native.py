"""The native C++ MVNDST orthant probabilities (port of ``ital_tpu.utils.native``).

``ital_tpu_torch/native/mvndst.cpp``, Genz's sequentially conditioned QMC
over the Richtmyer lattice in double precision on the host, is an
independent cross-check of :mod:`ital_tpu_torch.ops.mvn`.  It is compiled
with the system ``g++`` at first use into ``build/ital_tpu_torch/`` at the
repository root, named by a hash of the source and flags, and loaded with
``ctypes``.  Each build writes a file of its own (the process and thread in
its name) and moves it into place with ``os.replace``, so concurrent builds,
as parallel test workers make them, cannot race.  A missing compiler or a
failed build raises; nothing returns None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ital_tpu_torch.ops._build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR / "native" / "mvndst.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: dict = {}  # build directory -> the loaded library
_LOCK = threading.Lock()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libmvndst_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``mvndst.cpp`` unless its library exists in ``build_dir``;
    returns the library's path.  Raises where ``g++`` is missing or fails."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native MVNDST cross-check is built "
                           f"from {SOURCE} at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


def load_mvndst(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (once) and load the library of ``build_dir``."""
    key = str(build_dir)
    with _LOCK:
        if key not in _LIB:
            lib = ctypes.CDLL(str(build(build_dir)))
            dp = ctypes.POINTER(ctypes.c_double)
            lib.mvn_orthant_batch.argtypes = [dp, dp, dp, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, dp]
            lib.mvn_orthant_batch.restype = None
            _LIB[key] = lib
        return _LIB[key]


def mvn_orthant_probs_native(mu: np.ndarray, chol: np.ndarray, signs: np.ndarray,
                             n_points: int = 128) -> np.ndarray:
    """(n_cfg,) orthant probabilities ``P(signs_i z_i > 0 for all i)``, z ~
    N(``mu``, ``chol chol^T``), for every row of ``signs`` (n_cfg, m).

    The algorithm and lattice of
    :func:`ital_tpu_torch.ops.mvn.mvn_orthant_prob`, in double precision on
    the host.
    """
    lib = load_mvndst()
    mu = np.ascontiguousarray(mu, dtype=np.float64)
    chol = np.ascontiguousarray(chol, dtype=np.float64)
    signs = np.ascontiguousarray(signs, dtype=np.float64)
    n_cfg, m = signs.shape
    out = np.empty(n_cfg, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.mvn_orthant_batch(mu.ctypes.data_as(dp), chol.ctypes.data_as(dp),
                          signs.ctypes.data_as(dp), m, n_cfg, n_points, out.ctypes.data_as(dp))
    return out
