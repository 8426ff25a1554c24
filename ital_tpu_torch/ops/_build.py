"""Build the package's CUDA kernels from ``csrc/*.cu`` at first use.

``nvcc`` compiles every source into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), which
:mod:`ital_tpu_torch.ops.rbf_hopper` loads with ``ctypes``.  The library
lands in ``build/ital_tpu_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source builds anew and an unchanged one
is reused.  A missing ``nvcc`` or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ital_tpu_torch"

# sm_90a: Hopper with its architecture-specific features (wgmma, setmaxnreg).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin (default /usr/local/cuda): "
        "ital_tpu_torch builds its CUDA kernels from ital_tpu_torch/csrc/*.cu "
        "at first use and needs the CUDA toolkit for that"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libital_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    Returns the library's path.  The compiler's report (registers, shared
    memory and spills of each kernel, from ``-Xptxas -v``) is kept beside it
    as ``<library>.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    sources = [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *sources],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib
