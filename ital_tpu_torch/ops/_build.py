"""Build the package's CUDA kernels from ``csrc/*.cu`` at first use.

``nvcc`` compiles every source at once, one process each, and links the
objects into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds), which
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    objects, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{lib.stem}.{src.stem}.{os.getpid()}.o"
        objects.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [p.communicate()[0] for p in procs]
    steps = [(p.returncode, log) for p, log in zip(procs, logs)]
    if all(rc == 0 for rc, _ in steps):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        steps.append((link.returncode, link.stdout))
    for obj in objects:
        obj.unlink(missing_ok=True)
    failed = [(rc, log) for rc, log in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {failed[0][0]}:\n{failed[0][1]}"
        )
    lib.with_suffix(".so.log").write_text("".join(log for _, log in steps))
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib
