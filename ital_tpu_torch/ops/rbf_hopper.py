"""Wrapper of the hand-written CUDA RBF kernel (``csrc/rbf_tile.cu``).

The port of ``ital_tpu/ops/pallas_rbf.py::rbf_kernel_pallas``.  The library
is built from the repository's sources at first use (:mod:`._build`) and
bound with ``ctypes``.  :func:`rbf_tile` takes CUDA tensors only and raises on
anything the kernel does not take; :func:`ital_tpu_torch.ops.kernels.rbf_kernel`
is the entry point callers use, and sends CPU tensors to the plain version.

``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ital_tpu_torch.ops import _build

LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build()))
        fn = lib.ital_rbf_tile
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device_scalar(value, device: torch.device, name: str) -> torch.Tensor:
    """A float32 scalar on ``device`` (the kernel reads it from device memory)."""
    if not isinstance(value, torch.Tensor):
        return torch.full((), float(value), dtype=torch.float32, device=device)
    if value.device != device or value.numel() != 1:
        raise ValueError(
            f"{name} must be a number or a one-element tensor on {device}, "
            f"got shape {tuple(value.shape)} on {value.device}"
        )
    return value.reshape(()).to(torch.float32).contiguous()


def _check_norms(n2: Optional[torch.Tensor], rows: int, device, name: str):
    if n2 is None:
        return None
    if (n2.device != device or n2.dtype != torch.float32 or n2.dim() != 1
            or n2.shape[0] != rows or not n2.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous float32 ({rows},) tensor on {device}, "
            f"got {n2.dtype} {tuple(n2.shape)} on {n2.device}"
        )
    return n2


def rbf_tile(
    a: torch.Tensor,
    b: torch.Tensor,
    length_scale: torch.Tensor | float,
    var: torch.Tensor | float = 1.0,
    *,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(M, N) float32 ``var * exp(-||a_i - b_j||^2 / (2 ls^2))`` on the card.

    ``a`` (M, D) and ``b`` (N, D): contiguous CUDA tensors of one dtype,
    float32 or bfloat16.  ``a2``/``b2``: optional float32 squared row norms;
    where absent the kernel computes them in f32 from the stored values.
    """
    global LAUNCHES
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(
            f"rbf_tile takes float32 or bfloat16 inputs of one dtype, got "
            f"{a.dtype} and {b.dtype}"
        )
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(
            f"rbf_tile needs 2-D inputs of equal width, got {tuple(a.shape)} "
            f"and {tuple(b.shape)}"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rbf_tile needs contiguous (row-major) inputs")
    m, d = a.shape
    n = b.shape[0]
    a2 = _check_norms(a2, m, a.device, "a2")
    b2 = _check_norms(b2, n, a.device, "b2")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"rbf_tile needs a and b on one CUDA device, got {a.device} and {b.device}"
        )
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if d == 0:
        raise ValueError("rbf_tile needs a feature axis of width >= 1")
    ls_t = _device_scalar(length_scale, a.device, "length_scale")
    var_t = _device_scalar(var, a.device, "var")
    fn = _library().ital_rbf_tile
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(),
            None if a2 is None else a2.data_ptr(),
            None if b2 is None else b2.data_ptr(),
            ls_t.data_ptr(), var_t.data_ptr(), out.data_ptr(),
            m, n, d, _DTYPE_CODE[a.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"rbf_tile kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out
