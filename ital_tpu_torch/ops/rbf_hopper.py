"""Wrapper of the hand-written CUDA RBF kernels (``csrc/*.cu``).

The port of ``ital_tpu/ops/pallas_rbf.py::rbf_kernel_pallas``, in two routes
built into one library from the repository's sources at first use
(:mod:`._build`) and bound with ``ctypes``:

- ``"wgmma"`` (``csrc/rbf_wgmma.cu``): tensor-core tiles fed by a TMA ring,
  3xTF32 for f32 and one bf16 pass for a bf16 corpus; for calls with a wide
  feature axis or a large output whose rows TMA can address.
- ``"tile"`` (``csrc/rbf_tile.cu``): f32 FMA tiles on the CUDA cores, for
  everything else (narrow features, unaligned rows or pointers).

:func:`choose_route` picks the route before the launch from shape, dtype and
alignment alone; no route is ever taken because another failed.
:func:`rbf_tile` takes CUDA tensors only and raises on anything the kernels do
not take; :func:`ital_tpu_torch.ops.kernels.rbf_kernel` is the entry point
callers use, and sends CPU tensors to the plain version.

``LAUNCHES`` counts the launches of both routes and ``ROUTE_LAUNCHES`` each
route's, so a run can show that its main path went through the kernels.  The
counts are taken under a lock, so launches from a server's handler threads
are never lost; :func:`reset_launch_counts` sets them to 0.  A launch made
while a CUDA graph is captured runs only when the graph is replayed: the
capture records it (:func:`recording_launches`) and every replay adds it
(:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from ital_tpu_torch.ops import _build

LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "tile": 0}
_COUNT_LOCK = threading.Lock()
_RECORDING = threading.local()  # .tally: the launches of a graph being captured

# Where the tensor-core route's device time beats the tile kernel's, from a
# sweep on an H100 (PERF.md): the tile kernel walks D in a serial loop of
# 32-wide chunks, so the feature width D sets the crossover more than M or N
# do.  The tensor-core route takes calls with D >= 128 at any M and N (even
# (4, 25000, 512) and (4096, 3, 512)), and any D once the output has 2^20
# entries.
WGMMA_MIN_DEPTH = 128
WGMMA_MIN_OUTPUT = 1 << 20
# The tensor-core tile's short side: a call with a side this narrow gets one
# 64-row slab on that side.
WGMMA_SLAB_ROWS = 64
# CUDA's limits on a launch's grid (x, y) and on the kernels' int extents.
MAX_GRID = (2**31 - 1, 65535)
MAX_EXTENT = 2**31 - 1

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


class Route(NamedTuple):
    """A launch plan: ``name`` ``"wgmma"`` or ``"tile"``; for ``"wgmma"`` the
    tile ``variant`` (0: 128 x 128; 1: a 64-row slab x 128) and whether the
    product is taken with a and b swapped (the slab on N) and stored
    ``transposed``."""

    name: str
    variant: int = 0
    transposed: bool = False


def reset_launch_counts() -> None:
    """Set ``LAUNCHES`` and every route's count to 0."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES = 0
        for route in ROUTE_LAUNCHES:
            ROUTE_LAUNCHES[route] = 0


def _count_launch(route: str) -> None:
    global LAUNCHES
    tally = getattr(_RECORDING, "tally", None)
    if tally is not None:
        tally[route] += 1
        return
    with _COUNT_LOCK:
        LAUNCHES += 1
        ROUTE_LAUNCHES[route] += 1


@contextlib.contextmanager
def recording_launches():
    """Count this thread's launches into the dict this yields, by route, and
    not into ``LAUNCHES``: what a graph's capture launches runs at each of its
    replays, which :func:`add_launches` counts."""
    outer = getattr(_RECORDING, "tally", None)
    _RECORDING.tally = {route: 0 for route in ROUTE_LAUNCHES}
    try:
        yield _RECORDING.tally
    finally:
        _RECORDING.tally = outer


def add_launches(by_route: dict) -> None:
    """Count the launches ``by_route`` (a replayed graph's) in ``LAUNCHES``
    and ``ROUTE_LAUNCHES``."""
    global LAUNCHES
    with _COUNT_LOCK:
        for route, n in by_route.items():
            LAUNCHES += n
            ROUTE_LAUNCHES[route] += n


def wgmma_takes(m: int, n: int, d: int, dtype: torch.dtype, a_ptr: int, b_ptr: int) -> bool:
    """Whether the tensor-core route can take the call: TMA needs 16-byte
    aligned base pointers and a row stride (D x element size) that is a
    multiple of 16 bytes."""
    width_ok = (d * dtype.itemsize) % 16 == 0
    return m > 0 and n > 0 and d > 0 and width_ok and a_ptr % 16 == 0 and b_ptr % 16 == 0


def choose_route(m: int, n: int, d: int, dtype: torch.dtype, a_ptr: int, b_ptr: int,
                 force: Optional[str] = None) -> Route:
    """The route of an (M, N, D) call, from shape, dtype and alignment alone.

    ``force`` (``"wgmma"`` or ``"tile"``) overrides the size thresholds, for
    timing one route against the other; forcing ``"wgmma"`` on a call it
    cannot take raises.
    """
    takes = wgmma_takes(m, n, d, dtype, a_ptr, b_ptr)
    if force == "tile":
        return Route("tile")
    if force == "wgmma":
        if not takes:
            raise ValueError(
                f"the tensor-core route cannot take ({m}, {n}, {d}) {dtype} at pointers "
                f"{a_ptr:#x}, {b_ptr:#x}: it needs 16-byte aligned rows and pointers")
    elif force is not None:
        raise ValueError(f"unknown route {force!r}")
    elif not (takes and (d >= WGMMA_MIN_DEPTH or m * n >= WGMMA_MIN_OUTPUT)):
        return Route("tile")
    transposed = n <= WGMMA_SLAB_ROWS < m
    rows = n if transposed else m
    return Route("wgmma", 1 if rows <= WGMMA_SLAB_ROWS else 0, transposed)


def launch_grid(route: Route, m: int, n: int) -> tuple[int, int]:
    """The (x, y) grid of ``route``'s launch for an (M, N) block, as the
    sources compute it (``csrc/rbf_wgmma.cu::launch``: 128-wide column
    tiles, 128- or 64-row tiles, the smaller side's tiles along x;
    ``csrc/rbf_tile.cu::launch``: 64 x 64 tiles, or 16-wide ones on a side
    of at most 16).  Each source notes beside its grid that the two change
    together."""
    cdiv = lambda a, b: -(-a // b)
    if route.name == "wgmma":
        if route.transposed:
            m, n = n, m
        tiles_m, tiles_n = cdiv(m, 128 if route.variant == 0 else WGMMA_SLAB_ROWS), cdiv(n, 128)
        return (tiles_m, tiles_n) if m < n else (tiles_n, tiles_m)
    if m <= 16:
        return cdiv(n, 64), cdiv(m, 16)
    if n <= 16:
        return cdiv(n, 16), cdiv(m, 64)
    return cdiv(n, 64), cdiv(m, 64)


def check_launch(route: Route, m: int, n: int, d: int) -> None:
    """Raise ``ValueError`` before a launch of ``route`` that CUDA would
    refuse or the kernels would index wrongly: an extent past int32, or a
    grid past CUDA's limits (the tile kernel's grid.y reaches 65535 at
    4.19M rows, the tensor-core route's at 8.39M)."""
    if max(m, n, d) > MAX_EXTENT:
        raise ValueError(f"rbf_tile: ({m}, {n}, {d}) has an extent past the kernels' int32 "
                         f"({MAX_EXTENT})")
    grid = launch_grid(route, m, n)
    if any(g > limit for g, limit in zip(grid, MAX_GRID)):
        raise ValueError(
            f"rbf_tile: the {route.name} route's grid {grid} for ({m}, {n}, {d}) exceeds "
            f"CUDA's launch limits {MAX_GRID}: split the block along its rows")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ital_rbf_tile.argtypes = [ptr] * 6 + [f32, f32, ptr] + [i32] * 4 + [ptr]
        lib.ital_rbf_tile.restype = i32
        lib.ital_rbf_wgmma.argtypes = [ptr] * 6 + [f32, f32, ptr] + [i32] * 6 + [ptr]
        lib.ital_rbf_wgmma.restype = i32
        _lib = lib
    return _lib


def _scalar_arg(value, device: torch.device, name: str):
    """(tensor or None, number) for a scalar the kernel reads: a Python number
    goes by value; a 0-d f32 tensor on ``device`` is read from device memory
    as it is; another one-element tensor on ``device`` is made one first."""
    if not isinstance(value, torch.Tensor):
        return None, float(value)
    if value.device != device or value.numel() != 1:
        raise ValueError(
            f"{name} must be a number or a one-element tensor on {device}, "
            f"got shape {tuple(value.shape)} on {value.device}"
        )
    if value.dim() != 0 or value.dtype != torch.float32:
        value = value.reshape(()).to(torch.float32).contiguous()
    return value, 0.0


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
    out: Optional[torch.Tensor] = None,
    _route: Optional[str] = None,
) -> torch.Tensor:
    """(M, N) float32 ``var * exp(-||a_i - b_j||^2 / (2 ls^2))`` on the card.

    ``a`` (M, D) and ``b`` (N, D): contiguous CUDA tensors of one dtype,
    float32 or bfloat16.  ``a2``/``b2``: optional float32 squared row norms;
    where absent the kernel computes them in f32 from the stored values.
    ``out``: a contiguous float32 (M, N) tensor on the same device, its
    base 16-byte aligned, to write the block into (default: a new one).
    ``_route`` forces a route (see :func:`choose_route`), for timing.
    """
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
    # The wgmma route stores pairs (float2) from out's base, and
    # choose_route sees only a's and b's pointers: refuse an unaligned out.
    if out is not None and (tuple(out.shape) != (m, n) or out.dtype != torch.float32
                            or out.device != a.device or not out.is_contiguous()
                            or out.data_ptr() % 16):
        raise ValueError(
            f"out must be a contiguous, 16-byte-aligned float32 ({m}, {n}) tensor on "
            f"{a.device}, got {out.dtype} {tuple(out.shape)} on {out.device} at offset "
            f"{out.data_ptr() % 16} of 16")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"rbf_tile needs a and b on one CUDA device, got {a.device} and {b.device}"
        )
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if d == 0:
        raise ValueError("rbf_tile needs a feature axis of width >= 1")
    ls_t, ls_v = _scalar_arg(length_scale, a.device, "length_scale")
    var_t, var_v = _scalar_arg(var, a.device, "var")
    route = choose_route(m, n, d, a.dtype, a.data_ptr(), b.data_ptr(), force=_route)
    check_launch(route, m, n, d)
    lib = _library()
    args = (
        a.data_ptr(), b.data_ptr(),
        None if a2 is None else a2.data_ptr(),
        None if b2 is None else b2.data_ptr(),
        None if ls_t is None else ls_t.data_ptr(),
        None if var_t is None else var_t.data_ptr(),
        ls_v, var_v, out.data_ptr(), m, n, d, _DTYPE_CODE[a.dtype],
    )
    guard = (torch.cuda.device(a.device) if a.device.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if route.name == "wgmma":
            err = lib.ital_rbf_wgmma(*args, route.variant, int(route.transposed), stream)
        else:
            err = lib.ital_rbf_tile(*args, stream)
    if err != 0:
        raise RuntimeError(f"rbf_tile {route.name} kernel launch failed with error {err}")
    _count_launch(route.name)
    return out
