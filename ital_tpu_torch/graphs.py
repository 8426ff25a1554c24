"""Captured CUDA graphs of the round's programs: the port's ``jax.jit``.

The reference compiles each fetch, update and round into one device program
(``ital_tpu/models/session.py::_jit_select`` / ``_update_donated``,
``ital_tpu/runner.py::make_step_fns``, ``__graft_entry__.py::entry``).  The
port issues the same work op by op from Python, some 3300 small launches a
production fetch.  Here each program is captured once into a
``torch.cuda.CUDAGraph`` and then replayed.

A program is a function of tensors, its *body*, captured once per static
signature: the program's name, its static options, the shape, layout and
dtype of every input, the address of the tensors it shares (the corpus),
the device and the float32 matmul precision (TF32 is baked in at capture).
A call copies its inputs into the program's static buffers, replays the
graph and copies the outputs out.  Inputs that the body writes in place are
copied back into the caller's tensors, so a graphed call has the eager
call's effects.

Programs are process-wide: every session with the same signature replays the
same program, as every session shares the reference's ``_jit_select``.  One
lock orders copy-in, replay and copy-out, since a server's handler threads
reach the programs for different sessions at once; captures run under it
too, in ``thread_local`` error mode, so that another thread's work cannot
break them.  All programs allocate from one memory pool.  A program keeps
no reference to the tensors it shares: its key holds their address, which
only a live tensor of the same layout can hold when the program is called.

What a body may do, so that it can be captured:

- no read to the host (``.item()``, ``.tolist()``, boolean-mask indexing, a
  host branch on a device value): a check that needs one goes through
  :func:`check_after`, which runs it once the program has run and before its
  writes are copied back;
- no copy from pageable host memory: tables live on the device, cached by the
  warm-up that precedes every capture;
- no random draw: the caller draws from its generator first and feeds the
  draws in as inputs;
- fixed shapes and pointers: the RBF kernel's TMA descriptors are encoded at
  capture from the static buffers' addresses, so a replay must find the same
  buffers there.  A host count becomes a 0-d device tensor.

On the CPU, and on the card inside :func:`eager` (the counterpart of
``jax.disable_jit``), a call runs its body eagerly on the caller's tensors.
On the card a capture or replay error raises; nothing falls back to the
eager body.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Optional

import torch

from ital_tpu_torch.ops import rbf_hopper

# (name, static, device, inputs' layouts, shared tensors' addresses, precision) -> Program
_PROGRAMS: dict = {}
_LOCK = threading.RLock()  # every program's capture, copy-in, replay and copy-out
_POOL: list = []  # the one memory pool of every program, made at the first capture
_LOCAL = threading.local()  # .eager: eager() depth; .pending: checks of a body being captured
# Devices whose tensors a call runs through a captured graph.
_GRAPH_DEVICES = ("cuda",)


class CaptureError(RuntimeError):
    """A program's body could not be captured."""


@dataclasses.dataclass
class Program:
    """One captured program: its graph, static buffers and what a replay does
    beside running the graph (the kernel launches to count, the checks)."""

    name: str
    graph: Any
    inputs: dict
    outputs: tuple
    checks: list
    launches: dict
    warmup_ms: float
    capture_ms: float
    instantiate_ms: float
    replays: int = 0
    done: Any = None  # CUDA event after the last call's copy-out

    @property
    def static_bytes(self) -> int:
        """Bytes of the static input and output buffers (the memory pool's
        temporaries not counted)."""
        held = [t for t in self.inputs.values() if t is not None] + list(self.outputs)
        return sum(t.numel() * t.element_size() for t in held)


@contextlib.contextmanager
def eager():
    """Run every program called in this block eagerly, also on the card (the
    counterpart of ``jax.disable_jit``): for A/B comparisons against the
    graphs, never on a serving or experiment path."""
    _LOCAL.eager = getattr(_LOCAL, "eager", 0) + 1
    try:
        yield
    finally:
        _LOCAL.eager -= 1


def in_program() -> bool:
    """Whether this thread runs a program's body for its warm-up or capture."""
    return getattr(_LOCAL, "pending", None) is not None


@contextlib.contextmanager
def _in_program():
    """Run a body as a program's: :func:`check_after` collects its checks
    into the list this yields instead of running them."""
    outer = getattr(_LOCAL, "pending", None)
    _LOCAL.pending = []
    try:
        yield _LOCAL.pending
    finally:
        _LOCAL.pending = outer


def check_after(value: torch.Tensor, check: Callable[[torch.Tensor], None]) -> None:
    """``check(value)`` now, or, inside a program's body, after each replay of
    the program and before its writes are copied back: a check that reads
    ``value`` to the host cannot run inside a graph."""
    pending = getattr(_LOCAL, "pending", None)
    if pending is None:
        check(value)
    else:
        pending.append((value, check))


def _graphed(device: torch.device) -> bool:
    return (device.type in _GRAPH_DEVICES and not getattr(_LOCAL, "eager", 0)
            and not in_program())


def _signature(name, static, inputs, shared, device) -> tuple:
    def spec(v):
        if v is None or isinstance(v, int):
            return type(v).__name__
        return tuple(v.shape), v.stride(), v.dtype

    return (name, static, device, tuple((k, spec(v)) for k, v in inputs.items()),
            tuple((k, v.data_ptr(), tuple(v.shape), v.stride(), v.dtype)
                  for k, v in shared.items()),
            torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())


def _device_of(inputs: dict) -> torch.device:
    for v in inputs.values():
        if isinstance(v, torch.Tensor):
            return v.device
    raise ValueError("a program needs at least one tensor input")


def _as_tensor(v, device):
    """An input as the body sees it: a host int becomes a 0-d int64 tensor on
    ``device``, written by a fill (no copy from the host)."""
    if isinstance(v, int):
        return torch.full((), v, dtype=torch.int64, device=device)
    return v


def _load(buffers: dict, inputs: dict) -> None:
    for k, v in inputs.items():
        if isinstance(v, int):
            buffers[k].fill_(v)
        elif v is not None:
            buffers[k].copy_(v)


def run(name: str, body: Callable[..., tuple], inputs: dict, *, shared: Optional[dict] = None,
        static: tuple = (), writes: tuple = ()) -> tuple:
    """``body(**shared, **inputs)``, a tuple of tensors, through its program.

    ``inputs``: tensors on one device (CUDA or CPU), ``None`` or host ints
    (the body gets a 0-d int64 tensor); ``shared``: tensors the program reads
    where they are, keyed by their address (the corpus); ``static``: the
    hashable options ``body`` closes over; ``writes``: the inputs the body
    writes in place, copied back after a replay.  Returns the outputs, as
    tensors of the caller's own.  The body's :func:`check_after` checks run
    after each replay, before any write is copied back: one that raises
    leaves the caller's tensors as they were.
    """
    shared = shared or {}
    device = _device_of(inputs)
    if not _graphed(device):
        return body(**shared, **{k: _as_tensor(v, device) for k, v in inputs.items()})
    key = _signature(name, static, inputs, shared, device)
    with _LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = _capture(name, body, inputs, shared, device)
            _PROGRAMS[key] = prog
        if prog.done is not None:  # the last call's copy-out, on whatever stream it ran
            torch.cuda.current_stream(device).wait_event(prog.done)
        _load(prog.inputs, inputs)
        prog.graph.replay()
        prog.replays += 1
        rbf_hopper.add_launches(prog.launches)
        for value, check in prog.checks:
            check(value)
        for k in writes:
            inputs[k].copy_(prog.inputs[k])
        out = tuple(o.clone() for o in prog.outputs)
        if device.type == "cuda":
            prog.done = torch.cuda.Event()
            prog.done.record(torch.cuda.current_stream(device))
        return out


def _capture(name, body, inputs, shared, device) -> Program:
    # Each buffer keeps its input's layout: the library's Cholesky factor is
    # column-major, and a row-major copy would round its solves differently.
    buffers = {k: None if v is None else
               torch.empty((), dtype=torch.int64, device=device) if isinstance(v, int) else
               torch.empty_like(v) for k, v in inputs.items()}
    _load(buffers, inputs)
    graph, outputs, checks, launches, warmup_ms, capture_ms, instantiate_ms = (
        _capture_graph(name, body, buffers, shared, device))
    return Program(name=name, graph=graph, inputs=buffers, outputs=outputs,
                   checks=checks, launches=launches, warmup_ms=warmup_ms,
                   capture_ms=capture_ms, instantiate_ms=instantiate_ms)


def _capture_graph(name, body, buffers, shared, device):
    """Warm ``body`` up on a side stream, then capture it into a graph.

    The warm-up runs the body once on the static buffers: it loads the
    kernels' library, makes the kernels' first ``cudaFuncSetAttribute`` and
    fills the device tables' caches, none of which a capture may do.  Returns
    (graph, outputs, checks, launches by route, warm-up ms, capture ms,
    instantiate ms); the capture ms include the synchronization before it.
    """
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), _in_program():
        body(**shared, **buffers)
    torch.cuda.current_stream(device).wait_stream(side)
    warmup_ms = (time.perf_counter() - t0) * 1e3
    if not _PROGRAMS:
        # Before the first program, a failed capture may have left the pool
        # with no graph, and a capture may not join such a pool.
        _POOL.clear()
    if not _POOL:
        _POOL.append(torch.cuda.graph_pool_handle())
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()  # the capture starts with a synchronization
    try:
        with rbf_hopper.recording_launches() as launches, _in_program() as checks:
            with torch.cuda.graph(graph, pool=_POOL[0], capture_error_mode="thread_local"):
                outputs = tuple(body(**shared, **buffers))
                t1 = time.perf_counter()
    except Exception as exc:
        raise CaptureError(f"capturing program {name!r} failed: {exc}") from exc
    t2 = time.perf_counter()
    return graph, outputs, checks, launches, warmup_ms, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def programs() -> list[Program]:
    """Every program captured in this process, in capture order."""
    with _LOCK:
        return list(_PROGRAMS.values())
