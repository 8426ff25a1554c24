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
same program, as every session shares the reference's ``_jit_select``.  A
program whose corpus is gone is released at the next capture.  One
lock orders copy-in, replay and copy-out, since a server's handler threads
reach the programs for different sessions at once; captures run under it
too, in ``thread_local`` error mode, so that another thread's work cannot
break them.  The single-device programs allocate from one memory pool, each
mesh's programs from one of the mesh's own.  A program keeps no reference
to the tensors it shares: its key holds their address, which only a live
tensor of the same layout can hold when the program is called.

A pool hands its memory back to the device only once no program in it
lives, and a capture's warm-up runs eagerly beside the pools already held.
So a single-device capture that runs out of device memory releases every
single-device program (each is captured again at its next call), starts a
new pool and captures once more; a call under :func:`eager` that runs out
of memory and writes no input does the same.  A second failure raises.  A
mesh program never does: its ranks release only alike.

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
  buffers there.  A host count becomes a 0-d device tensor, K sessions'
  counts a (K,) one.

A cohort's program takes each session's buffers as they are: an input that
is a list of K same-shaped tensors is stacked inside the program (the
reference's ``_stack_gpstates`` inside its jit) into one (K, ...) buffer by
K copies, and where the body writes it, copied back slice by slice into the
K tensors after the checks.  That buffer only stages: every call copies all
of its inputs in, and its writes back before another program runs, so the
programs share it.  One *stage* is held per list input's name and slice
layout (shape, strides, dtype, device, mesh), (Kmax, ...) for the widest K
asked of it, and a program of K sessions binds its first K slices
(``stage[:K]``: one address and the slices' strides for every K).  A
program that needs more slices than its stage holds grows it, which
releases every program bound to the old buffer.  A call that binds a stage
first waits for the copy-out of the stage's last call, on whatever stream it
ran.  The stages together keep at most :data:`STACK_BYTES`, each counted
once: a new or grown stage first releases others, those no program binds
before the least recently used, and the programs bound to them.

A program on a corpus mesh (``run(..., mesh=mesh)``, the reference's
``jax.jit(shard_map(...))``) calls ``torch.distributed`` collectives on the
mesh's group inside its body, and on the card its graph holds them.  Every
rank runs the same body on its shard, and every rank must capture, replay
and release the same programs in the same order: a rank that warms up and
captures (which runs the collectives) while its peer replays deadlocks both.
So a mesh program's choices depend only on the calls the ranks make alike:
its key holds the mesh, it holds the tensors it shares (no other tensor can
come to their addresses while it lives, so no rank finds it by a dead
tensor's address while another captures anew), the garbage collector never
releases it, and its stages are its mesh's own, counted against
:data:`STACK_BYTES` with its own mesh's stages only (a stage grows only with
the K that every rank calls alike).  :func:`release_mesh` (``Mesh.close``)
releases a mesh's programs and stages before its communicator goes, so no
graph outlives it.  The warm-up before a capture runs the collectives once,
which sets up any communicator that starts lazily (the ring's point-to-point
pairs).  A check of a mesh program (:func:`check_after`) reads values every
rank holds alike, so it fails on every rank alike; the exception it raises
is marked (:func:`uniform_failure`), which tells a mesh service that the
ranks are still in step.

On the CPU, and on the card inside :func:`eager` (the counterpart of
``jax.disable_jit``), a call runs its body eagerly on the caller's tensors.
On the card a capture or replay error raises; nothing falls back to the
eager body.

While tracing is on (:mod:`ital_tpu_torch.utils.logging`), each call is a
span ``graphs.run`` (attributes ``program`` and ``graphed``) and, on the
graph path, its parts are spans beneath it: ``graphs.capture`` (attributes
``program``, ``cause`` and ``stage``: ``reused`` where every list input's
stage held its K slices, ``grown`` where one was made or grown, ``none``
without a list input) with ``graphs.release`` (attribute ``reason``),
``graphs.warmup``, ``graphs.record``, ``graphs.instantiate`` and
``graphs.pool_bytes`` beneath it; ``graphs.copy_in``, ``graphs.replay``,
``graphs.checks.wait``, ``graphs.copy_back`` and ``graphs.copy_out``.  A
capture's ``cause`` is ``new`` for a signature never held, else
``after_<reason>`` of its release; the reasons of the last
``_RELEASED_KEPT`` releases are kept whether tracing is on or off, so that a
capture traced after its release went untraced is still named.  The
counters are ``graphs.copy_bytes`` (by ``dir``: ``in``, ``back``, ``out``),
the bytes of the tensors that the copy-in, the copy-back and the outputs'
clones copy, and ``graphs.stage_bytes`` (by ``event``: ``reused``,
``grown``), the bytes of the stage slices a capture bound, as its stage held
them or after growing it.  A program's ``warmup_ms``, ``capture_ms`` and
``instantiate_ms`` are its capture spans' durations, kept also with tracing
off.

A graph's replay runs no Python, so the counters a body counts
(``logging.count``, e.g. ``kernels.kpost_bytes``) are counted as its RBF
launches are: the calls the body makes while it is captured are kept in the
program (``Program.counts``, :func:`~ital_tpu_torch.utils.logging.
program_counts`), whether tracing is on or off, and each replay adds them to
the segment being recorded while tracing is on, inside the check that the
copy-out's counter already makes (with tracing off a replay reads no more
flags than before).  A call that captures counts them twice, as it does its
launches: once as its eager warm-up runs the body, once at its replay.  An
eager call (:func:`eager`, the CPU) counts them as the body runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import weakref
from typing import Any, Callable, Optional

import torch

from ital_tpu_torch.ops import rbf_hopper
from ital_tpu_torch.utils.logging import add_counts, count, program_counts, span, timed, tracing

# (name, static, device, inputs' layouts, shared tensors' addresses, precision, mesh) -> Program
_PROGRAMS: dict = {}
_LOCK = threading.RLock()  # every program's capture, copy-in, replay and copy-out
_POOLS: dict = {}  # mesh uid (None: the single-device programs) -> their memory pool
_LOCAL = threading.local()  # .eager: eager() depth; .pending: checks of a body being captured
_USES = itertools.count(1)  # the order of the programs' calls, for STACK_BYTES
_CAPTURES = [0]  # programs captured in this process (released ones included)
_ROOM = [0]  # programs released to make room after an out-of-memory error
# (mesh uid, input name, slice shape, strides, dtype, device) -> Stage
_STAGES: dict = {}
# Key -> why it was released (stack_bytes, stage_grown, dead_corpus, room), at most
# _RELEASED_KEPT of them, the oldest dropped first: a capture of the key names it.
_RELEASED: dict = {}
_RELEASED_KEPT = 1024
# Devices whose tensors a call runs through a captured graph.
_GRAPH_DEVICES = ("cuda",)
# Bytes of the stages of one mesh (or of the single-device programs), each
# counted once, the least recently used released first.  On an H100 at cap
# 64 a session's slices are 6.3 MiB at 25 000 x 512 and 25.2 MiB at 100 000
# (chip_smoke.py phases 8-9), about 252 MiB at 1M rows: a program of 8
# sessions there held 2018.11 MiB of them (phase 15, H100 80GB HBM3 at 700
# W).  Every stacked program of up to 8 sessions binds the same stages, so at
# 1M rows the selection of 8 and the updates of 3 to 8 hold one such set
# between them, and the default of 4 GiB keeps it.
STACK_BYTES = 4 << 30


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
    key: tuple = ()
    shared: tuple = ()  # weak references to the tensors the program reads in place
    # Of its own static input and output buffers (not the stages it binds,
    # nor the pool's temporaries).
    static_bytes: int = 0
    pool_bytes: int = 0  # growth of the graph pools' segments at the capture
    replays: int = 0
    last_used: int = 0
    stages: tuple = ()  # the stages its list inputs are bound to
    done: Any = None  # CUDA event after the last call's copy-out
    mesh: Optional[int] = None  # the uid of the mesh whose collectives it holds
    pinned: tuple = ()  # a mesh program's shared tensors, held while it lives
    # The count() calls of its capture, (name, attributes) -> n, counted at each replay.
    counts: dict = dataclasses.field(default_factory=dict)

    @property
    def stacks(self) -> bool:
        """Whether it stacks sessions' buffers (a list input) and lives."""
        return bool(self.stages)

    def release(self) -> None:
        """Drop the graph and the static buffers, once the last call is done;
        the stages it bound stay."""
        if self.done is not None:
            self.done.synchronize()
        self.graph, self.inputs, self.outputs, self.checks = None, {}, (), []
        self.pinned, self.stages = (), ()


@dataclasses.dataclass(eq=False)
class Stage:
    """The (Kmax, ...) buffer that every program with a list input of one
    name and slice layout binds its first K slices of."""

    key: tuple
    buffer: torch.Tensor
    done: Any = None  # CUDA event after the copy-out of the last call that bound it
    last_used: int = 0

    @property
    def nbytes(self) -> int:
        return self.buffer.numel() * self.buffer.element_size()

    def release(self) -> None:
        """Let the buffer go, once the last call that bound it is done."""
        if self.done is not None:
            self.done.synchronize()


def _wait_for(device: torch.device, events) -> None:
    """Order the current stream after each of ``events`` (earlier calls'
    copy-outs, on whatever stream they ran; ``None``: none), each once."""
    for event in set(events) - {None}:
        torch.cuda.current_stream(device).wait_event(event)


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
        _checked(check, value)
    else:
        pending.append((value, check))


def _checked(check: Callable[[torch.Tensor], None], value: torch.Tensor) -> None:
    """``check(value)``; an exception it raises is marked as a check's."""
    try:
        check(value)
    except Exception as exc:
        exc.ital_check_failed = True
        raise


def uniform_failure(exc: BaseException) -> bool:
    """Whether ``exc`` was raised by a check (:func:`check_after`): on a mesh
    a check reads values every rank holds alike, so every rank raised it at
    the same point, after the program's collectives and before any write."""
    return bool(getattr(exc, "ital_check_failed", False))


def _graphed(device: torch.device) -> bool:
    return (device.type in _GRAPH_DEVICES and not getattr(_LOCAL, "eager", 0)
            and not in_program())


def _is_list(v) -> bool:
    return isinstance(v, (list, tuple))


def _list_spec(v) -> tuple:
    """(K, shape, stride, dtype, device) of a list input; raises where its
    tensors differ in any of them."""
    specs = {(tuple(t.shape), t.stride(), t.dtype, t.device) for t in v}
    if len(specs) != 1:
        raise ValueError(f"a list input needs tensors of one shape, layout, dtype and device; "
                         f"got {sorted(map(str, specs))}")
    return (len(v), *specs.pop())


def _stack_buffer(v) -> torch.Tensor:
    """An empty (K, ...) buffer for list input ``v``, each slice in the
    layout of ``v``'s tensors where they are row- or column-major (the
    library's Cholesky factor is column-major), else row-major."""
    k, shape, stride, dtype, device = _list_spec(v)
    t = v[0]
    if t.dim() == 2 and not t.is_contiguous() and t.mT.is_contiguous():
        numel = t.numel()
        return torch.empty_strided((k, *shape), (numel, 1, shape[0]), dtype=dtype, device=device)
    return torch.empty((k, *shape), dtype=dtype, device=device)


def _stacked(v) -> torch.Tensor:
    """List input ``v`` stacked into a new buffer, as a program holds it."""
    buf = _stack_buffer(v)
    for j, t in enumerate(v):
        buf[j].copy_(t)
    return buf


def _signature(name, static, inputs, shared, device, mesh) -> tuple:
    def spec(v):
        if v is None or isinstance(v, int):
            return type(v).__name__
        if _is_list(v):
            return ("list", *_list_spec(v)[:4])
        return tuple(v.shape), v.stride(), v.dtype

    return (name, static, device, tuple((k, spec(v)) for k, v in inputs.items()),
            tuple((k, v.data_ptr(), tuple(v.shape), v.stride(), v.dtype)
                  for k, v in shared.items()),
            torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
            None if mesh is None else ("mesh", mesh.uid))


def _device_of(inputs: dict) -> torch.device:
    for v in inputs.values():
        if isinstance(v, torch.Tensor):
            return v.device
    raise ValueError("a program needs at least one tensor input")


def _as_tensor(v, device):
    """An input as the body sees it: a host int becomes a 0-d int64 tensor on
    ``device``, written by a fill (no copy from the host); a list of K
    tensors their (K, ...) stack."""
    if isinstance(v, int):
        return torch.full((), v, dtype=torch.int64, device=device)
    if _is_list(v):
        return _stacked(v)
    return v


def _bytes(values) -> int:
    """Bytes of the tensors among ``values``, each tensor of a list input."""
    tensors = [t for v in values for t in (v if _is_list(v) else [v])
               if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in tensors)


def _load(buffers: dict, inputs: dict) -> None:
    if tracing():
        count("graphs.copy_bytes", _bytes(inputs.values()), dir="in")
    for k, v in inputs.items():
        if isinstance(v, int):
            buffers[k].fill_(v)
        elif _is_list(v):
            for j, t in enumerate(v):
                buffers[k][j].copy_(t)
        elif v is not None:
            buffers[k].copy_(v)


def _write_back(inputs: dict, buffers: dict, writes: tuple) -> None:
    """Copy the written ``buffers`` into the caller's inputs: a list input's
    K tensors slice by slice, a tensor where it is not the buffer itself."""
    if tracing():
        count("graphs.copy_bytes", _bytes(inputs[k] for k in writes
                                          if _is_list(inputs[k]) or inputs[k] is not buffers[k]),
              dir="back")
    for k in writes:
        v = inputs[k]
        if _is_list(v):
            for j, t in enumerate(v):
                t.copy_(buffers[k][j])
        elif v is not buffers[k]:
            v.copy_(buffers[k])


def _release_dead() -> None:
    """Release the programs whose shared tensors (their corpus) are gone: no
    live tensor can match their key but one that lands at the same address,
    and until then they only hold memory.  A mesh program holds its shared
    tensors and goes with its mesh (:func:`release_mesh`)."""
    for key, prog in list(_PROGRAMS.items()):
        if prog.mesh is None and any(ref() is None for ref in prog.shared):
            _release(key, "dead_corpus")


def _release(key: tuple, reason: str) -> None:
    """Release the program of ``key``, remembering why for its next capture."""
    prog = _PROGRAMS.pop(key)
    with span("graphs.release", program=prog.name, reason=reason):
        prog.release()
    _RELEASED.pop(key, None)
    _RELEASED[key] = reason
    if len(_RELEASED) > _RELEASED_KEPT:
        del _RELEASED[next(iter(_RELEASED))]


def release_mesh(mesh) -> None:
    """Release every program of ``mesh`` (each rank its own), before its
    process group is destroyed: no graph may outlive the communicator it
    holds, and a later mesh captures its programs anew."""
    with _LOCK:
        for key, prog in list(_PROGRAMS.items()):
            if prog.mesh == mesh.uid:
                del _PROGRAMS[key]
                prog.release()
        for key in [key for key in _STAGES if key[0] == mesh.uid]:
            _STAGES.pop(key).release()
        _POOLS.pop(mesh.uid, None)


def _out_of_memory(exc: BaseException) -> bool:
    """Whether ``exc``, or an exception it was raised from or while
    handling, is the device running out of memory."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return False


def _release_for_room() -> bool:
    """Release every single-device program and drop their stages and pool,
    whose memory then goes back to the device at the next
    ``torch.cuda.empty_cache()`` (a capture empties the cache first, and
    the allocator does before it reports running out).  Releasing only
    some would free nothing: the pool stays while any program in it lives.
    (An m = 8 full scan's pool takes 44-52 GiB of the H100's 80 GB, and a
    second one's capture beside it ran out, PERF.md §6.)  Returns whether
    any program or stage was released."""
    held = [key for key, prog in _PROGRAMS.items() if prog.mesh is None]
    for key in held:
        _release(key, "room")
    stages = [key for key in _STAGES if key[0] is None]
    for key in stages:
        _drop_stage(key, "room")
    _POOLS.pop(None, None)
    _ROOM[0] += len(held)
    return bool(held or stages)


def _making_room(call: Callable[[], Any], mesh: Optional[int]) -> Any:
    """``call()``; where the device runs out of memory for a single-device
    call while single-device programs or stages are held, release them and
    call it once more."""
    try:
        return call()
    except Exception as exc:
        if mesh is not None or not _out_of_memory(exc):
            raise
        with _LOCK:
            if not _release_for_room():
                raise
    # The failed attempt's tensors went with its exception.
    return call()


def _stage_needs(inputs: dict, mesh: Optional[int]) -> dict:
    """Input name -> (stage key, K) of each list input of ``inputs``."""
    return {k: ((mesh, k, *_list_spec(v)[1:]), len(v)) for k, v in inputs.items()
            if _is_list(v)}


def _lacks(key: tuple, k: int) -> bool:
    """Whether no stage of ``key`` holds ``k`` slices."""
    stage = _STAGES.get(key)
    return stage is None or stage.buffer.shape[0] < k


def _stage_event(inputs: dict, mesh: Optional[int]) -> str:
    """What a capture of ``inputs`` does to the stages: ``none`` without a
    list input, ``reused`` where each stage holds its K slices, else
    ``grown``."""
    needs = _stage_needs(inputs, mesh)
    if not needs:
        return "none"
    return "grown" if any(_lacks(key, k) for key, k in needs.values()) else "reused"


def _bind_stages(inputs: dict, mesh: Optional[int]) -> dict:
    """Input name -> the stage of each list input of a capture, made or grown
    to the input's K slices where it lacks them.  Growing releases the
    programs bound to the old buffer; a new or grown stage first makes room
    for itself among the stages of the mesh of uid ``mesh`` (``None``: the
    single-device ones) (:func:`_stage_room`)."""
    needs = _stage_needs(inputs, mesh)
    grown = {name: key for name, (key, k) in needs.items() if _lacks(key, k)}
    for key in grown.values():
        if key in _STAGES:
            _drop_stage(key, "stage_grown")
    if grown:
        _stage_room(_bytes(inputs[name] for name in grown), mesh,
                    {key for key, _ in needs.values()})
    for name, key in grown.items():
        _STAGES[key] = Stage(key, _stack_buffer(inputs[name]))
    if tracing():
        for name in needs:
            count("graphs.stage_bytes", _bytes([inputs[name]]),
                  event="grown" if name in grown else "reused")
    return {name: _STAGES[key] for name, (key, _) in needs.items()}


def _drop_stage(key: tuple, reason: str) -> None:
    """Drop the stage of ``key``, first releasing the programs bound to it."""
    stage = _STAGES.pop(key)
    for pkey, prog in list(_PROGRAMS.items()):
        if any(s is stage for s in prog.stages):
            _release(pkey, reason)
    stage.release()


def _stage_room(need: int, mesh: Optional[int], keep: set) -> None:
    """Release stages of the mesh of uid ``mesh`` but those of ``keep``, and
    the programs bound to them, until its stages and ``need`` bytes more fit
    in :data:`STACK_BYTES`: first those no program binds, then the least
    recently used.  Every rank of a mesh releases the same."""
    while True:
        held = [stage for key, stage in _STAGES.items() if key[0] == mesh]
        free = [stage for stage in held if stage.key not in keep]
        if not free or need + sum(stage.nbytes for stage in held) <= STACK_BYTES:
            return
        bound = {id(s) for prog in _PROGRAMS.values() for s in prog.stages}
        stage = min(free, key=lambda s: (id(s) in bound, s.last_used))
        _drop_stage(stage.key, "stack_bytes")


def run(name: str, body: Callable[..., tuple], inputs: dict, *, shared: Optional[dict] = None,
        static: tuple = (), writes: tuple = (), mesh=None) -> tuple:
    """``body(**shared, **inputs)``, a tuple of tensors, through its program.

    ``inputs``: tensors on one device (CUDA or CPU), ``None``, host ints
    (the body gets a 0-d int64 tensor) or lists of K same-shaped tensors (the
    body gets their (K, ...) stack, the first K slices of a stage shared
    with the other programs, which counts against :data:`STACK_BYTES`);
    ``shared``: tensors the program reads where they are, keyed by their
    address (the corpus); ``static``: the hashable options ``body`` closes
    over; ``writes``: the inputs the body writes in place, copied back after
    a replay (a list input slice by slice, also when the body runs
    eagerly); ``mesh``: the corpus mesh whose collectives the body calls
    (every rank calls ``run`` alike).  Returns the outputs, as
    tensors of the caller's own.  The body's :func:`check_after` checks run
    after each replay, before any write is copied back: one that raises
    leaves the caller's tensors as they were.
    """
    shared = shared or {}
    device = _device_of(inputs)
    graphed = _graphed(device)
    with span("graphs.run", program=name, graphed=graphed):
        if graphed:
            return _replay(name, body, inputs, shared, static, writes, device, mesh)
        return _eagerly(body, inputs, shared, writes, device, mesh)


def _eagerly(body, inputs: dict, shared: dict, writes: tuple, device, mesh) -> tuple:
    """:func:`run`'s call of ``body`` on the caller's tensors."""
    def call():
        args = {k: _as_tensor(v, device) for k, v in inputs.items()}
        out = body(**shared, **args)
        _write_back(inputs, args, writes)
        return out

    if device.type in _GRAPH_DEVICES and not in_program() and not writes:
        return _making_room(call, None if mesh is None else mesh.uid)
    return call()


def _replay(name, body, inputs: dict, shared: dict, static: tuple, writes: tuple, device,
            mesh) -> tuple:
    """:func:`run`'s call through the program of the call's signature,
    captured first where none is held."""
    key = _signature(name, static, inputs, shared, device, mesh)
    with _LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = _new_program(name, body, inputs, shared, device, key, mesh)
        if not prog.shared or any(ref() is None for ref in prog.shared):
            # A new tensor at a dead one's address and layout: the program is its.
            prog.shared = tuple(weakref.ref(t) for t in shared.values())
        # This program's last copy-out, and that of the last call on each of its stages.
        _wait_for(device, [prog.done, *(stage.done for stage in prog.stages)])
        with span("graphs.copy_in"):
            _load(prog.inputs, inputs)
        with span("graphs.replay"):
            prog.graph.replay()
        prog.replays += 1
        prog.last_used = next(_USES)
        for stage in prog.stages:
            stage.last_used = prog.last_used
        rbf_hopper.add_launches(prog.launches)
        if prog.checks:
            with span("graphs.checks.wait"):
                for value, check in prog.checks:
                    _checked(check, value)
        if writes:
            with span("graphs.copy_back"):
                _write_back(inputs, prog.inputs, writes)
        with span("graphs.copy_out"):
            out = tuple(o.clone() for o in prog.outputs)
        if tracing():
            count("graphs.copy_bytes", _bytes(out), dir="out")
            add_counts(prog.counts)
        if device.type == "cuda":
            prog.done = torch.cuda.Event()
            prog.done.record(torch.cuda.current_stream(device))
            for stage in prog.stages:
                stage.done = prog.done
        return out


def _new_program(name, body, inputs: dict, shared: dict, device, key: tuple, mesh) -> Program:
    """Capture the program of ``key`` and hold it, first releasing the
    programs whose corpus is gone and, for one that stacks sessions, making
    or growing its stages (:func:`_bind_stages`)."""
    uid = None if mesh is None else mesh.uid
    reason = _RELEASED.get(key)
    cause = "new" if reason is None else f"after_{reason}"
    with span("graphs.capture", program=name, cause=cause, stage=_stage_event(inputs, uid)):
        _release_dead()
        prog = _making_room(lambda: _capture(name, body, inputs, shared, device, uid), uid)
        prog.key, prog.mesh = key, uid
        if mesh is not None:
            prog.pinned = tuple(shared.values())
        _PROGRAMS[key] = prog
        _RELEASED.pop(key, None)
        _CAPTURES[0] += 1
    return prog


def _capture(name, body, inputs, shared, device, mesh: Optional[int]) -> Program:
    # Each buffer keeps its input's layout: the library's Cholesky factor is
    # column-major, and a row-major copy would round its solves differently.
    # A list input's buffer is the first K slices of its stage.
    stages = _bind_stages(inputs, mesh)
    _wait_for(device, [stage.done for stage in stages.values()])
    buffers = {k: None if v is None else
               torch.empty((), dtype=torch.int64, device=device) if isinstance(v, int) else
               stages[k].buffer[:len(v)] if _is_list(v) else
               torch.empty_like(v) for k, v in inputs.items()}
    _load(buffers, inputs)
    with span("graphs.pool_bytes"):
        pools = _pool_bytes(device)
    with program_counts() as counts:
        graph, outputs, checks, launches, warmup_ms, capture_ms, instantiate_ms = (
            _capture_graph(name, body, buffers, shared, device, mesh))
    with span("graphs.pool_bytes"):
        grown = _pool_bytes(device) - pools
    own = [t for k, t in buffers.items() if t is not None and k not in stages] + list(outputs)
    return Program(name=name, graph=graph, inputs=buffers, outputs=outputs,
                   checks=checks, launches=launches, warmup_ms=warmup_ms,
                   capture_ms=capture_ms, instantiate_ms=instantiate_ms,
                   static_bytes=_bytes(own), pool_bytes=grown,
                   stages=tuple(stages.values()), counts=counts)


def _pool_bytes(device: torch.device) -> int:
    """Bytes of the device's segments in graph pools (any pool but the
    default one); 0 off the card."""
    if device.type != "cuda":
        return 0
    torch.cuda.empty_cache()  # as a capture does first: count only what is held
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg.get("device", device.index) == device.index
               and tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def _capture_graph(name, body, buffers, shared, device, mesh):
    """Warm ``body`` up on a side stream, then capture it into a graph that
    allocates from the pool of the programs of mesh uid ``mesh`` (``None``:
    the single-device programs).

    The warm-up runs the body once on the static buffers: it loads the
    kernels' library, makes the kernels' first ``cudaFuncSetAttribute`` and
    fills the device tables' caches, none of which a capture may do.  Returns
    (graph, outputs, checks, launches by route, warm-up ms, capture ms,
    instantiate ms), the durations of the spans ``graphs.warmup``,
    ``graphs.record`` and ``graphs.instantiate``; the capture ms include the
    synchronization before it.
    """
    with timed("graphs.warmup") as warmup:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), _in_program(), program_counts(record=False):
            body(**shared, **buffers)
        torch.cuda.current_stream(device).wait_stream(side)
    if not any(prog.mesh == mesh for prog in _PROGRAMS.values()):
        # A failed capture may have left the pool with no graph, and a
        # capture may not join such a pool.
        _POOLS.pop(mesh, None)
    if mesh not in _POOLS:
        _POOLS[mesh] = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    record = timed("graphs.record").open()  # the capture starts with a synchronization
    instantiate = None
    try:
        with rbf_hopper.recording_launches() as launches, _in_program() as checks:
            with torch.cuda.graph(graph, pool=_POOLS[mesh], capture_error_mode="thread_local"):
                outputs = tuple(body(**shared, **buffers))
                record.close()
                instantiate = timed("graphs.instantiate").open()
        instantiate.close()
    except Exception as exc:
        raise CaptureError(f"capturing program {name!r} failed: {exc}") from exc
    finally:
        record.close()
        if instantiate is not None:
            instantiate.close()
    return graph, outputs, checks, launches, warmup.ms, record.ms, instantiate.ms


def programs() -> list[Program]:
    """Every program captured in this process and not released since, in
    capture order."""
    with _LOCK:
        return list(_PROGRAMS.values())


def stages() -> list[Stage]:
    """Every stage held, in the order they were made."""
    with _LOCK:
        return list(_STAGES.values())


def captures() -> int:
    """How many programs this process has captured, released ones included:
    a capture may release other programs, so the count of :func:`programs`
    does not tell whether a call captured."""
    with _LOCK:
        return _CAPTURES[0]


def released_for_room() -> int:
    """How many programs this process has released to make room for a call
    that ran out of device memory."""
    with _LOCK:
        return _ROOM[0]
