"""Start a mesh's ranks and run one function on each (SPMD).

JAX ran a mesh's shards from one process; ``torch.distributed`` runs one
process per rank.  :func:`launch` runs a mesh of one in the calling process
and starts a larger one with ``torch.multiprocessing`` (spawn), one process
per device, all on one file store in a temporary directory.  Every rank runs
``fn(mesh, *args, **kwargs)``; the call returns rank 0's value.  A rank that
raises fails the call with its traceback, and the other ranks are stopped.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Any, Callable

import torch

from ital_tpu_torch.parallel.mesh import make_mesh


class RankFailed(RuntimeError):
    """A rank of a launched mesh raised; the message holds its traceback."""


def _rank_main(rank: int, n_ranks: int, device_type: str, threads: int, work_dir: str,
               fn: Callable, args: tuple, kwargs: dict) -> None:
    if device_type == "cpu":
        torch.set_num_threads(threads)
    with make_mesh(n_ranks, device=device_type, rank=rank,
                   store_path=os.path.join(work_dir, "store")) as mesh:
        try:
            out = fn(mesh, *args, **kwargs)
        except BaseException:
            # When one rank fails, its peers fail too (their collectives
            # lose it), and spawn reports whichever it sees first: note the
            # time, before this rank's group closes and its peers notice.
            with open(os.path.join(work_dir, f"rank{rank}.err"), "w") as fh:
                fh.write(f"{time.monotonic()!r}\n{traceback.format_exc()}")
            raise
    if rank == 0:
        torch.save(out, os.path.join(work_dir, "rank0.pt"))


def _first_failure(work_dir: str, n_ranks: int):
    """``(rank, traceback)`` of the rank that failed first, or ``None``."""
    found = []
    for rank in range(n_ranks):
        path = os.path.join(work_dir, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as fh:
                stamp, _, tb = fh.read().partition("\n")
            if tb:  # a rank stopped while it wrote leaves less
                found.append((float(stamp), rank, tb))
    return min(found)[1:] if found else None


def launch(n_ranks: int, fn: Callable, *args, device, **kwargs) -> Any:
    """``fn(mesh, *args, **kwargs)`` on every rank of a mesh of ``n_ranks``
    devices of ``device``'s type; returns rank 0's value.

    ``fn`` and its arguments go to the ranks by pickle: ``fn`` must be a
    module-level function, and its module must import cleanly in a new
    process.  CPU ranks share the caller's thread count.  Raises
    :class:`RankFailed` with the traceback of the rank that failed first.
    """
    dev_type = torch.device(device).type
    if n_ranks == 1:
        with make_mesh(1, device=dev_type) as mesh:
            return fn(mesh, *args, **kwargs)
    threads = max(1, torch.get_num_threads() // n_ranks)
    with tempfile.TemporaryDirectory(prefix="ital_mesh_") as work_dir:
        try:
            torch.multiprocessing.spawn(
                _rank_main, nprocs=n_ranks, join=True,
                args=(n_ranks, dev_type, threads, work_dir, fn, args, kwargs))
        except torch.multiprocessing.ProcessRaisedException as exc:
            first = _first_failure(work_dir, n_ranks)
            if first is None:
                raise
            raise RankFailed(f"rank {first[0]} of {n_ranks} failed first:\n{first[1]}") from exc
        return torch.load(os.path.join(work_dir, "rank0.pt"), weights_only=False)
