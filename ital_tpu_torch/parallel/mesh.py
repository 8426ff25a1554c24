"""The corpus mesh: one rank per device on a ``torch.distributed`` process
group (port of ``ital_tpu.parallel.mesh``).

The reference lays a 1-D JAX mesh over its chips and runs one ``shard_map``
body with explicit collectives over the corpus axis.  The port runs the same
shard-local body as SPMD code: one process (rank) per device, each holding
its shard of the corpus, with the collectives as ``torch.distributed`` calls
on the mesh's group — NCCL between cards, gloo between CPU processes.  The
group's store is a file in a temporary directory, so no network is needed.

A :class:`Mesh` owns the default process group it initialised and destroys
it in :meth:`Mesh.close`; :func:`make_mesh` refuses to start while any
default group is initialised, so it never reuses or replaces one that
something else (or a mesh not yet closed) holds.  Each mesh has a uid of its
own in its process, which keys its compiled programs
(:mod:`ital_tpu_torch.graphs`); closing it releases them first.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ital_tpu_torch import graphs

CORPUS_AXIS = "data"
_UIDS = itertools.count()


@dataclasses.dataclass
class Mesh:
    """This rank's view of a 1-D corpus mesh of ``size`` ranks."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str
    _store_dir: Optional[str] = None  # removed on close (a mesh started in-process)
    uid: int = dataclasses.field(default_factory=lambda: next(_UIDS))

    def close(self) -> None:
        """Release the mesh's programs and destroy its process group (every
        rank closes its own)."""
        graphs.release_mesh(self)
        if dist.is_initialized():
            dist.destroy_process_group()
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def device_count(device_type: str) -> Optional[int]:
    """Devices of ``device_type`` a mesh can span: the CUDA device count, or
    ``None`` (no limit) for CPU processes."""
    return torch.cuda.device_count() if device_type == "cuda" else None


def make_mesh(n_devices: Optional[int] = None, *, device, rank: int = 0,
              store_path: Optional[str] = None) -> Mesh:
    """Rank ``rank`` of a mesh over ``n_devices`` devices of ``device``'s type
    (default 1), each rank on its own device: ``cuda:rank`` with NCCL, or a
    CPU process with gloo.

    A mesh of one starts in-process with a store of its own; a larger one is
    started on every rank with one shared ``store_path``
    (:func:`ital_tpu_torch.parallel.launch.launch` does so).  Raises
    ``ValueError`` when more cards are asked for than exist, and
    ``RuntimeError`` while a default process group is initialised.
    """
    dev_type = torch.device(device).type
    n = 1 if n_devices is None else int(n_devices)
    available = device_count(dev_type)
    if n < 1 or (available is not None and n > available):
        raise ValueError(f"requested {n} devices, only {available} available")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n}")
    if (store_path is None) != (n == 1):
        raise ValueError("a mesh of one makes its own store; a larger one needs store_path")
    if dist.is_initialized():
        raise RuntimeError(
            "a default process group is already initialised: close the mesh that "
            "holds it (Mesh.close) before making another; a mesh never reuses or "
            "replaces a group it did not start")
    store_dir = None
    if store_path is None:
        store_dir = tempfile.mkdtemp(prefix="ital_mesh_")
        store_path = os.path.join(store_dir, "store")
    if dev_type == "cuda":
        dev, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(dev)
        extra = {"device_id": dev}
    else:
        dev, backend, extra = torch.device("cpu"), "gloo", {}
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                                world_size=n, **extra)
    except BaseException:
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
        raise
    return Mesh(group=dist.group.WORLD, rank=rank, size=n, device=dev, backend=backend,
                _store_dir=store_dir)
