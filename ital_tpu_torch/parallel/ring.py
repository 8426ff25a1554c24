"""Ring passes over the sharded corpus axis (port of ``ital_tpu.parallel.ring``).

Strategies whose score needs an interaction between every candidate and
every corpus row (EMOC's column-abs-sums, MCMI's whole-corpus hypothetical
entropy, the corpus density) keep their candidates fixed on each rank and
pass the corpus shards around the ring: at step ``s`` a rank holds the
blocks of rank ``(me + s) % p``, received from its right neighbour while it
works on the blocks it has, so the N^2 work splits p ways and only O(N/p)
rows move per step.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from ital_tpu_torch.parallel.mesh import Mesh


def _start_shift(mesh: Mesh, blocks: Sequence[torch.Tensor]):
    """Send ``blocks`` to the left neighbour and receive the right one's;
    returns the pending requests and the buffers being received."""
    left, right = (mesh.rank - 1) % mesh.size, (mesh.rank + 1) % mesh.size
    incoming = [torch.empty_like(b) for b in blocks]
    ops = []
    for out, inc in zip(blocks, incoming):
        ops.append(dist.P2POp(dist.isend, out, left, group=mesh.group))
        ops.append(dist.P2POp(dist.irecv, inc, right, group=mesh.group))
    return dist.batch_isend_irecv(ops), incoming


def ring_reduce_over_corpus(
    mesh: Mesh,
    blocks: Sequence[torch.Tensor],
    accumulate: Callable[[Any, Sequence[torch.Tensor]], Any],
    init: Any,
) -> Any:
    """Accumulate ``accumulate(acc, blocks)`` over every rank's ``blocks``.

    ``blocks``: this rank's contiguous tensors, which travel the ring
    together (their leading dims need not match).  ``accumulate`` is called
    once per step; at step ``s`` the blocks are those of rank
    ``(me + s) % p``, the reference's visiting order.  Each step's transfer
    runs while ``accumulate`` works on the blocks already here.
    """
    blocks = [b.contiguous() for b in blocks]
    acc = init
    for s in range(mesh.size):
        pending = None
        if s < mesh.size - 1:
            pending = _start_shift(mesh, blocks)
        acc = accumulate(acc, blocks)
        if pending is not None:
            reqs, blocks = pending
            for r in reqs:
                r.wait()
    return acc
