"""Apply a function over fixed-size row blocks (``ital_tpu.ops.blocking``).

PyTorch runs eagerly, so the reference's ``lax.map`` becomes a Python loop
over blocks.  Padding is kept: every block has exactly ``block`` rows, the
last one padded with ``pad_values``, so each block computes what the
reference's block computes.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def blocked_map(
    fn: Callable[..., torch.Tensor],
    arrays: Sequence[torch.Tensor],
    *,
    block: int,
    pad_values: Sequence[Any] | None = None,
) -> torch.Tensor:
    """``cat([fn(*blk) for blk in row-blocks of arrays])[:n]``.

    Args:
      fn: maps per-block slices (leading dim ``block``, or ``n`` when the
        whole input fits in one block) to a tensor with the same leading dim.
      arrays: same leading dim ``n``; streamed together.
      block: rows per block; the last block is zero-padded (or per-array
        ``pad_values``) and the padded outputs sliced away.
      pad_values: optional per-array pad constants (e.g. 1.0 for a variance
        vector so downstream sqrt/division stays finite on pad rows); must
        match ``arrays`` in length.
    """
    n = arrays[0].shape[0]
    if pad_values is not None and len(pad_values) != len(arrays):
        raise ValueError(
            f"pad_values has {len(pad_values)} entries for {len(arrays)} "
            f"arrays — a silent zip truncation would drop streamed inputs"
        )
    if n <= block:
        return fn(*arrays)
    if pad_values is None:
        pad_values = [0.0] * len(arrays)
    outs = []
    for start in range(0, n, block):
        blk = []
        for a, pv in zip(arrays, pad_values):
            part = a[start:start + block]
            short = block - part.shape[0]
            if short:
                fill = torch.full((short, *a.shape[1:]), pv, dtype=a.dtype,
                                  device=a.device)
                part = torch.cat([part, fill])
            blk.append(part)
        outs.append(fn(*blk))
    return torch.cat(outs)[:n]
