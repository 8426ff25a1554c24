#!/usr/bin/env python3
"""Time the GP's triangular solves of a wide right-hand side on the card.

``gp_update`` solves ``L_b x = r`` for its (b, N) corpus-wide rows under the
feedback block's (b, b) factor, and ``gp_fit`` ``L x = K_lN`` for its
(cap, N) rows.  This times the forms of that solve at m = 4 (the update's
block) and m = 64 (the fit's cap) for one session and a stack of 8, at
N = 1000, 100 000 and 1M, with a host clock around calls that end in
``torch.cuda.synchronize()``, the mean of five calls (one call of the
left-side form at 1M):

* ``left``: ``torch.linalg.solve_triangular(L, r)``, cuBLAS's left-side solve;
* ``right``: the right-side solve of the transposed system on ``r``'s own
  row-major buffer;
* ``inverse``: ``L``'s inverse times ``r``;
* ``tri_solve``: ``ops/chol.py::tri_solve``, the port's op (the right-side
  form for a right-hand side wider than ``L``);

and prints each form's largest difference to the left-side values (to the
right-side ones where the left-side form is skipped); each form but the
left-side one at 1M is called once first, untimed.  The
left-side form of a stack of 8 at 1M is skipped (a single session's took
9.7 s at m = 4).  Run from the repository root on the GPU machine::

    python3 scripts/wide_solve_torch.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from ital_tpu_torch.ops.chol import tri_solve  # noqa: E402


def timed(fn, reps: int):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def variants(l: torch.Tensor, b: torch.Tensor) -> dict:
    m = l.shape[-1]
    return {"left": lambda: torch.linalg.solve_triangular(l, b, upper=False),
            "right": lambda: torch.linalg.solve_triangular(l.mT, b.mT, upper=True,
                                                           left=False).mT,
            "inverse": lambda: torch.linalg.solve_triangular(
                l, torch.eye(m, device=l.device).expand_as(l), upper=False) @ b,
            "tri_solve": lambda: tri_solve(l, b)}


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    for m, k, n in ((m, k, n) for m in (4, 64) for k in (1, 8)
                    for n in (1000, 100_000, 1_000_000)):
        l = torch.tril(torch.randn(k, m, m, device=dev, generator=g) * 0.1
                       + torch.eye(m, device=dev) * 2)
        b = torch.randn(k, m, n, device=dev, generator=g)
        if k == 1:
            l, b = l[0], b[0]
        want, first = None, None
        for name, fn in variants(l, b).items():
            once = name == "left" and n == 1_000_000
            if once and k == 8:
                continue
            if not once:
                fn()
            ms, out = timed(fn, 1 if once else 5)
            if want is None:
                want, first = out, name
            print(f"K={k} m={m} N={n} {name}: {ms:.3f} ms, max diff to {first} "
                  f"{float((out - want).abs().max()):.2e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
