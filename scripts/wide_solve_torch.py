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
9.7 s at m = 4).

Two more parts time the other wide solves at their own shapes:

* ``regression``: ``ital_regression``'s conditional-variance solve
  (``select/regression.py``, ``parallel/sharded.py``), a (K, t, t) factor on
  the (K, t, N) transpose of a (K, N, t) cross-covariance, at t = 1, 2, 3,
  K = 1 and 8, N = 100 000 and 1M: the left-side solve (once at 1M) against
  ``tri_solve``, each with its residual ``max |L x - b|`` formed in f64;
* ``chol2d``: the large-cap refit's block solves in ``parallel/chol2d.py``
  on a mesh of one at cap 1024 and N = 1M: ``solve2d_local``'s forward and
  transposed solves of the (cap, cap) factor on ``beta``'s (cap, 1)
  right-hand side (and, to look for the cliff, on (cap, N) rows), and
  ``_whiten_``'s solve into ``v``'s own (cap, N) rows with ``out=``.

Run from the repository root on the GPU machine::

    python3 scripts/wide_solve_torch.py [--parts wide,regression,chol2d]
"""

from __future__ import annotations

import argparse
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


def lower(shape, dev, g) -> torch.Tensor:
    """A well-conditioned lower-triangular factor of ``shape`` (..., m, m)."""
    m = shape[-1]
    return torch.tril(torch.randn(shape, device=dev, generator=g) * 0.1
                      + torch.eye(m, device=dev) * 2)


def residual(l: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    """``max |L x - b|``, formed in f64."""
    return float((l.double() @ x.double() - b.double()).abs().max())


def regression_solves(dev, g) -> None:
    """``ital_regression``'s (K, t, N) solve: left-side against ``tri_solve``."""
    for k in (1, 8):
        for t in (1, 2, 3):
            for n in (100_000, 1_000_000):
                chol = lower((k, t, t), dev, g)
                cross = torch.randn(k, n, t, device=dev, generator=g)
                forms = {"left": lambda: torch.linalg.solve_triangular(chol, cross.mT,
                                                                       upper=False),
                         "tri_solve": lambda: tri_solve(chol, cross.mT)}
                want = None
                for name, fn in forms.items():
                    once = name == "left" and n == 1_000_000
                    if not once:
                        fn()
                    ms, out = timed(fn, 1 if once else 5)
                    want = out if want is None else want
                    print(f"regression K={k} t={t} N={n} {name}: {ms:.3f} ms, max diff to "
                          f"left {float((out - want).abs().max()):.2e}, residual "
                          f"{residual(chol, out, cross.mT):.2e}", flush=True)


def chol2d_solves(dev, g, cap: int = 1024, n: int = 1_000_000) -> None:
    """The large-cap refit's block solves on a mesh of one."""
    l = lower((cap, cap), dev, g)
    for cols in (1, n):
        b = torch.randn(cap, cols, device=dev, generator=g)
        forms = {"forward": lambda: torch.linalg.solve_triangular(l, b, upper=False),
                 "transposed": lambda: torch.linalg.solve_triangular(l.T, b, upper=True),
                 "tri_solve": lambda: tri_solve(l, b)}
        for name, fn in forms.items():
            fn()
            ms, _ = timed(fn, 5)
            print(f"chol2d cap={cap} rhs=({cap}, {cols}) {name}: {ms:.3f} ms", flush=True)
    v = torch.randn(cap, n, device=dev, generator=g)
    want = tri_solve(l, v)

    def whiten():
        torch.linalg.solve_triangular(l, v, upper=False, out=v)

    ms, _ = timed(whiten, 1)  # v now holds L^-1 v: compare, then time on it again
    err = float((v - want).abs().max())
    ms5, _ = timed(whiten, 5)
    print(f"chol2d cap={cap} whiten in place ({cap}, {n}) out=: {ms:.3f} ms first, "
          f"{ms5:.3f} ms mean of 5, max diff to tri_solve {err:.2e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="wide,regression,chol2d",
                    help="comma-separated parts to run (default: all three)")
    parts = set(ap.parse_args(argv).parts.split(","))
    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    if "regression" in parts:
        regression_solves(dev, g)
    if "chol2d" in parts:
        chol2d_solves(dev, g)
    if "wide" not in parts:
        return 0
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
