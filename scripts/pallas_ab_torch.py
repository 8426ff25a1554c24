#!/usr/bin/env python3
"""The PyTorch port's A/B of the RBF kernel's routes at the router's consumers.

The port's counterpart of ``scripts/pallas_ab.py``, with its consumer
cases, block, cap and width (block 2048, cap 64, D 512) and its record
layout ``scales[N][route][case]``:

- ``emoc_block``: one block of ``ops/kernels.py::blockwise_reduce_abs_kpost``:
  the (N, 2048) cross-kernel block of 2048 candidates, the posterior
  correction with the (64, N) whitened ``v``, the column abs-sum;
- ``density_block``: one block of ``models/gp.py::corpus_density``: the
  (2048, N) block, its row means;
- ``materialized``: the raw (N, 2048) block, summed so that every route
  writes and reads it alike (skipped at 1M, an 8 GB block);
- ``a2_slab`` (1M rows, f32 only): the full scan's (N, 3, 512) cross block
  against a 3-row partial batch with cached corpus norms, where the
  tensor-core route (1.157 ms in ``chip_smoke.py`` phase 15) trailed plain
  torch (0.972-0.986 ms).

Each case runs through each of the port's three routes: the tensor-core
kernel (``"wgmma"``, ``csrc/rbf_wgmma.cu``), the tile kernel (``"tile"``,
``csrc/rbf_tile.cu``), both forced through ``ops.rbf_hopper.rbf_tile``, and
the plain torch composition (``"plain"``, ``ops.kernels.rbf_kernel_plain``),
at N = 25 000, 100 000, 250 000, 500 000 and 1M, on an f32 corpus
(``scales``) and on a bfloat16 one with f32 norms (``scales_bf16``).  Each
entry is ``study_torch.time_call``'s (the first call alone, then CUDA-event
runs graphed and under ``graphs.eager()``), a fresh candidate block a call,
plus the route the router (``rbf_hopper.choose_route``) picks for the
case's kernel call; ``fastest`` names each case's fastest route, graphed,
and whether the router picked the faster kernel route.  The router is not
changed by this record.

Held: each kernel route's (N, 2048) block equals the plain version's
within 1e-5 x var (f32) and 1e-4 x var (bf16), and so do the reduced
outputs (the column sums within N times that, the row means within it).
The reference's times are its TPU's, a record, not a target.

Writes ``results/pallas_ab_torch.json`` (``--out``).  Run from the
repository root::

    python3 scripts/pallas_ab_torch.py

It needs a CUDA card unless ``--device cpu`` is given (``--scales 600
--dim 32``: the CPU tests' size, plain route only).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import study_torch as st  # noqa: E402
from pool_refine_torch import PROTOCOL  # noqa: E402

BLOCK = 2048  # the consumers' streaming block (ops/kernels.py, models/gp.py)
CAP = 64
D = 512
SCALES = (25_000, 100_000, 250_000, 500_000, 1_000_000)
ROUTES = ("wgmma", "tile", "plain")
CASES = ("emoc_block", "density_block", "materialized")
MATERIALIZED_MAX = 4 << 30  # bytes of the (N, 2048) block: skips 1M, as the reference does
# The reference's length scale (6.0) puts every off-diagonal entry of its
# N(0, 1) rows near exp(-14), where no route can err; 16 puts them near
# exp(-2).  The times do not depend on it.
LS, VAR = 16.0, 1.0
ATOL = {"float32": 1e-5, "bfloat16": 1e-4}
CALLS = 8  # fresh candidate blocks cycled through the timed calls


def impl(route: str):
    """The RBF block of ``route``: ``f(a, b, ls, var, a2, b2)``."""
    from ital_tpu_torch.ops import rbf_hopper
    from ital_tpu_torch.ops.kernels import rbf_kernel_plain

    if route == "plain":
        return lambda a, b, ls, var, a2, b2: rbf_kernel_plain(a, b, ls, var, a2=a2, b2=b2)
    return lambda a, b, ls, var, a2, b2: rbf_hopper.rbf_tile(a, b, ls, var, a2=a2, b2=b2,
                                                             _route=route)


def case_body(case: str, route: str):
    """The program body of ``case`` through ``route``:
    ``body(x, v, x2, idx) -> (out,)``."""
    rbf = impl(route)

    def body(x, v, x2, idx):
        xc, xc2 = x[idx], x2[idx]
        if case == "emoc_block":
            k_post = (rbf(x, xc, LS, VAR, x2, xc2) - v.T @ v[:, idx]).abs_()
            return (k_post.sum(0),)
        if case == "density_block":
            return (rbf(xc, x, LS, 1.0, xc2, x2).mean(1),)
        if case == "materialized":
            return (rbf(x, xc, LS, VAR, x2, xc2).sum(),)
        return (rbf(x, xc[:3], LS, VAR, x2, None).sum(),)  # a2_slab
    return body


def router_choice(case: str, x, idx) -> str:
    """The route ``choose_route`` picks for ``case``'s kernel call."""
    from ital_tpu_torch.ops import rbf_hopper

    n, b = x.shape[0], (3 if case == "a2_slab" else idx.shape[0])
    m, nn = (b, n) if case == "density_block" else (n, b)
    xc = x[idx[:b]]
    a, bb = (xc, x) if case == "density_block" else (x, xc)
    return rbf_hopper.choose_route(m, nn, x.shape[1], x.dtype, a.data_ptr(), bb.data_ptr()).name


def check_routes(torch, x, v, x2, idx, routes, dtype: str) -> dict:
    """Each kernel route's (N, 2048) block and reduced outputs against
    plain: ``{route: {"block", "emoc_block", "density_block"}}`` max abs
    errors over var, and ``held``."""
    tol = ATOL[dtype]
    xc, xc2 = x[idx], x2[idx]
    out = {}
    plain = {c: case_body(c, "plain")(x, v, x2, idx)[0] for c in ("emoc_block", "density_block")}
    for route in routes:
        if route == "plain":
            continue
        rbf, err = impl(route), 0.0
        for lo in range(0, x.shape[0], 1 << 17):  # (131072, 2048) blocks
            rows = slice(lo, lo + (1 << 17))
            got = rbf(x[rows], xc, LS, VAR, x2[rows], xc2)
            want = impl("plain")(x[rows], xc, LS, VAR, x2[rows], xc2)
            err = max(err, float((got - want).abs().max()) / VAR)
        e = {"block": err}
        for c, want in plain.items():
            e[c] = float((case_body(c, route)(x, v, x2, idx)[0] - want).abs().max()) / VAR
        e["held"] = bool(err <= tol and e["density_block"] <= tol
                         and e["emoc_block"] <= tol * x.shape[0])
        out[route] = e
    return out


def run_scale(torch, device, x_all, v_all, n: int, dtype: str, routes, log=print,
              target_s: float = 0.25) -> dict:
    """``{route: {case: entry}}`` of one corpus size and dtype, plus the
    router's pick and the fastest route per case and the route check."""
    from ital_tpu_torch import graphs

    x = x_all[:n].contiguous()
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    x2 = (x.float() ** 2).sum(-1)  # f32 norms of the stored values
    v = v_all[:, :n].contiguous()
    gen = torch.Generator(device="cpu").manual_seed(n)
    idxs = [torch.randint(0, n, (BLOCK,), generator=gen).to(device) for _ in range(CALLS)]
    cases = list(CASES if n * BLOCK * 4 <= MATERIALIZED_MAX else CASES[:2])
    if n == SCALES[-1] and dtype == "float32":
        cases.append("a2_slab")
    rec: dict = {}
    for route in routes:
        for case in cases:
            body, turn = case_body(case, route), iter(range(1 << 30))

            def call():
                idx = idxs[next(turn) % CALLS]
                return graphs.run(f"pallas_ab_{case}", body, {"idx": idx},
                                  shared={"x": x, "v": v, "x2": x2},
                                  static=(route, case, dtype))

            try:
                r = st.time_call(torch, device, call, target_s=target_s)
            except (torch.cuda.OutOfMemoryError, graphs.CaptureError) as exc:
                # Out of memory in the eager warm-up, or in the capture after it.
                if not isinstance(exc.__cause__ or exc, torch.cuda.OutOfMemoryError):
                    raise
                torch.cuda.empty_cache()
                r = {"error": f"out of memory: {str(exc).splitlines()[0]}"}
                log(f"  N={n} {dtype} {route:>5} {case:>13}: out of memory")
                rec.setdefault(route, {})[case] = r
                continue
            r["router"] = router_choice(case, x, idxs[0])
            rec.setdefault(route, {})[case] = r
            log(f"  N={n} {dtype} {route:>5} {case:>13}: {r['ms_per_round']:.4f} ms graphed, "
                f"{r['eager_ms_per_round']:.4f} eager (first call {r['first_call_s']:.2f} s; "
                f"router {r['router']})")
    fastest = {}
    for case in cases:
        ms = {route: rec[route][case]["ms_per_round"] for route in routes
              if "ms_per_round" in rec[route][case]}
        pick = router_choice(case, x, idxs[0])
        kernels = {r: t for r, t in ms.items() if r != "plain"}
        fastest[case] = {"route": min(ms, key=ms.get), "router": pick,
                         "router_is_faster_kernel_route": (pick == min(kernels, key=kernels.get)
                                                           if kernels else None),
                         "plain_beats_router": (ms["plain"] < ms[pick]
                                                if pick in ms and "plain" in ms else None)}
    rec["fastest"] = fastest
    rec["check"] = check_routes(torch, x, v, x2, idxs[0], routes, dtype)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", default=",".join(map(str, SCALES)))
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--dim", type=int, default=D)
    ap.add_argument("--out", default=os.path.join(REPO, "results", "pallas_ab_torch.json"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    import torch

    device = st.open_device(torch, args.device)
    st.record_path(args.out)
    log = lambda s: print(s, flush=True)  # noqa: E731
    routes = ROUTES if device.type == "cuda" else ("plain",)
    scales = [int(s) for s in args.scales.split(",")]
    rng = np.random.default_rng(0)
    n_max = max(scales)
    x_all = torch.as_tensor(rng.standard_normal((n_max, args.dim), np.float32), device=device)
    v_all = torch.as_tensor(rng.standard_normal((CAP, n_max), np.float32) * 0.05, device=device)
    report = {"platform": "gpu" if device.type == "cuda" else "cpu",
              **st.card_fields(torch, device), "protocol": PROTOCOL,
              "block": BLOCK, "cap": CAP, "d": args.dim, "length_scale": LS, "var": VAR,
              "routes": {"wgmma": "csrc/rbf_wgmma.cu (tensor cores, 3xTF32 / bf16)",
                         "tile": "csrc/rbf_tile.cu (FMA tiles)",
                         "plain": "ops.kernels.rbf_kernel_plain (torch)"}}
    for dtype in args.dtypes.split(","):
        key = {"float32": "scales", "bfloat16": "scales_bf16"}[dtype]
        report[key] = {}
        for n in scales:
            log(f"== N = {n} ({dtype})")
            report[key][str(n)] = run_scale(torch, device, x_all, v_all, n, dtype, routes,
                                            log=log)
    checks = [r["check"][route]["held"] for key in ("scales", "scales_bf16")
              for r in report.get(key, {}).values() for route in r["check"]]
    report["held"] = all(checks)
    print("held" if report["held"] else "not held", flush=True)
    st.write_record(args.out, report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
