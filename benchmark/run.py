"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Runs on the card (one process, the cell's
chips); without a CUDA device, or with fewer than the cell asks for, it exits
non-zero and prints no result.  ``--device cpu`` is the rehearsal path for
tests at small configurations: the same run on the CPU, whose device metrics
read nothing.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (spans around the calls into the service,
the program's counters, a profiled stretch of the window).  The last line of
standard output is the result; the numbers ``correct`` compared, each beside
its limit, are the last lines of standard error and the line's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu to rehearse")
    args = ap.parse_args(argv)

    from benchmark import harness

    found = harness.forbidden_modules()
    if found:
        print(f"refused: {found} loaded at start-up", file=sys.stderr)
        return 3
    cell = harness.resolve(args.workload)
    import torch

    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card "
                  "(--device cpu rehearses on the CPU)", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} devices, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      args.device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"refused: {found} loaded by the run", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
