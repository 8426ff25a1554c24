"""The RBF kernels' share of their roofline over a profiled stretch of the
window: the least time of every RBF block the stretch's calls launched
(:func:`benchmark.roofline.rbf_bound_ms`, summed over the blocks that the
launch tables give for those calls, :func:`benchmark.roofline.blocks`) over
the device time of the stretch's RBF kernel records.

Where the tables' count of the stretch's launches differs from the port's own
(``rbf_hopper.LAUNCHES`` over the stretch), the tables no longer describe the
program and the metric reads nothing; so too where the profile dropped more
of the records than :func:`benchmark.devtrace.readable` allows.  Where it
dropped fewer, the records kept stand for the launches at their mean time."""

import sys

from benchmark.devtrace import readable
from benchmark.roofline import blocks, rbf_bound_ms, sizes_of


def read(rec):
    t = rec.trace
    if not readable(t) or not t["kernel_records"]:
        return None
    cfg = rec.cell.config
    sizes = sizes_of(cfg)
    lo, hi = t["calls"]
    counts = blocks(rec.calls[lo:hi], sizes, cfg["selection"]["strategy"],
                    rec.cell.root)
    if counts is None or sum(counts.values()) != t["launches"]:
        rec.log(f"rbf_roofline_pct: the tables give "
                f"{None if counts is None else sum(counts.values())} launches, "
                f"the port counted {t['launches']}")
        return None
    bf16 = cfg["corpus"]["dtype"] == "bfloat16"
    bound_s = 0.0
    for (m, n, same, norms), count in sorted(counts.items()):
        ms, _ = rbf_bound_ms(m, n, sizes["D"], bf16, norms=n if norms else 0, same=same)
        bound_s += ms / 1e3 * count
    spent_s = t["kernel_s"] * t["launches"] / t["kernel_records"]
    print(f"rbf_roofline_pct: {t['launches']} launches in the stretch, bound "
          f"{bound_s * 1e3:.4f} ms, device {spent_s * 1e3:.4f} ms", file=sys.stderr)
    return 100.0 * bound_s / spent_s
