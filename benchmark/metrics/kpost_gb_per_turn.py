"""Gigabytes of posterior-covariance blocks the port formed over the kept
stretch (``kernels.kpost_bytes``: each (N, block) block that a session's
EMOC column sums write, ``ops/kernels.py::blockwise_reduce_abs_kpost``),
per user turn (:mod:`benchmark.portspans`).  Counted inside the programs at
their capture and at each replay.  None where the stretch holds no such
counter: a program that counts none, or one that forms no such block."""

from benchmark.portspans import kept


def read(rec):
    got = kept(rec)
    if got is None:
        return None
    seg, turns = got
    nbytes = seg.count("kernels.kpost_bytes")
    if not nbytes:
        return None
    return nbytes / 1e9 / turns
