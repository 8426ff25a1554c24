"""Megabytes the port's programs copied over the kept stretch
(``graphs.copy_bytes``: into their static buffers, back into the sessions'
tensors and out of the outputs, from the tensors' sizes), per user turn
(:mod:`benchmark.portspans`)."""

from benchmark.portspans import kept


def read(rec):
    got = kept(rec)
    if got is None:
        return None
    seg, turns = got
    return seg.count("graphs.copy_bytes") / 1e6 / turns
