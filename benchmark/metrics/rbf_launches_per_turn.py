"""RBF kernel launches of the window (``ops/rbf_hopper.LAUNCHES``, counted
through graph replays) per user turn."""


def read(rec):
    n = rec.counters.get("rbf_launches")
    return n / rec.attempted if n is not None and rec.attempted else None
