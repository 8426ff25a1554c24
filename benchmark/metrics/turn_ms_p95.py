"""The 95th percentile (nearest rank) of every user turn in the window, in
ms on the host's clock; a failed turn counts as longer than any other."""

import math


def read(rec):
    turns = sorted(rec.turn_ms)
    if not turns:
        return None
    p95 = turns[math.ceil(0.95 * len(turns)) - 1]
    return p95 if math.isfinite(p95) else None
