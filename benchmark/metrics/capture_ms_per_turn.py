"""Host milliseconds inside the port's ``graphs.capture`` spans over the kept
stretch, per user turn (:mod:`benchmark.portspans`): programs captured on the
served path, the releases that made room for them and the measurement of
their pools included.  Read only where the spans agree with the harness's
own count: every call of the stretch that raised ``graphs.captures()``
holds a capture span, no other call holds one, and every capture span lies
in a call."""

import collections

from benchmark.portspans import by_call, kept


def read(rec):
    got = kept(rec)
    if got is None:
        return None
    seg, turns = got
    spans = [s for s in seg.spans if s.name == "graphs.capture"]
    per_request = collections.Counter(s.request for s in spans)
    held = [sum(per_request[r.request] for r in reqs) for reqs in by_call(seg)]
    captured = [c for _, _, c in rec.calls[slice(*rec.trace["calls"])]]
    rec.log(f"capture_ms_per_turn: {len(spans)} capture spans in {sum(map(bool, held))} calls, "
            f"{sum(captured)} calls that captured, {turns} user turns")
    if sum(held) != len(spans) or [bool(h) for h in held] != captured:
        return None
    return sum(s.ns for s in spans) / 1e6 / turns
