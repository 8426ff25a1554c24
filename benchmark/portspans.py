"""The port's own spans and counters (``ital_tpu_torch.utils.logging``) over
the traced stretch the harness kept.

The port records while a ``torch.profiler`` records, one segment per
profiled stretch.  The kept stretch's segment is the one whose requests, in
order, are the harness's calls ``rec.calls[lo:hi]`` (``rec.trace["calls"]``):
``serve.set_query`` a ``start``, ``serve.feedback[_many]`` a
``feedback[_many]``, ``serve.next_batch[_many]`` a ``select[_many]``.  Its
user turns are the sessions of the stretch's selection calls.  A program
without these spans (one that records none), a CPU run (no stretch) and a
stretch that no segment matches read nothing.
"""

from __future__ import annotations

# The port's request spans that are the harness's calls, by the call's kind.
CALLS = {"serve.set_query": "start", "serve.feedback": "feedback",
         "serve.feedback_many": "feedback_many", "serve.next_batch": "select",
         "serve.next_batch_many": "select_many"}
SELECTS = ("select", "select_many")


def requests(segment) -> list:
    """The segment's requests: its spans opened with none open beneath them
    on their thread, of the service's entry points (``serve.*``)."""
    return [s for s in segment.spans if s.parent is None and s.name.startswith("serve.")]


def by_call(segment) -> list:
    """The segment's requests grouped by the harness's call they belong to,
    one list a call in order: a ``serve.create_session`` goes with the start
    that follows it, a ``serve.delete`` with none (the harness deletes a
    session outside its calls)."""
    calls, pending = [], []
    for s in requests(segment):
        if s.name in CALLS:
            calls.append(pending + [s])
            pending = []
        elif s.name == "serve.create_session":
            pending.append(s)
    return calls


def kept(rec):
    """``(segment, user turns)`` of the stretch the harness kept, or None."""
    t = rec.trace
    if not t or "calls" not in t:
        return None
    try:
        from ital_tpu_torch.utils import logging as port

        segments = port.segments()
    except (ImportError, AttributeError):
        return None
    lo, hi = t["calls"]
    calls = rec.calls[lo:hi]
    kinds = [kind for kind, _, _ in calls]
    turns = sum(n for kind, n, _ in calls if kind in SELECTS)
    for seg in reversed(segments):
        made = [CALLS[s.name] for s in requests(seg) if s.name in CALLS]
        if len(made) == hi - lo and made == kinds:
            return (seg, turns) if turns else None
    rec.log(f"portspans: no segment of {len(segments)} holds the stretch's {hi - lo} calls")
    return None
