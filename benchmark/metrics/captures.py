"""Programs the port captured during the window (``graphs.captures()``):
a capture is a cached program released under ``graphs.STACK_BYTES`` and
made again, or a shape the warm-up missed."""


def read(rec):
    return rec.counters.get("captures")
