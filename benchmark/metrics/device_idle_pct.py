"""Share of a profiled stretch of the window in which no kernel, copy or
set ran on the device (``torch.profiler``'s CUDA records, their intervals'
union).  The stretch's spans do not synchronize, so the device runs as in
the served window.  Read only where the profile holds a record for each
RBF launch the port counted over the same stretch, or for all but 2 % of
them (:func:`benchmark.devtrace.readable`): a profile that dropped records
reads a busy device as idle, by at most the dropped kernels' time."""

from benchmark.devtrace import readable


def read(rec):
    t = rec.trace
    if not readable(t):
        if t:
            rec.log(f"device_idle_pct: the profile holds {t.get('kernel_records')} RBF "
                    f"kernel records for {t.get('launches')} launches")
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
