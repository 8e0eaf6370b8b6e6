"""device_idle_pct.update: the share of the window's updates in which no
operation ran on the card, from the profiler's trace, in %."""

from porla_bench import devtrace


def read(run):
    windows = devtrace.op_intervals_ns(run, "update")
    if run.device is None or not windows:
        return None
    busy = devtrace.busy_ns(run.device.intervals, windows)
    return 100.0 * (1.0 - busy / sum(hi - lo for lo, hi in windows))
