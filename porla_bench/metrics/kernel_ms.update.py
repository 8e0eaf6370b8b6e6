"""kernel_ms.update: device time of the port's kernels (the functions the
sources of `native.KERNELS` define) inside the window's updates, from the
profiler's trace, ms per update."""

from porla_bench import devtrace, spans


def read(run):
    n = len(spans.op_ms(run, "update"))
    if run.device is None or not n:
        return None
    ours = [iv for iv in run.device.intervals
            if devtrace.is_kernel(iv[2], run.kernel_names)]
    ns = devtrace.busy_ns(ours, devtrace.op_intervals_ns(run, "update"))
    return ns / 1e6 / n if ns else None
