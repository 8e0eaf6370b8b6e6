"""kernel_ms.audit: device time of the port's kernels (the functions the
sources of `native.KERNELS` define) inside the window's audits, from the
profiler's trace, ms per audit."""

from porla_bench import devtrace, spans


def read(run):
    n = len(spans.op_ms(run, "audit"))
    if run.device is None or not n:
        return None
    ours = [iv for iv in run.device.intervals
            if devtrace.is_kernel(iv[2], run.kernel_names)]
    ns = devtrace.busy_ns(ours, devtrace.op_intervals_ns(run, "audit"))
    return ns / 1e6 / n if ns else None
