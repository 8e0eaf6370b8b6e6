"""update_ms.mean: the window's update time over its updates, in ms (the
reference's own meter, Client.hpp:894-919: the amortized cost of a
request)."""

from porla_bench import spans


def read(run):
    return spans.mean(spans.op_ms(run, "update"))
