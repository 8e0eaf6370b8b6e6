"""audit_ms.p90: the 90th percentile of every audit's time, in ms."""

from porla_bench import spans


def read(run):
    return spans.percentile(spans.op_ms(run, "audit"), 90)
