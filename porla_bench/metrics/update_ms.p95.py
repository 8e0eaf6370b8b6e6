"""update_ms.p95: the 95th percentile of every update's time, in ms: the
tail of a rewrite, set by the deeper folds of the hierarchical log."""

from porla_bench import spans


def read(run):
    return spans.percentile(spans.op_ms(run, "update"), 95)
