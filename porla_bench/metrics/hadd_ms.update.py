"""hadd_ms.update: the server's HAdd and fold (`server.hadd`), ms per
update."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.update/server.update/server.hadd")
    return spans.per_op(run, "update", ms) if ms else None
