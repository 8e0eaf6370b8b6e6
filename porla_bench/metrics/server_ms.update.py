"""server_ms.update: the server's `server.update` span, ms per update."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.update/server.update")
    return spans.per_op(run, "update", ms) if ms else None
