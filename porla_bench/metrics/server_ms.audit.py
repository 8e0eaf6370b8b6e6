"""server_ms.audit: the server's `server.audit` span, ms per audit."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.audit/server.audit")
    return spans.per_op(run, "audit", ms) if ms else None
