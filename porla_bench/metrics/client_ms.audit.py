"""client_ms.audit: the client's own time in an audit (the `client.audit`
span less its `server.audit` child: its MSM over the complements and its
verification), ms per audit."""

from porla_bench import spans


def read(run):
    ms = spans.self_ms(run, "client.audit", "server.audit")
    return None if ms is None else spans.per_op(run, "audit", ms)
