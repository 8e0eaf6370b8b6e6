"""client_ms.update: the client's own time in an update (the
`client.update` span less its `server.update` child), ms per update."""

from porla_bench import spans


def read(run):
    ms = spans.self_ms(run, "client.update", "server.update")
    return None if ms is None else spans.per_op(run, "update", ms)
