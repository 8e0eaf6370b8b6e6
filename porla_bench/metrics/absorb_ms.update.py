"""absorb_ms.update: the server's two point adds of the deltas into the
level (`server.absorb`), ms per update."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.update/server.update/server.absorb")
    return spans.per_op(run, "update", ms) if ms else None
