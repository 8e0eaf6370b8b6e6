"""store_ms.update: the server's write of the new block to its store
(`server.block_write`), ms per update."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.update/server.update/server.block_write")
    return spans.per_op(run, "update", ms) if ms else None
