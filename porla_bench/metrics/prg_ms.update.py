"""prg_ms.update: the client's AES PRG of the new block (`client.prg`), ms
per update."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.update/client.prg")
    return spans.per_op(run, "update", ms) if ms else None
