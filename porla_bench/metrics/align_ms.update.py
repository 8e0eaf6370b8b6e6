"""align_ms.update: HAdd's align_MAC (`server.align`: the mod-p correction,
its K4 commitment and the reduction), ms per update."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(
        run, "client.update/server.update/server.hadd/server.align")
    return spans.per_op(run, "update", ms) if ms else None
