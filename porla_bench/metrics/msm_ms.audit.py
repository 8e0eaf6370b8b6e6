"""msm_ms.audit: the server's combination MSMs (`server.audit.msm`), ms per
audit."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.audit/server.audit/server.audit.msm")
    return spans.per_op(run, "audit", ms) if ms else None
