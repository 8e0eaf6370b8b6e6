"""prove_ms.audit: the server's proof (`server.audit.prove`: the IPA
prover or the KZG commitment and opening), ms per audit."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.audit/server.audit/server.audit.prove")
    return spans.per_op(run, "audit", ms) if ms else None
