"""verify_ms.audit: the client's verification of the IPA proof
(`ipa.verify`), ms per audit."""

from porla_bench import spans


def read(run):
    ms = spans.total_ms(run, "client.audit/ipa.verify")
    return spans.per_op(run, "audit", ms) if ms else None
