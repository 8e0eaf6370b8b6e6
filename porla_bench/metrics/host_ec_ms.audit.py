"""host_ec_ms.audit: the curve arithmetic in Python integers, every
`ecc.host` under `client.audit` (the IPA prover's, the verifier's and the
MAC check's), ms per audit."""

from porla_bench import spantree


def read(run):
    return spantree.named_ms(run, "client.audit", {"ecc.host"}, "audit")
