"""file_read_ms.audit: the audit gather's reads of codeword files, every
`store.read` (the batched file reads into the host buffer, without the
copy to the card) under `server.audit.gather`, ms per audit."""

from porla_bench import spantree


def read(run):
    return spantree.named_ms(
        run, "client.audit/server.audit/server.audit.gather", {"store.read"},
        "audit")
