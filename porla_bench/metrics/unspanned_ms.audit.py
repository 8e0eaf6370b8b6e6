"""unspanned_ms.audit: the host time of an audit that no leaf span names:
each `client.audit` request less its leaf spans (the spans that no record
names as parent, found through the records' `parent` and `root` ids), ms
per audit."""

from porla_bench import spantree


def read(run):
    return spantree.unspanned_ms(run, "client.audit", "audit")
