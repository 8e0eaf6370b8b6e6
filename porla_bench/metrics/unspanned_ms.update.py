"""unspanned_ms.update: the host time of an update that no leaf span
names: each `client.update` request less its leaf spans (the spans that
no record names as parent, found through the records' `parent` and
`root` ids), ms per update."""

from porla_bench import spantree


def read(run):
    return spantree.unspanned_ms(run, "client.update", "update")
