"""fold_data_ms.update: the data planes of the server's folds, every
`fold.data` (the plain-torch data butterfly and its concatenations) under
`server.hadd`, ms per update."""

from porla_bench import spantree


def read(run):
    return spantree.named_ms(run, "client.update/server.update/server.hadd",
                             {"fold.data"}, "update")
