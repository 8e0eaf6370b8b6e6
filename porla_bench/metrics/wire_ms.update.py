"""wire_ms.update: the update's wire conversions, every `client.serialize`
(the MAC and the deltas to bytes) and `server.parse` (the block's chunks,
the MAC and the deltas from bytes) under `client.update`, ms per update."""

from porla_bench import spantree


def read(run):
    return spantree.named_ms(run, "client.update",
                             {"client.serialize", "server.parse"}, "update")
