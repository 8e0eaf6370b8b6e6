"""Client<->server transport.

The reference uses ZeroMQ REQ/REP with strictly alternating
request/reply (Client.hpp:108-112, Server.hpp:113-115). This slice of the
port has the in-process transport only; the ZMQ pair comes later.
"""

from __future__ import annotations

from porla_tpu_torch.utils import trace


class InProcTransport:
    """Directly couples a client to a server instance (single process).
    Works with any object that has `handle(bytes) -> bytes`, including a
    server of the reference package."""

    def __init__(self, server):
        self.server = server

    def __call__(self, msg: bytes) -> bytes:
        trace.count("transport.round_trips")
        trace.count("transport.bytes_sent", len(msg))
        reply = self.server.handle(bytes(msg))
        trace.count("transport.bytes_received", len(reply))
        return reply
