"""Client<->server transport.

The reference runs its client and server as two processes over ZeroMQ
REQ/REP on tcp://localhost:8888, with strictly alternating request and
reply (Client.hpp:108-112, Server.hpp:113-115). `ZmqClientTransport` and
`serve_zmq` are that pair, on the port's own ZMTP 3 peer
(`protocol/zmtp.py`, no pyzmq), so either end may also be a libzmq socket
or the reference package's pair. `InProcTransport` couples a client to a
server object in one process, for tests and tools.
"""

from __future__ import annotations

from porla_tpu_torch.protocol import zmtp
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


class ZmqClientTransport:
    """The client's REQ socket, connected to `endpoint`. The connect is
    retried until a server binds it, for up to `timeout_s` seconds (or
    `zmtp.CONNECT_WAIT_S`), then raises ConnectionError; `timeout_s` also
    bounds each reply's wait (None blocks, as the reference does). A
    server that closes the connection before it replies raises
    ConnectionError. Each round trip is the span `transport.request`: the
    server's handling plus the wire."""

    def __init__(self, endpoint: str = "tcp://localhost:8888",
                 timeout_s: float | None = None):
        self.sock = zmtp.ReqSocket(endpoint, timeout_s)

    def __call__(self, msg: bytes) -> bytes:
        trace.count("transport.round_trips")
        trace.count("transport.bytes_sent", len(msg))
        with trace.span("transport.request"):
            reply = self.sock.request(bytes(msg))
        trace.count("transport.bytes_received", len(reply))
        return reply

    def close(self) -> None:
        self.sock.close()


def serve_zmq(server, bind: str = "tcp://*:8888", forever: bool = True):
    """REQ/REP dispatch loop (the reference's Server::self_test,
    Server.hpp:933-952): each request goes to `server.handle` and its
    reply back to the peer. One peer at a time; when it disconnects, the
    next peer to connect is served. With `forever=False` it returns the
    bound socket (`zmtp.RepSocket`, the caller's to close) once the server
    reaches the ready state. An exception from `server.handle` closes the
    socket and propagates."""
    sock = zmtp.RepSocket(bind)
    try:
        while True:
            msg = sock.recv()
            sock.send(server.handle(msg))
            if not forever and server._state == "ready":
                return sock
    except BaseException:
        sock.close()
        raise
