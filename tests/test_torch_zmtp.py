"""The port's ZMQ wire (porla_tpu_torch/protocol/zmtp.py and the
`ZmqClientTransport` / `serve_zmq` pair of protocol/transport.py) against
libzmq through pyzmq, and against the reference package's own pair
(porla_tpu/protocol/transport.py, on pyzmq), on localhost:

- messages of 0 bytes to 8 MiB both ways: the port's REQ against a libzmq
  REP, a libzmq REQ against the port's REP, the reference's client against
  the port's `serve_zmq` and the port's client against the reference's
  `serve_zmq` (each reply a function of its request, so a swapped or cut
  message fails);
- the handshake: a peer whose socket type does not pair (a libzmq REQ, a
  raw peer that sends a libzmq-style greeting and READY) is refused, and the
  raw peer is sent ERROR; the port's REP drops such a peer and serves the
  next;
- a closed port raises ConnectionError within its bound; a server that
  closes the connection mid-request raises; a PING before the reply is
  answered with a PONG; a second client is served after the first
  disconnects; an exception in the server's handler propagates and frees
  the port;
- endpoints: the three bind forms work, ipc:// and inproc:// raise
  ValueError; the port's transport imports and runs with
  `sys.modules["zmq"] = None`.

Every socket has a timeout and every thread a join with a deadline.
"""

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

zmq = pytest.importorskip("zmq")

from porla_tpu.protocol import transport as ref_transport  # noqa: E402
from porla_tpu_torch.protocol import transport, zmtp  # noqa: E402

SIZES = (0, 1, 255, 256, 65536, 8 << 20)
TIMEOUT_S = 30


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _message(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()


def _answer(msg: bytes) -> bytes:
    """The reply each server gives: the request reversed, then its size."""
    return bytes(msg[::-1]) + len(msg).to_bytes(8, "little")


class Peer(threading.Thread):
    """Runs `fn` in a daemon thread; `finish` joins it with a deadline and
    re-raises what it raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.result, self.error = fn, None, None
        self.start()

    def run(self):
        try:
            self.result = self.fn()
        except BaseException as e:      # handed to the test in finish()
            self.error = e

    def finish(self):
        self.join(TIMEOUT_S)
        assert not self.is_alive(), "peer thread still running"
        if self.error is not None:
            raise self.error
        return self.result


class Echo:
    """A server whose `handle` answers with `_answer` and reaches the
    ready state after `k` requests (as serve_zmq's forever=False reads)."""

    def __init__(self, k: int = 1):
        self.k, self._state = k, "serving"

    def handle(self, msg: bytes) -> bytes:
        self.k -= 1
        if self.k == 0:
            self._state = "ready"
        return _answer(msg)


@pytest.fixture
def ctx():
    """libzmq's sockets, with timeouts on every socket that the context
    makes (the reference's pair makes its sockets from the global
    instance)."""
    inst = zmq.Context.instance()
    inst.setsockopt(zmq.LINGER, 0)
    inst.setsockopt(zmq.RCVTIMEO, TIMEOUT_S * 1000)
    inst.setsockopt(zmq.SNDTIMEO, TIMEOUT_S * 1000)
    return inst


@pytest.mark.parametrize("size", SIZES)
def test_port_req_against_libzmq_rep(ctx, size):
    port = _free_port()
    rep = ctx.socket(zmq.REP)
    rep.bind(f"tcp://127.0.0.1:{port}")
    try:
        peer = Peer(lambda: rep.send(_answer(rep.recv())))
        req = zmtp.ReqSocket(f"tcp://localhost:{port}", timeout_s=TIMEOUT_S)
        try:
            msg = _message(size)
            assert req.request(msg) == _answer(msg)
        finally:
            req.close()
        peer.finish()
    finally:
        rep.close()


@pytest.mark.parametrize("size", SIZES)
def test_libzmq_req_against_port_rep(ctx, size):
    port = _free_port()
    rep = zmtp.RepSocket(f"tcp://127.0.0.1:{port}")
    try:
        peer = Peer(lambda: rep.send(_answer(rep.recv())))
        req = ctx.socket(zmq.REQ)
        req.connect(f"tcp://127.0.0.1:{port}")
        try:
            msg = _message(size)
            req.send(msg)
            assert req.recv() == _answer(msg)
        finally:
            req.close()
        peer.finish()
    finally:
        rep.close()


@pytest.mark.parametrize("size", SIZES)
def test_reference_client_against_port_serve_zmq(ctx, size):
    port = _free_port()
    peer = Peer(lambda: transport.serve_zmq(Echo(), f"tcp://*:{port}",
                                            forever=False))
    client = ref_transport.ZmqClientTransport(f"tcp://127.0.0.1:{port}")
    try:
        msg = _message(size)
        assert client(msg) == _answer(msg)
    finally:
        client.sock.close()
    peer.finish().close()


@pytest.mark.parametrize("size", SIZES)
def test_port_client_against_reference_serve_zmq(ctx, size):
    port = _free_port()
    peer = Peer(lambda: ref_transport.serve_zmq(
        Echo(), f"tcp://127.0.0.1:{port}", forever=False))
    client = transport.ZmqClientTransport(f"tcp://localhost:{port}",
                                          timeout_s=TIMEOUT_S)
    try:
        msg = _message(size)
        assert client(msg) == _answer(msg)
    finally:
        client.close()
    peer.finish().close()


# --- a raw peer, to drive the handshake and the frames byte by byte -------

def _libzmq_greeting() -> bytes:
    """A greeting as libzmq 4.3 sends it: version 3.1 and a 1 in the last
    padding byte of the signature."""
    return (b"\xff" + bytes(7) + b"\x01\x7f" + b"\x03\x01"
            + b"NULL".ljust(20, b"\x00") + b"\x00" + bytes(31))


def _ready(socket_type: bytes) -> bytes:
    props = b""
    for name, value in ((b"Socket-Type", socket_type), (b"Identity", b"")):
        props += bytes([len(name)]) + name + struct.pack(">I", len(value)) \
            + value
    return zmtp.command(b"READY", props)


def _read_exact(sock, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise EOFError
        out += chunk
    return out


def _read_frame(sock) -> tuple[int, bytes]:
    flags, size = _read_exact(sock, 2)
    if flags & zmtp.LONG:
        size = int.from_bytes(bytes([size]) + _read_exact(sock, 7), "big")
    return flags, _read_exact(sock, size)


def _raw_connect(port: int) -> socket.socket:
    """A plain tcp connection to a server that may not have bound yet."""
    deadline = time.monotonic() + TIMEOUT_S
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), TIMEOUT_S)
            sock.settimeout(TIMEOUT_S)
            return sock
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _raw_server(script):
    """A listening socket's port, and a thread that accepts one peer and
    runs `script(conn)` on it."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.settimeout(TIMEOUT_S)

    def run():
        conn, _ = lsock.accept()
        conn.settimeout(TIMEOUT_S)
        try:
            return script(conn)
        finally:
            conn.close()
            lsock.close()
    return lsock.getsockname()[1], Peer(run)


def test_req_refuses_a_req_peer(ctx):
    """A REQ/REQ pair: libzmq's REQ drops the connection, and a raw peer
    that announces REQ (with an Identity, as libzmq's REQ does) is sent
    ERROR; the port's REQ raises both times."""
    port = _free_port()
    other = ctx.socket(zmq.REQ)
    other.bind(f"tcp://127.0.0.1:{port}")
    try:
        with pytest.raises(ConnectionError):
            zmtp.ReqSocket(f"tcp://127.0.0.1:{port}", timeout_s=5)
    finally:
        other.close()

    def script(conn):
        conn.sendall(_libzmq_greeting() + _ready(b"REQ"))
        assert _read_exact(conn, 64)[:1] == b"\xff"
        _read_frame(conn)                               # its READY
        return _read_frame(conn)
    port, peer = _raw_server(script)
    with pytest.raises(zmtp.ZmtpError, match="does not pair"):
        zmtp.ReqSocket(f"tcp://127.0.0.1:{port}", timeout_s=5)
    flags, body = peer.finish()
    assert flags & zmtp.COMMAND and body[1:6] == b"ERROR"


def test_rep_drops_an_unpaired_peer_and_serves_the_next(ctx):
    port = _free_port()
    peer = Peer(lambda: transport.serve_zmq(Echo(), f"tcp://127.0.0.1:{port}",
                                            forever=False))
    with _raw_connect(port) as raw:
        raw.sendall(_libzmq_greeting() + _ready(b"REP"))
        _read_exact(raw, 64)
        _read_frame(raw)                                # its READY
        flags, body = _read_frame(raw)
        assert flags & zmtp.COMMAND and body[1:6] == b"ERROR"
    req = ctx.socket(zmq.REQ)
    req.connect(f"tcp://127.0.0.1:{port}")
    try:
        req.send(b"next")
        assert req.recv() == _answer(b"next")
    finally:
        req.close()
    peer.finish().close()


def test_ping_is_answered_and_the_reply_still_arrives():
    def script(conn):
        conn.sendall(_libzmq_greeting() + _ready(b"REP"))
        _read_exact(conn, 64)
        _read_frame(conn)                               # its READY
        delim, body = _read_frame(conn), _read_frame(conn)
        assert delim == (zmtp.MORE, b"")
        conn.sendall(zmtp.command(b"PING", b"\x00\x0actx"))
        pong = _read_frame(conn)
        conn.sendall(zmtp.frame(b"", zmtp.MORE) + zmtp.frame(body[1][::-1]))
        return pong
    port, peer = _raw_server(script)
    req = zmtp.ReqSocket(f"tcp://127.0.0.1:{port}", timeout_s=TIMEOUT_S)
    try:
        assert req.request(b"ping me") == b"em gnip"
    finally:
        req.close()
    flags, body = peer.finish()
    assert flags & zmtp.COMMAND and body == b"\x04PONGctx"


def test_server_closing_mid_request_raises():
    def script(conn):
        conn.sendall(_libzmq_greeting() + _ready(b"REP"))
        _read_exact(conn, 64)
        _read_frame(conn)
        _read_frame(conn)
        _read_frame(conn)                               # the request
    port, peer = _raw_server(script)
    client = transport.ZmqClientTransport(f"tcp://127.0.0.1:{port}",
                                          timeout_s=TIMEOUT_S)
    t0 = time.monotonic()
    try:
        with pytest.raises(ConnectionError):
            client(b"lost")
    finally:
        client.close()
    assert time.monotonic() - t0 < TIMEOUT_S / 2
    peer.finish()


def test_connect_to_a_closed_port_raises_within_its_bound():
    port = _free_port()
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match=f"tcp://127.0.0.1:{port}"):
        transport.ZmqClientTransport(f"tcp://127.0.0.1:{port}",
                                     timeout_s=1.0)
    assert time.monotonic() - t0 < 3.0


def test_second_client_served_after_the_first_disconnects(ctx):
    port = _free_port()
    peer = Peer(lambda: transport.serve_zmq(Echo(2), f"tcp://*:{port}",
                                            forever=False))
    first = transport.ZmqClientTransport(f"tcp://localhost:{port}",
                                         timeout_s=TIMEOUT_S)
    try:
        assert first(b"one") == _answer(b"one")
    finally:
        first.close()
    second = ctx.socket(zmq.REQ)
    second.connect(f"tcp://127.0.0.1:{port}")
    try:
        second.send(b"two")
        assert second.recv() == _answer(b"two")
    finally:
        second.close()
    peer.finish().close()


def test_handler_exception_propagates_and_frees_the_port():
    class Broken:
        _state = "serving"

        def handle(self, msg):
            raise ValueError(f"unknown opcode {msg[:1]!r}")

    port = _free_port()
    peer = Peer(lambda: transport.serve_zmq(Broken(), f"tcp://*:{port}"))
    client = transport.ZmqClientTransport(f"tcp://127.0.0.1:{port}",
                                          timeout_s=TIMEOUT_S)
    try:
        with pytest.raises(ConnectionError):
            client(b"Z")
    finally:
        client.close()
    with pytest.raises(ValueError, match="unknown opcode"):
        peer.finish()
    zmtp.RepSocket(f"tcp://127.0.0.1:{port}").close()


@pytest.mark.parametrize("host", ["*", "0.0.0.0", "127.0.0.1"])
def test_bind_forms(host):
    rep = zmtp.RepSocket(f"tcp://{host}:0")
    try:
        assert rep.port > 0
        peer = Peer(lambda: rep.send(_answer(rep.recv())))
        req = zmtp.ReqSocket(f"tcp://localhost:{rep.port}",
                             timeout_s=TIMEOUT_S)
        try:
            assert req.request(b"bind") == _answer(b"bind")
        finally:
            req.close()
        peer.finish()
    finally:
        rep.close()


@pytest.mark.parametrize("endpoint", ["ipc:///tmp/porla.sock",
                                      "inproc://porla"])
def test_other_transports_raise(endpoint):
    scheme = endpoint.split("://")[0] + "://"
    with pytest.raises(ValueError, match=scheme):
        transport.ZmqClientTransport(endpoint, timeout_s=1.0)
    with pytest.raises(ValueError, match=scheme):
        transport.serve_zmq(Echo(), endpoint)


def test_transport_runs_without_pyzmq():
    code = """
import sys, threading
sys.modules["zmq"] = None
from porla_tpu_torch.protocol import transport, zmtp
rep = zmtp.RepSocket("tcp://127.0.0.1:0")
t = threading.Thread(target=lambda: rep.send(rep.recv()[::-1]), daemon=True)
t.start()
client = transport.ZmqClientTransport(f"tcp://localhost:{rep.port}",
                                      timeout_s=20)
assert client(b"no pyzmq") == b"qmzyp on"
t.join(20)
assert "zmq" not in sys.modules or sys.modules["zmq"] is None
print("ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, env=env, cwd=root)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
