"""ZeroMQ's wire protocol, ZMTP 3 (RFC 23/ZMTP), for a REQ/REP pair on tcp.

The reference's client and server talk over ZeroMQ REQ/REP sockets
(Client.hpp:108-112, Server.hpp:113-115). This module speaks the same
bytes over Python's `socket` module, so the port needs no pyzmq and a
libzmq peer talks to it unchanged. It implements what the reference uses
and nothing more: tcp, the NULL security mechanism, a REQ socket that
connects (`ReqSocket`) and a REP socket that binds (`RepSocket`), one
frame of body a message.

On the wire, after a 64-byte greeting each way, each side sends a READY
command that names its socket type (`Socket-Type`), then messages. A frame
is a flags byte (bit 0 MORE, bit 1 LONG, bit 2 COMMAND), its size (one
byte, or eight big-endian bytes when LONG) and its body. A REQ/REP message
is an empty delimiter frame with MORE set, then the body frame.

Each message goes out in one `sendall` of its joined frames on a socket
with TCP_NODELAY, as libzmq writes it: a request split over two writes
waits for the peer's delayed ACK (about 40 ms a round trip).
"""

from __future__ import annotations

import socket
import struct
import time

MORE, LONG, COMMAND = 1, 2, 4
GREETING = (b"\xff" + bytes(8) + b"\x7f" + b"\x03\x00"
            + b"NULL".ljust(20, b"\x00") + b"\x00" + bytes(31))
PEER = {b"REQ": b"REP", b"REP": b"REQ"}    # the socket type each pairs with
MAX_FRAME = 1 << 32           # a larger declared size is refused unread
CONNECT_WAIT_S = 120.0        # ReqSocket's bound when no timeout is given
HANDSHAKE_S = 30.0            # RepSocket drops a peer that takes longer
RETRY_S = 0.1


class ZmtpError(ConnectionError):
    """The peer broke the protocol, or its socket type does not pair."""


class PeerClosed(ConnectionError):
    """The peer closed the connection."""


def parse_endpoint(endpoint: str, bind: bool) -> tuple[str, int]:
    """(host, port) of a `tcp://host:port` endpoint; to bind, the host may
    be `*` (every interface). Any other transport raises ValueError."""
    scheme, sep, rest = endpoint.partition("://")
    if not sep or scheme != "tcp":
        raise ValueError(f"unsupported ZMQ endpoint {endpoint!r}: the "
                         f"transport {scheme + sep!r} is not tcp://")
    host, sep, port = rest.rpartition(":")
    if not sep or not port.isdigit() or not host:
        raise ValueError(f"malformed tcp endpoint {endpoint!r}")
    if host == "*":
        if not bind:
            raise ValueError(f"cannot connect to {endpoint!r}")
        host = ""
    return host, int(port)


def frame(body: bytes, flags: int = 0) -> bytes:
    if len(body) > 255:
        return bytes([flags | LONG]) + struct.pack(">Q", len(body)) + body
    return bytes([flags, len(body)]) + body


def command(name: bytes, data: bytes = b"") -> bytes:
    return frame(bytes([len(name)]) + name + data, COMMAND)


def ready(socket_type: bytes) -> bytes:
    prop = b"Socket-Type"
    return command(b"READY", bytes([len(prop)]) + prop
                   + struct.pack(">I", len(socket_type)) + socket_type)


def parse_properties(data: bytes) -> dict[bytes, bytes]:
    props, off = {}, 0
    while off < len(data):
        n = data[off]
        name = data[off + 1:off + 1 + n]
        off += 1 + n
        if off + 4 > len(data):
            raise ZmtpError("truncated READY property")
        (size,) = struct.unpack_from(">I", data, off)
        props[name] = data[off + 4:off + 4 + size]
        off += 4 + size
        if off > len(data):
            raise ZmtpError("truncated READY property")
    return props


class Connection:
    """One ZMTP 3 connection over a connected tcp socket, after the
    handshake: frames in and out, command frames answered or skipped."""

    def __init__(self, sock: socket.socket, socket_type: bytes):
        self.sock = sock
        self._hdr = bytearray(8)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(GREETING + ready(socket_type))
        peer = self._read(64)
        if peer[0] != 0xFF or not peer[9] & 1:
            raise ZmtpError("the peer does not speak ZMTP 3 (bad signature)")
        if peer[10] != 3:
            raise ZmtpError(f"the peer speaks ZMTP {peer[10]}.{peer[11]}, "
                            f"not 3.x")
        mechanism = peer[12:32].rstrip(b"\x00")
        if mechanism != b"NULL":
            raise ZmtpError(f"the peer's security mechanism is "
                            f"{mechanism!r}, not NULL")
        flags, body = self._frame()
        if not flags & COMMAND or body[1:1 + body[0]] != b"READY":
            raise ZmtpError("the peer's first command is not READY")
        props = parse_properties(bytes(body[1 + body[0]:]))
        peer_type = props.get(b"Socket-Type", b"")
        if peer_type != PEER[socket_type]:
            reason = (f"{socket_type.decode()} does not pair with "
                      f"{peer_type.decode(errors='replace')}").encode()
            try:
                sock.sendall(command(b"ERROR", bytes([len(reason)]) + reason))
            except OSError:
                pass              # the refusal below is what matters
            raise ZmtpError(reason.decode())

    def _read(self, n: int, into: bytearray | None = None) -> bytearray:
        buf = bytearray(n) if into is None else into
        view, got = memoryview(buf)[:n], 0
        while got < n:
            k = self.sock.recv_into(view[got:])
            if k == 0:
                raise PeerClosed("the peer closed the connection")
            got += k
        return buf

    def _frame(self) -> tuple[int, bytearray]:
        flags, size = self._read(2, self._hdr)[:2]
        if flags & ~(MORE | LONG | COMMAND):
            raise ZmtpError(f"reserved frame flags {flags:#04x}")
        if flags & LONG:
            size = int.from_bytes(bytes([size]) + self._read(7, self._hdr)[:7],
                                  "big")
            if size > MAX_FRAME:
                raise ZmtpError(f"frame of {size} bytes refused")
        return flags, self._read(size)

    def recv_frames(self) -> list[bytes]:
        """The frames of the next message; a command frame between
        messages is skipped, a PING answered with a PONG."""
        frames = []
        while True:
            flags, body = self._frame()
            if flags & COMMAND:
                if frames:
                    raise ZmtpError("a command inside a message")
                name = bytes(body[1:1 + body[0]])
                if name == b"PING":
                    # PING: name, a 2-byte TTL, then the context to echo
                    self.sock.sendall(command(b"PONG", body[1 + body[0] + 2:]))
                elif name == b"ERROR":
                    raise ZmtpError(f"the peer sent ERROR "
                                    f"{bytes(body[1 + body[0] + 1:])!r}")
                continue
            frames.append(bytes(body))
            if not flags & MORE:
                return frames

    def send_frames(self, frames: list[bytes]) -> None:
        self.sock.sendall(b"".join(
            frame(f, MORE if i < len(frames) - 1 else 0)
            for i, f in enumerate(frames)))

    def close(self) -> None:
        self.sock.close()


class ReqSocket:
    """A REQ socket connected to `endpoint` (tcp://host:port). The connect
    is retried, as libzmq's REQ retries, for up to `timeout_s` seconds
    (CONNECT_WAIT_S when None) and then raises ConnectionError;
    `timeout_s` also bounds every later read (None: block). `request`
    sends a message and returns the reply, so requests and replies
    alternate strictly."""

    def __init__(self, endpoint: str, timeout_s: float | None = None):
        host, port = parse_endpoint(endpoint, bind=False)
        wait = CONNECT_WAIT_S if timeout_s is None else timeout_s
        deadline = time.monotonic() + wait
        while True:
            try:
                sock = socket.create_connection(
                    (host, port), timeout=max(deadline - time.monotonic(),
                                              RETRY_S))
                break
            except (ConnectionRefusedError, socket.timeout) as e:
                if time.monotonic() + RETRY_S > deadline:
                    raise ConnectionError(
                        f"no ZMQ peer at {endpoint} after {wait:g} s") from e
                time.sleep(RETRY_S)
        sock.settimeout(timeout_s)
        try:
            self.conn = Connection(sock, b"REQ")
        except BaseException:
            sock.close()
            raise

    def request(self, msg: bytes) -> bytes:
        self.conn.send_frames([b"", msg])
        frames = self.conn.recv_frames()
        if len(frames) != 2 or frames[0]:
            raise ZmtpError(f"a reply of {len(frames)} frames, not the "
                            f"delimiter and one body")
        return frames[1]

    def close(self) -> None:
        self.conn.close()


class RepSocket:
    """A REP socket bound to `endpoint` (tcp://*:port, tcp://0.0.0.0:port
    or tcp://127.0.0.1:port) that serves one peer at a time: `recv` waits
    for the next request, from the current peer or, once it has
    disconnected, from the next peer to connect; `send` replies to it. A
    peer that breaks the handshake (not a REQ, not ZMTP 3) is sent ERROR
    where it applies and dropped, and so is a peer whose message is not
    the delimiter and one body."""

    def __init__(self, endpoint: str):
        host, port = parse_endpoint(endpoint, bind=True)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            # a restarted server binds the port its predecessor held
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
            self.listener.listen(1)
        except BaseException:
            self.listener.close()
            raise
        self.port = self.listener.getsockname()[1]
        self.conn = None
        self._pending = False       # a request received, not yet answered

    def _drop(self) -> None:
        if self.conn is not None:
            self.conn.close()
        self.conn, self._pending = None, False

    def recv(self) -> bytes:
        if self._pending:
            raise RuntimeError("REP: recv before the last request's send")
        while True:
            if self.conn is None:
                sock, _ = self.listener.accept()
                sock.settimeout(HANDSHAKE_S)
                try:
                    self.conn = Connection(sock, b"REP")
                except OSError:
                    sock.close()
                    continue
                sock.settimeout(None)
            try:
                frames = self.conn.recv_frames()
            except OSError:
                self._drop()
                continue
            if len(frames) != 2 or frames[0]:
                self._drop()
                continue
            self._pending = True
            return frames[1]

    def send(self, reply: bytes) -> None:
        if not self._pending:
            raise RuntimeError("REP: send without a request")
        try:
            self.conn.send_frames([b"", reply])
            self._pending = False
        except OSError:
            # the peer left before its reply, which is dropped as libzmq's
            # REP drops it; the next recv takes the next peer
            self._drop()

    def close(self) -> None:
        self._drop()
        self.listener.close()
