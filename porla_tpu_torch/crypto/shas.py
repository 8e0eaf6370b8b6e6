"""SHA-256 with libsecp256k1's exact incremental-state semantics.

The reference's Fiat–Shamir transcript (reference: porla/Server/Server.hpp:
2306-2432, porla/Client/Client.hpp:1493-1551) keeps ONE sha256 object and
continues writing to it after finalize. libsecp256k1's finalize (reference:
porla/Utils/secp256k1_lib/hash_impl.h:151-168) pushes the padding through
the normal write path (advancing the byte counter) and then ZEROES the state
words. Subsequent writes therefore compress against an all-zero chaining
value with a byte counter that continues from the padded total. Python's
hashlib cannot express this, so the state machine is written here twice:
`Sha256`, on the port's native runtime (`runtime/native/porla_rt.cc`, over
a state record the object owns), which the IPA's transcript runs on, and
`Sha256Plain`, the same state machine in Python integers (`_compress`),
which the golden prover (`golden/ipa.py`) and the tests hold it against.
A failed build or load of the runtime raises: nothing falls back to the
Python compression.

Also provides HMAC-SHA256 and the RFC6979 HMAC-DRBG used by secp256k1's
test RNG (testrand), which the reference uses (unseeded!) to derive the
IPA generator points.
"""

from __future__ import annotations

import struct

from porla_tpu_torch.runtime import lib as rt
from porla_tpu_torch.utils import trace

_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2)

_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(state: list[int], block: bytes) -> None:
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + _K[i] + w[i]) & _M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    state[0] = (state[0] + a) & _M32
    state[1] = (state[1] + b) & _M32
    state[2] = (state[2] + c) & _M32
    state[3] = (state[3] + d) & _M32
    state[4] = (state[4] + e) & _M32
    state[5] = (state[5] + f) & _M32
    state[6] = (state[6] + g) & _M32
    state[7] = (state[7] + h) & _M32


class Sha256Plain:
    """secp256k1-compatible incremental SHA-256 in Python integers: the
    plain version of `Sha256`.

    Unlike hashlib, ``finalize`` mutates the object the same way
    libsecp256k1 does (state zeroed, byte counter keeps running), so a
    transcript may keep writing afterwards.
    """

    def __init__(self):
        self.state = list(_IV)
        self.buf = b""
        self.bytes = 0

    def write(self, data: bytes) -> "Sha256Plain":
        self.bytes += len(data)
        data = self.buf + data
        n_blocks = len(data) // 64
        for i in range(n_blocks):
            _compress(self.state, data[i * 64:(i + 1) * 64])
        self.buf = data[n_blocks * 64:]
        return self

    def finalize(self) -> bytes:
        # hash_impl.h:151-168: pad via write(), output state, zero state.
        nbytes = self.bytes
        padlen = 1 + ((119 - (nbytes % 64)) % 64)
        self.write(b"\x80" + b"\x00" * (padlen - 1))
        self.write(struct.pack(">II", (nbytes >> 29) & _M32, (nbytes << 3) & _M32))
        out = struct.pack(">8I", *self.state)
        self.state = [0] * 8
        return out


_INITIAL = bytes(rt.Sha256State(s=_IV))     # a fresh state record


class Sha256:
    """`Sha256Plain`'s state machine on the native runtime: the same bytes,
    with the compression in C++. The state lives in `state`, an
    `rt.Sha256State` the object owns. Every block the runtime compresses,
    in a write or a finalize, is counted on the trace counter
    `sha256.blocks` (a no-op with tracing off): 14 a side of an IPA
    proof."""

    __slots__ = ("state",)

    def __init__(self):
        self.state = rt.Sha256State.from_buffer_copy(_INITIAL)

    def write(self, data: bytes) -> "Sha256":
        trace.count("sha256.blocks", rt.sha256_write(self.state, bytes(data)))
        return self

    def finalize(self) -> bytes:
        # hash_impl.h:151-168: pad via write(), output state, zero state.
        out, blocks = rt.sha256_finalize(self.state)
        trace.count("sha256.blocks", blocks)
        return out


def sha256(data: bytes) -> bytes:
    return Sha256().write(data).finalize()


def hmac_sha256(key: bytes, data: bytes) -> bytes:
    import hashlib
    import hmac as _hmac
    return _hmac.new(key, data, hashlib.sha256).digest()


class Rfc6979HmacSha256:
    """RFC6979 HMAC-DRBG matching secp256k1 (hash_impl.h:222-289).

    A zero-initialized instance (``Rfc6979HmacSha256()`` with no seed)
    reproduces libsecp256k1's *uninitialized static* test RNG — which is
    exactly what the reference relies on for generator derivation (it never
    calls secp256k1_testrand_init; reference porla/Server/Server.hpp:314-327).
    """

    def __init__(self, key: bytes | None = None):
        if key is None:
            # mimic C static zero-initialization of the rng struct
            self.v = b"\x00" * 32
            self.k = b"\x00" * 32
            self.retry = False
        else:
            self.v = b"\x01" * 32
            self.k = b"\x00" * 32
            self.k = hmac_sha256(self.k, self.v + b"\x00" + key)
            self.v = hmac_sha256(self.k, self.v)
            self.k = hmac_sha256(self.k, self.v + b"\x01" + key)
            self.v = hmac_sha256(self.k, self.v)
            self.retry = False

    def generate(self, outlen: int) -> bytes:
        if self.retry:
            self.k = hmac_sha256(self.k, self.v + b"\x00")
            self.v = hmac_sha256(self.k, self.v)
        out = b""
        while len(out) < outlen:
            self.v = hmac_sha256(self.k, self.v)
            out += self.v
        self.retry = True
        return out[:outlen]
