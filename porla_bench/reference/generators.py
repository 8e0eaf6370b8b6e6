"""The IPA scheme's public points and its transcript hash.

The reference draws its 128 Pedersen generators, the Bulletproof point u
and the MAC-hiding point h from libsecp256k1's test RNG in its
zero-initialized state (Utils/utils.h:104-124, Server.hpp:314-327,
Client.hpp:153): an RFC6979 HMAC-SHA256 DRBG whose bytes become x
coordinates. Its Fiat-Shamir transcript is one SHA-256 object written on
after each finalize, with libsecp256k1's semantics (hash_impl.h:151-168):
the padding goes through the write path and the state words are zeroed.
"""

from __future__ import annotations

import hashlib
import hmac
import struct

from porla_bench.reference import ecc

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


def _compress(state: list, block: bytes) -> None:
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25))
              + ((e & f) ^ (~e & g)) + _K[i] + w[i]) & _M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22))
              + ((a & b) ^ (a & c) ^ (b & c))) & _M32
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M32, c, b, a,
                                  (t1 + t2) & _M32)
    for i, v in enumerate((a, b, c, d, e, f, g, h)):
        state[i] = (state[i] + v) & _M32


class Transcript:
    """libsecp256k1's incremental SHA-256, written on after finalize."""

    def __init__(self):
        self.state = list(_IV)
        self.buf = b""
        self.nbytes = 0

    def write(self, data: bytes) -> None:
        self.nbytes += len(data)
        data = self.buf + data
        full = len(data) // 64
        for i in range(full):
            _compress(self.state, data[64 * i:64 * (i + 1)])
        self.buf = data[64 * full:]

    def finalize(self) -> bytes:
        n = self.nbytes
        self.write(b"\x80" + b"\x00" * (((119 - n % 64) % 64)))
        self.write(struct.pack(">II", (n >> 29) & _M32, (n << 3) & _M32))
        out = struct.pack(">8I", *self.state)
        self.state = [0] * 8
        return out


class _TestRng:
    """secp256k1's test RNG (testrand_impl.h) from its zero state."""

    _ADDBITS = (0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 2, 2, 2, 2, 2, 2,
                2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 1, 0)

    def __init__(self):
        self.v = b"\x00" * 32
        self.k = b"\x00" * 32
        self.retry = False
        self.words: list = []
        self.used = 8
        self.integer = 0
        self.bits_left = 0

    def _mac(self, data: bytes) -> bytes:
        return hmac.new(self.k, data, hashlib.sha256).digest()

    def generate(self, outlen: int) -> bytes:
        if self.retry:
            self.k = self._mac(self.v + b"\x00")
            self.v = self._mac(self.v)
        out = b""
        while len(out) < outlen:
            self.v = self._mac(self.v)
            out += self.v
        self.retry = True
        return out[:outlen]

    def rand32(self) -> int:
        if self.used == 8:
            self.words = list(struct.unpack("<8I", self.generate(32)))
            self.used = 0
        self.used += 1
        return self.words[self.used - 1]

    def bits(self, nbits: int) -> int:
        if self.bits_left < nbits:
            self.integer |= self.rand32() << self.bits_left
            self.bits_left += 32
        ret = self.integer & _M32
        self.integer >>= nbits
        self.bits_left -= nbits
        return ret & (_M32 >> (32 - nbits))

    def bytes_test(self, length: int) -> bytes:
        out = bytearray(length)
        bits = 0
        while bits < 8 * length:
            now = 1 + (self.bits(6) * self.bits(5) + 16) // 31
            val = self.bits(1)
            while now > 0 and bits < 8 * length:
                out[bits // 8] |= val << (bits % 8)
                now -= 1
                bits += 1
        return bytes(out)

    def group_element(self):
        cv = ecc.SECP256K1
        while True:
            x = int.from_bytes(self.bytes_test(32), "big")
            if x >= cv.p:
                continue
            pt = ecc.lift_x(cv, x, self.bits(1))
            if pt is not None:
                return pt


def ipa_points(num: int):
    """(generators G_0..G_{num-1}, u, h): the first num + 1 draws of the
    zero-state test RNG, and h, the client's first draw of its own."""
    rng = _TestRng()
    pts = [rng.group_element() for _ in range(num + 1)]
    return pts[:num], pts[num], _TestRng().group_element()
