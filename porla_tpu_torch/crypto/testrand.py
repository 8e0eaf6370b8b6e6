"""secp256k1 test-RNG replica and deterministic IPA generator derivation.

The reference derives its 128 Pedersen generators, the Bulletproof generator
``u``, and the MAC-hiding point ``h`` by drawing from libsecp256k1's *test*
RNG without ever seeding it (reference: porla/Utils/utils.h:104-124,
porla/Server/Server.hpp:314-327, porla/Client/Client.hpp:153). The static
RNG state is zero-initialized C memory, so the whole sequence is
deterministic. This module reproduces that byte stream exactly
(reference: porla/Utils/secp256k1_lib/testrand_impl.h) so our generators are
the same curve points the reference binary uses.
"""

from __future__ import annotations

import struct

from porla_tpu_torch.crypto.shas import Rfc6979HmacSha256
from porla_tpu_torch.golden import ecc

_ADDBITS = [0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 2, 2, 2, 2, 2, 2,
            2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 1, 0]


class TestRand:
    """Replica of testrand_impl.h's stream state machine."""

    def __init__(self, seed16: bytes | None = None):
        self.rng = Rfc6979HmacSha256(seed16)
        self.precomputed: list[int] = []
        self.precomputed_used = 8
        self.integer = 0
        self.integer_bits_left = 0

    def rand32(self) -> int:
        if self.precomputed_used == 8:
            buf = self.rng.generate(32)
            self.precomputed = list(struct.unpack("<8I", buf))
            self.precomputed_used = 0
        v = self.precomputed[self.precomputed_used]
        self.precomputed_used += 1
        return v

    def bits(self, nbits: int) -> int:
        if self.integer_bits_left < nbits:
            self.integer |= self.rand32() << self.integer_bits_left
            self.integer_bits_left += 32
        ret = self.integer & 0xFFFFFFFF
        self.integer >>= nbits
        self.integer_bits_left -= nbits
        return ret & ((0xFFFFFFFF) >> (32 - nbits))

    def rand_int(self, rng_range: int) -> int:
        if rng_range <= 1:
            return 0
        trange = rng_range - 1
        nbits = 0
        while trange > 0:
            trange >>= 1
            nbits += 1
        if _ADDBITS[nbits]:
            nbits = nbits + _ADDBITS[nbits]
            mult = ((0xFFFFFFFF) >> (32 - nbits)) // rng_range
            trange = rng_range * mult
        else:
            trange = rng_range
            mult = 1
        while True:
            x = self.bits(nbits)
            if x < trange:
                return x if mult == 1 else x % rng_range

    def rand256(self) -> bytes:
        return self.rng.generate(32)

    def bytes_test(self, length: int) -> bytes:
        """Biased run-length byte pattern (testrand_impl.h:92-105)."""
        out = bytearray(length)
        bits = 0
        while bits < length * 8:
            now = 1 + (self.bits(6) * self.bits(5) + 16) // 31
            val = self.bits(1)
            while now > 0 and bits < length * 8:
                out[bits // 8] |= val << (bits % 8)
                now -= 1
                bits += 1
        return bytes(out)

    def rand256_test(self) -> bytes:
        return self.bytes_test(32)

    # --- curve-point draws (utils.h:104-124) -------------------------------

    def random_field_element(self) -> int:
        while True:
            b32 = self.rand256_test()
            x = int.from_bytes(b32, "big")
            if x < ecc.SECP256K1.p:  # fe_set_b32 rejects >= p
                return x

    def random_group_element(self):
        while True:
            x = self.random_field_element()
            odd = self.bits(1)
            pt = ecc.lift_x(ecc.SECP256K1, x, odd)
            if pt is not None:
                return pt

    def random_scalar_order(self) -> int:
        while True:
            b32 = self.rand256()
            s = int.from_bytes(b32, "big")
            if s == 0 or s >= ecc.SECP256K1.n:
                continue
            return s


_GENERATOR_CACHE: dict[int, list] = {}


def derive_ipa_generators(num: int):
    """The first ``num+1`` group elements of the zero-state test RNG:
    generators[0..num-1] and the Bulletproof generator u, exactly as the
    reference server derives them (Server.hpp:314-327). The client's
    MAC-hiding point h equals generators[0] because the client draws from
    its own zero-state RNG (Client.hpp:153)."""
    if num not in _GENERATOR_CACHE:
        tr = TestRand()
        _GENERATOR_CACHE[num] = [tr.random_group_element() for _ in range(num + 1)]
    pts = _GENERATOR_CACHE[num]
    return pts[:num], pts[num]


def derive_h_mac():
    """Client-side MAC-hiding point h (first zero-state draw)."""
    tr = TestRand()
    return tr.random_group_element()
