"""Port mirror of tests/test_crypto.py: the byte-exact crypto layer of
porla_tpu_torch (crypto/shas.py, crypto/testrand.py, the PRG of
crypto/aes.py), each fed the same numpy-seeded inputs as the reference
package's (porla_tpu.crypto) and held against it byte for byte, and against
hashlib and FIPS-197 where they apply.

- SHA-256, both routes (`shas.Sha256` on the native runtime, which the
  IPA transcript runs on, and `shas.Sha256Plain` in Python integers), each
  against hashlib and the reference's `Sha256`, one shot and incremental;
  the reference's state after finalize (the chaining value zeroed, the
  byte counter running on: libsecp256k1 hash_impl.h:151-168), against an
  independent simulation; an IPA transcript's sequence of writes and
  finalizes; a write after a finalize at every buffer fill; writes across
  a block boundary.
- The RFC 6979 HMAC-SHA256 DRBG: deterministic, and the reference's output
  for the same seed.
- `testrand.TestRand` (libsecp256k1's test RNG): every draw the reference's.
- The derived IPA generators: on the curve, stable, the reference's points,
  and h = generators[0].
- The PRG: deterministic, its int view the byte stream's, and reseeding by
  ID (key = seed XOR the ID's low 8 bytes): ID 0 is raw AES-ECB of the
  counter block under the seed, and every ID's stream is the reference's.
"""

import hashlib
import struct

import numpy as np
import pytest

from porla_tpu.crypto import aes as ref_aes
from porla_tpu.crypto import shas as ref_shas
from porla_tpu.crypto import testrand as ref_testrand
from porla_tpu_torch.crypto import aes, shas, testrand
from porla_tpu_torch.golden import ecc

SEED = 20261017
MESSAGES = [b"", b"abc", b"x" * 63, b"y" * 64, b"z" * 1000,
            np.random.default_rng(SEED).bytes(4097)]


def _bytes(n: int, tag: int = 0) -> bytes:
    return np.random.default_rng([SEED, tag]).bytes(n)


# the transcript's route and its plain version
SHA_CLASSES = pytest.mark.parametrize(
    "cls", [shas.Sha256, shas.Sha256Plain], ids=["native", "plain"])


@SHA_CLASSES
@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: f"len{len(m)}")
def test_sha256_matches_hashlib(msg, cls):
    got = cls().write(msg).finalize()
    assert got == hashlib.sha256(msg).digest()
    assert got == ref_shas.sha256(msg)
    assert shas.sha256(msg) == got


@SHA_CLASSES
def test_sha256_incremental(cls):
    h = cls()
    h.write(b"hello ")
    h.write(b"world" * 30)
    assert h.finalize() == hashlib.sha256(b"hello " + b"world" * 30).digest()


@SHA_CLASSES
def test_sha256_write_after_finalize_semantics(cls):
    h, ref = cls(), ref_shas.Sha256()
    for obj in (h, ref):
        obj.write(b"A" * 32)
    first = h.finalize()
    assert first == ref.finalize() == hashlib.sha256(b"A" * 32).digest()
    h.write(b"B" * 64)
    ref.write(b"B" * 64)
    second = h.finalize()
    assert second == ref.finalize()
    # independently: a zero chaining value, the 64 bytes, then the padding
    # of a 128-byte total (the first finalize padded to 64)
    state = [0] * 8
    shas._compress(state, b"B" * 64)
    shas._compress(state, b"\x80" + b"\x00" * 55
                   + struct.pack(">II", 0, 128 * 8))
    assert second == struct.pack(">8I", *state)


@SHA_CLASSES
def test_sha256_transcript_sequence(cls):
    """One side of an IPA proof's transcript (commit/ipa.py): 32 + 32
    bytes and a finalize, then 12 writes of 33 bytes (a compressed L or R),
    each followed by a finalize; every digest the reference's."""
    h, ref = cls(), ref_shas.Sha256()
    for obj in (h, ref):
        obj.write(_bytes(32, 1)).write(_bytes(32, 2))
    digests = [(h.finalize(), ref.finalize())]
    for r in range(12):
        point = _bytes(33, 10 + r)
        h.write(point)
        ref.write(point)
        digests.append((h.finalize(), ref.finalize()))
    assert all(got == want for got, want in digests)
    assert len({got for got, _ in digests}) == 13


@SHA_CLASSES
def test_sha256_write_after_finalize_at_every_fill(cls):
    """A finalize at every buffer fill 0-63, each followed by writes that
    fill a block and leave a remainder, then a second finalize."""
    for fill in range(64):
        h, ref = cls(), ref_shas.Sha256()
        head, tail = _bytes(64 + fill, fill), _bytes(70, 100 + fill)
        for obj in (h, ref):
            obj.write(head)
        assert h.finalize() == ref.finalize(), fill
        for obj in (h, ref):
            obj.write(tail[:3]).write(tail[3:])
        assert h.finalize() == ref.finalize(), fill


@SHA_CLASSES
@pytest.mark.parametrize("sizes", [(60, 10), (63, 1, 64, 2), (1,) * 130,
                                   (5, 200, 59, 64)],
                         ids=["60_10", "63_1_64_2", "bytewise", "5_200_59_64"])
def test_sha256_writes_across_a_block_boundary(cls, sizes):
    msg = _bytes(sum(sizes), len(sizes))
    h, ref = cls(), ref_shas.Sha256()
    off = 0
    for n in sizes:
        h.write(msg[off:off + n])
        ref.write(msg[off:off + n])
        off += n
    digest = h.finalize()
    assert digest == ref.finalize() == hashlib.sha256(msg).digest()
    h.write(msg[:70])
    ref.write(msg[:70])
    assert h.finalize() == ref.finalize()


def test_rfc6979_seeded_vector():
    key = _bytes(16)
    a, b = shas.Rfc6979HmacSha256(key), shas.Rfc6979HmacSha256(key)
    first, second = a.generate(32), a.generate(32)
    assert first != second and b.generate(32) == first
    ref = ref_shas.Rfc6979HmacSha256(key)
    assert [ref.generate(32), ref.generate(32)] == [first, second]
    zero, ref_zero = (shas.Rfc6979HmacSha256(bytes(16)),
                      ref_shas.Rfc6979HmacSha256(bytes(16)))
    assert zero.generate(64) == ref_zero.generate(64)


@pytest.mark.parametrize("seed", [None, "numpy"])
def test_testrand_matches_reference(seed):
    s = None if seed is None else _bytes(16)
    t, ref = testrand.TestRand(s), ref_testrand.TestRand(s)
    assert t.rand256() == ref.rand256()
    assert [t.bits(7) for _ in range(20)] == [ref.bits(7) for _ in range(20)]
    assert [t.rand_int(1000) for _ in range(20)] == \
        [ref.rand_int(1000) for _ in range(20)]
    assert t.rand256_test() == ref.rand256_test()
    assert t.random_scalar_order() == ref.random_scalar_order()
    again = testrand.TestRand(s)
    assert again.rand256() == testrand.TestRand(s).rand256()


def test_derived_generators_on_curve_and_stable():
    gens, u = testrand.derive_ipa_generators(8)
    assert len(gens) == 8
    for pt in gens + [u]:
        assert ecc.is_on_curve(ecc.SECP256K1, pt)
    assert (gens, u) == testrand.derive_ipa_generators(8)
    assert (gens, u) == ref_testrand.derive_ipa_generators(8)
    # h equals generators[0]: both sides draw from a zero-state RNG
    assert testrand.derive_h_mac() == gens[0] == ref_testrand.derive_h_mac()


def test_prg_determinism_and_int_view():
    seed = _bytes(16)
    assert aes.Prg(seed).random_data(100) == aes.Prg(seed).random_data(100)
    ints = aes.Prg(seed).random_ints(25)
    assert ints.dtype == np.int32 and ints.shape == (25,)
    raw = aes.Prg(seed).random_data(100)
    assert np.frombuffer(raw, dtype="<i4").tolist() == ints.tolist()
    assert raw == ref_aes.Prg(seed).random_data(100)


@pytest.mark.parametrize("stream_id", [0, 1, 2, 0xFFFF_FFFF_FFFF])
def test_prg_reseed_by_id(stream_id):
    seed = _bytes(16, stream_id)
    got = aes.Prg(seed, stream_id).random_block(3)
    assert got == ref_aes.Prg(seed, stream_id).random_block(3)
    prg = aes.Prg(_bytes(16, 99), 7)
    prg.reseed(seed, stream_id)
    assert prg.random_block(3) == got
    key = bytes(s ^ i for s, i in zip(seed, struct.pack("<Q", stream_id)
                                      + bytes(8)))
    counters = b"".join(struct.pack("<QQ", c, 0) for c in range(3))
    assert got == aes.ecb_encrypt_plain(key, counters)
    if stream_id == 0:
        assert key == seed
    else:
        assert got != aes.Prg(seed, 0).random_block(3)
