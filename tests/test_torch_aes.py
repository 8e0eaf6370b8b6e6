"""The port's AES-128 (porla_tpu_torch.crypto.aes: the MAC PRF and the PRG
on the native runtime, and the numpy plain version `ecb_encrypt_plain`; no
third-party crypto package) vs the reference package's
`cryptography`-backed porla_tpu.crypto.aes: byte for byte."""

import os
import random

import pytest

from porla_tpu.crypto import aes as ref
from porla_tpu_torch.crypto import aes


def test_fips197_vector():
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert aes.ecb_encrypt_plain(key, pt).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("nblocks", [1, 7, 256])
def test_ecb_matches_reference(nblocks):
    rng = random.Random(nblocks)
    for _ in range(5):
        key = rng.randbytes(16)
        pt = rng.randbytes(16 * nblocks)
        assert aes.ecb_encrypt_plain(key, pt) == ref._ecb_encrypt(key, pt)


def test_mac_prf_matches_reference():
    key = os.urandom(16)
    recs = [(0, 5, 7), (1, 2, 3), (3, 9, 1 << 40), (10, 2047, 0), (-1, -2, -3)]
    a, b = aes.MacPrf(key), ref.MacPrf(key)
    assert a.prf_scalars_ipa(recs) == b.prf_scalars_ipa(recs)
    assert [a.prf_scalar_ipa(*r) for r in recs] == \
        [b.prf_scalar_ipa(*r) for r in recs]
    assert a.prf_scalars_kzg(recs, 10**70 + 33) == \
        b.prf_scalars_kzg(recs, 10**70 + 33)
    assert a.prf_scalars_ipa([]) == []


@pytest.mark.parametrize("stream_id", [0, 1, 2])
def test_prg_matches_reference(stream_id):
    seed = bytes(range(16))
    a, b = aes.Prg(seed, stream_id), ref.Prg(seed, stream_id)
    assert a.random_block(3) == b.random_block(3)
    assert a.random_data(4064) == b.random_data(4064)
    assert a.random_data(13) == b.random_data(13)
    assert (a.random_ints(100) == b.random_ints(100)).all()
