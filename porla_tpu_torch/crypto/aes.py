"""AES-128 primitives: the MAC-complement PRF and the emp-style AES-CTR PRG.

PRF (reference: porla/Client/Client.hpp:423-455): one AES-128-ECB
encryption of the 16-byte record [level:i32 LE | index:i32 LE |
write_step:i64 LE] under SECRET_KEY. The IPA scheme reads the ciphertext as
two little-endian u64 limbs (a 128-bit scalar); the KZG scheme feeds the 16
bytes big-endian into BN254's Fr.

PRG (reference: porla/Utils/prg.h, block.h): AES-128-ECB over counter
blocks makeBlock(0, counter) — i.e. plaintext bytes [counter:u64 LE | 0u64].
Key = seed XOR makeBlock(0, id). Used by BOTH parties to expand the 16-byte
audit seed into challenge integers, so it must be byte-compatible.

Both run on the port's native runtime (`runtime/lib.py`: AES-NI on
x86-64), so the port needs no third-party crypto package. Its plain
version, `ecb_encrypt_plain`, is a self-contained FIPS-197 AES-128 (key
schedule plus ECB encryption) vectorized over blocks with numpy; only the
tests call it, to hold the native one against it.
"""

from __future__ import annotations

import struct

import numpy as np

from porla_tpu_torch.runtime import lib as rt


def _make_sbox() -> np.ndarray:
    """FIPS-197 S-box: multiplicative inverse in GF(2^8) mod x^8+x^4+x^3+x+1
    followed by the affine map b ^ rotl(b,1..4) ^ 0x63."""
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)  # multiply by 3
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    sbox = np.zeros(256, np.uint8)
    for a in range(256):
        inv = 0 if a == 0 else exp[255 - log[a]]
        s = inv
        for k in range(1, 5):
            s ^= ((inv << k) | (inv >> (8 - k))) & 0xFF
        sbox[a] = s ^ 0x63
    return sbox


_SBOX = _make_sbox()
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
# ShiftRows on the column-major state (byte 4c + r is row r, column c):
# row r rotates left by r columns
_SHIFT = np.array([(r + 4 * ((c + r) % 4)) for c in range(4) for r in range(4)])


def _expand_key(key: bytes) -> np.ndarray:
    """AES-128 key schedule -> (11, 16) uint8 round keys."""
    assert len(key) == 16
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [int(_SBOX[b]) for b in t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.asarray(w, np.uint8).reshape(11, 16)


def _xtime(a: np.ndarray) -> np.ndarray:
    return ((a << 1) ^ np.where(a & 0x80, 0x1B, 0).astype(np.uint8)).astype(np.uint8)


def _mix_columns(s: np.ndarray) -> np.ndarray:
    c = s.reshape(-1, 4, 4)                       # (N, column, row)
    a0, a1, a2, a3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    t = a0 ^ a1 ^ a2 ^ a3
    out = np.empty_like(c)
    out[..., 0] = a0 ^ t ^ _xtime(a0 ^ a1)
    out[..., 1] = a1 ^ t ^ _xtime(a1 ^ a2)
    out[..., 2] = a2 ^ t ^ _xtime(a2 ^ a3)
    out[..., 3] = a3 ^ t ^ _xtime(a3 ^ a0)
    return out.reshape(-1, 16)


def ecb_encrypt_plain(key: bytes, plaintext: bytes) -> bytes:
    """AES-128-ECB over a whole number of 16-byte blocks in numpy: the
    plain version of `rt.aes128_ecb`."""
    assert len(plaintext) % 16 == 0
    rk = _expand_key(key)
    s = np.frombuffer(plaintext, np.uint8).reshape(-1, 16) ^ rk[0]
    for r in range(1, 10):
        s = _mix_columns(_SBOX[s][:, _SHIFT]) ^ rk[r]
    s = _SBOX[s][:, _SHIFT] ^ rk[10]
    return s.astype(np.uint8).tobytes()


class MacPrf:
    """AES-128 PRF over (level, index, write_step) records."""

    def __init__(self, key: bytes):
        assert len(key) == 16
        self.key = key

    def prf_block(self, level: int, index: int, write_step: int) -> bytes:
        return rt.aes128_ecb(self.key, struct.pack("<iiq", level, index,
                                                write_step))

    def prf_scalar_ipa(self, level: int, index: int, write_step: int) -> int:
        """128-bit scalar r (secp256k1_scalar with d[0],d[1] from the
        ciphertext little-endian; d[2]=d[3]=0)."""
        return int.from_bytes(self.prf_block(level, index, write_step), "little")

    def prf_scalars_ipa(self, records) -> list[int]:
        """Batch PRF: records = iterable of (level, index, write_step)."""
        pt = b"".join(struct.pack("<iiq", l, i, w) for (l, i, w) in records)
        if not pt:
            return []
        ct = rt.aes128_ecb(self.key, pt)
        return [int.from_bytes(ct[k:k + 16], "little") for k in range(0, len(ct), 16)]

    def prf_scalars_kzg(self, records, r_modulus: int) -> list[int]:
        """KZG variant: ciphertext bytes big-endian into Fr (gnark SetBytes)."""
        pt = b"".join(struct.pack("<iiq", l, i, w) for (l, i, w) in records)
        if not pt:
            return []
        ct = rt.aes128_ecb(self.key, pt)
        return [int.from_bytes(ct[k:k + 16], "big") % r_modulus
                for k in range(0, len(ct), 16)]


class Prg:
    """emp-toolkit-compatible AES-CTR PRG (reference Utils/prg.h)."""

    def __init__(self, seed: bytes | None = None, stream_id: int = 0):
        if seed is None:
            import os
            seed = os.urandom(16)
        self.reseed(seed, stream_id)

    def reseed(self, seed: bytes, stream_id: int = 0) -> None:
        assert len(seed) == 16
        key = bytearray(seed)
        idb = struct.pack("<Q", stream_id)
        for i in range(8):  # v ^= makeBlock(0, id): id XORs the low 8 bytes
            key[i] ^= idb[i]
        self.key = bytes(key)
        self.counter = 0

    def random_block(self, nblocks: int) -> bytes:
        out = rt.prg_expand(self.key, self.counter, nblocks)
        self.counter += nblocks
        return out

    def random_data(self, nbytes: int) -> bytes:
        full = nbytes // 16
        out = self.random_block(full) if full else b""
        if nbytes % 16:
            out += self.random_block(1)[: nbytes % 16]
        return out

    def random_ints(self, count: int) -> np.ndarray:
        """`count` signed int32 values, matching random_data into an int[]."""
        raw = self.random_data(count * 4)
        return np.frombuffer(raw, dtype="<i4").copy()
