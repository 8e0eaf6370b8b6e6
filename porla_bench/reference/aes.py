"""AES-128 in NumPy, the emp-style AES-CTR PRG and the MAC-complement PRF.

FIPS-197 AES-128 (key schedule and ECB encryption) vectorized over
blocks. The PRG (the reference's Utils/prg.h) encrypts the counter blocks
[counter:u64 LE | 0:u64] under the key seed XOR makeBlock(0, stream id);
the PRF (Client.hpp:423-455) encrypts the record [level:i32 LE | index:i32
LE | write_step:i64 LE] under the secret key.
"""

from __future__ import annotations

import struct

import numpy as np


def _make_sbox() -> np.ndarray:
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
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
# ShiftRows on the column-major state (byte 4c + r is row r, column c)
_SHIFT = np.array([(r + 4 * ((c + r) % 4))
                   for c in range(4) for r in range(4)])


def _expand_key(key: bytes) -> np.ndarray:
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [int(_SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.asarray(w, np.uint8).reshape(11, 16)


def _xtime(a: np.ndarray) -> np.ndarray:
    return ((a << 1) ^ np.where(a & 0x80, 0x1B, 0).astype(np.uint8)).astype(
        np.uint8)


def _mix_columns(s: np.ndarray) -> np.ndarray:
    c = s.reshape(-1, 4, 4)
    a0, a1, a2, a3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    t = a0 ^ a1 ^ a2 ^ a3
    out = np.empty_like(c)
    out[..., 0] = a0 ^ t ^ _xtime(a0 ^ a1)
    out[..., 1] = a1 ^ t ^ _xtime(a1 ^ a2)
    out[..., 2] = a2 ^ t ^ _xtime(a2 ^ a3)
    out[..., 3] = a3 ^ t ^ _xtime(a3 ^ a0)
    return out.reshape(-1, 16)


def ecb_encrypt(key: bytes, plaintext: bytes) -> bytes:
    """AES-128-ECB over a whole number of 16-byte blocks."""
    if len(key) != 16 or len(plaintext) % 16:
        raise ValueError("AES-128 takes a 16-byte key and whole blocks")
    rk = _expand_key(key)
    s = np.frombuffer(plaintext, np.uint8).reshape(-1, 16) ^ rk[0]
    for r in range(1, 10):
        s = _mix_columns(_SBOX[s][:, _SHIFT]) ^ rk[r]
    s = _SBOX[s][:, _SHIFT] ^ rk[10]
    return s.astype(np.uint8).tobytes()


class Prg:
    """The AES-CTR stream of one (seed, stream id), read from its start."""

    def __init__(self, seed: bytes, stream_id: int):
        key = bytearray(seed)
        for i, b in enumerate(struct.pack("<Q", stream_id)):
            key[i] ^= b
        self.key = bytes(key)
        self.counter = 0

    def blocks(self, nblocks: int) -> bytes:
        ctr = np.zeros((nblocks, 2), "<u8")
        ctr[:, 0] = np.arange(self.counter, self.counter + nblocks,
                              dtype=np.uint64)
        self.counter += nblocks
        return ecb_encrypt(self.key, ctr.tobytes())

    def random_data(self, nbytes: int) -> bytes:
        out = self.blocks(nbytes // 16)
        if nbytes % 16:
            out += self.blocks(1)[:nbytes % 16]
        return out

    def random_ints(self, count: int) -> np.ndarray:
        """`count` signed int32 values (random_data read as an int[])."""
        return np.frombuffer(self.random_data(4 * count), "<i4").copy()


def prf_blocks(key: bytes, records) -> list[bytes]:
    """The 16-byte PRF outputs of (level, index, write_step) records."""
    pt = b"".join(struct.pack("<iiq", lv, ix, ws) for lv, ix, ws in records)
    if not pt:
        return []
    ct = ecb_encrypt(key, pt)
    return [ct[k:k + 16] for k in range(0, len(ct), 16)]
