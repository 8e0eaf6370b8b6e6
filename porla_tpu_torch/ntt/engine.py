"""NTT / ICC erasure-encoding engine over the CRT data plane (plain torch).

The reference encodes data with an iterative radix-2 NTT over
Z_p (p = 207*2^248+1) while keeping values reduced mod LCM = p*q
(reference porla/Server/Server.hpp:1548-1830 `CRebuild_Cached`,
:1209-1328 `mix`). Butterfly:

    t = v_j * A[k+m2];  A[k] = (u + t) % LCM;  A[k+m2] = (u - t) % LCM
    with v_j = w^(n*j/m2), w a 2n-th primitive root of unity mod p.

A value mod LCM is carried as the CRT residue pair (x mod p, x mod q) —
two 256-bit limb-tensor lanes; every butterfly is exact in both lanes.

Twiddle tables are precomputed per length on the host (numpy uint32
limbs, as in the reference package) in Montgomery form per lane plus
standard form (the same values feed the EC "MAC mirror" butterflies as
scalars; Server.hpp:1592). Callers move them to their device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont


class CrtArray(NamedTuple):
    """A batch of Z_LCM values as residue lanes. Shapes (…, 16) each."""
    p: torch.Tensor
    q: torch.Tensor

    @property
    def batch_shape(self):
        return self.p.shape[:-1]

    def to(self, device) -> "CrtArray":
        return CrtArray(self.p.to(device), self.q.to(device))


def crt_from_ints(values, mod_q: mont.Modulus, device="cpu") -> CrtArray:
    """Python ints (any size) -> CRT lane tensors (N, 16), standard form."""
    vp = [int(v) % C.FFT_PRIME for v in values]
    vq = [int(v) % mod_q.n for v in values]
    return CrtArray(L.ints_to_tensor(vp, device), L.ints_to_tensor(vq, device))


def crt_to_ints(arr: CrtArray, mod_q: mont.Modulus) -> list[int]:
    """CRT lanes -> canonical representatives in [0, p*q) (host)."""
    ps = L.tensor_to_ints(arr.p)
    qs = L.tensor_to_ints(arr.q)
    p = C.FFT_PRIME
    q = mod_q.n
    pinv = pow(p, -1, q)
    return [xp_ + p * (((xq - xp_) * pinv) % q) for xp_, xq in zip(ps, qs)]


def crt_reduce_mod_p(arr: CrtArray, mod_q: mont.Modulus) -> CrtArray:
    """A := A mod p (align_MAC's `A[i] = A[i] % PRIME_MODULUS`,
    Server.hpp:499-502): the p lane is already canonical; the q lane is
    recomputed from it."""
    return CrtArray(arr.p, q_lane_from_p(arr.p, mod_q))


def q_lane_from_p(arr_p, mod_q: mont.Modulus):
    """Canonical q-lane residue of a canonical-mod-p (…, 16) value."""
    if mod_q.n > C.FFT_PRIME:
        return arr_p
    return mont.mod_reduce(arr_p, mod_q)


def align_scalars(arr: CrtArray, mod_q: mont.Modulus):
    """(A mod p - A) mod q per element — the correction scalars committed
    by align_MAC (Server.hpp:499-503). (…, 16) standard-form q-lane values."""
    return mont.sub_mod(q_lane_from_p(arr.p, mod_q), arr.q, mod_q)


class Twiddles(NamedTuple):
    """Twiddle factors for one butterfly length: v_j = w^(n*j/m2)."""
    std: np.ndarray     # (m2, 16) uint32 standard form (EC scalar use)
    mont_p: np.ndarray  # (m2, 16) uint32 Montgomery form mod p
    mont_q: np.ndarray  # (m2, 16) uint32 Montgomery form mod q


def reverse_bits(value: int, nbits: int) -> int:
    """Bit-reversal (reference porla/Utils/utils.h:81-91)."""
    out = 0
    for _ in range(nbits):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def _batch_powers(base: int, count: int, modulus: int) -> list[int]:
    """[base^0, …, base^(count-1)] mod modulus via doubling (host ints)."""
    pows = [1]
    while len(pows) < count:
        mult = pow(base, len(pows), modulus)
        pows.extend((x * mult) % modulus for x in pows[: count - len(pows)])
    return pows[:count]


class NttContext:
    """Per-(num_blocks, scheme) twiddle and root-of-unity context."""

    def __init__(self, num_blocks: int, scheme: str = "ipa",
                 hardened: bool = False):
        assert num_blocks & (num_blocks - 1) == 0, "n must be a power of two"
        self.n = num_blocks
        self.scheme = scheme
        self.hardened = hardened
        self.height = num_blocks.bit_length()  # log2(n) + 1
        self.mod_p = MOD_P
        self.mod_q = MOD_SECP_N if scheme == "ipa" else MOD_BN254_R
        # w = g^((p-1)/2n) (Client.hpp:141-144). With the reference's g
        # this has order n only (see fields/constants.py); hardened mode
        # uses a true generator so the codeword is MDS.
        gen = C.FFT_TRUE_GENERATOR if hardened else C.FFT_GENERATOR
        self.w = pow(gen, (C.FFT_PRIME - 1) // (2 * num_blocks),
                     C.FFT_PRIME)
        from porla_tpu_torch.curves import instances as _ci
        self.curve_ops = (_ci.secp256k1() if scheme == "ipa"
                          else _ci.bn254())
        self._tw_cache: dict[int, Twiddles] = {}

    def twiddles(self, length: int) -> Twiddles:
        """v_j = w^(n*j/length) for j in [0, length)."""
        tw = self._tw_cache.get(length)
        if tw is None:
            v = pow(self.w, self.n // length, C.FFT_PRIME)
            vals = _batch_powers(v, length, C.FFT_PRIME)
            tw = self._make_tw(vals)
            self._tw_cache[length] = tw
        return tw

    def _make_tw(self, vals: list[int]) -> Twiddles:
        std = L.ints_to_limbs(vals)
        mp = L.ints_to_limbs([self.mod_p.to_mont_int(v) for v in vals])
        mq = L.ints_to_limbs([self.mod_q.to_mont_int(v % self.mod_q.n)
                              for v in vals])
        return Twiddles(std, mp, mq)

    def wt_scalar(self, write_step: int) -> Twiddles:
        """w^bitrev(write_step mod n, height-1) — the time-twist applied to
        the Y copy (HAdd at Server.hpp:1391, CRebuild at :1494)."""
        e = reverse_bits(write_step % self.n, self.height - 1)
        return self._make_tw([pow(self.w, e, C.FFT_PRIME)])


MOD_P = mont.Modulus(C.FFT_PRIME, "fft_p")
MOD_SECP_N = mont.Modulus(C.SECP_N, "secp_n")
MOD_BN254_R = mont.Modulus(C.BN254_R, "bn254_r")


def butterfly_lane(a0, a1, tw_mont, mod: mont.Modulus):
    """One lane of the data butterfly: (a0 + tw*a1, a0 - tw*a1).
    a0, a1 standard form; tw_mont broadcastable, Montgomery form."""
    t = mont.mont_mul(a1, tw_mont, mod)
    return mont.add_mod(a0, t, mod), mont.sub_mod(a0, t, mod)


def encode_stages(ctx: NttContext, arr: CrtArray) -> CrtArray:
    """All CRebuild butterfly stages s = 1..height-1 over an (n, C, 16)
    CRT array (Server.hpp:1548-1687). Stage s pairs (k, k+m2) for
    k mod m < m2, twiddle v^j with j = k mod m2."""
    ap, aq = arr.p, arr.q
    for s in range(1, ctx.height):
        m2 = 1 << (s - 1)
        tw = ctx.twiddles(m2)
        ap = stage(ap, L.to_torch(tw.mont_p, ap.device), m2, ctx.mod_p)
        aq = stage(aq, L.to_torch(tw.mont_q, aq.device), m2, ctx.mod_q)
    return CrtArray(ap, aq)


def stage(a, tw_mont, m2: int, mod: mont.Modulus):
    """One radix-2 stage over (n, C, 16) limbs of one lane with half-width
    m2 and (m2, 16) Montgomery twiddles."""
    n = a.shape[0]
    m = 2 * m2
    v = a.reshape((n // m, m) + tuple(a.shape[1:]))
    u, t_in = v[:, :m2], v[:, m2:]
    tw = tw_mont.reshape((1, m2) + (1,) * (a.dim() - 2) + (L.NLIMBS,))
    hi, lo = butterfly_lane(u, t_in, tw, mod)
    return torch.cat([hi, lo], dim=1).reshape(a.shape)
