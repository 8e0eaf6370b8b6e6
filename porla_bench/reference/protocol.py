"""The porla protocol, worked out again in Python integers.

`Deployment` holds what a configuration fixes: the scheme, n blocks of
`chunks` 256-bit chunks, the audit's sample count, the keys. `Replay` runs
the client's requests against a plain model of the server and keeps, for
every level of the hierarchical log (Server.hpp:61-70), what the server
must hold:

- `v`: the data plane, each chunk an integer mod p*q (the FFT prime p and
  the curve order q); the program's two CRT lanes are v mod p and v mod q.
- `u`: the MAC plane's committed value mod q. A MAC point is
  alpha * Commit(u) + r * h, and the alignment point beside it is
  Commit((v - u) mod q): the server reduces some data mod p (align_MAC,
  Server.hpp:478-562) and commits the difference instead.
- `r`: the MAC plane's complement exponent, after the client's deltas the
  fresh PRF(level, index, write step) of the level's formation
  (Client.hpp:256-306, 584-614).

A level above the deployment's `top_caching_level` lives in the
server's H_X/H_Y files, written in the 256-bit form: the final pass of
CRebuild_No_Cached (Server.hpp:1835-2255, align_MAC then write_256b at
:1977-1981) and of the disk `mix` (Server.hpp:954-1207) reduce each
element mod p as the level is formed and commit the difference into the
alignment plane. So such a level keeps `u` and holds v mod p, and a later
fold or audit reads that reduced value.

Commit is the Pedersen sum over the IPA generators, or for KZG the SRS
sum, f(tau) * G1. An audit reply is computed from the levels as the
server must answer it (Server.hpp:596-916).
"""

from __future__ import annotations

import hashlib

import numpy as np

from porla_bench.reference import aes, ecc
from porla_bench.reference.generators import Transcript, ipa_points

FFT_PRIME = 207 * (1 << 248) + 1                     # utils.h:31
FFT_GENERATOR = int(                                 # utils.h:29
    "3772465885858211343979859650005427966620095918126137910829420"
    "6582568298678")
_IPA_INIT = b"hash of P, c, etc. all that jazz"      # Server.hpp:2306


def reverse_bits(value: int, nbits: int) -> int:
    out = 0
    for _ in range(nbits):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def _obj(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


class Deployment:
    """What a configuration fixes, and the scheme's public values."""

    def __init__(self, scheme: str, num_blocks: int, chunks: int,
                 num_check_audit: int, secret_key: bytes, tau_key: bytes,
                 top_caching_level: int | None = None):
        if num_blocks & (num_blocks - 1):
            raise ValueError("num_blocks must be a power of two")
        self.scheme = scheme
        self.n = num_blocks
        self.chunks = chunks
        self.num_check_audit = num_check_audit
        self.height = num_blocks.bit_length()
        # levels above it are in files (TOP_CACHING_LEVEL, config.hpp:13);
        # by default every level is held in memory
        self.top_caching_level = self.height - 1 if top_caching_level is None \
            else top_caching_level
        self.key = secret_key
        self.w = pow(FFT_GENERATOR, (FFT_PRIME - 1) // (2 * num_blocks),
                     FFT_PRIME)
        if scheme == "ipa":
            self.curve = ecc.SECP256K1
            self.alpha = int.from_bytes(secret_key, "little")
            self.gens, self.u_point, self.h = ipa_points(chunks)
        elif scheme == "kzg":
            self.curve = ecc.BN254
            r = self.curve.n
            self.alpha = int.from_bytes(secret_key, "big") % r
            self.tau = int.from_bytes(tau_key, "big") % r
            self.hr = int.from_bytes(hashlib.sha256(
                tau_key + b"porla-h").digest(), "big") % r
            self.tau_pows = [pow(self.tau, j, r) for j in range(chunks)]
        else:
            raise ValueError(f"unknown scheme {scheme!r}")
        self.q = self.curve.n
        self.lcm = FFT_PRIME * self.q
        self._tw: dict = {}

    # --- scalars -----------------------------------------------------------

    def prf(self, records) -> list[int]:
        """The complement exponents of (level, index, write_step) records."""
        blocks = aes.prf_blocks(self.key, records)
        if self.scheme == "ipa":
            return [int.from_bytes(b, "little") for b in blocks]
        return [int.from_bytes(b, "big") % self.q for b in blocks]

    def twiddles(self, length: int) -> np.ndarray:
        """v_j = w^(n j / length) mod p, j < length."""
        tw = self._tw.get(length)
        if tw is None:
            v = pow(self.w, self.n // length, FFT_PRIME)
            tw = self._tw[length] = _obj(
                [pow(v, j, FFT_PRIME) for j in range(length)])
        return tw

    def wt(self, write_step: int) -> int:
        """The Y copy's time twist w^bitrev(write_step mod n)."""
        return pow(self.w, reverse_bits(write_step % self.n, self.height - 1),
                   FFT_PRIME)

    # --- group elements ----------------------------------------------------

    def commit_point(self, g_part, h_part: int = 0):
        """Commit(g_part) + h_part * h, the point with these exponents."""
        g = [int(x) % self.q for x in g_part]
        if self.scheme == "kzg":
            s = sum(a * t for a, t in zip(g, self.tau_pows)) + h_part * self.hr
            return ecc.mul(self.curve, self.curve.g, s)
        return ecc.msm(self.curve, self.gens + [self.h], g + [h_part])


class Side:
    """One side (X or Y) of a level: rows of v (mod p*q), u (mod q) and r."""

    def __init__(self, v: np.ndarray, u: np.ndarray, r=None):
        self.v, self.u, self.r = v, u, r

    def e(self, q: int) -> np.ndarray:
        """The alignment exponents (v - u) mod q."""
        return (self.v - self.u) % q


class Replay:
    """The server's state as the protocol fixes it, request by request."""

    def __init__(self, dep: Deployment, data_seed: bytes):
        self.dep = dep
        self.data = aes.Prg(data_seed, 1)
        self.blocks: dict[int, list[int]] = {}
        self.mac_r: dict[int, int] = {}
        self.levels: list = [None] * dep.height
        self.write_step = 0

    # --- requests ----------------------------------------------------------

    def _new_blocks(self, ids) -> None:
        c = self.dep.chunks
        raw = self.data.random_data(32 * (c - 1) * len(ids))
        step = 32 * (c - 1)
        for k, bid in enumerate(ids):
            rec = raw[k * step:(k + 1) * step]
            self.blocks[bid] = [bid] + [int.from_bytes(rec[32 * i:32 * i + 32],
                                                       "little")
                                        for i in range(c - 1)]

    def initialize(self) -> None:
        """Initialize at write step 0 (Client.hpp:180 is run at step 0 on
        both sides, as the port does)."""
        n = self.dep.n
        self._new_blocks(range(1, n + 1))
        for bid, r in zip(range(1, n + 1), self.dep.prf(
                [(0, bid, 0) for bid in range(1, n + 1)])):
            self.mac_r[bid] = r
        self._crebuild()

    def update(self) -> None:
        """The next round-robin update."""
        dep = self.dep
        bid = self.write_step % dep.n + 1
        self._new_blocks([bid])
        self.mac_r[bid] = dep.prf([(0, bid, self.write_step)])[0]
        self.write_step += 1
        if self.write_step % dep.n == 0:
            self._crebuild()
        else:
            self._hadd(bid)

    # --- the log -----------------------------------------------------------

    def _fresh(self, level: int, side_x: Side, side_y: Side) -> None:
        """The complement deltas: r becomes PRF(level, i, write step)."""
        rows = side_x.v.shape[0]
        r = self.dep.prf([(level, i, self.write_step)
                          for i in range(2 * rows)])
        side_x.r, side_y.r = _obj(r[:rows]), _obj(r[rows:])

    def _crebuild(self) -> None:
        """CRebuild (Server.hpp:1479-1830): the top level from U."""
        dep = self.dep
        n, M = dep.n, dep.lcm
        dx = np.empty((n, dep.chunks), dtype=object)
        for i in range(n):
            dx[i] = self.blocks[i + 1]
        dy = (dx * dep.wt(self.write_step)) % M
        for s in range(1, dep.height):
            m2 = 1 << (s - 1)
            tw = dep.twiddles(m2)
            dx, dy = _stage(dx, tw, m2, M), _stage(dy, tw, m2, M)
        top = dep.height - 1
        sx, sy = _formed(dep, top, (Side(dx, dx % dep.q),
                                    Side(dy, dy % dep.q)))
        self._fresh(top, sx, sy)
        self.levels = [None] * top + [(sx, sy)]

    def _hadd(self, bid: int) -> None:
        """HAdd (Server.hpp:1388-1477) and the fold into the first empty
        level (HRebuildX/Y, Server.hpp:1330-1386)."""
        dep = self.dep
        q, M = dep.q, dep.lcm
        chunks = np.empty((1, dep.chunks), dtype=object)
        chunks[0] = self.blocks[bid]
        wt = dep.wt(self.write_step)
        vy = (chunks * wt) % M
        slot = (Side(chunks, chunks % q), Side(vy % FFT_PRIME, vy % q))
        level = 0
        if self.levels[0] is not None:
            slot = _mix(dep, self.levels[0], slot, 1)
            level = 1
            while self.levels[level] is not None:
                slot = _mix(dep, self.levels[level], slot, 1 << level)
                level += 1
            slot = _formed(dep, level, slot)
        self._fresh(level, *slot)
        self.levels[:level + 1] = [None] * level + [slot]

    # --- audits ------------------------------------------------------------

    def audit_reply(self, seed: bytes) -> dict:
        """What the server must answer to an audit with `seed`: the reply's
        exact bytes, except KZG's two Jacobian triples, given as the group
        elements they must be."""
        dep = self.dep
        q, M = dep.q, dep.lcm
        plan = audit_plan(seed, self.write_step, dep.n, dep.height,
                          dep.num_check_audit)
        B = np.zeros(dep.chunks, dtype=object)
        U = np.zeros(dep.chunks, dtype=object)
        E = np.zeros(dep.chunks, dtype=object)
        R = 0
        for level, is_x, index, coeff in plan["samples"]:
            side = self.levels[level][0 if is_x else 1]
            B = B + coeff * side.v[index]
            U = U + coeff * side.u[index]
            E = E + coeff * ((side.v[index] - side.u[index]) % q)
            R += coeff * side.r[index]
        B %= M
        bp = [int(x) % FFT_PRIME for x in B]
        corr = [(x - int(y)) % q for x, y in zip(bp, B)]
        commitment = dep.commit_point(bp)
        mac = dep.commit_point([dep.alpha * int(x) for x in U], R % q)
        align = dep.commit_point([int(x) + c for x, c in zip(E, corr)])
        if dep.scheme == "ipa":
            b_vec, v = [], plan["ipa_challenge"]
            for _ in range(dep.chunks):
                b_vec.append(v)
                v = v * v % q
            return {"bytes": (ecc.secp_compressed(commitment)
                              + ecc.secp_compressed(mac)
                              + ecc.secp_compressed(align)
                              + ipa_prove(dep, bp, b_vec)),
                    "points": []}
        z = (plan["kzg_challenge"] & 0xFFFFFFFFFFFFFFFF) % q
        claimed, quot = _poly_open(bp, z, q)
        H = dep.commit_point(quot) if quot else ecc.INF
        return {"bytes": (ecc.bn254_marshal(commitment) + ecc.bn254_marshal(H)
                          + z.to_bytes(32, "big")
                          + claimed.to_bytes(32, "big")),
                "points": [mac, align]}


def _stage(a: np.ndarray, tw: np.ndarray, m2: int, M: int) -> np.ndarray:
    """One radix-2 CRebuild stage: rows (k, k + m2) for k mod 2 m2 < m2,
    twiddle v^(k mod m2) (Server.hpp:1548-1687)."""
    rows, c = a.shape
    v = a.reshape(rows // (2 * m2), 2 * m2, c)
    t = (v[:, m2:] * tw[None, :, None]) % M
    lo = v[:, :m2]
    out = np.concatenate([(lo + t) % M, (lo - t) % M], axis=1)
    return out.reshape(rows, c)


def _formed(dep: Deployment, level: int, sides):
    """A level as the server keeps it once formed: in memory as it was
    worked out, or in files with each element reduced mod p and `u` kept,
    so that its alignment exponent becomes (v mod p - u) mod q (align_MAC
    in the final pass of CRebuild_No_Cached and of the disk `mix`)."""
    if level <= dep.top_caching_level:
        return sides
    return tuple(Side(s.v % FFT_PRIME, s.u, s.r) for s in sides)


def _mix(dep: Deployment, lower, upper, length: int):
    """mix (Server.hpp:1209-1328): out[i] = lower[i] + v^i upper[i],
    out[i + length] = lower[i] - v^i upper[i], both sides."""
    tw = dep.twiddles(length)[:, None]
    out = []
    for lo, up in zip(lower, upper):
        tv = (up.v * tw) % dep.lcm
        tu = (up.u * tw) % dep.q
        out.append(Side(np.concatenate([(lo.v + tv) % dep.lcm,
                                        (lo.v - tv) % dep.lcm]),
                        np.concatenate([(lo.u + tu) % dep.q,
                                        (lo.u - tu) % dep.q])))
    return tuple(out)


def _poly_open(coeffs: list[int], z: int, r: int):
    """f(z) and the quotient (f - f(z)) / (x - z) (main.go:153-175)."""
    claimed = 0
    for c in reversed(coeffs):
        claimed = (claimed * z + c) % r
    quot = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (coeffs[i] + carry * z) % r
        quot[i - 1] = carry
    return claimed, quot


def _abs_i32(v: int) -> int:
    return abs(int(v)) & 0xFFFFFFFF


def audit_plan(seed: bytes, write_step: int, n: int, height: int,
               num_check: int) -> dict:
    """The samples (level, is_x, index, coefficient) and the two challenges
    both parties draw from an audit seed (Client.hpp:682-744,
    Server.hpp:596-732, 861, 907)."""
    vals = aes.Prg(seed, 0).random_ints(2 * num_check * height)
    ptr = 0
    samples = []
    for i in range(height):
        if not ((write_step % n) >> i & 1 or i == height - 1):
            continue
        l = 1 << i
        if 2 * l > num_check:
            idx = vals[ptr:ptr + num_check]
            cof = vals[ptr + num_check:ptr + 2 * num_check]
            ptr += 2 * num_check
            picks = [(_abs_i32(a) % (2 * l), _abs_i32(b))
                     for a, b in zip(idx, cof)]
        else:
            picks = [(j, _abs_i32(b)) for j, b in
                     enumerate(vals[ptr:ptr + 2 * l])]
            ptr += 2 * l
        for j, coeff in picks:
            samples.append((i, j < l, j if j < l else j - l, coeff))
    return {"samples": samples, "ipa_challenge": int(vals[len(samples)]),
            "kzg_challenge": int(vals[ptr])}


def ipa_prove(dep: Deployment, a: list[int], b: list[int]) -> bytes:
    """The reference's inner-product prover (Server.hpp:2279-2452), its
    round MSMs over the generators."""
    cv, Q = dep.curve, dep.q
    a, b = list(a), list(b)
    proof = bytearray((sum(x * y for x, y in zip(a, b)) % Q)
                      .to_bytes(32, "little"))
    sha = Transcript()
    sha.write(_IPA_INIT)
    sha.write(bytes(proof[:32]))
    digest = sha.finalize()
    xv = [1] * dep.chunks
    half, k = dep.chunks // 2, 1
    while half > 1:
        x = int.from_bytes(digest, "little") % Q
        ix = pow(x, -1, Q)
        cl = sum(a[i] * b[half + i] for i in range(half)) % Q
        cr = sum(a[half + i] * b[i] for i in range(half)) % Q
        sl, sr = [0] * dep.chunks, [0] * dep.chunks
        for i in range(k):
            base = ((i << 1) + 1) * half
            for j in range(half):
                sl[base + j] = a[j] * xv[base + j] % Q
                xv[base + j] = xv[base + j] * x % Q
        for i in range(k):
            base = (i << 1) * half
            for j in range(half):
                sr[base + j] = a[half + j] * xv[base + j] % Q
                xv[base + j] = xv[base + j] * ix % Q
        for pts_scal, c in ((sl, cl), (sr, cr)):
            pt = ecc.msm(cv, dep.gens + [dep.u_point], pts_scal + [c])
            ser = ecc.secp_compressed(pt)
            proof += ser
            sha.write(ser)
            digest = sha.finalize()
        a = [(a[i] * x + a[i + half] * ix) % Q for i in range(half)]
        b = [(b[i] * ix + b[i + half] * x) % Q for i in range(half)]
        half >>= 1
        k <<= 1
    for i in range(2):
        proof += a[i].to_bytes(32, "little") + b[i].to_bytes(32, "little")
    return bytes(proof)
