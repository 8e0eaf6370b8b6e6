"""Bulletproof-style inner-product argument over secp256k1.

Byte-exact reimplementation of the reference's prover/verifier
(reference porla/Server/Server.hpp:2279-2452 inner_product_prove,
porla/Client/Client.hpp:1464-1633 inner_product_verify), including its
idiosyncratic Fiat-Shamir transcript: ONE sha256 object written across
finalizes (see porla_tpu/crypto/shas.py for the exact state semantics).

Scalar/point serialization matches the reference wire format:
- 32-byte scalars are little-endian u32 limb arrays (convert_ZZ_to_arr);
- L/R points are 33-byte compressed (secp256k1_eckey_pubkey_serialize).

Proof layout (NUM_CHUNKS=128): [ip:32] + 6 rounds * [L:33 | R:33] +
[a0:32 | b0:32 | a1:32 | b1:32] = 556 bytes (Server.hpp:856).

Every curve operation runs on the card's kernels (their plain versions on
the CPU); no scalar multiplication is left to the host's integers. The
bases, u and every table the kernels read are an `IpaKey`'s, on the device
the kernels should run on.

- A prover's round is one K4 launch of two groups of NUM_CHUNKS lanes, L's
  and R's, over a table laid out for the round (`IpaKey.rounds`): a
  group's 64 generators, then u with the scalar cL (or cR), then pad lanes
  of zero scalar. So the launch returns L and R whole.
- The verifier derives every round's x from the proof's bytes first, then
  sums x^2 L + x^-2 R over the rounds and the commitment in one K2 GLV
  launch and one `group_sum`, and the final MSM and (ab - c) u in one K4
  launch over the first round's table, one side of the equation a group.
"""

from __future__ import annotations

from porla_tpu_torch.config import NUM_CHUNKS
from porla_tpu_torch.crypto.shas import Sha256
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.curves.weierstrass import cat, index
from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.fields import limbs
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.utils import trace

Q = C.SECP_N
_INIT_STR = b"hash of P, c, etc. all that jazz"


# columns of the source table an `IpaKey`'s round tables gather from: the
# NUM_CHUNKS generators, then u, then the point at infinity for the pad lanes
_U = NUM_CHUNKS
_PAD = NUM_CHUNKS + 1


def _lanes(left: list, left_u, right: list, right_u, pad) -> list:
    """A round's 2 * NUM_CHUNKS lanes: each group holds its generators'
    entries, then u's, then `pad` up to NUM_CHUNKS lanes (a power of two,
    as `fb_msm_groups` asks)."""
    fill = [pad] * (NUM_CHUNKS - len(left) - 1)
    return left + [left_u] + fill + right + [right_u] + fill


class IpaKey:
    """The IPA's bases and their K4 tables, built once and held by their
    owner (the server's at its construction; the client's at initialize,
    from the generators and u that arrive on the wire): `gens_affine`, the
    NUM_CHUNKS generators; `u`; `table`, the generators' table, which the
    server's Pedersen commitments use too; and `rounds`, each prover
    round's table by its `half`. A round's table is L's group over the
    generators of the odd half-blocks and R's over those of the even ones
    (Server.hpp:2337-2349, 2387-2399), each followed by u and pad lanes at
    infinity, gathered (`cuda_curve.FbColumns`) from the generators' table
    beside a table of u and infinity: u's windows are the only points
    computed for them. `device` is where the proofs' scalars go. In one
    process a client's and a server's keys share the tables of their bases
    (`cuda_curve.fixed_base_table`)."""

    def __init__(self, gens_affine, u, device):
        if len(gens_affine) != NUM_CHUNKS:
            raise ValueError(f"{len(gens_affine)} generators, expected "
                             f"{NUM_CHUNKS}")
        ops = secp256k1()
        self.gens_affine = list(gens_affine)
        self.u = u
        self.device = device
        self.table = cuda_curve.fixed_base_table(ops, self.gens_affine)
        src = cuda_curve.fb_table_cat(
            [self.table, cuda_curve.fixed_base_table(ops, [u, ecc.INF])])
        self.rounds = {}
        for r in range(1, NUM_CHUNKS.bit_length() - 1):     # half 64 .. 2
            half = NUM_CHUNKS >> r
            odd = [j for j in range(NUM_CHUNKS) if (j // half) & 1]
            even = [j for j in range(NUM_CHUNKS) if not (j // half) & 1]
            self.rounds[half] = cuda_curve.FbColumns(
                src, _lanes(odd, _U, even, _U, _PAD))


def _round_msm(table, scalars: list[int], device):
    """One K4 launch over a round's table: the two groups' sums as a
    (2,) JacPoint."""
    return cuda_curve.fb_msm_groups(
        table, limbs.ints_to_tensor(scalars, device), nout=2)


def _hash_mod_q(b32: bytes) -> int:
    """convert_arr_to_ZZ_p: little-endian u32 words -> int mod q
    (utils.h:384-393 under ZZ_p::init(GROUP_ORDER))."""
    return int.from_bytes(b32, "little") % Q


def prove(a: list[int], b: list[int], key: IpaKey) -> bytes:
    """a, b: length-128 integer vectors (a = audited block mod p, b =
    challenge powers; b[0] may be negative — NTL semantics)."""
    assert len(a) == NUM_CHUNKS and len(b) == NUM_CHUNKS
    a = list(a)
    b = list(b)
    proof = bytearray()

    ip = sum(x * y for x, y in zip(a, b)) % Q
    proof += ip.to_bytes(32, "little")

    with trace.span("ipa.transcript"):
        sha = Sha256()
        sha.write(_INIT_STR)
        sha.write(bytes(proof[:32]))
        random_str = sha.finalize()

    x_values = [1] * NUM_CHUNKS

    half = NUM_CHUNKS // 2
    k = 1
    while half > 1:
        x = _hash_mod_q(random_str)
        inv_x = pow(x, -1, Q)

        with trace.span("ipa.scalars", lanes=2 * half):
            cL = sum(a[i] * b[half + i] for i in range(half)) % Q
            cR = sum(a[half + i] * b[i] for i in range(half)) % Q

            # L: scalars on odd half-blocks (Server.hpp:2337-2349); R: even
            # half-blocks (Server.hpp:2387-2399), each in position order, as
            # the round's table lays out its groups. R's scalars depend
            # only on x/inv_x — not on L's transcript bytes — so L and R
            # (their u terms included) are ONE device call per round.
            scal_l = []
            for i in range(k):
                pos = (i << 1) + 1
                for qi, j in enumerate(range(pos * half, (pos + 1) * half)):
                    scal_l.append((a[qi] * x_values[j]) % Q)
                    x_values[j] = (x_values[j] * x) % Q
            scal_r = []
            for i in range(k):
                pos = i << 1
                for qi, j in enumerate(range(pos * half, (pos + 1) * half)):
                    scal_r.append((a[half + qi] * x_values[j]) % Q)
                    x_values[j] = (x_values[j] * inv_x) % Q

            a = [(a[i] * x + a[i + half] * inv_x) % Q for i in range(half)]
            b = [(b[i] * inv_x + b[i + half] * x) % Q for i in range(half)]
        with trace.span("ipa.msm2"):
            L, R = secp256k1().to_affine(_round_msm(
                key.rounds[half], _lanes(scal_l, cL, scal_r, cR, 0),
                key.device))

        with trace.span("ipa.transcript"):
            ser = ecc.secp_serialize_compressed(L)
            proof += ser
            sha.write(ser)
            random_str = sha.finalize()

            ser = ecc.secp_serialize_compressed(R)
            proof += ser
            sha.write(ser)
            random_str = sha.finalize()

        half >>= 1
        k <<= 1

    for i in range(2):
        proof += (a[i] % (1 << 256)).to_bytes(32, "little")
        proof += (b[i] % (1 << 256)).to_bytes(32, "little")
    return bytes(proof)


class IpaVerificationError(AssertionError):
    pass


def verify(commitment, proof: bytes, key: IpaKey) -> None:
    """Raises IpaVerificationError on failure (the reference CHECK-aborts,
    Client.hpp:1628). `commitment` is the affine commitment point."""
    with trace.span("ipa.verify", bytes=len(proof)):
        _verify(commitment, proof, key)


def _verify(commitment, proof: bytes, key: IpaKey) -> None:
    ops = secp256k1()
    dev = key.device
    off = 0
    c = int.from_bytes(proof[off:off + 32], "little")
    off += 32

    with trace.span("ipa.transcript"):
        sha = Sha256()
        sha.write(_INIT_STR)
        sha.write(proof[:32])
        random_str = sha.finalize()

    x_values = [1] * NUM_CHUNKS
    # every round's L and R with its x^2 and x^-2: the transcript hashes
    # the proof alone, so all of them are known before any curve work
    points, point_scalars = [], []

    half = NUM_CHUNKS // 2
    k = 1
    while half > 1:
        x = _hash_mod_q(random_str)
        inv_x = pow(x, -1, Q)
        for i in range(k):
            pos = (i << 1) + 1
            for j in range(pos * half, (pos + 1) * half):
                x_values[j] = (x_values[j] * x) % Q
        for i in range(k):
            pos = i << 1
            for j in range(pos * half, (pos + 1) * half):
                x_values[j] = (x_values[j] * inv_x) % Q

        x2 = (x * x) % Q
        inv_x2 = pow(x2, -1, Q)

        with trace.span("ipa.transcript"):
            L = ecc.secp_parse_compressed(proof[off:off + 33])
            sha.write(proof[off:off + 33])
            random_str = sha.finalize()
            off += 33
            R = ecc.secp_parse_compressed(proof[off:off + 33])
            sha.write(proof[off:off + 33])
            random_str = sha.finalize()
            off += 33
        points += [L, R]
        point_scalars += [x2, inv_x2]
        half >>= 1
        k <<= 1

    a = [0, 0]
    b = [0, 0]
    for i in range(2):
        a[i] = int.from_bytes(proof[off:off + 32], "little")
        off += 32
        b[i] = int.from_bytes(proof[off:off + 32], "little")
        off += 32
    ab = (a[0] * b[0] + a[1] * b[1]) % Q

    scal = [(a[j & 1] * x_values[j]) % Q for j in range(NUM_CHUNKS)]
    # The reference checks commitment + c u + sum(x^2 L + x^-2 R) ==
    # ab u + sum(scal_j G_j). Here (ab - c) u and the upper half's terms
    # stay on the right, the lower half's move to the left negated: the
    # first round's table holds exactly these two groups.
    lo = NUM_CHUNKS // 2
    with trace.span("ipa.msm"):
        msm = _round_msm(key.rounds[lo], _lanes(
            scal[lo:], (ab - c) % Q, [(-s) % Q for s in scal[:lo]], 0, 0),
            dev)
    with trace.span("ecc.host"):
        terms = cuda_curve.scalar_mul(
            ops, ops.from_affine(points, dev),
            limbs.ints_to_tensor(point_scalars, dev))
        lhs = cuda_curve.group_sum(ops, cat([
            terms, ops.from_affine([commitment], dev),
            index(msm, slice(1, 2))]), 1)
        lhs, rhs = ops.to_affine(cat([lhs, index(msm, slice(0, 1))]))

    if lhs != rhs:
        raise IpaVerificationError("inner-product argument check failed")
