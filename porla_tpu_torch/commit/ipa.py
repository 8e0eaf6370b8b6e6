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

The per-round MSMs and the final 128-point MSM run on K4, the fixed-base
kernel (full generator width with zero padding); single-point scalar
mults stay on the host golden model. `gens` is a JacPoint on the device
the MSMs should run on.
"""

from __future__ import annotations

from porla_tpu_torch.config import NUM_CHUNKS
from porla_tpu_torch.crypto.shas import Sha256
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.fields import limbs
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.utils import trace

Q = C.SECP_N
_INIT_STR = b"hash of P, c, etc. all that jazz"


def _gens_table(gens: JacPoint):
    g = JacPoint(*(c[:NUM_CHUNKS] for c in gens))
    return cuda_curve.fb_table_for(secp256k1(), g)


def _msm_gens(gens: JacPoint, scalar_map: dict[int, int]):
    """MSM over the fixed generator set with scalars at given positions
    (zeros elsewhere keep the shape fixed), as one K4 launch over
    NUM_CHUNKS lanes plus a lane-halving sum. Returns the affine point."""
    sc = [0] * NUM_CHUNKS
    for pos, v in scalar_map.items():
        sc[pos] = v % Q
    with trace.span("ipa.msm"):
        out = cuda_curve.fb_msm_groups(
            _gens_table(gens), limbs.ints_to_tensor(sc, gens.x.device), nout=1)
        return secp256k1().to_affine(out)[0]


def _msm_gens2(gens: JacPoint, scal_l: dict[int, int],
               scal_r: dict[int, int]):
    """Two fixed-base MSMs over the generator set as one K4 launch
    (2*NUM_CHUNKS lanes), reduced per half. Returns two affine points."""
    sc = [0] * (2 * NUM_CHUNKS)
    for pos, v in scal_l.items():
        sc[pos] = v % Q
    for pos, v in scal_r.items():
        sc[NUM_CHUNKS + pos] = v % Q
    with trace.span("ipa.msm2"):
        out = cuda_curve.fb_msm_groups(
            _gens_table(gens), limbs.ints_to_tensor(sc, gens.x.device), nout=2)
        aff = secp256k1().to_affine(out)
        return aff[0], aff[1]


def _hash_mod_q(b32: bytes) -> int:
    """convert_arr_to_ZZ_p: little-endian u32 words -> int mod q
    (utils.h:384-393 under ZZ_p::init(GROUP_ORDER))."""
    return int.from_bytes(b32, "little") % Q


def prove(a: list[int], b: list[int], gens: JacPoint, u) -> bytes:
    """a, b: length-128 integer vectors (a = audited block mod p, b =
    challenge powers; b[0] may be negative — NTL semantics)."""
    assert len(a) == NUM_CHUNKS and len(b) == NUM_CHUNKS
    a = list(a)
    b = list(b)
    cv = ecc.SECP256K1
    proof = bytearray()

    ip = sum(x * y for x, y in zip(a, b)) % Q
    proof += ip.to_bytes(32, "little")

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

        cL = sum(a[i] * b[half + i] for i in range(half)) % Q
        cR = sum(a[half + i] * b[i] for i in range(half)) % Q

        # L: scalars on odd half-blocks (Server.hpp:2337-2349); R: even
        # half-blocks (Server.hpp:2387-2399). R's scalars depend only on
        # x/inv_x — not on L's transcript bytes — so both MSMs run as ONE
        # batched device call per round.
        scal_l = {}
        for i in range(k):
            pos = (i << 1) + 1
            for qi, j in enumerate(range(pos * half, (pos + 1) * half)):
                scal_l[j] = (a[qi] * x_values[j]) % Q
                x_values[j] = (x_values[j] * x) % Q
        scal_r = {}
        for i in range(k):
            pos = i << 1
            for qi, j in enumerate(range(pos * half, (pos + 1) * half)):
                scal_r[j] = (a[half + qi] * x_values[j]) % Q
                x_values[j] = (x_values[j] * inv_x) % Q
        msm_l, msm_r = _msm_gens2(gens, scal_l, scal_r)

        L = ecc.add(cv, msm_l, ecc.mul(cv, u, cL))
        ser = ecc.secp_serialize_compressed(L)
        proof += ser
        sha.write(ser)
        random_str = sha.finalize()

        R = ecc.add(cv, msm_r, ecc.mul(cv, u, cR))
        ser = ecc.secp_serialize_compressed(R)
        proof += ser
        sha.write(ser)
        random_str = sha.finalize()

        a = [(a[i] * x + a[i + half] * inv_x) % Q for i in range(half)]
        b = [(b[i] * inv_x + b[i + half] * x) % Q for i in range(half)]
        half >>= 1
        k <<= 1

    for i in range(2):
        proof += (a[i] % (1 << 256)).to_bytes(32, "little")
        proof += (b[i] % (1 << 256)).to_bytes(32, "little")
    return bytes(proof)


class IpaVerificationError(AssertionError):
    pass


def verify(commitment, proof: bytes, gens: JacPoint, u) -> None:
    """Raises IpaVerificationError on failure (the reference CHECK-aborts,
    Client.hpp:1628). `commitment` is the affine commitment point."""
    cv = ecc.SECP256K1
    off = 0
    c = int.from_bytes(proof[off:off + 32], "little")
    off += 32
    P_acc = ecc.add(cv, commitment, ecc.mul(cv, u, c))

    sha = Sha256()
    sha.write(_INIT_STR)
    sha.write(proof[:32])
    random_str = sha.finalize()

    x_values = [1] * NUM_CHUNKS

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

        L = ecc.secp_parse_compressed(proof[off:off + 33])
        sha.write(proof[off:off + 33])
        random_str = sha.finalize()
        off += 33
        R = ecc.secp_parse_compressed(proof[off:off + 33])
        sha.write(proof[off:off + 33])
        random_str = sha.finalize()
        off += 33

        P_acc = ecc.add(cv, P_acc, ecc.mul(cv, L, x2))
        P_acc = ecc.add(cv, P_acc, ecc.mul(cv, R, inv_x2))
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

    scal = {}
    for i in range(NUM_CHUNKS >> 1):
        pos = i << 1
        scal[pos] = (a[0] * x_values[pos]) % Q
    for i in range(NUM_CHUNKS >> 1):
        pos = (i << 1) + 1
        scal[pos] = (a[1] * x_values[pos]) % Q
    P = ecc.add(cv, ecc.mul(cv, u, ab), _msm_gens(gens, scal))

    if P_acc != P:
        raise IpaVerificationError("inner-product argument check failed")
