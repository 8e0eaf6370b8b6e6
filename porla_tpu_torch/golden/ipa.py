"""The inner-product prover in host integers: ground truth for the tests
and for `chip_smoke.py`, which hold `commit/ipa.py`'s prover (its rounds on
K4, u's terms in the same launch) to it byte for byte.

The same transcript and scalar folding as `commit/ipa.prove` (reference
Server.hpp:2279-2452), with each round's L = msm_l + cL u and
R = msm_r + cR u computed one point at a time by the golden model's
curve arithmetic (`golden/ecc.py`).
"""

from __future__ import annotations

from porla_tpu_torch.crypto.shas import Sha256
from porla_tpu_torch.golden import ecc

INIT_STR = b"hash of P, c, etc. all that jazz"


def prove(a: list[int], b: list[int], gens: list, u) -> bytes:
    """a, b: equal-length integer vectors (a power of two); gens: the
    affine generators, one a position; u: an affine point."""
    cv = ecc.SECP256K1
    q = cv.n
    n = len(a)
    a, b = list(a), list(b)
    proof = bytearray((sum(x * y for x, y in zip(a, b)) % q)
                      .to_bytes(32, "little"))
    sha = Sha256()
    sha.write(INIT_STR)
    sha.write(bytes(proof))
    random_str = sha.finalize()
    x_values = [1] * n
    half, k = n // 2, 1
    while half > 1:
        x = int.from_bytes(random_str, "little") % q
        inv_x = pow(x, -1, q)
        c_l = sum(a[i] * b[half + i] for i in range(half)) % q
        c_r = sum(a[half + i] * b[i] for i in range(half)) % q
        # L over the odd half-blocks with x, R over the even ones with 1/x
        msm = []
        for odd, xs, off in ((1, x, 0), (0, inv_x, half)):
            pts, sc = [], []
            for i in range(k):
                pos = (i << 1) + odd
                for qi, j in enumerate(range(pos * half, (pos + 1) * half)):
                    pts.append(gens[j])
                    sc.append(a[off + qi] * x_values[j] % q)
                    x_values[j] = x_values[j] * xs % q
            msm.append(ecc.msm(cv, pts, sc))
        a = [(a[i] * x + a[i + half] * inv_x) % q for i in range(half)]
        b = [(b[i] * inv_x + b[i + half] * x) % q for i in range(half)]
        for m, c in zip(msm, (c_l, c_r)):
            ser = ecc.secp_serialize_compressed(
                ecc.add(cv, m, ecc.mul(cv, u, c)))
            proof += ser
            sha.write(ser)
            random_str = sha.finalize()
        half >>= 1
        k <<= 1
    for i in range(2):
        proof += (a[i] % (1 << 256)).to_bytes(32, "little")
        proof += (b[i] % (1 << 256)).to_bytes(32, "little")
    return bytes(proof)
