"""KZG polynomial commitments over BN254 (the reference's ENABLE_KZG
scheme, which it delegates to gnark-crypto via cgo — porla/main.go).

Counterpart of `porla_tpu/commit/kzg.py`.

- SRS: [tau^i]G1 for i < size, plus G2 and [tau]G2 (gnark kzg.NewSRS,
  main.go:42-68). The CLIENT generates tau from TAU_KEY (a trusted setup
  by the data owner, main.go:31-40), so it commits with one scalar
  multiplication (f(tau)*alpha*G1, main.go:70-89) while the server commits
  through the SRS (main.go:103-116).
- The SRS is a fixed base set, so a commitment is K4 (`fb_msm_groups`, one
  group of `size` lanes) over its per-window table (`KzgSrs.table`), as an
  IPA MSM is; the quotient polynomial is synthetic division on the host and
  verification a pairing check on the host (`golden/bn254_pairing.py`).

Serialization: G1 points use the gnark 64-byte uncompressed marshal
(X||Y big-endian; golden/ecc.py), Fr scalars 32-byte big-endian — the
reference's wire sizes (main.go:118-175). The SRS bytes are the reference
package's for the same tau.
"""

from __future__ import annotations

import functools

from porla_tpu_torch import native
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.instances import bn254
from porla_tpu_torch.fields import limbs
from porla_tpu_torch.fields.constants import BN254_R as FR
from porla_tpu_torch.golden import bn254_pairing as bp
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.utils import trace


class KzgSrs:
    """Structured reference string of given size, and the owner of the K4
    table of its G1 powers (`table`)."""

    def __init__(self, g1_powers, g2_tau):
        self.g1_powers = g1_powers            # list of affine G1 points
        self.g2 = bp.G2
        self.g2_tau = g2_tau                  # [tau] G2 (Fp2 affine)

    @property
    def size(self) -> int:
        return len(self.g1_powers)

    @functools.cached_property
    def table(self) -> cuda_curve.FbTable:
        """K4's table of the G1 powers, built at first use and held: the
        server's commitments (`commit_msm`, `open_at` and its align
        commitments) all read it."""
        return cuda_curve.fixed_base_table(bn254(), self.g1_powers)

    @classmethod
    def from_tau(cls, tau: int, size: int) -> "KzgSrs":
        with trace.span("kzg.srs", size=size):
            tau %= FR
            pows = []
            acc = 1
            for _ in range(size):
                pows.append(acc)
                acc = (acc * tau) % FR
            g1_powers = [ecc.mul(ecc.BN254, bp.G1, p) for p in pows]
            return cls(g1_powers, bp.g2_mul(bp.G2, tau))

    # --- wire format -------------------------------------------------------

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += len(self.g1_powers).to_bytes(4, "little")
        for pt in self.g1_powers:
            out += ecc.bn254_marshal(pt)
        for c in (self.g2_tau[0][0], self.g2_tau[0][1],
                  self.g2_tau[1][0], self.g2_tau[1][1]):
            out += c.to_bytes(32, "big")
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "KzgSrs":
        n = int.from_bytes(data[:4], "little")
        off = 4
        g1 = []
        for _ in range(n):
            g1.append(ecc.bn254_unmarshal(data[off:off + 64]))
            off += 64
        cs = [int.from_bytes(data[off + 32 * i:off + 32 * (i + 1)], "big")
              for i in range(4)]
        return cls(g1, ((cs[0], cs[1]), (cs[2], cs[3])))


def commit_msm(srs: KzgSrs, coeffs: list[int], device="cuda"):
    """Server-side commitment sum_i f_i * [tau^i]G1 (reference
    compute_digest_from_srs, main.go:103-116): one K4 launch over the SRS
    table, the coefficients zero-padded to the SRS size. Affine result."""
    assert len(coeffs) <= srs.size
    dev = native.resolve_device(device)
    sc = limbs.ints_to_tensor([c % FR for c in coeffs]
                              + [0] * (srs.size - len(coeffs)), dev)
    with trace.span("kzg.commit_msm"):
        return bn254().to_affine(
            cuda_curve.fb_msm_groups(srs.table, sc, nout=1))[0]


def commit_eval(tau: int, alpha: int, coeffs: list[int]):
    """Client-side commitment f(tau)*alpha*G1 — one scalar mult
    (reference compute_digest, main.go:70-89)."""
    return ecc.mul(ecc.BN254, bp.G1, (poly_eval(coeffs, tau) * alpha) % FR)


def poly_eval(coeffs: list[int], z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % FR
    return acc


def open_at(srs: KzgSrs, coeffs: list[int], z: int, device="cuda"):
    """KZG opening proof at z (reference create_proof, main.go:153-175):
    returns (H = [q(tau)]G1 with q = (f - f(z))/(x - z), claimed = f(z))."""
    z %= FR
    claimed = poly_eval(coeffs, z)
    # synthetic division: f(x) - claimed = (x - z) q(x)
    q = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (coeffs[i] + carry * z) % FR
        q[i - 1] = carry
    H = commit_msm(srs, q, device) if q else None
    return H, claimed


def verify(srs: KzgSrs, commitment, H, z: int, claimed: int) -> bool:
    """e(C - [claimed]G1, G2) == e(H, [tau - z]G2)
    (gnark kzg.Verify semantics, main.go:177-193)."""
    cv = ecc.BN254
    with trace.span("kzg.verify"):
        lhs = ecc.add(cv, commitment,
                      ecc.neg(cv, ecc.mul(cv, bp.G1, claimed % FR)))
        g2_tau_minus_z = bp.g2_add(srs.g2_tau,
                                   bp.g2_neg(bp.g2_mul(srs.g2, z % FR)))
        nH = ecc.neg(cv, H) if H is not None else None
        return bp.pairing_check([(lhs, srs.g2), (nH, g2_tau_minus_z)])
