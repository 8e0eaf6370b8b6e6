"""Point wire serialization for MAC blocks.

The MAC wire format is the canonical Jacobian triple (X, Y, Z) as
3 x 32 little-endian bytes (96 bytes), standard (not Montgomery) form;
infinity is Z = 0. It is byte-compatible with the reference package's
`porla_tpu/protocol/points_io.py`, so a client of one package can talk to
a server of the other. IPA audit replies carry the reference's 33-byte
compressed points instead, KZG audit replies these triples
(protocol/server.py). Either curve: the caller passes its `CurveOps`.
"""

from __future__ import annotations

from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs

MAC_WIRE_SIZE = 96


def points_to_bytes(pts: JacPoint, ops) -> bytes:
    """Batched JacPoint (N,) of `ops`'s curve -> N*96 bytes (host
    conversion, exact)."""
    fp = ops.fp
    p = fp.n
    rinv = pow(fp.r, -1, p)
    xs, ys, zs = (limbs.tensor_to_ints(c) for c in pts)
    out = bytearray()
    for x, y, z in zip(xs, ys, zs):
        out += ((x * rinv) % p).to_bytes(32, "little")
        out += ((y * rinv) % p).to_bytes(32, "little")
        out += ((z * rinv) % p).to_bytes(32, "little")
    return bytes(out)


def points_from_bytes(data: bytes, ops, device="cpu") -> JacPoint:
    """N*96 bytes -> batched JacPoint (N,) of `ops`'s curve in Montgomery
    form."""
    assert len(data) % MAC_WIRE_SIZE == 0
    n = len(data) // MAC_WIRE_SIZE
    fp = ops.fp
    xs, ys, zs = [], [], []
    for i in range(n):
        rec = data[i * 96:(i + 1) * 96]
        xs.append(fp.to_mont_int(int.from_bytes(rec[0:32], "little")))
        ys.append(fp.to_mont_int(int.from_bytes(rec[32:64], "little")))
        zs.append(fp.to_mont_int(int.from_bytes(rec[64:96], "little")))
    return JacPoint(limbs.ints_to_tensor(xs, device),
                    limbs.ints_to_tensor(ys, device),
                    limbs.ints_to_tensor(zs, device))
