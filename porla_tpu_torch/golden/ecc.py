"""Exact big-int elliptic-curve arithmetic (ground truth for tests and for
host-side single-point protocol operations).

Short-Weierstrass curves y^2 = x^3 + b over prime fields, affine
coordinates, Python integers. This is the golden model the batched
limb-tensor kernels (porla_tpu_torch/curves/*) are tested against; it also backs
cheap one-off host computations (point (de)serialization, generator
derivation) where tensorization would be pointless.
"""

from __future__ import annotations

from dataclasses import dataclass

from porla_tpu_torch.fields import constants as C

INF = None  # point at infinity is represented as None


@dataclass(frozen=True)
class Curve:
    p: int  # base field prime
    b: int  # curve constant
    n: int  # group order
    gx: int
    gy: int

    @property
    def g(self):
        return (self.gx, self.gy)


SECP256K1 = Curve(p=C.SECP_P, b=C.SECP_B, n=C.SECP_N, gx=C.SECP_GX, gy=C.SECP_GY)
BN254 = Curve(p=C.BN254_P, b=C.BN254_B, n=C.BN254_R, gx=C.BN254_G1X, gy=C.BN254_G1Y)


def is_on_curve(cv: Curve, pt) -> bool:
    if pt is INF:
        return True
    x, y = pt
    return (y * y - (x * x * x + cv.b)) % cv.p == 0


def neg(cv: Curve, pt):
    if pt is INF:
        return INF
    x, y = pt
    return (x, (-y) % cv.p)


def add(cv: Curve, p1, p2):
    if p1 is INF:
        return p2
    if p2 is INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    p = cv.p
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return INF
        lam = (3 * x1 * x1) * pow(2 * y1, p - 2, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def _jac_dbl(X, Y, Z, p):
    """Jacobian doubling for a = 0 (dbl-2009-l); Z == 0 is infinity."""
    if Z == 0 or Y == 0:
        return 1, 1, 0
    A = X * X % p
    B = Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    return X3, (E * (D - X3) - 8 * C) % p, 2 * Y * Z % p


def _jac_madd(X, Y, Z, ax, ay, p):
    """Jacobian + affine point, every case handled."""
    if Z == 0:
        return ax, ay, 1
    ZZ = Z * Z % p
    H = (ax * ZZ - X) % p
    r = (ay * Z * ZZ - Y) % p
    if H == 0:
        return _jac_dbl(X, Y, Z, p) if r == 0 else (1, 1, 0)
    HH = H * H % p
    HHH = H * HH % p
    V = X * HH % p
    X3 = (r * r - HHH - 2 * V) % p
    return X3, (r * (V - X3) - Y * HHH) % p, Z * H % p


def mul(cv: Curve, pt, k: int):
    """k * pt, exact: MSB-first double-and-add in Jacobian coordinates with
    one inversion at the end."""
    k %= cv.n
    if pt is INF or k == 0:
        return INF
    p = cv.p
    ax, ay = pt
    X, Y, Z = ax, ay, 1
    for bit in bin(k)[3:]:
        X, Y, Z = _jac_dbl(X, Y, Z, p)
        if bit == "1":
            X, Y, Z = _jac_madd(X, Y, Z, ax, ay, p)
    if Z == 0:
        return INF
    zi = pow(Z, -1, p)
    zi2 = zi * zi % p
    return X * zi2 % p, Y * zi2 * zi % p


def msm(cv: Curve, points, scalars):
    acc = INF
    for pt, s in zip(points, scalars):
        acc = add(cv, acc, mul(cv, pt, s))
    return acc


def sqrt_mod(a: int, p: int):
    """Square root mod p for p % 4 == 3 (both our base fields). None if QNR."""
    assert p % 4 == 3
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a % p else None


def lift_x(cv: Curve, x: int, odd: int):
    """Point with given x and y-parity, or None (mirrors ge_set_xo_var)."""
    y2 = (x * x * x + cv.b) % cv.p
    y = sqrt_mod(y2, cv.p)
    if y is None:
        return None
    if (y & 1) != odd:
        y = cv.p - y
    return (x, y)


# --- secp256k1 compressed serialization (33 bytes, eckey_pubkey format) ----

def secp_serialize_compressed(pt) -> bytes:
    """0x02/0x03 || X big-endian — matches secp256k1_eckey_pubkey_serialize
    with compressed=1 (reference Server.hpp:884-890 wire format)."""
    if pt is INF:
        raise ValueError("cannot serialize infinity as compressed point")
    x, y = pt
    return bytes([0x02 | (y & 1)]) + x.to_bytes(32, "big")


def secp_parse_compressed(data: bytes):
    assert len(data) == 33 and data[0] in (2, 3)
    pt = lift_x(SECP256K1, int.from_bytes(data[1:], "big"), data[0] & 1)
    if pt is None:
        raise ValueError("invalid compressed point")
    return pt


# --- gnark-crypto BN254 G1 marshal (64 bytes uncompressed) -----------------

def bn254_marshal(pt) -> bytes:
    """X||Y big-endian 32B each; infinity encodes as the gnark infinity mask
    (0b01000000 in the first byte, rest zero) — gnark v0.6 RawBytes format."""
    if pt is INF:
        return bytes([0x40]) + b"\x00" * 63
    x, y = pt
    return x.to_bytes(32, "big") + y.to_bytes(32, "big")


def bn254_unmarshal(data: bytes):
    assert len(data) == 64
    if data[0] & 0x40:
        return INF
    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:], "big")
    if x == 0 and y == 0:
        return INF
    return (x, y)
