"""Exact elliptic-curve arithmetic in Python integers.

Short-Weierstrass curves y^2 = x^3 + b (a = 0) over prime fields:
affine points as (x, y) tuples, None for the point at infinity; Jacobian
triples (X, Y, Z), Z = 0 for infinity, inside the sums. `msm` is a
bucket (Pippenger) multi-scalar multiplication, so that the sums the
check needs, over thousands of points, take seconds and not minutes.
"""

from __future__ import annotations

from dataclasses import dataclass

INF = None
_JINF = (1, 1, 0)


@dataclass(frozen=True)
class Curve:
    p: int      # base field prime
    b: int      # curve constant
    n: int      # group order
    g: tuple    # generator, affine


SECP256K1 = Curve(
    p=2**256 - 2**32 - 977, b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    g=(0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
       0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8))
BN254 = Curve(
    p=0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    b=3,
    n=0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
    g=(1, 2))


def is_on_curve(cv: Curve, pt) -> bool:
    if pt is INF:
        return True
    x, y = pt
    return 0 <= x < cv.p and 0 <= y < cv.p and \
        (y * y - x * x * x - cv.b) % cv.p == 0


def _dbl(P, p):
    X, Y, Z = P
    if Z == 0 or Y == 0:
        return _JINF
    A = X * X % p
    B = Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    return X3, (E * (D - X3) - 8 * C) % p, 2 * Y * Z % p


def _add(P1, P2, p):
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2
    if Z1 == 0:
        return P2
    if Z2 == 0:
        return P1
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 * Z2Z2 % p
    S2 = Y2 * Z1 * Z1Z1 % p
    H = (U2 - U1) % p
    r = (S2 - S1) % p
    if H == 0:
        return _dbl(P1, p) if r == 0 else _JINF
    HH = H * H % p
    HHH = H * HH % p
    V = U1 * HH % p
    X3 = (r * r - HHH - 2 * V) % p
    return X3, (r * (V - X3) - S1 * HHH) % p, Z1 * Z2 * H % p


def _madd(P1, ax, ay, p):
    X, Y, Z = P1
    if Z == 0:
        return ax, ay, 1
    ZZ = Z * Z % p
    H = (ax * ZZ - X) % p
    r = (ay * Z * ZZ - Y) % p
    if H == 0:
        return _dbl(P1, p) if r == 0 else _JINF
    HH = H * H % p
    HHH = H * HH % p
    V = X * HH % p
    X3 = (r * r - HHH - 2 * V) % p
    return X3, (r * (V - X3) - Y * HHH) % p, Z * H % p


def to_affine(cv: Curve, P):
    X, Y, Z = P
    if Z % cv.p == 0:
        return INF
    zi = pow(Z, -1, cv.p)
    zi2 = zi * zi % cv.p
    return X * zi2 % cv.p, Y * zi2 * zi % cv.p


def batch_to_affine(cv: Curve, jac) -> list:
    """Jacobian triples -> affine points with one inversion (Montgomery's
    trick); a triple with Z = 0 gives infinity."""
    p = cv.p
    zs = [Z % p for _, _, Z in jac]
    pref = []
    acc = 1
    for z in zs:
        pref.append(acc)
        if z:
            acc = acc * z % p
    inv = pow(acc, -1, p)
    out = [INF] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        z = zs[i]
        if not z:
            continue
        zi = inv * pref[i] % p
        inv = inv * z % p
        X, Y, _ = jac[i]
        zi2 = zi * zi % p
        out[i] = (X * zi2 % p, Y * zi2 * zi % p)
    return out


def add(cv: Curve, p1, p2):
    if p1 is INF:
        return p2
    if p2 is INF:
        return p1
    return to_affine(cv, _madd((p1[0], p1[1], 1), p2[0], p2[1], cv.p))


def mul(cv: Curve, pt, k: int):
    """k * pt, MSB-first double-and-add."""
    k %= cv.n
    if pt is INF or k == 0:
        return INF
    p = cv.p
    ax, ay = pt
    R = (ax, ay, 1)
    for bit in bin(k)[3:]:
        R = _dbl(R, p)
        if bit == "1":
            R = _madd(R, ax, ay, p)
    return to_affine(cv, R)


def msm(cv: Curve, points, scalars):
    """sum_i scalars[i] * points[i] (affine points, infinity allowed; any
    integer scalars, reduced mod the group order)."""
    p = cv.p
    pairs = [(pt, s % cv.n) for pt, s in zip(points, scalars)
             if pt is not INF and s % cv.n]
    if not pairs:
        return INF
    bits = max(s for _, s in pairs).bit_length()
    n = len(pairs)
    c = 4 if n < 32 else max(4, n.bit_length() - 3)
    mask = (1 << c) - 1
    acc = _JINF
    for w in range((bits + c - 1) // c - 1, -1, -1):
        for _ in range(c):
            acc = _dbl(acc, p)
        buckets = [None] * (mask + 1)
        sh = w * c
        for (ax, ay), s in pairs:
            d = (s >> sh) & mask
            if d:
                b = buckets[d]
                buckets[d] = (ax, ay, 1) if b is None else _madd(b, ax, ay, p)
        run = tot = _JINF
        for d in range(mask, 0, -1):
            if buckets[d] is not None:
                run = _add(run, buckets[d], p)
            tot = _add(tot, run, p)
        acc = _add(acc, tot, p)
    return to_affine(cv, acc)


def sqrt_mod(a: int, p: int):
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a % p else None


def lift_x(cv: Curve, x: int, odd: int):
    y = sqrt_mod((x * x * x + cv.b) % cv.p, cv.p)
    if y is None:
        return None
    return (x, y if (y & 1) == odd else cv.p - y)


def secp_compressed(pt) -> bytes:
    """0x02 | parity, then X big-endian (secp256k1_eckey_pubkey_serialize)."""
    if pt is INF:
        raise ValueError("infinity has no compressed form")
    return bytes([0x02 | (pt[1] & 1)]) + pt[0].to_bytes(32, "big")


def bn254_marshal(pt) -> bytes:
    """X || Y big-endian; infinity as gnark's mask byte 0x40."""
    if pt is INF:
        return bytes([0x40]) + b"\x00" * 63
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
