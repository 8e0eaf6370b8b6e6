"""BN254 (alt_bn128) optimal-ate pairing — exact host implementation.

Used by the KZG scheme's verifier (the one piece the reference delegates
entirely to gnark-crypto, porla/main.go:177-193). Pairings run once or
twice per audit verification — control-plane work, so a clear exact
Python implementation is the right tool; the bulk KZG math (the SRS
commitments) runs on the card through porla_tpu_torch.curves.

A copy of the reference package's `porla_tpu/golden/bn254_pairing.py`
(the port imports nothing of that package); the arithmetic is the same
line for line, so both give the same group and Fp12 elements.

Tower: Fp12 = Fp[w]/(w^12 - 18 w^6 + 82), with Fp2 = Fp[u]/(u^2+1)
embedded via u -> w^6 - 9 (xi = 9 + u is the twist factor). G2 points on
the twist are untwisted into E(Fp12) by (x, y) -> (x / w^2, y / w^3).
"""

from __future__ import annotations

from porla_tpu_torch.fields.constants import BN254_P as P
from porla_tpu_torch.fields.constants import BN254_R as R
from porla_tpu_torch.fields.constants import BN254_X

ATE_LOOP_COUNT = 6 * BN254_X + 2

# --- Fp2 -------------------------------------------------------------------

def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def fp2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return ((a[0] * d) % P, (-a[1] * d) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


# standard generators
G1 = (1, 2)
G2 = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


# --- G2 affine arithmetic (over Fp2) ---------------------------------------

def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_add(y1, y2) == (0, 0):
            return None
        lam = fp2_mul(fp2_mul((3, 0), fp2_mul(x1, x1)),
                      fp2_inv(fp2_add(y1, y1)))
    else:
        lam = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_mul(lam, lam), x1), x2)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt, k):
    acc = None
    add = pt
    k %= R
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fp2_neg(pt[1]))


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    b2 = fp2_mul((3, 0), fp2_inv((9, 1)))  # 3/xi
    return fp2_sub(fp2_mul(y, y),
                   fp2_add(fp2_mul(x, fp2_mul(x, x)), b2)) == (0, 0)


# --- Fp12 (dense polynomial basis, coefficients low-to-high) ---------------

FP12_ONE = (1,) + (0,) * 11
FP12_ZERO = (0,) * 12


def fp12_mul(a, b):
    t = [0] * 23
    for i in range(12):
        ai = a[i]
        if ai:
            for j in range(12):
                t[i + j] += ai * b[j]
    for k in range(22, 11, -1):
        v = t[k]
        if v:
            t[k] = 0
            t[k - 6] += v * 18          # w^12 = 18 w^6 - 82
            t[k - 12] -= v * 82
    return tuple(x % P for x in t[:12])


def fp12_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def fp12_scalar(a, s):
    return tuple((x * s) % P for x in a)


def fp12_pow(a, e):
    out = FP12_ONE
    base = a
    while e:
        if e & 1:
            out = fp12_mul(out, base)
        base = fp12_mul(base, base)
        e >>= 1
    return out


def _poly_deg(p):
    for i in range(len(p) - 1, -1, -1):
        if p[i]:
            return i
    return 0


def fp12_inv(a):
    """Inverse via extended Euclid over Fp[w] against the tower modulus."""
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(a) + [0]
    high = [82 % P, 0, 0, 0, 0, 0, (-18) % P, 0, 0, 0, 0, 0, 1]
    while _poly_deg(low):
        dl = _poly_deg(low)
        dh = _poly_deg(high)
        linv = pow(low[dl], P - 2, P)
        q = [0] * 13
        rem = list(high)
        for i in range(dh - dl, -1, -1):
            c = (rem[dl + i] * linv) % P
            q[i] = c
            if c:
                for j in range(dl + 1):
                    rem[j + i] = (rem[j + i] - c * low[j]) % P
        nm = list(hm)
        for i in range(13):
            if q[i]:
                for j in range(13 - i):
                    nm[i + j] = (nm[i + j] - q[i] * lm[j]) % P
        lm, low, hm, high = nm, rem, lm, low
    c = pow(low[0], P - 2, P)
    return tuple((x * c) % P for x in lm[:12])


# --- embedding and untwisting ----------------------------------------------

def fp2_to_fp12(a):
    """a0 + a1*u with u = w^6 - 9: -> polynomial in w."""
    out = [0] * 12
    out[0] = (a[0] - 9 * a[1]) % P
    out[6] = a[1] % P
    return tuple(out)


# w^2 and w^3 as Fp12 elements
_W2 = tuple(1 if i == 2 else 0 for i in range(12))
_W3 = tuple(1 if i == 3 else 0 for i in range(12))


def untwist(pt):
    """G2 (Fp2) -> E(Fp12): (x, y) -> (x * w^2, y * w^3).

    With xi = 9+u = w^6 this maps the twist y^2 = x^3 + 3/xi onto
    y^2 = x^3 + 3 ... up to the consistent factor convention; bilinearity
    and non-degeneracy (all that KZG verification needs) are test-checked.
    """
    x, y = pt
    return (fp12_mul(fp2_to_fp12(x), _W2), fp12_mul(fp2_to_fp12(y), _W3))


# --- Miller loop -----------------------------------------------------------

def _line(p1, p2, t):
    """Evaluate the line through p1, p2 (E(Fp12) affine) at t = (x, y)
    with x, y in Fp (a G1 point), returning an Fp12 value."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        num = fp12_sub(y2, y1)
        den = fp12_sub(x2, x1)
    elif y1 == y2:
        num = fp12_scalar(fp12_mul(x1, x1), 3)
        den = fp12_scalar(y1, 2)
    else:
        # vertical line
        xt12 = (xt % P,) + (0,) * 11
        return fp12_sub(xt12, x1)
    lam = fp12_mul(num, fp12_inv(den))
    xt12 = (xt % P,) + (0,) * 11
    yt12 = (yt % P,) + (0,) * 11
    return fp12_sub(fp12_sub(yt12, y1),
                    fp12_mul(lam, fp12_sub(xt12, x1)))


def _e12_add(p1, p2):
    """Affine addition on E(Fp12)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2:
            return None  # P + (-P)
        lam = fp12_mul(fp12_scalar(fp12_mul(x1, x1), 3),
                       fp12_inv(fp12_scalar(y1, 2)))
    else:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_mul(lam, lam), x1), x2)
    y3 = fp12_sub(fp12_mul(lam, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _frobenius_pt(pt):
    """(x, y) -> (x^p, y^p) coordinate-wise in Fp12."""
    return (fp12_pow(pt[0], P), fp12_pow(pt[1], P))


def miller_loop(q, p):
    """Optimal ate Miller loop: q in E(Fp12) (untwisted G2), p in G1."""
    if q is None or p is None:
        return FP12_ONE
    r_pt = q
    f = FP12_ONE
    for b in bin(ATE_LOOP_COUNT)[3:]:
        f = fp12_mul(fp12_mul(f, f), _line(r_pt, r_pt, p))
        r_pt = _e12_add(r_pt, r_pt)
        if b == "1":
            f = fp12_mul(f, _line(r_pt, q, p))
            r_pt = _e12_add(r_pt, q)
    q1 = _frobenius_pt(q)
    nq2 = _frobenius_pt(q1)
    nq2 = (nq2[0], fp12_sub(FP12_ZERO, nq2[1]))
    f = fp12_mul(f, _line(r_pt, q1, p))
    r_pt = _e12_add(r_pt, q1)
    f = fp12_mul(f, _line(r_pt, nq2, p))
    return f


_FINAL_EXP = (P ** 12 - 1) // R


def pairing(q2, p1):
    """e(P1 in G1, Q2 in G2) -> Fp12 element of order r (or 1)."""
    if q2 is None or p1 is None:
        return FP12_ONE
    f = miller_loop(untwist(q2), p1)
    return fp12_pow(f, _FINAL_EXP)


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for [(P1 point, G2 point), …]."""
    acc = FP12_ONE
    for p1, q2 in pairs:
        if p1 is None or q2 is None:
            continue
        acc = fp12_mul(acc, miller_loop(untwist(q2), p1))
    return fp12_pow(acc, _FINAL_EXP) == FP12_ONE
