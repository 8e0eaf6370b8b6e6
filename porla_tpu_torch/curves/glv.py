"""GLV endomorphism scalar decomposition (host side, exact).

Both protocol curves have j-invariant 0, so they carry the cube-root
endomorphism phi(x, y) = (beta*x, y) with phi(P) = lambda*P: a 256-bit
scalar k splits as k = k1 + lambda*k2 with |k1|, |k2| ~ 2^128, halving
the doubling chain of every variable-base scalar mul (the reference's
secp256k1 build uses the same trick: USE_ENDOMORPHISM / GLV split in
ecmult_impl.h:620-634, scalar lambda split in scalar_impl.h).

Parameters are DERIVED, not hard-coded: lambda from the roots of
x^2 + x + 1 mod n, beta from the cube roots of 1 mod p, matched by
checking lambda*G == (beta*Gx, Gy) on the golden model; the short
lattice basis by the extended-Euclid descent (the standard GLV
construction). Everything is asserted at build time, and decompose()
re-asserts k1 + lambda*k2 == k mod n per batch.
"""

from __future__ import annotations

from functools import lru_cache

from porla_tpu_torch.golden import ecc


def _sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli-Shanks (p odd prime). None if a is a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general case
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def _cube_roots_of_unity(p: int) -> list[int]:
    """Nontrivial roots of x^2 + x + 1 mod p: (-1 ± sqrt(-3)) / 2."""
    s = _sqrt_mod(p - 3, p)
    assert s is not None, "p = 1 mod 3 required for the endomorphism"
    inv2 = pow(2, -1, p)
    return [((-1 + s) * inv2) % p, ((-1 - s) * inv2) % p]


def _short_basis(n: int, lam: int):
    """Extended-Euclid descent on (n, lam): rows (r, t) with
    r = t*lam mod n. The classic GLV construction: v1 = (r_l, -t_l) at
    the first index l where r_l < sqrt(n); v2 = the SHORTER (max-norm) of
    rows l-1 and l+1 — not merely the next short row, so the
    decomposition bound below is guaranteed, not incidental (advisor r1
    finding)."""
    seq = []  # (r, t) rows of the descent
    r0, r1 = n, lam
    t0, t1 = 0, 1
    lim = 1
    while lim * lim < n:
        lim <<= 1
    while r1:
        seq.append((r1, t1))
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        t0, t1 = t1, t0 - q * t1
        if len(seq) >= 2 and seq[-2][0] < lim:
            break
    # l = first index with r < sqrt(n); candidates are rows l-1 and l+1
    l = next(i for i, (r, _) in enumerate(seq) if r < lim)
    v1 = (seq[l][0], -seq[l][1])
    cands = [seq[l - 1]] if l > 0 else []
    if l + 1 < len(seq):
        cands.append(seq[l + 1])
    rC, tC = min(cands, key=lambda rt: max(abs(rt[0]), abs(rt[1])))
    # v_i = (a_i, b_i) with a_i + b_i*lam = 0 mod n
    return v1, (rC, -tC)


class GlvParams:
    def __init__(self, lam, beta, v1, v2, n):
        self.lam = lam
        self.beta = beta
        self.v1 = v1
        self.v2 = v2
        self.n = n


@lru_cache(maxsize=None)
def params_for(curve) -> GlvParams:
    """Derive and verify (lambda, beta, short basis) for an ecc curve."""
    n, p, g = curve.n, curve.p, curve.g
    lams = _cube_roots_of_unity(n)
    betas = _cube_roots_of_unity(p)
    for lam in lams:
        lg = ecc.mul(curve, g, lam)
        for beta in betas:
            if lg == ((beta * g[0]) % p, g[1]):
                v1, v2 = _short_basis(n, lam)
                for (a, b) in (v1, v2):
                    assert (a + b * lam) % n == 0
                # decompose() rounds the lattice coordinates, so
                # |k1| <= (|a1|+|a2|)/2 and |k2| <= (|b1|+|b2|)/2; the
                # 128-bit limit the 32-window kernels rely on is
                # therefore ESTABLISHED HERE once, for any curve —
                # not re-checked per batch as a crash-only guard
                (a1, b1), (a2, b2) = v1, v2
                assert abs(a1) + abs(a2) < (1 << 129), (v1, v2)
                assert abs(b1) + abs(b2) < (1 << 129), (v1, v2)
                return GlvParams(lam, beta, v1, v2, n)
    raise AssertionError("no (lambda, beta) pair matched the endomorphism")


def decompose(k: int, gp: GlvParams):
    """k -> (|k1|, sign1, |k2|, sign2) with k1 + lam*k2 = k mod n and
    |ki| < 2^128 (for our 256-bit curves)."""
    n = gp.n
    k %= n
    (a1, b1), (a2, b2) = gp.v1, gp.v2
    det = a1 * b2 - a2 * b1
    # round(k*b2/det), round(-k*b1/det) — det may be negative
    def rdiv(num, den):
        if den < 0:
            num, den = -num, -den
        return (2 * num + den) // (2 * den)
    c1 = rdiv(k * b2, det)
    c2 = rdiv(-k * b1, det)
    k1 = k - c1 * a1 - c2 * a2
    k2 = -c1 * b1 - c2 * b2
    assert (k1 + gp.lam * k2 - k) % n == 0
    assert abs(k1) < 1 << 128 and abs(k2) < 1 << 128, (k, k1, k2)
    return abs(k1), 1 if k1 < 0 else 0, abs(k2), 1 if k2 < 0 else 0
