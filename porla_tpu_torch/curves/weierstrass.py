"""Batched short-Weierstrass (a=0) elliptic-curve arithmetic on limb tensors.

Jacobian coordinates (X, Y, Z), each a (…, 16) int64 limb tensor in
Montgomery form; the point at infinity is Z == 0. The formulas are the
reference package's (`porla_tpu/curves/weierstrass.py`): dbl-2009-l and
add-2007-bl with branchless selects for the degenerate cases (infinity on
either side, P == Q, P == -Q), so a batch of points gives the same Jacobian
limbs here, in the reference and in the CUDA kernels of
`curves/cuda_curve.py`.

This is the plain torch curve layer: the arithmetic of every kernel's plain
version (the protocol's point adds on the CPU, through
`cuda_curve.point_add_plain`, included).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont
from porla_tpu_torch.fields.mont import Modulus
from porla_tpu_torch.golden import ecc


class JacPoint(NamedTuple):
    """Batched Jacobian point; limbs in Montgomery form."""
    x: torch.Tensor  # (…, 16) int64
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[:-1]

    @property
    def device(self):
        return self.x.device

    def to(self, device) -> "JacPoint":
        return JacPoint(*(c.to(device) for c in self))


def index(p: JacPoint, idx) -> JacPoint:
    return JacPoint(p.x[idx], p.y[idx], p.z[idx])


def cat(points, dim: int = 0) -> JacPoint:
    points = list(points)
    return JacPoint(torch.cat([p.x for p in points], dim),
                    torch.cat([p.y for p in points], dim),
                    torch.cat([p.z for p in points], dim))


def select(mask, a: JacPoint, b: JacPoint) -> JacPoint:
    m = mask.unsqueeze(-1)
    return JacPoint(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
                    torch.where(m, a.z, b.z))


class CurveOps:
    """Batched group operations for y^2 = x^3 + b over F_p."""

    def __init__(self, curve: ecc.Curve, name: str = ""):
        self.curve = curve
        self.fp = Modulus(curve.p, name + "_fp")
        self.order = Modulus(curve.n, name + "_order")

    # --- constructors ------------------------------------------------------

    def infinity(self, batch_shape=(), device="cpu") -> JacPoint:
        one = self.fp.const("r_limbs", device).expand(
            tuple(batch_shape) + (L.NLIMBS,)).clone()
        return JacPoint(one, one.clone(), L.zeros_t(batch_shape, device))

    def from_affine(self, points, device="cpu") -> JacPoint:
        """List of golden-model affine points (or INF) -> batched JacPoint."""
        xs, ys, zs = [], [], []
        for pt in points:
            if pt is ecc.INF:
                xs.append(1)
                ys.append(1)
                zs.append(0)
            else:
                xs.append(pt[0])
                ys.append(pt[1])
                zs.append(1)
        to_m = self.fp.to_mont_int
        return JacPoint(L.ints_to_tensor([to_m(v) for v in xs], device),
                        L.ints_to_tensor([to_m(v) for v in ys], device),
                        L.ints_to_tensor([to_m(v) for v in zs], device))

    def to_affine(self, pt: JacPoint):
        """Batched JacPoint -> list of golden-model affine points (host)."""
        xs = L.tensor_to_ints(pt.x)
        ys = L.tensor_to_ints(pt.y)
        zs = L.tensor_to_ints(pt.z)
        p = self.curve.p
        rinv = pow(self.fp.r, -1, p)
        out = []
        for x, y, z in zip(xs, ys, zs):
            x, y, z = (x * rinv) % p, (y * rinv) % p, (z * rinv) % p
            if z == 0:
                out.append(ecc.INF)
                continue
            zi = pow(z, -1, p)
            zi2 = zi * zi % p
            out.append((x * zi2 % p, y * zi2 * zi % p))
        return out

    # --- field helpers -----------------------------------------------------

    def _mul(self, a, b):
        return mont.mont_mul(a, b, self.fp)

    def _add(self, a, b):
        return mont.add_mod(a, b, self.fp)

    def _sub(self, a, b):
        return mont.sub_mod(a, b, self.fp)

    def _dbl_f(self, a):
        return mont.add_mod(a, a, self.fp)

    # --- group ops ---------------------------------------------------------

    def neg(self, p: JacPoint) -> JacPoint:
        return JacPoint(p.x, mont.neg_mod(p.y, self.fp), p.z)

    def double(self, p: JacPoint) -> JacPoint:
        """dbl-2009-l (a=0), independent multiplies stacked into one call.
        Maps infinity -> infinity and y=0 -> infinity (Z3 = 2YZ)."""
        X, Y, Z = p
        s1 = self._mul(torch.stack([X, Y]), torch.stack([X, Y]))
        A, B = s1[0], s1[1]
        xb = self._add(X, B)
        s2 = self._mul(torch.stack([B, xb, Y]), torch.stack([B, xb, Z]))
        C, xb2, YZ = s2[0], s2[1], s2[2]
        D = self._dbl_f(self._sub(self._sub(xb2, A), C))
        E = self._add(self._dbl_f(A), A)
        F = self._mul(E, E)
        X3 = self._sub(F, self._dbl_f(D))
        C8 = self._dbl_f(self._dbl_f(self._dbl_f(C)))
        Y3 = self._sub(self._mul(E, self._sub(D, X3)), C8)
        Z3 = self._dbl_f(YZ)
        return JacPoint(X3, Y3, Z3)

    def _add_terms(self, p1: JacPoint, p2: JacPoint):
        """add-2007-bl (12M + 4S) without case handling -> (raw sum,
        (U1, U2, S1, S2)), independent multiplies stacked into one call."""
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        s1 = self._mul(torch.stack([Z1, Z2, Y1, Y2]),
                       torch.stack([Z1, Z2, Z2, Z1]))
        Z1Z1, Z2Z2, A1, A2 = s1[0], s1[1], s1[2], s1[3]
        s2 = self._mul(torch.stack([X1, X2, A1, A2]),
                       torch.stack([Z2Z2, Z1Z1, Z2Z2, Z1Z1]))
        U1, U2, S1, S2 = s2[0], s2[1], s2[2], s2[3]
        H = self._sub(U2, U1)
        R = self._sub(S2, S1)
        s3 = self._mul(torch.stack([H, R, Z1]), torch.stack([H, R, Z2]))
        HH, RR, Z1Z2 = s3[0], s3[1], s3[2]
        s4 = self._mul(torch.stack([H, U1, Z1Z2]), torch.stack([HH, HH, H]))
        HHH, V, Z3 = s4[0], s4[1], s4[2]
        X3 = self._sub(self._sub(RR, HHH), self._dbl_f(V))
        s5 = self._mul(torch.stack([R, S1]),
                       torch.stack([self._sub(V, X3), HHH]))
        Y3 = self._sub(s5[0], s5[1])
        return JacPoint(X3, Y3, Z3), (U1, U2, S1, S2)

    def _madd_terms(self, p1: JacPoint, p2: JacPoint):
        """Mixed add (8M + 3S) without case handling: p2 is affine (Z2 = R,
        never read), so the products by Z2 collapse to identities."""
        X1, Y1, Z1 = p1
        X2, Y2 = p2.x, p2.y
        Z1Z1 = self._mul(Z1, Z1)
        s1 = self._mul(torch.stack([Y2, X2]), torch.stack([Z1, Z1Z1]))
        A2, U2 = s1[0], s1[1]
        S2 = self._mul(A2, Z1Z1)
        U1, S1 = X1, Y1
        H = self._sub(U2, U1)
        R = self._sub(S2, S1)
        s2 = self._mul(torch.stack([H, R]), torch.stack([H, R]))
        HH, RR = s2[0], s2[1]
        s3 = self._mul(torch.stack([H, U1, Z1]), torch.stack([HH, HH, H]))
        HHH, V, Z3 = s3[0], s3[1], s3[2]
        X3 = self._sub(self._sub(RR, HHH), self._dbl_f(V))
        s4 = self._mul(torch.stack([R, S1]),
                       torch.stack([self._sub(V, X3), HHH]))
        Y3 = self._sub(s4[0], s4[1])
        return JacPoint(X3, Y3, Z3), (U1, U2, S1, S2)

    def add_raw(self, p1: JacPoint, p2: JacPoint) -> JacPoint:
        """Raw Jacobian addition for the bucket kernels. The caller
        guarantees that neither operand is infinity and that P != +-Q
        (blinded buckets); any such lane gives a wrong point."""
        return self._add_terms(*_broadcast(p1, p2))[0]

    def madd_raw(self, p1: JacPoint, p2: JacPoint) -> JacPoint:
        """Raw mixed addition, p2 affine; same contract as `add_raw`."""
        return self._madd_terms(*_broadcast(p1, p2))[0]

    def add(self, p1: JacPoint, p2: JacPoint) -> JacPoint:
        """General Jacobian addition (add-2007-bl) with branchless handling
        of infinity / doubling / inverse-pair cases."""
        p1, p2 = _broadcast(p1, p2)
        raw, terms = self._add_terms(p1, p2)
        return self._cases(raw, p1, p2, *terms)

    def madd(self, p1: JacPoint, p2: JacPoint) -> JacPoint:
        """Mixed add: p2 is affine-or-infinity (Z2 in {0, R}) — 11 field
        muls instead of 16, same branchless case handling as `add` (the
        Pallas `_p_madd`)."""
        p1, p2 = _broadcast(p1, p2)
        raw, terms = self._madd_terms(p1, p2)
        return self._cases(raw, p1, p2, *terms)

    def _cases(self, raw, p1, p2, U1, U2, S1, S2) -> JacPoint:
        """Resolve the degenerate cases of an addition with selects: the
        doubling where P == Q, infinity where P == -Q, the other operand
        where one is infinity. On the CPU the doubling is skipped when no
        lane needs it (same output; CUDA tensors never sync on the host)."""
        p1_inf = mont.is_zero(p1.z)
        p2_inf = mont.is_zero(p2.z)
        h_zero = mont.eq(U1, U2)
        r_zero = mont.eq(S1, S2)
        both = ~p1_inf & ~p2_inf
        dbl_case = both & h_zero & r_zero
        inf_case = both & h_zero & ~r_zero
        out = raw
        if p1.x.is_cuda or bool(dbl_case.any()):
            out = select(dbl_case, self.double(p1), raw)
        out = select(inf_case, self.infinity(out.batch_shape, out.device), out)
        out = select(p2_inf, p1, out)
        return select(p1_inf, p2, out)

    def table16(self, p: JacPoint) -> JacPoint:
        """T[d] = d*P for d in 0..15, stacked on a new leading axis."""
        table = [self.infinity(p.batch_shape, p.device), p]
        for d in range(2, 16):
            if d % 2 == 0:
                table.append(self.double(table[d // 2]))
            else:
                table.append(self.add(table[d - 1], p))
        return JacPoint(*(torch.stack([t[c] for t in table]) for c in range(3)))

    def scalar_mul(self, p: JacPoint, scalars, nbits: int = 256) -> JacPoint:
        """Batched windowed (4-bit, MSB-first) double-and-add over the
        leading axis; scalars (B, 16) standard-form limbs, the low `nbits`
        bits used (values >= the group order wrap in the group)."""
        assert nbits % 4 == 0
        tbl = self.table16(p)
        acc = self.infinity(p.batch_shape, p.device)
        for w in reversed(range(nbits // 4)):
            digit = (scalars[..., w // 4] >> (4 * (w % 4))) & 0xF
            for _ in range(4):
                acc = self.double(acc)
            acc = self.add(acc, lookup(tbl, digit))
        return acc

    def tree_sum(self, p: JacPoint) -> JacPoint:
        """Point-add reduction over the leading axis (log depth) -> (1, …)."""
        n = p.x.shape[0]
        while n > 1:
            half = n // 2
            s = self.add(index(p, slice(0, half)), index(p, slice(half, 2 * half)))
            if n % 2:  # carry the odd element forward
                p = cat([s, index(p, slice(2 * half, n))])
                n = half + 1
            else:
                p = s
                n = half
        return index(p, slice(0, 1))


def _broadcast(p1: JacPoint, p2: JacPoint):
    c = torch.broadcast_tensors(*p1, *p2)
    return JacPoint(*c[:3]), JacPoint(*c[3:])


def lookup(tbl: JacPoint, digit) -> JacPoint:
    """Per-lane table select: tbl (16, B…, 16), digit (B…,) -> (B…, 16)."""
    idx = digit.unsqueeze(0).unsqueeze(-1).expand((1,) + tuple(digit.shape) + (L.NLIMBS,))
    return JacPoint(*(torch.gather(c, 0, idx)[0] for c in tbl))

