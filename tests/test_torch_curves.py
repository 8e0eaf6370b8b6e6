"""Plain versions of K2 (scalar_mul, windowed and GLV), K3
(point_butterfly) and K4 (fb_scalar_mul, fb_msm_groups) vs the reference
package's CurveOps(numpy), its fixed-base tables and the exact golden
model. Edge lanes: zero scalar, infinity input, a doubling (P == Q) lane
and P == -Q in K3's adds. Points compare as affine points; where the
reference computes the same formulas (windowed mode, point adds) the
Jacobian limbs must match too. Tolerance: zero."""

import random

import numpy as np
import pytest
import torch

from porla_tpu.curves import pallas_curve
from porla_tpu.curves.instances import secp256k1 as jsecp
from porla_tpu.fields import limbs as JL
from porla_tpu.golden import ecc
from porla_tpu_torch import native
from porla_tpu_torch.curves import cuda_curve as cc
from porla_tpu_torch.curves import kernels
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.golden import ecc as port_ecc

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

CUR = ecc.SECP256K1
rng = random.Random(2024)


def _pts(k):
    return [ecc.mul(CUR, CUR.g, rng.randrange(1, CUR.n)) for _ in range(k)]


def _np(p):
    return tuple(L.to_numpy(c) for c in p)


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


def test_point_ops_bit_exact_vs_reference():
    ops, jops = secp256k1(), jsecp()
    base = _pts(5)
    a = base + [ecc.INF, base[0], base[1], ecc.INF, base[2]]
    b = base[::-1] + [base[0], ecc.INF, base[1], ecc.INF, ecc.neg(CUR, base[2])]
    ta, tb = ops.from_affine(a), ops.from_affine(b)
    ja, jb = jops.from_affine(np, a), jops.from_affine(np, b)
    for got, want in ((ops.add(ta, tb), jops.add(np, ja, jb)),
                      (ops.double(ta), jops.double(np, ja)),
                      (ops.neg(ta), jops.neg(np, ja))):
        assert all(np.array_equal(g, w) for g, w in zip(_np(got), want))
    assert ops.to_affine(ops.add(ta, tb)) == \
        [ecc.add(CUR, x, y) for x, y in zip(a, b)]
    # mixed add (K4's point op) agrees with the full add on affine inputs
    assert ops.to_affine(ops.madd(ta, tb)) == ops.to_affine(ops.add(ta, tb))


def test_scalar_mul_window_vs_reference():
    ops, jops = secp256k1(), jsecp()
    pts = _pts(5) + [ecc.INF, CUR.g, CUR.g]
    sc = [rng.getrandbits(32) for _ in range(5)] + [7, 0, 1]
    p, s = ops.from_affine(pts), L.ints_to_tensor(sc)
    got = cc.scalar_mul(ops, p, s, nbits=32)
    want = jops.scalar_mul(np, jops.from_affine(np, pts),
                           JL.ints_to_limbs(sc), 32)
    assert all(np.array_equal(g, w) for g, w in zip(_np(got), want))
    assert ops.to_affine(got) == [ecc.mul(CUR, q, k) for q, k in zip(pts, sc)]


def test_scalar_mul_glv_vs_golden():
    ops = secp256k1()
    pts = _pts(5) + [ecc.INF, CUR.g, CUR.g, CUR.g]
    sc = [rng.randrange(CUR.n) for _ in range(5)] + [12345, 0, CUR.n - 1,
                                                      (1 << 256) - 1]
    got = cc.scalar_mul(ops, ops.from_affine(pts), L.ints_to_tensor(sc), 256)
    assert ops.to_affine(got) == [ecc.mul(CUR, q, k) for q, k in zip(pts, sc)]


def test_point_butterfly_vs_golden():
    ops = secp256k1()
    m1 = _pts(4) + [CUR.g, CUR.g, ecc.INF, CUR.g]
    m0 = _pts(4) + [ecc.INF, CUR.g, CUR.g, CUR.g]
    # lane 5: m0 + 1*m1 doubles; lane 7: s = n-1 -> m0 - s*m1 doubles and
    # m0 + s*m1 is P + (-P)
    sc = [rng.randrange(CUR.n) for _ in range(4)] + [5, 1, 9, CUR.n - 1]
    hi, lo = cc.point_butterfly(ops, ops.from_affine(m0), ops.from_affine(m1),
                                L.ints_to_tensor(sc))
    prods = [ecc.mul(CUR, q, k) for q, k in zip(m1, sc)]
    assert ops.to_affine(hi) == [ecc.add(CUR, a, t) for a, t in zip(m0, prods)]
    assert ops.to_affine(lo) == [ecc.add(CUR, a, ecc.neg(CUR, t))
                                 for a, t in zip(m0, prods)]
    assert ops.to_affine(hi)[7] is ecc.INF
    with pytest.raises(ValueError):          # not a multiple of 4
        cc.point_butterfly(ops, ops.from_affine(m0), ops.from_affine(m1),
                           L.ints_to_tensor(sc), nbits=130)


def test_fixed_base_table_matches_reference():
    ops = secp256k1()
    gens = _pts(3) + [CUR.g]
    mine = cc.build_fb_table(ops, gens, nbits=32)
    ref = pallas_curve.build_fb_table(jsecp(), gens, nbits=32, bt=128)
    from porla_tpu.ntt import mxu
    for c_mine, c_ref in zip(mine.coords, (ref.tx, ref.ty, ref.tz)):
        lim = mxu.limbs_from_digits(np, np.moveaxis(c_ref, 2, 3))
        assert np.array_equal(L.to_numpy(c_mine), lim)


def test_fb_scalar_mul_vs_golden():
    ops = secp256k1()
    gens = _pts(3) + [CUR.g]
    tbl = cc.build_fb_table(ops, gens, nbits=32)
    sc = [rng.getrandbits(32) for _ in range(9)] + [0, 1, 0xFFFFFFFF]
    got = cc.fb_scalar_mul(tbl, L.ints_to_tensor(sc))
    assert ops.to_affine(got) == [ecc.mul(CUR, gens[i % 4], k)
                                  for i, k in enumerate(sc)]


def test_fb_msm_groups_vs_golden():
    ops = secp256k1()
    gens = _pts(3) + [CUR.g]
    tbl = cc.build_fb_table(ops, gens, nbits=32)
    sc = [rng.getrandbits(32) for _ in range(16)]
    sc[3] = 0
    got = ops.to_affine(cc.fb_msm_groups(tbl, L.ints_to_tensor(sc), nout=2))
    for g in range(2):
        want = ecc.msm(CUR, [gens[i % 4] for i in range(8 * g, 8 * g + 8)],
                       sc[8 * g:8 * g + 8])
        assert got[g] == want
    with pytest.raises(AssertionError):      # non-pow2 group width
        cc.fb_msm_groups(tbl, L.ints_to_tensor(sc[:12]), nout=2)


def test_msm_dispatch_vs_golden():
    ops = secp256k1()
    pts = _pts(6) + [ecc.INF, CUR.g]
    sc = [rng.getrandbits(32) for _ in range(8)]
    out = kernels.msm(ops, ops.from_affine(pts), L.ints_to_tensor(sc), 32)
    assert ops.to_affine(out)[0] == ecc.msm(CUR, pts, sc)
    halves = kernels.msm_parts(ops, ops.from_affine(pts),
                               L.ints_to_tensor(sc), 2, 32)
    assert [ops.to_affine(h)[0] for h in halves] == \
        [ecc.msm(CUR, pts[:4], sc[:4]), ecc.msm(CUR, pts[4:], sc[4:])]


def test_wrappers_reject_other_devices():
    ops = secp256k1()
    p = ops.from_affine([CUR.g, CUR.g])
    meta = type(p)(*(c.to("meta") for c in p))
    with pytest.raises(ValueError):
        cc.scalar_mul(ops, meta, torch.zeros((2, 16), dtype=torch.int64,
                                             device="meta"), 32)
    with pytest.raises(ValueError):
        cc.scalar_mul(ops, p, torch.zeros((3, 16), dtype=torch.int64), 32)


@pytest.mark.parametrize("cv", [ecc.SECP256K1, ecc.BN254],
                         ids=["secp256k1", "bn254"])
def test_golden_mul_matches_reference(cv):
    """The port's golden scalar mul (Jacobian, one inversion) gives the
    reference golden model's affine points, edge scalars included."""
    r = random.Random(7)
    p = ecc.mul(cv, cv.g, r.randrange(1, cv.n))
    for k in [r.randrange(cv.n) for _ in range(6)] + [0, 1, 2, 3, cv.n - 1,
                                                      cv.n, cv.n + 5]:
        assert port_ecc.mul(cv, p, k) == ecc.mul(cv, p, k)
    assert port_ecc.mul(cv, ecc.INF, 5) is ecc.INF


def test_passed_in_glv_split():
    """A GLV split made once (as chip_smoke.py does to time the kernels
    alone) gives, through the plain GLV bodies, the wrappers' outputs."""
    ops = secp256k1()
    p = ops.from_affine(_pts(3) + [ecc.INF])
    sc = L.ints_to_tensor([rng.randrange(CUR.n) for _ in range(4)])
    g = cc.GlvScalars(ops, sc)
    a = cc.glv_scalar_mul_plain(ops, p, g)
    b = cc.scalar_mul(ops, p, sc, 256)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    hi, lo = cc.glv_butterfly_plain(ops, p, p, g)
    whi, wlo = cc.point_butterfly(ops, p, p, sc)
    assert all(torch.equal(x, y) for x, y in zip(hi + lo, whi + wlo))
    assert ops.to_affine(hi) == ops.to_affine(ops.add(p, b))
