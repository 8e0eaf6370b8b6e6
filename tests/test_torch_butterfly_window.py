"""K7 `point_butterfly_window` on the CPU: `cuda_curve.point_butterfly` at
scalar widths other than 256 bits runs the windowed plain version, held
against the golden model, against `ops.scalar_mul` plus two adds, and
against the reference package (its numpy CurveOps bit for bit; its Pallas
kernel in interpret mode in the slow tier). Tolerance: zero. Inputs from a
`random.Random` seed, shaped like tests/test_pallas_curve.py's butterfly
test: an infinity m0, the generator as m1, a zero scalar and a small one."""

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
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.fields import limbs as L

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

CUR = ecc.SECP256K1


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


def _inputs(nbits, k=6, seed=5):
    rng = random.Random(seed)
    pts = lambda m: [ecc.mul(CUR, CUR.g, rng.randrange(1, CUR.n))
                     for _ in range(m)]
    m0 = pts(k - 1) + [ecc.INF]
    m1 = pts(k - 1) + [CUR.g]
    sc = [rng.getrandbits(nbits) for _ in range(k - 2)] + [0, 3]
    return m0, m1, sc


def _golden(m0, m1, sc):
    t = [ecc.mul(CUR, b, s) for b, s in zip(m1, sc)]
    return ([ecc.add(CUR, a, x) for a, x in zip(m0, t)],
            [ecc.add(CUR, a, ecc.neg(CUR, x)) for a, x in zip(m0, t)])


@pytest.mark.parametrize("nbits", [4, 32, 64, 128, 252])
def test_window_butterfly_vs_golden(nbits):
    ops = secp256k1()
    m0, m1, sc = _inputs(nbits)
    M0, M1, S = ops.from_affine(m0), ops.from_affine(m1), L.ints_to_tensor(sc)
    before = native.launches()
    hi, lo = cc.point_butterfly(ops, M0, M1, S, nbits=nbits)
    assert native.launches() == before       # the CPU launches nothing
    want_hi, want_lo = _golden(m0, m1, sc)
    assert ops.to_affine(hi) == want_hi and ops.to_affine(lo) == want_lo
    t = ops.scalar_mul(M1, S, nbits)
    for got, want in ((hi, ops.add(M0, t)), (lo, ops.add(M0, ops.neg(t)))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_window_butterfly_edge_lanes():
    """m0 = s*m1 (the + add doubles, the - add gives infinity), m0 = -s*m1,
    infinity on either side, and a scalar that uses only the low nbits."""
    ops = secp256k1()
    nbits = 32
    m0, m1, sc = _inputs(nbits, k=8)
    m0[0] = ecc.mul(CUR, m1[0], sc[0])
    m0[1] = ecc.neg(CUR, ecc.mul(CUR, m1[1], sc[1]))
    m1[2] = ecc.INF
    high = sc[3] | (0xABCD << 40)            # bits above nbits are ignored
    S = L.ints_to_tensor(sc[:3] + [high] + sc[4:])
    hi, lo = cc.point_butterfly(ops, ops.from_affine(m0), ops.from_affine(m1),
                                S, nbits=nbits)
    want_hi, want_lo = _golden(m0, m1, sc)
    assert ops.to_affine(hi) == want_hi and ops.to_affine(lo) == want_lo
    assert ops.to_affine(lo)[0] is ecc.INF and ops.to_affine(hi)[1] is ecc.INF


def test_window_butterfly_bit_exact_vs_reference_ops():
    """The same Jacobian limbs as the reference's numpy curve layer gives
    for the kernel's formula (windowed scalar mul, then both adds)."""
    ops, jops = secp256k1(), jsecp()
    m0, m1, sc = _inputs(32)
    hi, lo = cc.point_butterfly(ops, ops.from_affine(m0), ops.from_affine(m1),
                                L.ints_to_tensor(sc), nbits=32)
    j0, j1 = jops.from_affine(np, m0), jops.from_affine(np, m1)
    t = jops.scalar_mul(np, j1, JL.ints_to_limbs(sc), 32)
    for got, want in ((hi, jops.add(np, j0, t)),
                      (lo, jops.add(np, j0, jops.neg(np, t)))):
        assert all(np.array_equal(L.to_numpy(g), w)
                   for g, w in zip(got, want))


def test_dispatch_by_width(monkeypatch):
    """256 bits take K3's GLV body, every other width K7's windowed one."""
    ops = secp256k1()
    m0, m1, sc = _inputs(32)
    M0, M1, S = ops.from_affine(m0), ops.from_affine(m1), L.ints_to_tensor(sc)
    seen = []
    glv, win = cc.point_butterfly_plain, cc.window_butterfly_plain
    monkeypatch.setattr(cc, "point_butterfly_plain",
                        lambda *a: seen.append("glv") or glv(*a))
    monkeypatch.setattr(cc, "window_butterfly_plain",
                        lambda *a: seen.append("window") or win(*a))
    a = cc.point_butterfly(ops, M0, M1, S, nbits=256)
    b = cc.point_butterfly(ops, M0, M1, S, nbits=32)
    assert seen == ["glv", "window"]
    assert ops.to_affine(a[0]) == ops.to_affine(b[0])
    for bad in (0, 30, 260):
        with pytest.raises(ValueError):
            cc.point_butterfly(ops, M0, M1, S, nbits=bad)


@pytest.mark.slow
def test_window_butterfly_vs_pallas_interpret():
    ops, jops = secp256k1(), jsecp()
    m0, m1, sc = _inputs(32)
    hi, lo = cc.point_butterfly(ops, ops.from_affine(m0), ops.from_affine(m1),
                                L.ints_to_tensor(sc), nbits=32)
    jhi, jlo = pallas_curve.point_butterfly(
        jops, jops.from_affine(np, m0), jops.from_affine(np, m1),
        JL.ints_to_limbs(sc), nbits=32, interpret=True)
    assert ops.to_affine(hi) == jops.to_affine(jhi)
    assert ops.to_affine(lo) == jops.to_affine(jlo)
