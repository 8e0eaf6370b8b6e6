"""K3 `point_butterfly` (256-bit scalars, GLV) on the CPU: its plain version
`glv_butterfly_plain` takes the GLV halves as two chains, k1*(±m1) and
k2*(±phi(m1)) by the windowed scalar mul over 128 bits, adds them, then
forms (m0 + t, m0 - t). Held limb for limb against the reference package's
numpy twin computing the same order (`CurveOps.scalar_mul` / `add` /
`neg` with `xp=np`), as affine points against the golden model, and limb
for limb against K2's plain GLV version (the same order). Edge lanes as
`chip_smoke.py` checks them on the card: an infinity input, a zero scalar,
m0 = s*m1 (the hi add doubles, lo is infinity), m0 = -s*m1, an infinity
m0. On secp256k1 and, in the case whose id starts with `bn254`, on BN254
G1 (the KZG scheme's MAC plane). Tolerance: zero."""

import random

import numpy as np
import pytest
import torch

from porla_tpu.curves import glv as jglv
from porla_tpu.curves.instances import bn254 as jbn254
from porla_tpu.curves.instances import secp256k1 as jsecp
from porla_tpu.curves.weierstrass import JacPoint as JJacPoint
from porla_tpu.fields import limbs as JL
from porla_tpu.fields import mont as jmont
from porla_tpu.golden import ecc
from porla_tpu_torch import native
from porla_tpu_torch.curves import cuda_curve as cc
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.fields import limbs as L

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

# curve name -> (golden curve, port ops, reference ops)
CURVES = {"secp256k1": (ecc.SECP256K1, secp256k1, jsecp),
          "bn254": (ecc.BN254, bn254, jbn254)}
CUR = ecc.SECP256K1


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


def _inputs(B, seed, cur=CUR):
    """B >= 6 lanes with the edge lanes first."""
    rng = random.Random(seed)
    pts = lambda k: [ecc.mul(cur, cur.g, rng.randrange(1, cur.n))
                     for _ in range(k)]
    m1, m0 = pts(B), pts(B)
    k = [rng.randrange(cur.n) for _ in range(B)]
    m1[0] = ecc.INF                                  # infinity input
    k[1] = 0                                         # zero scalar
    m0[2] = ecc.mul(cur, m1[2], k[2])                # m0 == s*m1
    m0[3] = ecc.neg(cur, ecc.mul(cur, m1[3], k[3]))  # m0 == -s*m1
    m0[4] = ecc.INF
    k[5] = cur.n - 1
    return m0, m1, k


def _np(p):
    return JJacPoint(*(L.to_numpy(c) for c in p))


def _reference(m0, m1, k, curve="secp256k1"):
    """The reference's numpy twin of K3's order, from the reference's own
    GLV split."""
    cur, _, jmake = CURVES[curve]
    jops = jmake()
    gp = jglv.params_for(cur)
    d = [jglv.decompose(v, gp) for v in k]
    J0, J1 = jops.from_affine(np, m0), jops.from_affine(np, m1)
    beta = np.broadcast_to(JL.int_to_limbs(jops.fp.to_mont_int(gp.beta)),
                           J1.x.shape)
    phi = JJacPoint(jmont.mont_mul(np, J1.x, beta, jops.fp), J1.y, J1.z)

    def signed(p, flags):
        n = jops.neg(np, p)
        m = np.asarray(flags, bool)[:, None]
        return JJacPoint(*(np.where(m, a, b) for a, b in zip(n, p)))

    r1 = jops.scalar_mul(np, signed(J1, [x[1] for x in d]),
                         JL.ints_to_limbs([x[0] for x in d]), 128)
    r2 = jops.scalar_mul(np, signed(phi, [x[3] for x in d]),
                         JL.ints_to_limbs([x[2] for x in d]), 128)
    t = jops.add(np, r1, r2)
    return jops.add(np, J0, t), jops.add(np, J0, jops.neg(np, t))


@pytest.mark.parametrize("B,seed,curve", [
    pytest.param(8, 1, "secp256k1", id="8-1"),
    pytest.param(16, 2, "secp256k1", id="16-2"),
    pytest.param(8, 3, "bn254", id="bn254-8-3")])
def test_glv_butterfly_plain_vs_reference_twin(B, seed, curve):
    cur, make, _ = CURVES[curve]
    ops = make()
    m0, m1, k = _inputs(B, seed, cur)
    g = cc.GlvScalars(ops, L.ints_to_tensor(k))
    hi, lo = cc.glv_butterfly_plain(ops, ops.from_affine(m0),
                                    ops.from_affine(m1), g)
    rhi, rlo = _reference(m0, m1, k, curve)
    for got, want in ((hi, rhi), (lo, rlo)):
        assert all(np.array_equal(a, b) for a, b in zip(_np(got), want))
    t = [ecc.mul(cur, q, s) for q, s in zip(m1, k)]
    assert ops.to_affine(hi) == [ecc.add(cur, a, x) for a, x in zip(m0, t)]
    assert ops.to_affine(lo) == [ecc.add(cur, a, ecc.neg(cur, x))
                                 for a, x in zip(m0, t)]
    assert ops.to_affine(hi)[2] == ecc.mul(cur, m0[2], 2)
    assert ops.to_affine(lo)[2] is ecc.INF and ops.to_affine(hi)[3] is ecc.INF


def test_glv_halves_same_points_as_k2_order():
    """K3's halves are K2's GLV order: the plain version of K2's GLV mode
    gives `glv_halves_plain`'s limbs, whose points are the golden ones."""
    ops = secp256k1()
    _, m1, k = _inputs(8, 3)
    P, S = ops.from_affine(m1), L.ints_to_tensor(k)
    g = cc.GlvScalars(ops, S)
    mine = cc.glv_halves_plain(ops, P, g)
    k2 = cc.scalar_mul(ops, P, S, 256)
    assert all(torch.equal(a, b) for a, b in zip(mine, k2))
    assert ops.to_affine(mine) == [ecc.mul(CUR, q, s) for q, s in zip(m1, k)]


def test_launch_rejects_bad_forms():
    """K3's launch takes one form of operands only: CUDA tensors with a GLV
    split of the same lanes. CPU operands, or a split of other lanes, are
    refused before the library is loaded."""
    ops = secp256k1()
    _, m1, k = _inputs(6, 4)
    P, S = ops.from_affine(m1), L.ints_to_tensor(k)
    for g in (cc.GlvScalars(ops, S), cc.GlvScalars(ops, S[:4])):
        with pytest.raises(ValueError):
            cc.launch_point_butterfly(ops, P, P, g)
