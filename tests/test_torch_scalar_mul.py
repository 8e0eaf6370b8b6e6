"""K2 `scalar_mul` on the CPU, both modes, against the reference package.

- GLV mode (256-bit scalars): its plain version `glv_halves_plain` runs the
  GLV halves k1*(±P) and k2*(±phi(P)) as two chains, each the windowed
  scalar mul over 128 bits, and adds them once. Held limb for limb against
  the reference's numpy twin of that order (`CurveOps.scalar_mul` / `add` /
  `neg` with `xp=np`) built from the reference's own GLV split, and as
  affine points against the golden model, at 1, 8 and 16 lanes. Edge lanes:
  infinity, scalars 0, 1, n - 1, n, and lambda (k1 = 0).
- Windowed mode: limb for limb `CurveOps.scalar_mul` of the reference with
  `xp=np` at nbits 32 and 64, with the edge scalars 0, 1 and 2^nbits - 1.
Tolerance: zero."""

import random

import numpy as np
import pytest
import torch

from porla_tpu.curves import glv as jglv
from porla_tpu.curves.instances import secp256k1 as jsecp
from porla_tpu.curves.weierstrass import JacPoint as JJacPoint
from porla_tpu.fields import limbs as JL
from porla_tpu.fields import mont as jmont
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


def _points(rng, B):
    return [ecc.mul(CUR, CUR.g, rng.randrange(1, CUR.n)) for _ in range(B)]


def _np(p):
    return tuple(L.to_numpy(c) for c in p)


def _halves_twin(pts, k):
    """The reference's numpy twin of K2's GLV order, from its own split."""
    jops = jsecp()
    gp = jglv.params_for(CUR)
    d = [jglv.decompose(v, gp) for v in k]
    J = jops.from_affine(np, pts)
    beta = np.broadcast_to(JL.int_to_limbs(jops.fp.to_mont_int(gp.beta)),
                           J.x.shape)
    phi = JJacPoint(jmont.mont_mul(np, J.x, beta, jops.fp), J.y, J.z)

    def signed(p, flags):
        n = jops.neg(np, p)
        m = np.asarray(flags, bool)[:, None]
        return JJacPoint(*(np.where(m, a, b) for a, b in zip(n, p)))

    r1 = jops.scalar_mul(np, signed(J, [x[1] for x in d]),
                         JL.ints_to_limbs([x[0] for x in d]), 128)
    r2 = jops.scalar_mul(np, signed(phi, [x[3] for x in d]),
                         JL.ints_to_limbs([x[2] for x in d]), 128)
    return jops.add(np, r1, r2)


def _glv_edges(rng, B):
    """B lanes: the edge lanes (as many as fit) first, then random ones."""
    gp = jglv.params_for(CUR)
    m = max(B, 6)
    pts = _points(rng, m)
    k = [rng.randrange(CUR.n) for _ in range(m)]
    pts[0] = ecc.INF
    k[1:6] = [0, 1, CUR.n - 1, CUR.n, gp.lam]
    return pts[:B], k[:B]


@pytest.mark.parametrize("B,seed", [(1, 1), (8, 2), (16, 3)])
def test_glv_plain_vs_reference_twin_and_golden(B, seed):
    rng = random.Random(seed)
    ops = secp256k1()
    if B == 1:                                  # the update's shape: k1 = 0
        pts, k = _points(rng, 1), [jglv.params_for(CUR).lam]
    else:
        pts, k = _glv_edges(rng, B)
    P, S = ops.from_affine(pts), L.ints_to_tensor(k)
    got = cc.scalar_mul(ops, P, S, 256)         # the CPU route: plain version
    assert all(torch.equal(a, b) for a, b in
               zip(got, cc.glv_halves_plain(ops, P, cc.GlvScalars(ops, S))))
    assert all(np.array_equal(a, b)
               for a, b in zip(_np(got), _halves_twin(pts, k)))
    assert ops.to_affine(got) == [ecc.mul(CUR, q, s) for q, s in zip(pts, k)]
    if B >= 6:
        g = cc.GlvScalars(ops, S)
        assert int(g.k1[5].abs().sum()) == 0    # the lambda lane has k1 = 0
        assert ops.to_affine(got)[:5] == [ecc.INF, ecc.INF, pts[2],
                                          ecc.neg(CUR, pts[3]), ecc.INF]


@pytest.mark.parametrize("nbits", [32, 64])
def test_window_plain_vs_reference(nbits):
    rng = random.Random(nbits)
    ops, jops = secp256k1(), jsecp()
    pts = _points(rng, 10)
    pts[0] = ecc.INF
    k = [rng.getrandbits(nbits) for _ in range(10)]
    k[1], k[2], k[3] = 0, 1, (1 << nbits) - 1
    got = cc.scalar_mul(ops, ops.from_affine(pts), L.ints_to_tensor(k), nbits)
    want = jops.scalar_mul(np, jops.from_affine(np, pts), JL.ints_to_limbs(k),
                           nbits)
    assert all(np.array_equal(a, b) for a, b in zip(_np(got), want))
    assert ops.to_affine(got) == [ecc.mul(CUR, q, s) for q, s in zip(pts, k)]


def test_launches_reject_bad_forms():
    """K2's launches take CUDA operands only, and the GLV mode a split of
    the same lanes: refused before the library is loaded."""
    ops = secp256k1()
    P = ops.from_affine(_points(random.Random(9), 4))
    S = L.ints_to_tensor([5, 6, 7, 8])
    for g in (cc.GlvScalars(ops, S), cc.GlvScalars(ops, S[:2])):
        with pytest.raises(ValueError):
            cc.launch_scalar_mul_glv(ops, P, g)
    with pytest.raises(ValueError):
        cc.scalar_mul(ops, P, S, 30)            # not a multiple of 4
