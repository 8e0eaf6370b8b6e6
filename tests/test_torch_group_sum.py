"""`group_sum`'s launch plan on the CPU: `cuda_curve.group_sum_plan` (the nb
blocks a group, the levels they run apart, the levels the group's last
block runs) and a plain torch replay of it, block by block, held limb for
limb (tolerance: zero) against `ops.tree_sum`, `group_sum` (its plain
version on the CPU) and the reference's numpy `tree_sum`. The replay runs
each block's apart levels to the end before the next block starts, over
that block's slots alone, so a plan whose blocks would need each other's
sums, or would miss an add, gives other limbs. Points: distinct multiples of
a random point (`random.Random` seeds), with infinity, P + P and P + (-P)
meeting in the first level of every group, on secp256k1 and BN254 G1."""

import functools
import random

import numpy as np
import pytest
import torch

from porla_tpu.curves.instances import bn254 as jbn254
from porla_tpu.curves.instances import secp256k1 as jsecp
from porla_tpu.curves.weierstrass import JacPoint as JJacPoint
from porla_tpu.golden import ecc
from porla_tpu_torch import native
from porla_tpu_torch.curves import cuda_curve as cc
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs as L

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

CURVES = {"secp256k1": (ecc.SECP256K1, secp256k1, jsecp),
          "bn254": (ecc.BN254, bn254, jbn254)}


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


def _widths(g):
    """The widths of `CurveOps.tree_sum`'s levels over g points."""
    out = []
    while g > 1:
        out.append(g)
        g = g // 2 + g % 2
    return out


def test_plan_at_the_path_shapes():
    """The audit's parts (1024 points) take 32 blocks of 32 points, five
    levels apart and five in the last block; 2^14 points take 128 blocks;
    an odd width splits on, its first carry in the block of its residue;
    any width splits its first level, whatever its half; a group of up to
    32 points takes one block."""
    p = cc.group_sum_plan(1024)
    assert (p.nb, p.apart, p.last) == (32, (1024, 512, 256, 128, 64),
                                       (32, 16, 8, 4, 2))
    assert cc.group_sum_plan(1 << 14).nb == 128
    p = cc.group_sum_plan(1025)
    assert p.nb == 32 and p.apart == (1025, 513, 257, 129, 65)
    assert p.last == (33, 17, 9, 5, 3, 2)
    p = cc.group_sum_plan(4095)
    assert p.nb == 32 and p.apart == (4095, 2048, 1024, 512, 256, 128, 64)
    p = cc.group_sum_plan(127)
    assert (p.nb, p.apart, p.last) == (8, (127, 64, 32, 16), (8, 4, 2))
    for g, nb in ((300, 16), (302, 16), (4094, 32)):
        p = cc.group_sum_plan(g)
        assert p.nb == nb and p.apart == (g,)
    for g in (1, 2, 3, 32):
        assert cc.group_sum_plan(g).nb == 1
    assert cc.group_sum_plan(1) == cc.GroupSumPlan(1, (), ())


def test_plan_rule():
    """Every plan covers tree_sum's levels in order, its blocks run apart
    the first level and then only while nb divides the half of the width
    (the kernel's loop), and nb is a power of two near sqrt(g), 1 up to 32
    points."""
    for g in list(range(1, 130)) + [255, 256, 300, 1000, 1024, 1025, 2048,
                                    4094, 4095, 1 << 14, 1 << 16]:
        p = cc.group_sum_plan(g)
        assert p.apart + p.last == tuple(_widths(g)), g
        assert p.nb & (p.nb - 1) == 0, g
        assert p.nb == 1 if g <= 32 else p.nb ** 2 <= g < 4 * p.nb ** 2, g
        assert all((m // 2) % p.nb == 0 for m in p.apart[1:]), g
        assert not p.last or p.nb > 1 and (p.last[0] // 2) % p.nb, g
        assert g < 2 or p.apart and p.apart[0] == g, g


def replay(ops, points, nout, plan):
    """`group_sum`'s kernel as `plan` runs it, in plain torch: block b of
    each group runs all its apart levels into its slots b, b + nb, ... of
    the scratch before block b + 1 starts, then the last block runs the
    remaining levels over every slot; an odd width carries its last slot
    into slot m/2 in the block of m/2's residue. The first level reads the
    input, a later level before the hand-off only sums of its own block, a
    level after it only sums (what the kernel's blocks, running together,
    can rely on). -> (nout, 16)."""
    g = points.x.shape[0] // nout
    inp = JacPoint(*(c.reshape(nout, g, L.NLIMBS) for c in points))
    slots = JacPoint(*(torch.zeros_like(c) for c in inp))
    owner = [None] * g          # the block that last wrote a scratch slot

    def level(m, b, step, apart):
        h = m // 2
        src = inp if m == g else slots
        tgt = list(range(b, h, step))
        srcs = [i + h for i in tgt]
        carry = m % 2 and b == h % step
        if m < g:
            assert all(owner[s] == b if apart else owner[s] is not None
                       for s in tgt + srcs + [2 * h] * carry), \
                "a block reads another block's sum, or a stale slot"
        s = ops.add(JacPoint(*(c[:, tgt] for c in src)),
                    JacPoint(*(c[:, srcs] for c in src)))
        for c, v in zip(slots, s):
            c[:, tgt] = v
        for i in tgt:
            owner[i] = b
        if carry:
            for c, v in zip(slots, src):
                c[:, h] = v[:, 2 * h]
            owner[h] = b

    for b in range(plan.nb):
        for m in plan.apart:
            level(m, b, plan.nb, True)
    for m in plan.last:
        level(m, 0, 1, False)
    return JacPoint(*(c[:, 0] for c in (slots if g > 1 else inp)))


@functools.lru_cache(maxsize=None)
def _points(curve, B, nout, seed=6):
    """B distinct multiples of a random point, shuffled, in nout groups;
    infinity, P + P and P + (-P) meet in the first level of each group."""
    cur = CURVES[curve][0]
    rng = random.Random(seed + B)
    step = ecc.mul(cur, cur.g, rng.randrange(1, cur.n))
    pts = [step]
    while len(pts) < B:
        pts.append(ecc.add(cur, pts[-1], step))
    rng.shuffle(pts)
    g = B // nout
    half = g // 2
    for o in range(0, B, g):
        if half >= 3:
            pts[o] = ecc.INF
            pts[o + half + 1] = pts[o + 1]
            pts[o + half + 2] = ecc.neg(cur, pts[o + 2])
    return pts


@pytest.mark.parametrize("curve", ["secp256k1", "bn254"])
@pytest.mark.parametrize("nout", [1, 2])
@pytest.mark.parametrize("g", [1, 2, 3, 64, 127, 300, 302, 303, 1024,
                               1025])
def test_replay_is_tree_sum(g, nout, curve):
    cur, make, jmake = CURVES[curve]
    ops, jops = make(), jmake()
    pts = _points(curve, g * nout, nout)
    P = ops.from_affine(pts)
    plan = cc.group_sum_plan(g)
    got = replay(ops, P, nout, plan)
    assert all(torch.equal(a, b) for a, b in zip(got, cc.group_sum(ops, P,
                                                                   nout)))
    for o in range(nout):
        grp = JacPoint(*(c[o * g:(o + 1) * g] for c in P))
        mine = ops.tree_sum(grp)
        assert all(torch.equal(a[o:o + 1], b) for a, b in zip(got, mine))
        ref = jops.tree_sum(np, JJacPoint(*(L.to_numpy(c) for c in grp)))
        assert all(np.array_equal(L.to_numpy(a[o:o + 1]), b)
                   for a, b in zip(got, ref))
    if g <= 64:
        assert ops.to_affine(got) == [
            ecc.msm(cur, pts[o * g:(o + 1) * g], [1] * g)
            for o in range(nout)]
