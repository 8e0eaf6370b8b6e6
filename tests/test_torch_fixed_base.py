"""K4 `fixed_base` and `group_sum` on the CPU: their plain versions held
against the golden model and the reference package. The fast tier compares
with the reference's numpy twins (`CurveOps.scalar_mul` / `tree_sum` with
`xp=np`); the slow tier with its Pallas `fb_scalar_mul` / `fb_msm_groups`
in interpret mode (each compile takes about two minutes on the CPU). K4's
points compare as affine points (a lane split over threads adds in another
order than the reference's window chain); `group_sum` compares limb for
limb with `tree_sum`. Tolerance: zero. Inputs from `random.Random` seeds:
4-8 generators, scalars with the edges 0, 1, n - 1, n and 2^nbits - 1
where they fit, and infinity, P + P and P + (-P) inside a group. On
secp256k1 and, in the cases whose id starts with `bn254`, on BN254 G1 (the
KZG scheme's complements, SRS commitments and audit sums)."""

import random

import numpy as np
import pytest
import torch

from porla_tpu.curves import pallas_curve
from porla_tpu.curves.instances import bn254 as jbn254
from porla_tpu.curves.instances import secp256k1 as jsecp
from porla_tpu.curves.weierstrass import JacPoint as JJacPoint
from porla_tpu.fields import limbs as JL
from porla_tpu.golden import ecc
from porla_tpu_torch import native
from porla_tpu_torch.commit import kzg, pedersen
from porla_tpu_torch.curves import cuda_curve as cc
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint, index
from porla_tpu_torch.fields import limbs as L

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

# curve name -> (golden curve, port ops, reference ops)
CURVES = {"secp256k1": (ecc.SECP256K1, secp256k1, jsecp),
          "bn254": (ecc.BN254, bn254, jbn254)}
CUR = ecc.SECP256K1
slow = pytest.mark.slow


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


def _gens(k, seed=3, cur=CUR):
    rng = random.Random(seed)
    return [ecc.mul(cur, cur.g, rng.randrange(1, cur.n))
            for _ in range(k - 1)] + [cur.g]


def _scalars(B, nbits, seed=4, cur=CUR):
    rng = random.Random(seed)
    top = 1 << nbits
    edges = [0, 1] + [v for v in (cur.n - 1, cur.n) if v < top] + [top - 1]
    return edges + [rng.getrandbits(nbits) for _ in range(B - len(edges))]


def _np(p):
    return JJacPoint(*(L.to_numpy(c) for c in p))


def _ref_lanes(gens, sc, nbits, jops=None):
    """The reference's numpy twin of K4 per lane: its windowed scalar mul
    of each lane's base."""
    jops = jops or jsecp()
    base = jops.from_affine(np, [gens[i % len(gens)] for i in range(len(sc))])
    return jops.scalar_mul(np, base, JL.ints_to_limbs(sc), nbits)


@pytest.mark.parametrize("nbits,curve", [
    pytest.param(32, "secp256k1", id="32"),
    pytest.param(64, "secp256k1", id="64"),
    pytest.param(256, "secp256k1", id="256"),
    pytest.param(128, "bn254", id="bn254-128")])
def test_fb_scalar_mul_vs_golden_and_reference(nbits, curve):
    cur, make, jmake = CURVES[curve]
    ops, jops = make(), jmake()
    gens = _gens(8, cur=cur)
    tbl = cc.build_fb_table(ops, gens, nbits=nbits)
    sc = _scalars(24, nbits, cur=cur)
    got = ops.to_affine(cc.fb_scalar_mul(tbl, L.ints_to_tensor(sc)))
    assert got == [ecc.mul(cur, gens[i % 8], k) for i, k in enumerate(sc)]
    assert got == jops.to_affine(_ref_lanes(gens, sc, nbits, jops))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_fb_lane_split_same_points(split):
    """Every split of a lane's windows over threads gives the same points
    (windows past the last are skipped: 7 windows at 28 bits)."""
    ops = secp256k1()
    gens = _gens(4)
    tbl = cc.build_fb_table(ops, gens, nbits=28)
    sc = _scalars(12, 28)
    got = cc.fb_lanes_plain(tbl, L.ints_to_tensor(sc), split)
    assert ops.to_affine(got) == [ecc.mul(CUR, gens[i % 4], k)
                                  for i, k in enumerate(sc)]


@pytest.mark.parametrize("nout,curve", [
    pytest.param(1, "secp256k1", id="1"),
    pytest.param(2, "secp256k1", id="2"),
    pytest.param(16, "secp256k1", id="16"),
    pytest.param(1, "bn254", id="bn254-1")])
def test_fb_msm_groups_vs_golden_and_reference(nout, curve):
    """nout = 1, 2 and B (groups of one lane), with the edge scalars in the
    first group: golden sums and the reference's numpy tree sums."""
    cur, make, jmake = CURVES[curve]
    ops, jops = make(), jmake()
    gens = _gens(4, cur=cur)
    nbits = 64
    tbl = cc.build_fb_table(ops, gens, nbits=nbits)
    B = 16
    sc = _scalars(B, nbits, cur=cur)
    got = ops.to_affine(cc.fb_msm_groups(tbl, L.ints_to_tensor(sc), nout))
    g = B // nout
    assert got == [ecc.msm(cur, [gens[i % 4] for i in range(o * g, o * g + g)],
                           sc[o * g:o * g + g]) for o in range(nout)]
    lanes = _ref_lanes(gens, sc, nbits, jops)
    ref = [jops.tree_sum(np, JJacPoint(*(c[o * g:o * g + g] for c in lanes)))
           for o in range(nout)]
    assert got == [jops.to_affine(r)[0] for r in ref]
    with pytest.raises(AssertionError):      # non-pow2 group width
        cc.fb_msm_groups(tbl, L.ints_to_tensor(sc[:12]), nout=2)


def test_commit_blocks_vs_golden():
    """commit_blocks is fb_msm_groups over its table with one group of NG
    lanes a block."""
    ops = secp256k1()
    gens = _gens(8)
    sc = _scalars(24, 256)
    tbl = cc.fixed_base_table(ops, gens)
    got = pedersen.commit_blocks(tbl, L.ints_to_tensor(sc).reshape(3, 8, 16))
    assert ops.to_affine(got) == [ecc.msm(CUR, gens, sc[8 * b:8 * b + 8])
                                  for b in range(3)]
    with pytest.raises(ValueError):        # 4 scalars a block, 8 bases
        pedersen.commit_blocks(tbl, L.ints_to_tensor(sc).reshape(6, 4, 16))


def test_commit_blocks_over_srs():
    """The KZG server's commitments: commit_blocks over the table of an SRS
    of 8 powers on BN254 is [f(tau)]G1 a block, the client's commit_eval
    with alpha = 1."""
    ops = bn254()
    tau = 123456789
    srs = kzg.KzgSrs.from_tau(tau, 8)
    sc = _scalars(16, 256, seed=5, cur=ecc.BN254)
    got = pedersen.commit_blocks(srs.table,
                                 L.ints_to_tensor(sc).reshape(2, 8, 16))
    assert ops.to_affine(got) == [kzg.commit_eval(tau, 1, sc[8 * b:8 * b + 8])
                                  for b in range(2)]


def _group_points(B, nout, seed=6, cur=CUR):
    """B points in nout groups with infinity, P + P and P + (-P) meeting in
    the first level of the first group."""
    rng = random.Random(seed)
    step = ecc.mul(cur, cur.g, rng.randrange(1, cur.n))
    pts = [step]
    while len(pts) < B:                        # distinct multiples of step
        pts.append(ecc.add(cur, pts[-1], step))
    rng.shuffle(pts)
    half = B // nout // 2
    if half >= 3:
        pts[0] = ecc.INF
        pts[half + 1] = pts[1]
        pts[half + 2] = ecc.neg(cur, pts[2])
    return pts


@pytest.mark.parametrize("g,nout,curve", [
    pytest.param(1, 3, "secp256k1", id="1-3"),
    pytest.param(3, 2, "secp256k1", id="3-2"),
    pytest.param(5, 2, "secp256k1", id="5-2"),
    pytest.param(8, 2, "secp256k1", id="8-2"),
    pytest.param(300, 1, "secp256k1", id="300-1"),
    pytest.param(8, 2, "bn254", id="bn254-8-2")])
def test_group_sum_plain_is_tree_sum(g, nout, curve):
    """group_sum is `ops.tree_sum` of each group limb for limb (odd levels
    carry their last point), the reference's numpy `tree_sum` too (up to 8
    points: its numpy arithmetic is slow), and the golden sums."""
    cur, make, jmake = CURVES[curve]
    ops, jops = make(), jmake()
    B = g * nout
    pts = _group_points(B, nout, cur=cur)
    P = ops.from_affine(pts)
    got = cc.group_sum(ops, P, nout)
    for o in range(nout):
        grp = index(P, slice(o * g, (o + 1) * g))
        mine = ops.tree_sum(grp)
        assert all(torch.equal(a[o:o + 1], b) for a, b in zip(got, mine))
        if g <= 8:
            ref = jops.tree_sum(np, _np(grp))
            assert all(np.array_equal(L.to_numpy(a[o:o + 1]), b)
                       for a, b in zip(got, ref))
    assert ops.to_affine(got) == [ecc.msm(cur, pts[o * g:(o + 1) * g], [1] * g)
                                  for o in range(nout)]


def test_fb_split_rule():
    assert cc.fb_split(131072) == 1
    assert cc.fb_split(131072, 128) == 1
    assert cc.fb_split(32768) == 2
    assert cc.fb_split(256, 128) == 4
    assert cc.fb_split(2048) == 4
    assert cc.fb_split(4096, 256) == 2           # group * split <= 512
    assert cc.fb_split(2048, 1024) == 1


def test_packed_table():
    """K4's packed table: x then y as 32-bit words of the limbs, infinity
    (digit 0) as zeros; a point with y = 0 would be refused."""
    ops = secp256k1()
    tbl = cc.build_fb_table(ops, _gens(4), nbits=8)
    w = tbl.packed("cpu")
    assert w.shape == (2, 16, 4, 16) and w.dtype == torch.int32
    words = w.to(torch.int64) & 0xFFFFFFFF
    lim = torch.stack([words & 0xFFFF, words >> 16], -1).flatten(-2)
    assert torch.equal(lim[..., :16][:, 1:], tbl.coords.x[:, 1:])
    assert torch.equal(lim[..., 16:][:, 1:], tbl.coords.y[:, 1:])
    assert not w[:, 0].any()
    c = tbl.coords
    bad = cc.FbTable(ops, JacPoint(c.x, torch.zeros_like(c.y), c.z), 8, 4)
    with pytest.raises(ValueError):
        bad.packed("cpu")


def test_table_columns():
    """A table gathered from two tables laid side by side (`fb_table_cat`,
    `FbColumns`, as the IPA rounds lay out theirs): lanes take any of
    their bases, repeated and reordered, infinity among them, in per-lane
    and group sums; its packed words are the gathered columns of its
    source's."""
    ops = secp256k1()
    gens = _gens(4)
    u = ecc.mul(CUR, CUR.g, 12345)
    src = cc.fb_table_cat([cc.build_fb_table(ops, gens, nbits=64),
                           cc.build_fb_table(ops, [u, ecc.INF], nbits=64)])
    cols = [2, 4, 0, 5, 1, 3, 5, 4]
    tbl = cc.FbColumns(src, cols)
    bases = gens + [u, ecc.INF]
    sc = _scalars(16, 64)
    got = ops.to_affine(cc.fb_scalar_mul(tbl, L.ints_to_tensor(sc)))
    assert got == [ecc.mul(CUR, bases[cols[i % 8]], k)
                   for i, k in enumerate(sc)]
    got = ops.to_affine(cc.fb_msm_groups(tbl, L.ints_to_tensor(sc), 2))
    assert got == [ecc.msm(CUR, [bases[cols[i % 8]] for i in range(o, o + 8)],
                           sc[o:o + 8]) for o in (0, 8)]
    assert torch.equal(tbl.packed("cpu"),
                       src.packed("cpu")[:, :, cols].contiguous())


def test_wrappers_reject_bad_operands():
    ops = secp256k1()
    P = ops.from_affine(_gens(6))
    with pytest.raises(ValueError):
        cc.group_sum(ops, P, 4)                  # 6 points, 4 groups
    tbl = cc.build_fb_table(ops, _gens(4), nbits=8)
    with pytest.raises(ValueError):
        cc.launch_fixed_base(tbl, torch.zeros((8, 16), dtype=torch.int64),
                             3)                  # 8 lanes, 3 groups
    with pytest.raises(ValueError):
        cc.fb_scalar_mul(tbl, torch.zeros((8, 15), dtype=torch.int64))


# --- against the Pallas kernels in interpret mode (slow tier) ----------------

@slow
def test_fb_scalar_mul_vs_pallas_interpret():
    ops, jops = secp256k1(), jsecp()
    gens = _gens(4)
    sc = _scalars(12, 32)
    jt = pallas_curve.build_fb_table(jops, gens, nbits=32, bt=128)
    ref = pallas_curve.fb_scalar_mul(jt, JL.ints_to_limbs(sc), interpret=True)
    got = cc.fb_scalar_mul(cc.build_fb_table(ops, gens, nbits=32),
                           L.ints_to_tensor(sc))
    assert ops.to_affine(got) == jops.to_affine(ref)


@slow
def test_fb_msm_groups_vs_pallas_interpret():
    ops, jops = secp256k1(), jsecp()
    gens = _gens(4)
    sc = _scalars(128, 32)
    jt = pallas_curve.build_fb_table(jops, gens, nbits=32, bt=128)
    ref = pallas_curve.fb_msm_groups(jt, JL.ints_to_limbs(sc), nout=2,
                                     interpret=True)
    got = cc.fb_msm_groups(cc.build_fb_table(ops, gens, nbits=32),
                           L.ints_to_tensor(sc), 2)
    assert ops.to_affine(got) == jops.to_affine(ref)
