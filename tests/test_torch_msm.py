"""The port's Pippenger MSM (`curves/cuda_msm.py`) on the CPU, where K5
`pip_bucket` and K6 `bucket_fold` run as their plain torch versions, against
the exact golden model and the pinned reference-C vector
(tests/vectors/secp256k1_kat.json, `ecmult_multi[1]`, n = 300). Also the
dispatch of `curves/kernels.py`: `msm` carries the crossover, `msm_parts`
has none. All integer arithmetic; tolerance zero. Inputs come from
`random.Random` seeds."""

import json
import os
import random

import pytest
import torch

from porla_tpu_torch import native
from porla_tpu_torch.crypto import testrand
from porla_tpu_torch.curves import cuda_msm as cm
from porla_tpu_torch.curves import kernels
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint, index
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.golden import ecc

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

VEC = os.path.join(os.path.dirname(__file__), "vectors",
                   "secp256k1_kat.json")
SEED = 1234                  # blinding seed: reproducible bucket states


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


def _inputs(ops, nbits: int, n: int, seed: int = 99):
    """Random points, scalars with duplicate digits, a zero scalar and the
    all-ones scalar (every signed digit borrows), and their exact MSM."""
    rng = random.Random(seed)
    cur = ops.curve
    pts = [ecc.mul(cur, cur.g, rng.randrange(1, cur.n)) for _ in range(n)]
    top = (1 << nbits) - 1
    sc = [rng.getrandbits(nbits) for _ in range(n - 3)] + [0, top // 15, top]
    return pts, sc, ecc.msm(cur, pts, sc)


def _jacobian(ops, pts, lam: int = 7) -> JacPoint:
    """Affine points with every Z = lam (X = x lam^2, Y = y lam^3)."""
    p, m = ops.curve.p, ops.fp.to_mont_int
    return JacPoint(
        L.ints_to_tensor([m(x * lam * lam % p) for x, _ in pts]),
        L.ints_to_tensor([m(y * pow(lam, 3, p) % p) for _, y in pts]),
        L.ints_to_tensor([m(lam)] * len(pts)))


def _tiled(ops, n: int, nbits: int, nbases: int = 8, seed: int = 7):
    """n lanes over `nbases` tiled bases (the golden sum stays O(n) host
    ints): points, scalar ints, and the per-lane base list."""
    rng = random.Random(seed)
    cur = ops.curve
    bases = [ecc.mul(cur, cur.g, rng.randrange(1, cur.n))
             for _ in range(nbases)]
    sc = [rng.getrandbits(nbits) for _ in range(n)]
    ph = ops.from_affine(bases)
    pts = JacPoint(*(c.repeat(n // nbases, 1) for c in ph))
    return pts, sc, bases


def _tiled_sum(cur, bases, sc, lanes):
    want = ecc.INF
    for g, b in enumerate(bases):
        tot = sum(sc[i] for i in lanes if i % len(bases) == g)
        want = ecc.add(cur, want, ecc.mul(cur, b, tot))
    return want


# --- pippenger_msm vs the golden model ---------------------------------------

@pytest.mark.parametrize("case", ["tiny", "jacobian", "bn254", "non_pow2"])
def test_pippenger_msm_vs_golden(case):
    """The shapes of the reference's interpret-mode tests: 21 affine points,
    21 Jacobian points (the full raw add), 9 points on BN254, and N = 300
    (a padded lane tile; bt = 512)."""
    ops = bn254() if case == "bn254" else secp256k1()
    n = {"tiny": 21, "jacobian": 21, "bn254": 9, "non_pow2": 300}[case]
    pts, sc, want = _inputs(ops, 8, n)
    p = _jacobian(ops, pts) if case == "jacobian" else ops.from_affine(pts)
    out = cm.pippenger_msm(ops, p, L.ints_to_tensor(sc), nbits=8)
    assert out.x.shape == (1, L.NLIMBS)
    assert ops.to_affine(out)[0] == want


def test_pippenger_msm_skips_infinity_and_is_blinding_independent():
    ops = secp256k1()
    pts, sc, _ = _inputs(ops, 8, 21)
    pts[4] = ecc.INF
    want = ecc.msm(ops.curve, pts, sc)
    p, s = ops.from_affine(pts), L.ints_to_tensor(sc)
    outs = [cm.pippenger_msm(ops, p, s, nbits=8, blind_seed=seed)
            for seed in (SEED, SEED + 1, None)]
    assert all(ops.to_affine(o)[0] == want for o in outs)


@pytest.mark.parametrize("c,sc", [
    # |d| = 64 = 2^(c-1) (largest digit without a borrow), 65 (borrow), 127
    # (all-ones window), 0, and a carry chain into the top window
    (7, [64, 65, 127, 128, 255, 0, 100]),
    # |d| = 128 packs as 0x80: value bit 7 set with the sign flag on bit 8;
    # 129 and 255 borrow with a carry; 0 must write nowhere
    (8, [128, 129, 255, 127, 0, 1]),
], ids=["c7", "c8"])
def test_pippenger_msm_digit_corners(c, sc):
    ops = secp256k1()
    cur = ops.curve
    rng = random.Random(c)
    pts = [ecc.mul(cur, cur.g, rng.randrange(1, cur.n)) for _ in sc]
    out = cm.pippenger_msm(ops, ops.from_affine(pts), L.ints_to_tensor(sc),
                           nbits=8, c=c)
    assert ops.to_affine(out)[0] == ecc.msm(cur, pts, sc)


def test_pippenger_msm_reference_c_vector():
    """ecmult_multi[1] of the pinned vectors: libsecp256k1's own result for
    n = 300 generators and 64-bit scalars (its Pippenger regime)."""
    with open(VEC) as f:
        case = json.load(f)["ecmult_multi"][1]
    n = case["n"]
    assert n == 300
    gens = testrand.derive_ipa_generators(128)[0]
    ops = secp256k1()
    sc = [((i + 1) * 0x9E3779B97F4A7C15) & ((1 << 64) - 1) for i in range(n)]
    out = cm.pippenger_msm(ops, ops.from_affine([gens[i % 128]
                                                 for i in range(n)]),
                           L.ints_to_tensor(sc), nbits=64)
    assert ops.to_affine(out)[0] == (int(case["result"][0], 16),
                                     int(case["result"][1], 16))


# --- K5 / K6 plain versions -----------------------------------------------------

def test_first_then_carry_equals_single_shot():
    """Chunks of one step, the bucket state carried from chunk to chunk
    (the streamed form), give the single launch's state bit for bit."""
    ops = secp256k1()
    n, c, bt = 300, 4, 128
    pts, sc, want = _inputs(ops, 8, n)
    nwin, tight = cm._nwin_for(8, c)
    npad = 3 * bt
    p = JacPoint(*(cm._pad_rows(t, npad) for t in ops.from_affine(pts)))
    s = cm._pad_rows(L.ints_to_tensor(sc), npad)
    digits = cm.signed_digits(s, p.z, c, nwin, tight)
    blind = cm.blinding(ops, 1 << (c - 1), SEED)
    whole = cm.pip_bucket(ops, p, digits, blind, bt, True)
    state = None
    for k in range(3):
        sl = slice(k * bt, (k + 1) * bt)
        state = cm.pip_bucket(ops, index(p, sl), digits[:, sl].contiguous(),
                              blind, bt, True, state)
    assert torch.equal(state, whole)
    wins = cm.reduce_lanes(ops, cm.bucket_fold(ops, whole))
    assert cm.horner(ops, ops.to_affine(wins), c, bt, blind.tsum) == want


def test_buckets_and_fold_vs_exact_ints():
    """Every bucket is its blinding point plus the signed sum of the lane's
    points whose digit selects it, and the fold is sum_s s*B_s."""
    ops = secp256k1()
    cur = ops.curve
    c, bt, steps, nbits = 4, 128, 2, 8
    nb = 1 << (c - 1)
    rng = random.Random(11)
    base = [ecc.mul(cur, cur.g, rng.randrange(1, cur.n)) for _ in range(8)]
    pts = [base[i % 8] for i in range(bt * steps)]
    sc = [rng.getrandbits(nbits) for _ in pts]
    p = ops.from_affine(pts)
    nwin, tight = cm._nwin_for(nbits, c)
    digits = cm.signed_digits(L.ints_to_tensor(sc), p.z, c, nwin, tight)
    blind = cm.blinding(ops, nb, SEED)
    state = cm.pip_bucket(ops, p, digits, blind, bt, True)
    assert state.shape == (nwin, nb, 3, 8, bt) and state.dtype == torch.int32
    buckets = cm.unpack_state(state)
    d_aff = ops.to_affine(JacPoint(blind.x, blind.y,
                                   ops.fp.const("r_limbs", "cpu")
                                   .expand_as(blind.x)))
    folded = cm.bucket_fold(ops, state)
    for w, lane in ((0, 0), (1, 5), (2, 127), (0, 64)):
        want = list(d_aff)
        for k in range(steps):
            v = int(digits[w, k * bt + lane])
            slot, neg = v & 255, v >> 8
            if slot:
                q = pts[k * bt + lane]
                want[slot - 1] = ecc.add(cur, want[slot - 1],
                                         ecc.neg(cur, q) if neg else q)
        got = ops.to_affine(index(buckets, (w, slice(None), lane)))
        assert got == want
        fold = ecc.msm(cur, want, range(1, nb + 1))
        assert ops.to_affine(index(folded, (w, slice(lane, lane + 1))))[0] \
            == fold


def test_state_packing_round_trip():
    rng = random.Random(3)
    vals = [rng.getrandbits(256) for _ in range(2 * 3 * 4)] \
        + [(1 << 256) - 1, 1 << 255, 0x80000000, 0xFFFFFFFF]
    t = L.ints_to_tensor(vals[:24]).reshape(2, 3, 4, L.NLIMBS)
    e = L.ints_to_tensor((vals[24:] * 6)[:24]).reshape(2, 3, 4, L.NLIMBS)
    state = cm.pack_state(JacPoint(t, e, t))
    assert state.shape == (2, 3, 3, 8, 4) and state.is_contiguous()
    back = cm.unpack_state(state)
    assert torch.equal(back.x, t) and torch.equal(back.y, e)
    # word k of a coordinate is limbs 2k, 2k+1 (little-endian), as the
    # kernels read it
    assert int(state[0, 0, 0, 0, 0]) & 0xFFFFFFFF == vals[0] & 0xFFFFFFFF


def test_wrappers_reject_bad_operands():
    ops = secp256k1()
    p = ops.from_affine([ops.curve.g] * 128)
    blind = cm.blinding(ops, 8, SEED)
    with pytest.raises(ValueError):          # int64 digits
        cm.pip_bucket(ops, p, torch.zeros((3, 128), dtype=torch.int64),
                      blind, 128, True)
    with pytest.raises(ValueError):          # digits do not tile the lanes
        cm.pip_bucket(ops, p, torch.zeros((3, 100), dtype=torch.int32),
                      blind, 128, True)
    with pytest.raises(ValueError):          # state of another shape
        cm.pip_bucket(ops, p, torch.zeros((3, 128), dtype=torch.int32),
                      blind, 128, True,
                      torch.zeros((3, 4, 3, 8, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        cm.bucket_fold(ops, torch.zeros((3, 8, 3, 8, 128)))
    s = L.ints_to_tensor([1] * 128)
    with pytest.raises(ValueError):          # c = 9 collides with the sign
        cm.pippenger_msm(ops, p, s, nbits=8, c=9)
    with pytest.raises(ValueError):
        cm.pippenger_msm(ops, p, s[:100], nbits=8)
    with pytest.raises(RuntimeError):        # no card here, and no fallback
        cm.pippenger_msm(ops, p, s, nbits=8, device="cuda")


def test_lane_width_must_be_power_of_two():
    ops = secp256k1()
    p = ops.from_affine([ops.curve.g] * 384)
    wide = JacPoint(*(c.reshape(1, 384, L.NLIMBS) for c in p))
    with pytest.raises(ValueError, match="power of two"):
        cm.reduce_lanes(ops, wide)
    with pytest.raises(ValueError, match="power of two"):
        cm.pippenger_msm(ops, p, L.ints_to_tensor([1] * 384), nbits=8, bt=384)


# --- signed digits --------------------------------------------------------------

@pytest.mark.parametrize("c,nbits", [(4, 256), (7, 256), (8, 256), (8, 254),
                                     (4, 8), (7, 64)])
def test_signed_digits_rebuild_scalars(c, nbits):
    """The packed digits, unpacked with the kernel's formulas (slot =
    v & 255, sign = v >> 8), rebuild every scalar with |d| <= 2^(c-1), in
    the carry-window form and, where c does not divide nbits, in the tight
    form too. (c = 8, nbits = 254) is the BN254 production shape."""
    nb = 1 << (c - 1)
    rng = random.Random(c * 1000 + nbits)
    top = (1 << nbits) - 1
    sc = [0, 1, nb, nb + 1, top, top - 1, int("80" * 32, 16) & top,
          int("7f" * 32, 16) & top]
    sc += [rng.getrandbits(nbits) for _ in range(8)]
    z = torch.ones((len(sc), L.NLIMBS), dtype=torch.int64)
    z[3] = 0                                 # point at infinity
    W = -(-nbits // c)
    variants = [(W + 1, False)]
    if cm._nwin_for(nbits, c)[1]:
        variants.append((W, True))
    for nwin, tight in variants:
        pack = cm.signed_digits(L.ints_to_tensor(sc), z, c, nwin, tight)
        assert pack.shape == (nwin, len(sc)) and pack.dtype == torch.int32
        for i, s in enumerate(sc):
            total = 0
            for w in range(nwin):
                v = int(pack[w, i])
                slot, sgn = v & (cm.SIGN - 1), v >> 8
                assert slot <= nb and sgn in (0, 1), (c, i, w, v, tight)
                total += (-slot if sgn else slot) << (c * w)
            assert total == (0 if i == 3 else s), (c, i, tight)


# --- dispatch -------------------------------------------------------------------

def test_msm_at_the_crossover_takes_pippenger(monkeypatch):
    """4096 points (8 tiled bases, 8-bit scalars) reach `pippenger_msm`;
    4095 stay on K2's route. Both equal the golden sum."""
    ops = secp256k1()
    n = kernels.PIPPENGER_CROSSOVER
    pts, sc, bases = _tiled(ops, n, 8)
    calls = []
    real = cm.pippenger_msm
    monkeypatch.setattr(cm, "pippenger_msm",
                        lambda *a, **k: calls.append(a[1].x.shape[0])
                        or real(*a, **k))
    out = kernels.msm(ops, pts, L.ints_to_tensor(sc), 8)
    assert calls == [n]
    assert ops.to_affine(out)[0] == _tiled_sum(ops.curve, bases, sc, range(n))
    small = kernels.msm(ops, index(pts, slice(0, 64)),
                        L.ints_to_tensor(sc[:64]), 8)
    assert calls == [n]
    assert ops.to_affine(small)[0] == _tiled_sum(ops.curve, bases, sc,
                                                 range(64))


def test_msm_parts_has_no_crossover(monkeypatch):
    """The server's stacked audit route at 4096 lanes (two parts of 2048,
    some lanes at infinity with scalar 0) runs K2's route, not Pippenger,
    and equals the golden sums."""
    ops = secp256k1()
    n = 4096
    pts, sc, bases = _tiled(ops, n, 8)
    z = pts.z.clone()
    for i in (3, 2047, 2048, 4095):
        z[i] = 0
        sc[i] = 0
    monkeypatch.setattr(cm, "pippenger_msm", lambda *a, **k: pytest.fail(
        "msm_parts must not take the Pippenger route"))
    halves = kernels.msm_parts(ops, JacPoint(pts.x, pts.y, z),
                               L.ints_to_tensor(sc), 2, 8)
    assert [ops.to_affine(h)[0] for h in halves] == \
        [_tiled_sum(ops.curve, bases, sc, range(2048)),
         _tiled_sum(ops.curve, bases, sc, range(2048, 4096))]
    with pytest.raises(ValueError):
        kernels.msm_parts(ops, pts, L.ints_to_tensor(sc), 3, 8)
