"""The port's Pippenger MSM (`porla_tpu_torch/curves/cuda_msm.py`) held
against the reference package's (`porla_tpu/curves/pallas_msm.py`) on the
same inputs: the policy, the signed digits (against the jitted `_prep_fn`),
the blinding points under a shared seed, the plain versions of K5 and K6
against the Pallas kernels in interpret mode (K6's window totals against
the reference's fold and its own lane reduction), and the whole MSM. All
integer arithmetic; tolerance zero. Inputs come from `random.Random` seeds.

The interpret-mode compile of one `_pip_call` / `_fold_call` pair takes
about half a minute on the CPU, so the fast tier compiles exactly one pair
(secp256k1, affine, nbits = 8, n = 21, c = 4, bt = 128) and every fast
comparison reuses it through the reference's `lru_cache`; the comparisons
that need another pair are in the slow tier."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porla_tpu.curves import pallas_curve as pc
from porla_tpu.curves import pallas_msm
from porla_tpu.curves.instances import bn254 as jbn254
from porla_tpu.curves.instances import secp256k1 as jsecp
from porla_tpu.curves.weierstrass import JacPoint as JJacPoint
from porla_tpu.fields import limbs as JL
from porla_tpu.golden import ecc
from porla_tpu.ntt import mxu
from porla_tpu_torch.curves import cuda_msm as cm
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs as L

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

SEED = 4321
slow = pytest.mark.slow


@pytest.fixture
def blind_seed(monkeypatch):
    """Both packages draw their blinding scalars from the same seed."""
    monkeypatch.setenv("PORLA_MSM_BLIND_SEED", str(SEED))
    pallas_msm._blinding.cache_clear()
    yield SEED
    pallas_msm._blinding.cache_clear()


def _limbs(digits):
    """(…, 32, B) Montgomery byte-digit tiles -> (…, B, 16) limbs."""
    return np.asarray(mxu.limbs_from_digits(
        np, np.moveaxis(np.asarray(digits).astype(np.uint32), -2, -1)))


def _inputs(cur, nbits, n):
    rng = random.Random(99)
    pts = [ecc.mul(cur, cur.g, rng.randrange(1, cur.n)) for _ in range(n)]
    top = (1 << nbits) - 1
    sc = [rng.getrandbits(nbits) for _ in range(n - 3)] + [0, top // 15, top]
    return pts, sc


# --- policy, digits, blinding (no Pallas kernel involved) -------------------

def test_policy_matches_reference(monkeypatch):
    monkeypatch.delenv("PORLA_MSM_C", raising=False)
    for nbits in (8, 32, 64, 128, 252, 254, 255, 256):
        for c in range(2, 9):
            assert cm._nwin_for(nbits, c) == pallas_msm._nwin_for(nbits, c)
        for n in (1, 300, 4096, (1 << 15) - 1, 1 << 15, 1 << 16, 1 << 20):
            assert cm.choose_c(n, nbits) == pallas_msm.choose_c(n, nbits)


@pytest.mark.parametrize("c,nbits,tight", [
    (4, 256, False), (7, 256, False), (7, 256, True), (8, 256, False),
    (8, 254, False), (8, 254, True)])
def test_signed_digits_match_prep_fn(c, nbits, tight):
    """Element for element the reference's packed digits, adversarial
    scalars included, with an infinity lane and a padding lane."""
    nb = 1 << (c - 1)
    rng = random.Random(c + nbits)
    top = (1 << nbits) - 1
    n = jsecp().curve.n
    sc = [0, 1, nb, nb + 1, top, (n - 1) & top, int("80" * 32, 16) & top,
          int("7f" * 32, 16) & top]
    sc += [rng.getrandbits(nbits) for _ in range(6)] + [top, 0]
    npad = bt = 16
    z = np.ones((npad, 16), np.uint32)
    z[14] = 0                   # infinity lane with a nonzero scalar
    z[15] = 0                   # padding lane
    W = -(-nbits // c)
    nwin = W if tight else W + 1
    prep = pallas_msm._prep_fn(npad, 1, bt, c, nwin, True, tight)
    _, _, want = prep(z, z, z, JL.ints_to_limbs(sc))
    got = cm.signed_digits(L.ints_to_tensor(sc), L.to_torch(z), c, nwin,
                           tight)
    assert np.array_equal(got.numpy(), np.asarray(want)[:, 0, :])
    assert not got[:, 14:].any()


@pytest.mark.parametrize("curve,nb", [("secp256k1", 8), ("secp256k1", 64),
                                      ("bn254", 128)])
def test_blinding_matches_reference(blind_seed, curve, nb):
    ops, jops = (secp256k1(), jsecp()) if curve == "secp256k1" \
        else (bn254(), jbn254())
    dx, dy, tsum = pallas_msm._blinding(jops, nb)
    mine = cm.blinding(ops, nb, blind_seed)
    assert mine.tsum == tsum
    assert np.array_equal(L.to_numpy(mine.x), _limbs(dx)[:, 0])
    assert np.array_equal(L.to_numpy(mine.y), _limbs(dy)[:, 0])
    # without a seed the scalars are secret and differ from the seeded ones
    assert cm.blinding(ops, nb).tsum != tsum


# --- the kernels' plain versions against the Pallas kernels -----------------

def _affine_buckets(jops, sx, sy, sz):
    """Reference bucket state (nwin, nb, 32, bt) byte digits -> affine."""
    shape = np.asarray(sx).shape
    pts = jops.to_affine(JJacPoint(*(_limbs(c).reshape(-1, 16)
                                     for c in (sx, sy, sz))))
    return pts, (shape[0], shape[1], shape[3])


def _compare_kernels(ops, jops, pts, sc, nbits, c, bt, affine, seed,
                     jac_lam=None, windows=False):
    """K5's and K6's plain versions against `_pip_call` / `_fold_call` in
    interpret mode on the same padded operands: every bucket and every
    folded lane is the same affine point; with `windows`, every window
    total of `fold_windows` against `_fold_call` then `_reduce_fn`."""
    nb = 1 << (c - 1)
    nwin, tight = pallas_msm._nwin_for(nbits, c)
    steps = -(-len(pts) // bt)
    npad = steps * bt
    if jac_lam is None:
        jp = jops.from_affine(np, pts)
    else:
        p, m = jops.curve.p, jops.fp.to_mont_int
        lam = jac_lam
        jp = JJacPoint(
            JL.ints_to_limbs([m(x * lam * lam % p) for x, _ in pts]),
            JL.ints_to_limbs([m(y * pow(lam, 3, p) % p) for _, y in pts]),
            JL.ints_to_limbs([m(lam)] * len(pts)))

    def pad(a):
        a = np.asarray(a, np.uint32)
        return np.concatenate([a, np.zeros((npad - len(a), 16), np.uint32)])

    x, y, z, s = pad(jp.x), pad(jp.y), pad(jp.z), pad(JL.ints_to_limbs(sc))
    friendly = pc._mont_friendly(jops.fp)
    tabs = [jnp.asarray(t) for t in pc._curve_tables2(jops.fp)]
    dx, dy, _ = pallas_msm._blinding(jops, nb)
    prepped = pallas_msm._prep_fn(npad, steps, bt, c, nwin, affine, tight)(
        x, y, z, s)
    ref_state = pallas_msm._pip_call(nwin, steps, bt, nb, affine, False,
                                     friendly, True)(*prepped, dx, dy, *tabs)
    ref_fold = pallas_msm._fold_call(nwin, bt, nb, friendly, True)(
        *ref_state, *tabs)

    P = JacPoint(L.to_torch(x), L.to_torch(y), L.to_torch(z))
    digits = cm.signed_digits(L.to_torch(s), P.z, c, nwin, tight)
    blind = cm.blinding(ops, nb, seed)
    state = cm.pip_bucket(ops, P, digits, blind, bt, affine)
    if windows:
        # K6 with its lane sum against the reference's fold followed by its
        # own lane reduction: the same window totals
        red = pallas_msm._reduce_fn(jops, nwin, bt)(
            *(jnp.asarray(_limbs(t)) for t in ref_fold))
        want_w = jops.to_affine(JJacPoint(*(np.asarray(t) for t in red)))
        assert ops.to_affine(cm.fold_windows(ops, state)) == want_w
        return
    folded = cm.bucket_fold(ops, state)

    want, shape = _affine_buckets(jops, *ref_state)
    b = cm.unpack_state(state)
    assert tuple(b.x.shape[:3]) == shape
    got = ops.to_affine(JacPoint(*(t.reshape(-1, 16) for t in b)))
    assert got == want
    want_f = jops.to_affine(JJacPoint(*(_limbs(t).reshape(-1, 16)
                                        for t in ref_fold)))
    got_f = ops.to_affine(JacPoint(*(t.reshape(-1, 16) for t in folded)))
    assert got_f == want_f


def _compare_msm(ops, jops, pts, sc, nbits, seed, **kw):
    """The whole MSM: the same limbs out of both packages."""
    want = pallas_msm.pippenger_msm(jops, jops.from_affine(np, pts),
                                    JL.ints_to_limbs(sc), nbits=nbits,
                                    interpret=True, **kw)
    got = cm.pippenger_msm(ops, ops.from_affine(pts), L.ints_to_tensor(sc),
                           nbits=nbits, blind_seed=seed, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(L.to_numpy(g), np.asarray(w))
    assert ops.to_affine(got)[0] == ecc.msm(ops.curve, pts, sc)


def test_plain_kernels_match_pallas_interpret(blind_seed):
    pts, sc = _inputs(jsecp().curve, 8, 21)
    _compare_kernels(secp256k1(), jsecp(), pts, sc, 8, 4, 128, True,
                     blind_seed)


def test_fold_windows_matches_fold_call_and_reduce_fn(blind_seed):
    """Same call shape as the test above: reuses its compiled pair."""
    pts, sc = _inputs(jsecp().curve, 8, 21)
    _compare_kernels(secp256k1(), jsecp(), pts, sc, 8, 4, 128, True,
                     blind_seed, windows=True)


def test_pippenger_msm_matches_reference(blind_seed):
    """Same call shape as the test above: reuses its compiled pair."""
    pts, sc = _inputs(jsecp().curve, 8, 21)
    _compare_msm(secp256k1(), jsecp(), pts, sc, 8, blind_seed)


@slow
def test_plain_kernels_match_pallas_interpret_jacobian(blind_seed):
    pts, sc = _inputs(jsecp().curve, 8, 21)
    _compare_kernels(secp256k1(), jsecp(), pts, sc, 8, 4, 128, False,
                     blind_seed, jac_lam=7)


@slow
def test_plain_kernels_match_pallas_interpret_bn254(blind_seed):
    pts, sc = _inputs(jbn254().curve, 8, 9)
    _compare_kernels(bn254(), jbn254(), pts, sc, 8, 4, 128, True, blind_seed)
    _compare_msm(bn254(), jbn254(), pts, sc, 8, blind_seed)


@slow
def test_pippenger_msm_matches_reference_non_pow2(blind_seed):
    pts, sc = _inputs(jsecp().curve, 8, 300)
    _compare_msm(secp256k1(), jsecp(), pts, sc, 8, blind_seed)
