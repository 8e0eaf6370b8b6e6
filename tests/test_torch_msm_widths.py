"""The port's Pippenger MSM (`curves/cuda_msm.py`) on the CPU across lane
widths and at the window shapes of the two curves' 2^20-point runs, against
the exact golden model. The plain versions' cost grows with windows x lanes
x buckets, so the widths run at c = 4 on 8-bit scalars and the production
windows (c = 7 at 256 bits; c = 8 at 254 bits in the tight form and in the
carry-window form) at 16 lanes. All integer arithmetic; tolerance zero.
Inputs come from `random.Random` seeds."""

import random

import pytest
import torch

from porla_tpu_torch import native
from porla_tpu_torch.curves import cuda_msm as cm
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.golden import ecc

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

SEED = 1234


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


def _tiled(ops, n, nbits, seed, nbases=8):
    """n lanes over tiled bases, scalars below 2^nbits with a zero and the
    all-ones scalar, and the exact MSM."""
    rng = random.Random(seed)
    cur = ops.curve
    bases = [ecc.mul(cur, cur.g, rng.randrange(1, cur.n))
             for _ in range(nbases)]
    sc = [rng.getrandbits(nbits) for _ in range(n)]
    sc[1], sc[2] = 0, (1 << nbits) - 1
    want = ecc.INF
    for g, b in enumerate(bases):
        want = ecc.add(cur, want, ecc.mul(cur, b, sum(sc[g::nbases])))
    ph = ops.from_affine(bases)
    reps = -(-n // nbases)
    pts = JacPoint(*(c.repeat(reps, 1)[:n] for c in ph))
    return pts, sc, want


@pytest.mark.parametrize("bt", [128, 256, cm.DEFAULT_BT])
def test_pippenger_msm_lane_widths(bt, monkeypatch):
    """Two steps and a ragged tail at every lane width the entry point
    takes at large N, the default included."""
    ops = secp256k1()
    n = bt + 5
    pts, sc, want = _tiled(ops, n, 8, bt)
    seen = []
    real = cm.pip_bucket
    monkeypatch.setattr(cm, "pip_bucket",
                        lambda *a, **k: seen.append(a[4]) or real(*a, **k))
    out = cm.pippenger_msm(ops, pts, L.ints_to_tensor(sc), nbits=8, bt=bt)
    assert seen == [bt]
    assert ops.to_affine(out)[0] == want


@pytest.mark.parametrize("curve,c,nbits,tight", [
    ("secp256k1", 7, 256, True),     # 37 windows
    ("bn254", 8, 254, True),         # 32 windows, the top one unsigned
    ("bn254", 8, 254, False),        # 33 windows, the top one the carry
], ids=["c7_256", "c8_254_tight", "c8_254_carry"])
def test_production_windows_vs_golden(curve, c, nbits, tight):
    """The tight form through `pippenger_msm`, which picks it; the
    carry-window form, which can only be asked for piece by piece, as
    digits -> K5 -> K6 -> Horner by hand. 40 points over 16 lanes."""
    ops = secp256k1() if curve == "secp256k1" else bn254()
    bt, n = 16, 40
    pts, sc, want = _tiled(ops, n, nbits, c * nbits)
    W = -(-nbits // c)
    assert cm._nwin_for(nbits, c) == (W, True)
    if tight:
        out = cm.pippenger_msm(ops, pts, L.ints_to_tensor(sc), nbits=nbits,
                               bt=bt, c=c, blind_seed=SEED)
        assert ops.to_affine(out)[0] == want
        return
    npad = -(-n // bt) * bt
    p = JacPoint(*(cm._pad_rows(t, npad) for t in pts))
    s = cm._pad_rows(L.ints_to_tensor(sc), npad)
    digits = cm.signed_digits(s, p.z, c, W + 1, False)
    blind = cm.blinding(ops, 1 << (c - 1), SEED)
    state = cm.pip_bucket(ops, p, digits, blind, bt, True)
    assert state.shape == (W + 1, 1 << (c - 1), bt, 3, 8)
    wins = cm.fold_windows(ops, state)
    assert cm.horner(ops, ops.to_affine(wins), c, bt, blind.tsum) == want
