"""The port's KZG commitments (`porla_tpu_torch/commit/kzg.py`) and its copy
of the BN254 pairing against the reference package on the CPU: the SRS
bytes for one tau, `commit_msm` (K4's plain version over the SRS table),
`commit_eval`, `open_at` and `verify` on the same seeded inputs, and the
pairing's values and bilinearity. Tolerance: zero (equal bytes, equal
affine points, equal Fp12 elements). The reference's `commit_msm` compiles
one XLA MSM on its first call (about 15 s)."""

import random

import pytest
import torch

from porla_tpu.commit import kzg as jkzg
from porla_tpu.golden import bn254_pairing as jbp
from porla_tpu_torch import native
from porla_tpu_torch.commit import kzg
from porla_tpu_torch.fields.constants import BN254_R as FR
from porla_tpu_torch.golden import bn254_pairing as bp
from porla_tpu_torch.golden import ecc

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

TAU = int.from_bytes(bytes(range(16)), "big")
SIZE = 8


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


@pytest.fixture(scope="module")
def srs_pair():
    return kzg.KzgSrs.from_tau(TAU, SIZE), jkzg.KzgSrs.from_tau(TAU, SIZE)


def _coeffs(seed, k=SIZE):
    """k coefficients with the edges 0, 1, r - 1, r + 5 and 2^256 - 1 (the
    last two reduce mod r) first."""
    rng = random.Random(seed)
    edges = [0, 1, FR - 1, FR + 5, (1 << 256) - 1]
    return (edges + [rng.getrandbits(256) for _ in range(k)])[:k]


def test_srs_bytes_match_reference(srs_pair):
    srs, ref = srs_pair
    wire = srs.to_bytes()
    assert wire == ref.to_bytes()
    assert len(wire) == 4 + 64 * SIZE + 128
    back = kzg.KzgSrs.from_bytes(wire)
    assert back.g1_powers == srs.g1_powers and back.g2_tau == srs.g2_tau
    assert back.to_bytes() == wire
    assert srs.g1_powers[1] == ecc.mul(ecc.BN254, bp.G1, TAU % FR)


@pytest.mark.parametrize("k,seed", [(SIZE, 1), (5, 2)])
def test_commit_msm_matches_reference(srs_pair, k, seed):
    """k <= SIZE coefficients (the rest padded with zeros): the port's
    commit_msm equals the reference's and [f(tau)]G1."""
    srs, ref = srs_pair
    coeffs = _coeffs(seed, k)
    got = kzg.commit_msm(srs, coeffs, device="cpu")
    assert got == jkzg.commit_msm(ref, coeffs)
    assert got == kzg.commit_eval(TAU, 1, coeffs)
    assert kzg.commit_eval(TAU, 1, coeffs) == jkzg.commit_eval(TAU, 1, coeffs)
    alpha = random.Random(seed).randrange(FR)
    assert kzg.commit_eval(TAU, alpha, coeffs) == \
        jkzg.commit_eval(TAU, alpha, coeffs)


@pytest.mark.parametrize("z", [424242, (1 << 64) - 5])
def test_open_at_matches_reference(srs_pair, z):
    """(H, claimed) of the reference at a small z and at a wrapped negative
    challenge (a C int through a Go uint64)."""
    srs, ref = srs_pair
    coeffs = _coeffs(3)
    H, claimed = kzg.open_at(srs, coeffs, z, device="cpu")
    assert (H, claimed) == jkzg.open_at(ref, coeffs, z)
    assert claimed == kzg.poly_eval(coeffs, z) == jkzg.poly_eval(coeffs, z)


def test_verify_agrees_with_reference(srs_pair):
    """A good opening verifies in both packages; a wrong claimed value is
    refused by both."""
    srs, ref = srs_pair
    coeffs = _coeffs(4)
    z = 99991
    C = kzg.commit_msm(srs, coeffs, device="cpu")
    H, claimed = kzg.open_at(srs, coeffs, z, device="cpu")
    for c in (claimed, (claimed + 1) % FR):
        want = c == claimed
        assert kzg.verify(srs, C, H, z, c) is want
        assert jkzg.verify(ref, C, H, z, c) is want


def test_pairing_matches_reference():
    """The copy's pairing gives the reference's Fp12 element and is
    bilinear and non-degenerate."""
    e1 = bp.pairing(bp.G2, bp.G1)
    assert e1 == jbp.pairing(jbp.G2, jbp.G1)
    assert e1 != bp.FP12_ONE and bp.fp12_pow(e1, bp.R) == bp.FP12_ONE
    a, b = 31337, 271828
    lhs = bp.pairing(bp.g2_mul(bp.G2, b), ecc.mul(ecc.BN254, bp.G1, a))
    assert lhs == bp.fp12_pow(e1, a * b % bp.R)
    assert bp.g2_mul(bp.G2, b) == jbp.g2_mul(jbp.G2, b)
