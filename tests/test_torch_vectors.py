"""The port's host models and plain curve kernels against the pinned
reference-C vectors (tests/vectors/secp256k1_kat.json, produced from the
reference's vendored libsecp256k1; see tests/test_reference_vectors.py):
the test-RNG generator derivation, compressed serialization, single-point
scalar mults, the SHA-256 transcript quirk, and the n = 64
ecmult_multi_var result through the port's MSM (K2 plain version +
tree_sum) and through K4's plain version (fb_msm_groups)."""

import json
import os

import pytest
import torch

from porla_tpu_torch.crypto import testrand
from porla_tpu_torch.crypto.shas import Sha256
from porla_tpu_torch.curves import cuda_curve as cc
from porla_tpu_torch.curves import kernels as ck
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.golden import ecc

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

VEC = os.path.join(os.path.dirname(__file__), "vectors",
                   "secp256k1_kat.json")
CV = ecc.SECP256K1


@pytest.fixture(scope="module")
def kat():
    with open(VEC) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def gens():
    return testrand.derive_ipa_generators(128)[0]


def _pt(hexpair):
    return (int(hexpair[0], 16), int(hexpair[1], 16))


def test_generators_and_serialization(kat, gens):
    _, u = testrand.derive_ipa_generators(128)
    want = [_pt(g) for g in kat["generators"]]
    assert gens == want[:128] and u == want[128]
    assert testrand.derive_h_mac() == want[0]
    for i, c in enumerate(kat["compressed"]):
        assert ecc.secp_serialize_compressed(gens[i]).hex() == c
        assert ecc.secp_parse_compressed(bytes.fromhex(c)) == gens[i]


def test_single_point_mults(kat, gens):
    g = (CV.gx, CV.gy)
    for i, want in enumerate(kat["ecmult"]):
        na = (0x0123456789ABCDEF * (i + 1)) & ((1 << 64) - 1)
        ng = (0xFEDCBA9876543210 * (i + 1)) & ((1 << 64) - 1)
        assert ecc.add(CV, ecc.mul(CV, gens[i], na),
                       ecc.mul(CV, g, ng)) == _pt(want)
    for i, want in enumerate(kat["ecmult_const"]):
        k = (0x1111111111111111 * (i + 1)) & ((1 << 64) - 1)
        assert ecc.mul(CV, gens[i], k) == _pt(want)


def test_sha_transcript_quirk(kat):
    sha = Sha256()
    sha.write(bytes([0xAA] * 32)).write(bytes([0x55] * 32))
    out1 = sha.finalize()
    sha.write(out1).write(bytes([0x55] * 32))
    out2 = sha.finalize()
    sha.write(out2)
    out3 = sha.finalize()
    assert [out1.hex(), out2.hex(), out3.hex()] == kat["sha_transcript"]


@pytest.mark.parametrize("route", ["msm", "fb_msm_groups"])
def test_ecmult_multi_through_plain_kernels(kat, gens, route):
    case = kat["ecmult_multi"][0]            # n = 64
    n = case["n"]
    sc = L.ints_to_tensor([((i + 1) * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
                           for i in range(n)])
    ops = secp256k1()
    if route == "msm":
        pts = ops.from_affine([gens[i % 128] for i in range(n)])
        out = ck.msm(ops, pts, sc, nbits=64)
    else:
        tbl = cc.build_fb_table(ops, gens[:n], nbits=64)
        out = cc.fb_msm_groups(tbl, sc, nout=1)
    assert ops.to_affine(out)[0] == _pt(case["result"])
