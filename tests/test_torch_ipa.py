"""Port mirror of tests/test_ipa.py: the Bulletproof inner-product argument
of porla_tpu_torch/commit/ipa.py on the CPU (K4's plain version), which
every audit over the wire ends in (the client's `ipa.verify`).

The same numpy-seeded vectors go into both packages: a (128 chunks of 248
bits) and b (the powers v, v^2, v^4, ... mod q of a 31-bit v). The
commitment sum a_i G_i comes from the reference package's golden model
(`porla_tpu.golden.ecc`, host integers), not from the port.

- The port's proof is 556 bytes (Server.hpp:856) and its `verify` accepts
  it against that commitment.
- The proof is byte for byte the one the golden prover builds on the same
  inputs in host integers (`porla_tpu_torch.golden.ipa`, each round's
  L = msm_l + cL u point by point in `golden/ecc.py`; the reference
  package's affine golden model would take over a minute a proof), also
  where the first round's cL is 0, so that u's lane of the round's K4
  launch holds the point at infinity; `verify` accepts that proof too.
- `verify` refuses a wrong commitment (a_17 + 1: the commitment plus G_17)
  and a proof with one bit flipped in its inner product, in L of rounds 1, 3
  and 6 (a bit of x, or the sign byte, which negates the point), in R of
  round 6, or in b1 (its lowest and its highest byte).
- The transcript is hashed on the native runtime: with the plain SHA-256
  compression (`crypto.shas._compress`) made to refuse, a prove and a
  verify still give and accept the same proof, and the trace counts 14
  compressed blocks a side (`sha256.blocks`). The golden prover hashes
  with that plain version, so the comparison above sets the two routes
  against each other.
- Slow tier: the port's proof is byte for byte `porla_tpu.commit.ipa.prove`'s
  on the same inputs (its MSMs compile), and the reference's `verify`
  accepts it.
"""

import numpy as np
import pytest
import torch

from porla_tpu.golden import ecc as ref_ecc
from porla_tpu_torch.commit import ipa, pedersen
from porla_tpu_torch.config import NUM_CHUNKS
from porla_tpu_torch.crypto import shas
from porla_tpu_torch.golden import ipa as golden_ipa
from porla_tpu_torch.utils import trace

torch.set_num_threads(1)     # small tensors; xdist runs files side by side
Q = ipa.Q


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1234)
    a = [int.from_bytes(rng.bytes(31), "little") for _ in range(NUM_CHUNKS)]
    x = int(rng.integers(1, 1 << 31))
    b = []
    for _ in range(NUM_CHUNKS):
        b.append(x)
        x = x * x % Q
    affine, u = pedersen.ipa_generators()
    key = ipa.IpaKey(affine, u, "cpu")
    cv = ref_ecc.SECP256K1
    commitment = None
    for g, s in zip(affine, a):
        commitment = ref_ecc.add(cv, commitment, ref_ecc.mul(cv, g, s % Q))
    proof = ipa.prove(a, b, key)
    return dict(a=a, b=b, key=key, u=u, affine=affine,
                commitment=commitment, proof=proof)


@pytest.fixture(scope="module")
def zero_case(case):
    """The case with a_0 chosen so that the first round's cL =
    sum(a_i b_(64+i)) is 0 mod q, while its L (the MSM over a_0..a_63)
    is not."""
    a, b = list(case["a"]), case["b"]
    half = NUM_CHUNKS // 2
    rest = sum(a[i] * b[half + i] for i in range(1, half))
    a[0] = -rest * pow(b[half], -1, Q) % Q
    assert sum(a[i] * b[half + i] for i in range(half)) % Q == 0
    cv = ref_ecc.SECP256K1
    commitment = ref_ecc.add(cv, case["commitment"], ref_ecc.mul(
        cv, case["affine"][0], (a[0] - case["a"][0]) % Q))
    proof = ipa.prove(a, b, case["key"])
    return dict(case, a=a, commitment=commitment, proof=proof)


def test_prove_verify_roundtrip(case):
    assert len(case["proof"]) == 32 + 6 * (33 + 33) + 4 * 32 == 556
    ipa.verify(case["commitment"], case["proof"], case["key"])


def test_verify_rejects_wrong_commitment(case):
    cv = ref_ecc.SECP256K1
    wrong = ref_ecc.add(cv, case["commitment"], case["affine"][17])
    with pytest.raises(ipa.IpaVerificationError):
        ipa.verify(wrong, case["proof"], case["key"])


# byte offsets: ip 0-31; round r's L at 32 + 66 (r - 1), its R 33 after;
# a0 428, b0 460, a1 492, b1 524-555
@pytest.mark.parametrize(
    "byte", [3, 40, 555, 32, 164, 362, 370, 395, 524],
    ids=["inner_product", "first_L", "last_scalar", "L_round1_sign",
         "L_round3_sign", "L_round6_sign", "L_round6", "R_round6_sign",
         "b1_low"])
def test_verify_rejects_tampered_proof(case, byte):
    proof = bytearray(case["proof"])
    proof[byte] ^= 1
    with pytest.raises((ipa.IpaVerificationError, ValueError)):
        ipa.verify(case["commitment"], bytes(proof), case["key"])


@pytest.mark.parametrize("which", ["case", "zero_case"])
def test_proof_matches_golden_model(request, which):
    c = request.getfixturevalue(which)
    assert c["proof"] == golden_ipa.prove(c["a"], c["b"], c["affine"],
                                          c["u"])


def test_u_lane_zero_roundtrip(zero_case):
    ipa.verify(zero_case["commitment"], zero_case["proof"], zero_case["key"])


def test_transcript_compresses_no_block_in_python(case, monkeypatch):
    def refuse(*args):
        raise AssertionError("a Python SHA-256 compression on the IPA's path")
    monkeypatch.setattr(shas, "_compress", refuse)

    def blocks():
        return sum(v["count"] for k, v in trace.summary().items()
                   if k.endswith("sha256.blocks"))
    trace.reset()
    trace.enable(True)
    try:
        proof = ipa.prove(case["a"], case["b"], case["key"])
        proved = blocks()
        ipa.verify(case["commitment"], proof, case["key"])
        both = blocks()
    finally:
        trace.enable(False)
        trace.reset()
    assert proof == case["proof"]
    assert (proved, both) == (14, 28)


@pytest.mark.slow
def test_proof_matches_reference(case):
    from porla_tpu.commit import ipa as ref_ipa
    from porla_tpu.commit import pedersen as ref_pedersen
    gens, u, _ = ref_pedersen.ipa_generators()
    assert ref_ipa.prove(case["a"], case["b"], gens, u) == case["proof"]
    ref_ipa.verify(case["commitment"], case["proof"], gens, u)
