"""Port mirror of tests/test_ipa.py: the Bulletproof inner-product argument
of porla_tpu_torch/commit/ipa.py on the CPU (K4's plain version), which
every audit over the wire ends in (the client's `ipa.verify`).

The same numpy-seeded vectors go into both packages: a (128 chunks of 248
bits) and b (the powers v, v^2, v^4, ... mod q of a 31-bit v). The
commitment sum a_i G_i comes from the reference package's golden model
(`porla_tpu.golden.ecc`, host integers), not from the port.

- The port's proof is 556 bytes (Server.hpp:856) and its `verify` accepts
  it against that commitment.
- `verify` refuses a wrong commitment (a_17 + 1: the commitment plus G_17)
  and a proof with one bit flipped in its inner product, its first L point
  or its last scalar.
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
    gens, u, affine = pedersen.ipa_generators()
    cv = ref_ecc.SECP256K1
    commitment = None
    for g, s in zip(affine, a):
        commitment = ref_ecc.add(cv, commitment, ref_ecc.mul(cv, g, s % Q))
    proof = ipa.prove(a, b, gens, u)
    return dict(a=a, b=b, gens=gens, u=u, affine=affine,
                commitment=commitment, proof=proof)


def test_prove_verify_roundtrip(case):
    assert len(case["proof"]) == 32 + 6 * (33 + 33) + 4 * 32 == 556
    ipa.verify(case["commitment"], case["proof"], case["gens"], case["u"])


def test_verify_rejects_wrong_commitment(case):
    cv = ref_ecc.SECP256K1
    wrong = ref_ecc.add(cv, case["commitment"], case["affine"][17])
    with pytest.raises(ipa.IpaVerificationError):
        ipa.verify(wrong, case["proof"], case["gens"], case["u"])


@pytest.mark.parametrize("byte", [3, 40, 555],
                         ids=["inner_product", "first_L", "last_scalar"])
def test_verify_rejects_tampered_proof(case, byte):
    proof = bytearray(case["proof"])
    proof[byte] ^= 1
    with pytest.raises((ipa.IpaVerificationError, ValueError)):
        ipa.verify(case["commitment"], bytes(proof), case["gens"], case["u"])


@pytest.mark.slow
def test_proof_matches_reference(case):
    from porla_tpu.commit import ipa as ref_ipa
    from porla_tpu.commit import pedersen as ref_pedersen
    gens, u, _ = ref_pedersen.ipa_generators()
    assert ref_ipa.prove(case["a"], case["b"], gens, u) == case["proof"]
    ref_ipa.verify(case["commitment"], case["proof"], gens, u)
