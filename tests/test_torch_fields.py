"""Port field arithmetic (porla_tpu_torch.fields.mont, plain torch, int64
limb carriers) vs the reference package's numpy twin
(porla_tpu.fields.mont with xp=numpy) and exact Python ints.

All arithmetic is integer: the tolerance is zero (bit-exact limbs)."""

import random

import numpy as np
import pytest
import torch

from porla_tpu.fields import constants as C
from porla_tpu.fields import limbs as JL
from porla_tpu.fields import mont as JM
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont as M

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

MODULI = {"fft_p": C.FFT_PRIME, "secp_n": C.SECP_N, "secp_p": C.SECP_P,
          "bn254_p": C.BN254_P, "bn254_r": C.BN254_R}


def _operands(n, rng, count=300):
    a = [rng.randrange(n) for _ in range(count)]
    b = [rng.randrange(n) for _ in range(count)]
    # edge lanes: zero, n-1, one, equal operands
    a[:5] = [0, n - 1, 1, n - 1, 12345]
    b[:5] = [0, n - 1, n - 1, 0, 12345]
    raw = [rng.getrandbits(256) for _ in range(count)]
    raw[:2] = [(1 << 256) - 1, 0]
    return JL.ints_to_limbs(a), JL.ints_to_limbs(b), JL.ints_to_limbs(raw)


# 300 lanes take mont's outer-product column sums, 600 its shifted rows
@pytest.mark.parametrize("count", [300, 600])
@pytest.mark.parametrize("name", sorted(MODULI))
def test_binary_ops_match_reference(name, count):
    n = MODULI[name]
    rng = random.Random(hash(name) & 0xFFFF)
    jm, tm = JM.Modulus(n), M.Modulus(n)
    A, B, RAW = _operands(n, rng, count)
    ta, tb, traw = (L.to_torch(x) for x in (A, B, RAW))
    for op in ("mont_mul", "add_mod", "sub_mod"):
        want = getattr(JM, op)(np, A, B, jm)
        got = L.to_numpy(getattr(M, op)(ta, tb, tm))
        assert np.array_equal(want, got), op
    # one operand any 256-bit value (the documented mont_mul contract)
    assert np.array_equal(JM.mont_mul(np, RAW, B, jm),
                          L.to_numpy(M.mont_mul(traw, tb, tm)))


@pytest.mark.parametrize("name", sorted(MODULI))
def test_unary_ops_match_reference(name):
    n = MODULI[name]
    rng = random.Random(7 + (hash(name) & 0xFF))
    jm, tm = JM.Modulus(n), M.Modulus(n)
    A, _, RAW = _operands(n, rng)
    ta, traw = L.to_torch(A), L.to_torch(RAW)
    for op, x, tx in (("neg_mod", A, ta), ("to_mont", A, ta),
                      ("from_mont", A, ta), ("mod_reduce", RAW, traw)):
        assert np.array_equal(getattr(JM, op)(np, x, jm),
                              L.to_numpy(getattr(M, op)(tx, tm))), op


def test_exact_ints_and_broadcast():
    n = C.SECP_P
    tm = M.Modulus(n)
    rng = random.Random(3)
    a = [rng.randrange(n) for _ in range(40)]
    b = rng.randrange(n)
    got = L.tensor_to_ints(M.mont_mul(L.ints_to_tensor(a),
                                      L.ints_to_tensor([b])[0], tm))
    rinv = pow(1 << 256, -1, n)
    assert got == [x * b * rinv % n for x in a]
    # batched (…, 16) shapes keep their leading axes
    t = L.ints_to_tensor(a).reshape(4, 10, 16)
    assert M.add_mod(t, t, tm).shape == (4, 10, 16)


def test_limb_codecs_roundtrip():
    rng = random.Random(11)
    vals = [rng.getrandbits(256) for _ in range(50)] + [0, (1 << 256) - 1]
    t = L.ints_to_tensor(vals)
    assert t.dtype == torch.int64 and t.shape == (52, 16)
    assert L.tensor_to_ints(t) == vals
    assert np.array_equal(L.to_numpy(t), JL.ints_to_limbs(vals))


def test_kernel_modulus_words():
    """The CIOS constants handed to the CUDA kernels."""
    for n in MODULI.values():
        w = M.Modulus(n).words32()
        assert sum(v << (32 * i) for i, v in enumerate(w[:8])) == n
        assert (w[8] * n) % (1 << 32) == (1 << 32) - 1   # -n^-1 mod 2^32
