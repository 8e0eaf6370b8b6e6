"""Pedersen vector commitments over secp256k1 (the IPA scheme's MACs).

A block commitment is the 128-point MSM sum_i chunk_i * G_i over the
deterministic generators (reference Client.hpp:374-421 /
Server.hpp:329-361). The generators never change within a run, so every
commitment rides K4 over per-window tables of the generators, one group of
NG lanes a block, summed inside the same launch. The KZG server's SRS
commitments are the same MSM over the SRS powers on BN254
(`commit_blocks` with `ops=bn254()`).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from porla_tpu_torch.config import NUM_GENERATORS
from porla_tpu_torch.crypto import testrand
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs
from porla_tpu_torch.golden import ecc


@lru_cache(maxsize=None)
def ipa_generators(num: int = NUM_GENERATORS):
    """(generators as host JacPoint (num,), u point affine, list of affine)."""
    gens, u = testrand.derive_ipa_generators(num)
    return secp256k1().from_affine(gens), u, gens


@lru_cache(maxsize=None)
def alpha_generators(alpha: int, num: int = NUM_GENERATORS):
    """alpha*G_i (client side; Client.hpp:340-344) as host JacPoint (num,)."""
    _, _, gens = ipa_generators(num)
    return secp256k1().from_affine(
        [ecc.mul(ecc.SECP256K1, g, alpha) for g in gens])


def commit_blocks(generators: JacPoint, scalars: torch.Tensor, ops,
                  nbits: int = 256) -> JacPoint:
    """scalars: (B, NG, 16) standard-form chunk values -> JacPoint (B,) of
    commitments sum_i s_i * G_i over `ops`'s curve (the IPA generators on
    secp256k1, the KZG SRS on BN254), on the scalars' device (NG a power
    of two)."""
    B, ng = scalars.shape[0], scalars.shape[1]
    tbl = cuda_curve.fb_table_for(
        ops, JacPoint(*(c[:ng] for c in generators)), nbits)
    return cuda_curve.fb_msm_groups(
        tbl, scalars.reshape(B * ng, limbs.NLIMBS).contiguous(), nout=B)
