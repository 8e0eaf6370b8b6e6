"""Pedersen vector commitments over secp256k1 (the IPA scheme's MACs).

A block commitment is the 128-point MSM sum_i chunk_i * G_i over the
deterministic generators (reference Client.hpp:374-421 /
Server.hpp:329-361). The generators never change within a run, so every
commitment rides K4 over per-window tables of the generators, one group of
NG lanes a block, summed inside the same launch; the table is the one its
owner holds (the server's `ipa.IpaKey.table`, the client's table of the
alpha generators). The KZG server's SRS commitments are the same MSM over
the SRS powers on BN254 (`commit_blocks` over `kzg.KzgSrs.table`).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from porla_tpu_torch.config import NUM_GENERATORS
from porla_tpu_torch.crypto import testrand
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs
from porla_tpu_torch.golden import ecc


def ipa_generators(num: int = NUM_GENERATORS):
    """(the generators as a list of affine points, the u point affine)."""
    return testrand.derive_ipa_generators(num)


@lru_cache(maxsize=None)
def alpha_generators(alpha: int, num: int = NUM_GENERATORS) -> list:
    """alpha*G_i (client side; Client.hpp:340-344), affine."""
    gens, _ = ipa_generators(num)
    return [ecc.mul(ecc.SECP256K1, g, alpha) for g in gens]


def commit_blocks(table: cuda_curve.FbTable,
                  scalars: torch.Tensor) -> JacPoint:
    """scalars: (B, NG, 16) standard-form chunk values -> JacPoint (B,) of
    commitments sum_i s_i * G_i over the bases of `table` (the IPA
    generators' on secp256k1, the KZG SRS's on BN254; NG of them, a power
    of two), on the scalars' device."""
    B, ng = scalars.shape[0], scalars.shape[1]
    if ng != table.ng:
        raise ValueError(f"{ng} scalars a block for a table of "
                         f"{table.ng} bases")
    return cuda_curve.fb_msm_groups(
        table, scalars.reshape(B * ng, limbs.NLIMBS).contiguous(), nout=B)
