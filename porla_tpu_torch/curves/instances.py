"""Shared curve-op instances (constructing a CurveOps precomputes Montgomery
constants; keep one per process)."""

from __future__ import annotations

from functools import lru_cache

from porla_tpu_torch.curves.weierstrass import CurveOps
from porla_tpu_torch.golden import ecc


@lru_cache(maxsize=None)
def secp256k1() -> CurveOps:
    return CurveOps(ecc.SECP256K1, "secp")


@lru_cache(maxsize=None)
def bn254() -> CurveOps:
    return CurveOps(ecc.BN254, "bn254")
