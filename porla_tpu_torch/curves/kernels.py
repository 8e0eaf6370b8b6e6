"""Curve-op dispatch for the protocol layer.

`msm` below the Pippenger crossover goes through K2 (`cuda_curve.
scalar_mul`) and a plain torch `tree_sum`; at or above it, a CUDA batch
raises, because the Pippenger kernels (`porla_tpu/curves/pallas_msm.py`)
are not ported yet. The reference package's jit/executable caches and its
host-fetch batching have no counterpart here: PyTorch runs eagerly and
tensors stay on their device.
"""

from __future__ import annotations

from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.weierstrass import CurveOps, JacPoint, index

# Above this point count the reference routes variable-base MSMs to its
# Pippenger bucket kernel (porla_tpu/curves/kernels.py:118-137).
PIPPENGER_CROSSOVER = 4096


def msm(ops: CurveOps, points: JacPoint, scalars,
        nbits: int = 256) -> JacPoint:
    """sum_i scalars[i] * points[i] over the leading axis -> (1,) point.
    Padded lanes (zero scalars, points at infinity) add the identity."""
    return msm_parts(ops, points, scalars, 1, nbits)[0]


def msm_parts(ops: CurveOps, points: JacPoint, scalars, nparts: int,
              nbits: int = 256) -> list[JacPoint]:
    """`nparts` MSMs over equal contiguous slices of the leading axis, with
    one K2 launch for all of them -> list of (1,) points."""
    n = points.x.shape[0]
    if n >= PIPPENGER_CROSSOVER and points.x.is_cuda:
        raise NotImplementedError("Pippenger not ported yet")
    assert n % nparts == 0
    parts = cuda_curve.scalar_mul(ops, points, scalars, nbits)
    k = n // nparts
    return [ops.tree_sum(index(parts, slice(i * k, (i + 1) * k)))
            for i in range(nparts)]
