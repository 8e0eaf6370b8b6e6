"""Curve-op dispatch for the protocol layer.

`msm` carries the Pippenger crossover, as the reference's `kernels.msm`
does: a batch of `PIPPENGER_CROSSOVER` or more points goes to
`cuda_msm.pippenger_msm` (K5 `pip_bucket` + K6 `bucket_fold`), a smaller one
to K2 (`cuda_curve.scalar_mul`) plus `cuda_curve.group_sum` (the
reference's `tree_sum`, one launch on the card). `msm_parts` is the
server's stacked audit route and has no crossover, as the reference
server's has none. The same rules hold on the CPU and on the card; CPU
tensors run the plain versions. The reference package's jit/executable
caches and its host-fetch batching have no counterpart here: PyTorch runs
eagerly and tensors stay on their device.
"""

from __future__ import annotations

from porla_tpu_torch.curves import cuda_curve, cuda_msm
from porla_tpu_torch.curves.weierstrass import CurveOps, JacPoint, index

# At or above this point count a variable-base MSM goes to the Pippenger
# bucket kernels: below it the per-window bucket fold does not amortize.
# The value is the reference package's (porla_tpu/curves/kernels.py:118),
# found on a TPU; it has not been re-measured on the H100.
PIPPENGER_CROSSOVER = 4096


def msm(ops: CurveOps, points: JacPoint, scalars,
        nbits: int = 256) -> JacPoint:
    """sum_i scalars[i] * points[i] over the leading axis -> (1,) point.
    Padded lanes (zero scalars, points at infinity) add the identity."""
    if points.x.dim() == 2 and points.x.shape[0] >= PIPPENGER_CROSSOVER:
        return cuda_msm.pippenger_msm(ops, points, scalars, nbits)
    return msm_parts(ops, points, scalars, 1, nbits)[0]


def msm_parts(ops: CurveOps, points: JacPoint, scalars, nparts: int,
              nbits: int = 256) -> list[JacPoint]:
    """`nparts` MSMs over equal contiguous slices of the leading axis, with
    one K2 launch for all of them and one `group_sum` call for their sums
    (each part summed as `ops.tree_sum` sums it) -> list of (1,) points. Any
    size: the server's audit stacks its MAC and alignment MSMs here."""
    n = points.x.shape[0]
    if n % nparts:
        raise ValueError(f"{n} lanes do not split into {nparts} parts")
    parts = cuda_curve.scalar_mul(ops, points, scalars, nbits)
    sums = cuda_curve.group_sum(ops, parts, nparts)
    return [index(sums, slice(i, i + 1)) for i in range(nparts)]
