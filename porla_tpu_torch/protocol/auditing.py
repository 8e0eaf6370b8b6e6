"""Shared audit challenge derivation.

Both parties expand the 16-byte audit seed into the same int32 stream and
walk it with identical sampling logic (reference Client.hpp:682-744 /
Server.hpp:596-732); any divergence breaks the MAC equation, so the plan
lives in one place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from porla_tpu_torch.config import NUM_CHECK_AUDIT
from porla_tpu_torch.crypto.aes import Prg


@dataclass
class AuditSample:
    level: int
    is_x: bool
    index: int   # index within the X or Y array of the level
    coeff: int   # |int32| (0x80000000 for INT32_MIN, matching C casts)


@dataclass
class AuditPlan:
    samples: list
    n_points: int
    ipa_challenge: int  # signed int32 audit_values[n_points] (Server.hpp:861)
    kzg_challenge: int  # signed int32 audit_values[consumed] — the KZG
    #                     build reads *audit_values_ptr (Server.hpp:907)


def expand_audit_values(seed: bytes, height: int) -> np.ndarray:
    prg = Prg(seed, 0)
    return prg.random_ints((NUM_CHECK_AUDIT << 1) * height)


def _abs_i32(v: int) -> int:
    # C abs() then implicit conversion to unsigned; INT32_MIN stays 2^31
    return abs(int(v)) & 0xFFFFFFFF


def occupied_levels(write_step: int, num_blocks: int, height: int):
    return [i for i in range(height)
            if ((write_step % num_blocks) >> i) & 1 or i == height - 1]


def build_audit_plan(seed: bytes, write_step: int, num_blocks: int,
                     height: int) -> AuditPlan:
    audit_values = expand_audit_values(seed, height)
    ptr = 0
    samples = []
    n_points = 0
    occ = set(occupied_levels(write_step, num_blocks, height))
    for i in range(height):
        l = 1 << i
        if i in occ:
            if (l << 1) > NUM_CHECK_AUDIT:
                indices = audit_values[ptr:ptr + NUM_CHECK_AUDIT]
                coeffs = audit_values[ptr + NUM_CHECK_AUDIT:
                                      ptr + 2 * NUM_CHECK_AUDIT]
                ptr += NUM_CHECK_AUDIT << 1
                for j in range(NUM_CHECK_AUDIT):
                    index = _abs_i32(indices[j]) % (l << 1)
                    coeff = _abs_i32(coeffs[j])
                    if index >= l:
                        samples.append(AuditSample(i, False, index - l, coeff))
                    else:
                        samples.append(AuditSample(i, True, index, coeff))
                    n_points += 1
            else:
                coeffs = audit_values[ptr:ptr + (l << 1)]
                ptr += l << 1
                for j in range(l << 1):
                    coeff = _abs_i32(coeffs[j])
                    if j >= l:
                        samples.append(AuditSample(i, False, j - l, coeff))
                    else:
                        samples.append(AuditSample(i, True, j, coeff))
                    n_points += 1
    return AuditPlan(samples, n_points, int(audit_values[n_points]),
                     int(audit_values[ptr]))


def max_audit_samples(num_blocks: int, height: int) -> int:
    """Worst-case sample count over ALL level occupancies (every level
    occupied): per level i the plan draws min(NUM_CHECK_AUDIT, 2^(i+1))
    samples. Audit batch shapes are padded to this so every audit of a
    given database size shares ONE set of executables — the per-occupancy
    shapes otherwise recompile the MSM/linear-combine programs on almost
    every audit (the round-4 dryrun's 165 s warm audit #2)."""
    return sum(min(NUM_CHECK_AUDIT, 2 << i) for i in range(height))


def audit_pad_slots(num_blocks: int, height: int) -> int:
    """max_audit_samples rounded up to a power of two (>= 8), the padded
    slot count used by both parties' audit batches. Padding slots carry
    coefficient 0 and the point at infinity — exact identity
    contributions in every downstream kernel."""
    m = max_audit_samples(num_blocks, height)
    p = 8
    while p < m:
        p <<= 1
    return p


def check_pad_slots(plan: AuditPlan, slots: int) -> None:
    """Both parties pad an audit to `slots` (audit_pad_slots); a plan with
    more samples than that would pad by a negative count (a silent no-op
    for list padding), so it is refused."""
    if len(plan.samples) > slots:
        raise ValueError(f"audit plan of {len(plan.samples)} samples exceeds "
                         f"its {slots} padded slots")


def masked_write_step(write_step: int, level: int) -> int:
    """The write step at which `level`'s fresh complements were installed
    (Client.hpp:646: write_step &= ~((1<<i)-1))."""
    return write_step & ~((1 << level) - 1)
