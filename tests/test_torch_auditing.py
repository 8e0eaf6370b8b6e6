"""The port's audit plans and MAC wire format against the reference
package: the same seed and log state give the same samples, coefficients
and IPA challenge (both the take-every-block and the sample-128 branches),
the same padded slot counts, and the same 96-byte Jacobian triples on the
wire for the same points."""

import random

import numpy as np
import pytest

from porla_tpu.curves.instances import secp256k1 as jsecp
from porla_tpu.golden import ecc
from porla_tpu.protocol import auditing as ref
from porla_tpu.protocol import points_io as ref_io
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.protocol import auditing, points_io


@pytest.mark.parametrize("n", [8, 128, 1024])
def test_audit_plans_match_reference(n):
    r = random.Random(n)
    height = n.bit_length()
    assert auditing.audit_pad_slots(n, height) == \
        ref.audit_pad_slots(n, height)
    for write_step in (0, 1, 2, 5, n - 1, n + 3, 3 * n + 7):
        seed = bytes(r.getrandbits(8) for _ in range(16))
        mine = auditing.build_audit_plan(seed, write_step, n, height)
        want = ref.build_audit_plan(seed, write_step, n, height)
        assert [(s.level, s.is_x, s.index, s.coeff) for s in mine.samples] \
            == [(s.level, s.is_x, s.index, s.coeff) for s in want.samples]
        assert (mine.n_points, mine.ipa_challenge) == \
            (want.n_points, want.ipa_challenge)
        for level in range(height):
            assert auditing.masked_write_step(write_step, level) == \
                ref.masked_write_step(write_step, level)


def test_mac_wire_format_matches_reference():
    cv = ecc.SECP256K1
    pts = [ecc.mul(cv, cv.g, k) for k in (1, 7, 123, cv.n - 1)] + [ecc.INF]
    ops = secp256k1()
    wire = points_io.points_to_bytes(ops.from_affine(pts), ops)
    assert wire == ref_io.points_to_bytes(jsecp().from_affine(np, pts))
    assert ops.to_affine(points_io.points_from_bytes(wire, ops)) == pts
