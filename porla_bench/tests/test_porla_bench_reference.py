"""The plain reference against the port's plain CPU path, exactly, in both
schemes: the server's state after initialize, updates across the epoch's
closing CRebuild, and audit replies. Also the reference's own pieces:
AES against FIPS-197, the audit plan's shape, the group sums."""

from __future__ import annotations

import random
import tempfile

import pytest
import torch

from porla_bench import state
from porla_bench.reference import aes, check, ecc
from porla_bench.reference.protocol import Deployment, Replay, audit_plan

KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
TAU = bytes.fromhex("ffeeddccbbaa99887766554433221100")


def test_aes_fips197():
    # FIPS-197 appendix C.1
    ct = aes.ecb_encrypt(bytes(range(16)),
                         bytes.fromhex("00112233445566778899aabbccddeeff"))
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_msm_and_affine():
    cv = ecc.SECP256K1
    rng = random.Random(3)
    pts = [ecc.mul(cv, cv.g, rng.getrandbits(64)) for _ in range(40)]
    sc = [rng.getrandbits(200) for _ in pts]
    want = None
    for p, s in zip(pts, sc):
        want = ecc.add(cv, want, ecc.mul(cv, p, s))
    assert ecc.msm(cv, pts, sc) == want
    jac = [(x * 4 % cv.p, y * 8 % cv.p, 2) for x, y in pts] + [(1, 1, 0)]
    assert ecc.batch_to_affine(cv, jac) == pts + [None]


def test_audit_plan_counts():
    plan = audit_plan(bytes(16), 63, 1024, 11, 128)
    assert len(plan["samples"]) == 2 + 4 + 8 + 16 + 32 + 64 + 128
    assert {s[0] for s in plan["samples"]} == {0, 1, 2, 3, 4, 5, 10}


@pytest.mark.parametrize("scheme", ["ipa", "kzg"])
def test_reference_equals_the_port(scheme, tmp_path):
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.protocol.client import PorlaClient
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import InProcTransport

    torch.set_num_threads(2)
    n, seed = 8, bytes(range(5, 21))
    cfg = PorlaConfig(scheme=scheme, storage_dir=str(tmp_path))
    server = PorlaServer(cfg, device="cpu")
    replies = []

    class Keep(InProcTransport):
        def __call__(self, msg):
            reply = super().__call__(msg)
            replies.append(reply)
            return reply

    client = PorlaClient(cfg, Keep(server), data_seed=seed, device="cpu")
    dep = Deployment(scheme, n, 128, 128, KEY, TAU)
    ref = Replay(dep, seed)
    client.initialize(n)
    ref.initialize()
    rng = random.Random(1)
    bad = check.check_state(dep, ref, state.server_state(server, dep.curve.p),
                            rng)
    assert bad == {"data": 0, "planes": 0, "blocks": 0}
    for k in range(n + 2):                  # across the closing CRebuild
        client.update(client.write_step % n + 1)
        ref.update()
        if k in (2, n + 1):
            audit_seed = bytes([k]) * 16
            client.audit(audit_seed)
            assert check.reply_matches(dep, ref.audit_reply(audit_seed),
                                       replies[-1])
    prog = state.server_state(server, dep.curve.p)
    assert check.check_state(dep, ref, prog, rng) == \
        {"data": 0, "planes": 0, "blocks": 0}
    # the check sees a changed data limb, a changed point and a block
    top = prog["levels"][-1]
    top["x"]["q"][0, 0] += 1
    x, y, z = top["y"]["c"][3]
    top["y"]["c"][3] = (x, y, z * 2 % dep.curve.p)
    blk = prog["blocks"][0]
    prog["blocks"][0] = blk[:-1] + bytes([blk[-1] ^ 1])
    bad = check.check_state(dep, ref, prog, rng)
    assert bad["data"] == 1 and bad["planes"] == 1 and bad["blocks"] == 1
    assert not check.reply_matches(dep, ref.audit_reply(bytes(16)),
                                   replies[-1])
