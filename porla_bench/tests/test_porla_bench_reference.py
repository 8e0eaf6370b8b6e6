"""The plain reference against the port's plain CPU path, exactly, in both
schemes, with every level in memory and with the upper levels in files:
the server's state after initialize, updates across the epoch's closing
CRebuild, and audit replies. Also the reference's own pieces: AES against
FIPS-197, the audit plan's shape, the group sums, the reading of codeword
files, and the default caching level."""

from __future__ import annotations

import os
import random

import numpy as np
import pytest
import torch

from porla_bench import state
from porla_bench.reference import aes, check, ecc
from porla_bench.reference.protocol import (FFT_PRIME, Deployment, Replay,
                                            audit_plan)

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


# every level in memory, audits at write steps 3 and 10; or levels 2 and 3
# in files (level 2 formed by the streamed fold at write step 4, level 3 by
# the streamed CRebuild), an audit at write step 7 reading both from files
LEVELS = {"memory": (None, (2, 9)), "files": (1, (2, 6, 9))}


@pytest.mark.parametrize("levels", list(LEVELS))
@pytest.mark.parametrize("scheme", ["ipa", "kzg"])
def test_reference_equals_the_port(scheme, levels, tmp_path):
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.protocol.client import PorlaClient
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import InProcTransport

    torch.set_num_threads(2)
    n, seed = 8, bytes(range(5, 21))
    top, audits = LEVELS[levels]
    store = str(tmp_path)
    opts = {} if top is None else {"top_caching_level": top,
                                   "stream_stripe_blocks": 2}
    cfg = PorlaConfig(scheme=scheme, storage_dir=store, **opts)
    server = PorlaServer(cfg, device="cpu")
    replies = []

    class Keep(InProcTransport):
        def __call__(self, msg):
            reply = super().__call__(msg)
            replies.append(reply)
            return reply

    client = PorlaClient(cfg, Keep(server), data_seed=seed, device="cpu")
    dep = Deployment(scheme, n, 128, 128, KEY, TAU, top)
    ref = Replay(dep, seed)
    client.initialize(n)
    ref.initialize()
    rng = random.Random(1)
    bad = check.check_state(dep, ref, state.server_state(
        server, dep.curve.p, dep.q, store), rng)
    assert bad == {"data": 0, "planes": 0, "blocks": 0}
    for k in range(n + 2):                  # across the closing CRebuild
        client.update(client.write_step % n + 1)
        ref.update()
        if k in audits:
            audit_seed = bytes([k]) * 16
            client.audit(audit_seed)
            assert check.reply_matches(dep, ref.audit_reply(audit_seed),
                                       replies[-1])
    prog = state.server_state(server, dep.curve.p, dep.q, store)
    assert check.check_state(dep, ref, prog, rng) == \
        {"data": 0, "planes": 0, "blocks": 0}
    assert server.levels[-1].file_backed == (top is not None)
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


def test_codeword_files_are_read_whole_or_not_at_all(tmp_path):
    os.makedirs(tmp_path / "H_X")
    vals = [random.Random(k).getrandbits(256) for k in range(256)]
    raw = [b"".join(v.to_bytes(32, "little") for v in vals[128 * i:
                                                            128 * i + 128])
           for i in range(2)]
    (tmp_path / "H_X" / "2_0").write_bytes(raw[0])
    (tmp_path / "H_X" / "2_1").write_bytes(raw[1][:-1])       # short
    (tmp_path / "H_X" / "2_3").write_bytes(raw[1])            # 2_2 missing
    got = state.code_ints(str(tmp_path), "H_X", 2)
    assert got.shape == (4, 128)
    assert list(got[0]) == vals[:128] and list(got[3]) == vals[128:]
    assert all(x is None for x in got[1]) and all(x is None for x in got[2])
    want = np.zeros((4, 128), dtype=object)
    assert int(np.count_nonzero(got != want)) == 4 * 128


def _replayed(dep: Deployment, seed: bytes, audit_at) -> tuple[list, list]:
    ref = Replay(dep, seed)
    ref.initialize()
    levels, replies = [], []
    for k in range(dep.n + 2):              # across the closing CRebuild
        ref.update()
        levels.append([None if lv is None else
                       [(list(s.v.reshape(-1)), list(s.u.reshape(-1)),
                         list(s.r)) for s in lv] for lv in ref.levels])
        if k in audit_at:
            replies.append(ref.audit_reply(bytes([k]) * 16))
    return levels, replies


@pytest.mark.parametrize("scheme", ["ipa", "kzg"])
def test_the_default_caching_level_holds_every_level_in_memory(scheme):
    n, seed, audit_at = 8, bytes(range(7, 23)), (2, 9)
    default = _replayed(Deployment(scheme, n, 128, 128, KEY, TAU), seed,
                        audit_at)
    assert Deployment(scheme, n, 128, 128, KEY, TAU).top_caching_level == 3
    assert _replayed(Deployment(scheme, n, 128, 128, KEY, TAU, 3), seed,
                     audit_at) == default
    # with level 3 in files the top level keeps u and holds v mod p
    files = Replay(Deployment(scheme, n, 128, 128, KEY, TAU, 2), seed)
    memory = Replay(Deployment(scheme, n, 128, 128, KEY, TAU), seed)
    files.initialize()
    memory.initialize()
    for f, m in zip(files.levels[3], memory.levels[3]):
        assert (f.u == m.u).all() and (f.r == m.r).all()
        assert (f.v == m.v % FFT_PRIME).all() and (f.v != m.v).any()
