"""A full epoch of the port at n = 8 on the CPU, IPA scheme, mirroring
tests/test_protocol_e2e.py's epoch tests: round-robin updates through
write step n - 1 fold every level from 0 to log2(n) - 1; update n closes
the epoch (the server's CRebuild from the update path, the client's over
the complements of the epoch's writes); the audits after it verify, one
update past it continues the rotation, a misaligned update is refused
without breaking it, and a corrupted q residue of a rebuilt codeword fails
the audit. The rebuilt top level is held against the JAX package at zero
tolerance: its data planes limb for limb against the numpy twin
(`porla_tpu.ntt.engine.encode_stages`, xp=np) on the blocks the store
holds, the Y plane twisted by the reference context's `wt_scalar`, and a
few lanes of its MAC planes as group elements against
`porla_tpu.golden.ecc` (alpha * commit(codeword) + PRF(level, index,
write_step) * h). Nothing of the JAX package is compiled: the twin and the
golden models are numpy and Python ints. test_torch_epoch_kzg.py runs the
same in the KZG scheme, test_torch_epoch_disk.py in the streamed tier. The
helpers below serve all three (one `initialize` a file: the plain versions
are slow on the CPU)."""

import hashlib

import numpy as np
import pytest
import torch

from porla_tpu.commit import kzg as jkzg
from porla_tpu.crypto import testrand as jtestrand
from porla_tpu.crypto.aes import MacPrf as JMacPrf
from porla_tpu.fields import limbs as jlimbs
from porla_tpu.fields import mont as jmont
from porla_tpu.fields.constants import BN254_R
from porla_tpu.golden import bn254_pairing as jbp
from porla_tpu.golden import ecc as jecc
from porla_tpu.ntt import engine as jeng
from porla_tpu_torch.curves.weierstrass import index
from porla_tpu_torch.protocol import auditing
from porla_tpu_torch.protocol.client import AuditError, UpdateOrderError
from porla_tpu_torch.tools import soak
from porla_tpu_torch.utils import trace

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

N = 8


def run_epoch(client, server, tmp_path):
    """Round-robin updates through write step n - 1, each forming the level
    of its write step's lowest set bit with every level below it empty,
    then update n, which closes the epoch. Returns the spans of the run."""
    trace.reset()
    trace.enable()
    try:
        while client.write_step < N - 1:
            soak.next_update(client)
            lv = soak.fold_level(server.write_step, N)
            assert not server.levels[lv].empty
            assert all(low.empty for low in server.levels[:lv])
        soak.next_update(client)
    finally:
        trace.enable(False)
    return soak.read_spans(trace.dump_jsonl(str(tmp_path / "epoch.jsonl")))


def check_epoch_closed(server, spans):
    """Update n ran one CRebuild on each side, and left the top level full
    and every level below it empty."""
    assert server.write_step == N and server.write_step % server.num_blocks \
        == 0
    top = server.height - 1
    assert not server.levels[top].empty
    assert all(lv.empty for lv in server.levels[:top])
    for side, path in (("server", "client.update/server.update/"),
                       ("client", "client.update/")):
        assert [s["path"] for s in spans
                if s["name"] == f"{side}.crebuild"] == [
            f"{path}{side}.crebuild"]
    closing = [s for s in spans if s["name"] == "client.update"
               and s["attrs"]["write_step"] == N]
    # the soak tool's meter over the same spans: levels 0..2 formed by 4, 2
    # and 1 updates, level 3 the closing update's CRebuild
    stats = soak.epoch_stats(soak.update_times(spans), N)
    assert {lv: r["updates"] for lv, r in stats["by_level"].items()} == \
        {"0": 4, "1": 2, "2": 1, "3": 1}
    assert stats["epoch_close_s"] == [closing[0]["elapsed_s"]]


def reference_top_level(server):
    """The top level's (X, Y) data planes by the JAX package's numpy twin,
    over the blocks in the server's store: each lane reduced, Y twisted by
    the reference context's wt_scalar(write_step), every CRebuild stage."""
    jctx = jeng.NttContext(N, server.config.scheme)
    raw = np.stack([jlimbs.bytes_to_limbs(server.store.read_block(i))
                    for i in range(N)])
    mod_p = jctx.mod_p
    x = jeng.CrtArray(jmont.mod_reduce(np, raw, mod_p),
                      jmont.mod_reduce(np, raw, jctx.mod_q))
    wt = jctx.wt_scalar(server.write_step)
    y = jeng.CrtArray(jmont.mont_mul(np, x.p, wt.mont_p[0], mod_p),
                      jmont.mont_mul(np, x.q, wt.mont_q[0], jctx.mod_q))
    return jeng.encode_stages(np, jctx, x), jeng.encode_stages(np, jctx, y)


def as_limbs(t) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def check_top_data(server, want_x, want_y):
    top = server.levels[server.height - 1]
    for got, want in ((top.x.data, want_x), (top.y.data, want_y)):
        assert np.array_equal(as_limbs(got.p), want.p)
        assert np.array_equal(as_limbs(got.q), want.q)


def golden_macs(config, level: int, write_step: int):
    """(commit(chunks) scaled by alpha, PRF(level, index, write_step) * h)
    as functions, from the JAX package's golden models."""
    prf = JMacPrf(config.secret_key)
    if config.scheme == "ipa":
        cv = jecc.SECP256K1
        alpha = int.from_bytes(config.secret_key, "little")
        gens = jtestrand.derive_ipa_generators(128)[0]
        h = jtestrand.derive_h_mac()

        def commit(chunks):
            return jecc.msm(cv, gens, [alpha * c for c in chunks])

        def mask(i):
            return jecc.mul(cv, h, prf.prf_scalars_ipa(
                [(level, i, write_step)])[0])
        return cv, commit, mask
    cv = jecc.BN254
    alpha = int.from_bytes(config.secret_key, "big") % BN254_R
    tau = int.from_bytes(config.tau_key, "big") % BN254_R
    h = jecc.mul(cv, jbp.G1, int.from_bytes(hashlib.sha256(
        config.tau_key + b"porla-h").digest(), "big") % BN254_R)

    def mask(i):
        return jecc.mul(cv, h, prf.prf_scalars_kzg(
            [(level, i, write_step)], BN254_R)[0])
    return cv, (lambda chunks: jkzg.commit_eval(tau, alpha, chunks)), mask


def check_mac_lanes(server, want_x, want_y, lanes=((0, 0), (1, N - 1))):
    """MAC lane i of the rebuilt level's X (side 0) or Y (side 1) plane is
    alpha * commit(codeword i's q residue) + PRF(top, side * n + i, ws) * h
    (two lanes: the golden IPA commitment is 128 scalar mults of about 65
    ms each)."""
    top = server.height - 1
    cv, commit, mask = golden_macs(server.config, top, server.write_step)
    lv = server.levels[top]
    for side, lane in lanes:
        plane = (lv.x, lv.y)[side].points["c"]
        got = server.ops.to_affine(index(plane, [lane]))[0]
        chunks = jlimbs.limbs_to_ints((want_x, want_y)[side].q[lane])
        assert got == jecc.add(cv, commit(chunks), mask(side * N + lane))


def check_corrupted_top_refused(client, server, seed):
    """A flipped bit in the q residue of a rebuilt codeword that the audit
    of `seed` samples with a nonzero coefficient fails that audit; with
    the codeword restored the same audit verifies."""
    top = server.height - 1
    plan = auditing.build_audit_plan(seed, server.write_step, N,
                                     server.height)
    hit = next(s for s in plan.samples
               if s.level == top and s.coeff % server.mod_q.n)
    side = server.levels[top].x if hit.is_x else server.levels[top].y
    orig = side.data
    bad = orig.q.clone()
    bad[hit.index, 0, 0] ^= 1
    side.data = type(orig)(orig.p, bad)
    try:
        with pytest.raises(AuditError):
            client.audit(seed=seed)
    finally:
        side.data = orig
    client.audit(seed=seed)


def check_misaligned_rejected(client, server):
    """Updates must continue the rotation: any other block id raises and
    changes nothing; the expected one then goes through."""
    n = client.num_blocks
    expected = client.write_step % n + 1
    before = (client.write_step, server.write_step)
    with pytest.raises(UpdateOrderError):
        client.update(expected % n + 1)
    assert (client.write_step, server.write_step) == before
    client.update(expected)


@pytest.fixture(scope="module")
def epoch(tmp_path_factory):
    """A pair initialized at n = 8, its epoch closed by update n, and the
    spans of the epoch."""
    client, server, _ = soak.open_pair(
        "ipa", N, str(tmp_path_factory.mktemp("store")), "cpu")
    spans = run_epoch(client, server, tmp_path_factory.mktemp("trace"))
    return client, server, spans


def test_full_epoch_triggers_crebuild(epoch):
    client, server, spans = epoch
    check_epoch_closed(server, spans)
    want_x, want_y = reference_top_level(server)
    check_top_data(server, want_x, want_y)
    check_mac_lanes(server, want_x, want_y)
    client.audit(seed=bytes(range(16)))


def test_corrupted_rebuilt_codeword_is_refused(epoch):
    client, server, _ = epoch
    check_corrupted_top_refused(client, server, bytes(range(5, 21)))


def test_post_epoch_update_and_audit(epoch):
    client, server, _ = epoch
    soak.next_update(client)
    assert server.write_step == N + 1 and not server.levels[0].empty
    client.audit()


def test_misaligned_update_rejected(epoch):
    client, server, _ = epoch
    check_misaligned_rejected(client, server)
    client.audit()
