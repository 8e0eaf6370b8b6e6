"""The port's server over a (2, 2) mesh of CPU devices at n = 8 (n_loc = 4,
so CRebuild stage 3 exchanges shards), against a one-device port server:
one client talks to both through a transport that hands every message to
each server and requires byte-identical replies (IPA replies are affine
points and the proof, so the mesh must give the same group elements). The
audits run the DP MSM (K2 per shard) and, with force_sharded_pippenger,
the per-shard Pippenger kernels; a corrupted codeword is refused by the
mesh server; its checkpoint resumes on one device. Plain versions
throughout (about 2 minutes)."""

import dataclasses

import pytest
import torch

from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.parallel import sharded
from porla_tpu_torch.protocol import auditing
from porla_tpu_torch.protocol.client import AuditError, PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

CPU = torch.device("cpu")


class Tee:
    """Every message to both servers; the replies must be equal. With
    `only` set, messages go to that server alone."""

    def __init__(self, one, mesh):
        self.one, self.mesh, self.only = one, mesh, None

    def __call__(self, msg: bytes) -> bytes:
        if self.only is not None:
            return self.only.handle(bytes(msg))
        a = self.one.handle(bytes(msg))
        b = self.mesh.handle(bytes(msg))
        assert a == b, f"mesh reply differs to {bytes(msg[:1])!r}"
        return a


@pytest.fixture(scope="module")
def cycle(tmp_path_factory):
    mesh = sharded.make_mesh([CPU] * 4)
    cfg = PorlaConfig(scheme="ipa", mesh=mesh,
                      storage_dir=str(tmp_path_factory.mktemp("mesh")))
    one = PorlaServer(dataclasses.replace(
        cfg, mesh=None, storage_dir=str(tmp_path_factory.mktemp("one"))),
        device="cpu")
    server = PorlaServer(cfg, device="cpu")
    tee = Tee(one, server)
    client = PorlaClient(cfg, tee, data_seed=bytes(range(16)), device="cpu")
    client.initialize(8)
    return client, server, tee


def test_replies_equal_one_device(cycle):
    client, server, _ = cycle
    assert server._mesh.shape == {"blocks": 2, "chunks": 2}
    client.audit(seed=bytes(range(16)))
    client.update(client.write_step % client.num_blocks + 1)
    client.audit(seed=bytes([3] * 16))


def test_forced_pippenger_audit_equals_one_device(cycle):
    client, server, _ = cycle
    cfg = server.config
    server.config = dataclasses.replace(cfg, force_sharded_pippenger=True)
    try:
        client.audit(seed=bytes([5] * 16))
    finally:
        server.config = cfg
    assert server._sh_pip, "the audit did not take the Pippenger path"


def test_corrupted_codeword_refused(cycle):
    client, server, tee = cycle
    seed = bytes([7] * 16)
    plan = auditing.build_audit_plan(seed, server.write_step,
                                     server.num_blocks, server.height)
    hit = next(s for s in plan.samples
               if s.level == server.height - 1 and s.coeff % server.mod_q.n)
    lv = server.levels[hit.level]
    side = lv.x if hit.is_x else lv.y
    orig = side.data
    bad = orig.q.clone()
    bad[hit.index, 0, 0] ^= 1
    side.data = type(orig)(orig.p, bad)
    tee.only = server
    try:
        with pytest.raises(AuditError):
            client.audit(seed=seed)
    finally:
        tee.only = None
        side.data = orig


def test_checkpoint_resumes_on_one_device(cycle):
    client, server, tee = cycle
    server.save_checkpoint()
    restored = PorlaServer.restore(
        dataclasses.replace(server.config, mesh=None), device="cpu")
    assert restored._mesh is None
    tee.only = restored
    try:
        client.audit(seed=bytes([9] * 16))
    finally:
        tee.only = None
