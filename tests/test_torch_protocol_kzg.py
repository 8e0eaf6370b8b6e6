"""The port's KZG scheme (BN254 MACs, the client's trusted setup, SRS
commitments on K4's plain version, pairing-checked openings) on the CPU,
port client against port server at n = 8 over the in-process transport:
an audit after initialize, updates then an audit, a flipped bit in a
stored codeword of the top level that the next audit rejects, a reply whose
MAC is off by one generator that the MAC check refuses, then a
checkpoint restored into a new server that the client goes on with.
Mirrors tests/test_protocol_kzg.py and, for KZG, tests/test_checkpoint.py;
chip_smoke.py runs the same cycle at n = 1024 through the kernels."""

import pytest
import torch

from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.curves.instances import bn254
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.protocol import points_io
from porla_tpu_torch.protocol.client import AuditError, PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport
from test_torch_checkpoint import save_restore_cycle

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = PorlaConfig(scheme="kzg",
                      storage_dir=str(tmp_path_factory.mktemp("store")))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server),
                         data_seed=bytes([3] * 16), device="cpu")
    client.initialize(8)
    return client, server


def test_kzg_audit_after_initialize(pair):
    client, server = pair
    assert server.ops is bn254() and client.ops is bn254()
    assert server.srs.to_bytes() == client.srs.to_bytes()
    client.audit(seed=bytes(range(16)))


def test_kzg_updates_and_audit(pair):
    client, server = pair
    client.update(1)
    client.update(2)
    assert server.write_step == 2 and not server.levels[1].empty
    client.audit(seed=bytes(range(1, 17)))


def test_kzg_corruption_detected(pair):
    client, server = pair
    top = server.levels[server.height - 1]
    orig = top.x.data
    bad = orig.q.clone()
    bad[0, 0, 0] ^= 1
    top.x.data = type(orig)(orig.p, bad)
    with pytest.raises(AuditError):
        client.audit(seed=bytes(range(2, 18)))
    top.x.data = orig
    client.audit(seed=bytes(range(2, 18)))


def test_kzg_mac_off_by_a_generator_refused(pair, monkeypatch):
    client, _ = pair
    ops = client.ops
    send = client.transport

    def off_by_g(msg):
        reply = send(msg)
        mac = ops.to_affine(points_io.points_from_bytes(reply[192:288], ops))
        mac = ops.from_affine([ecc.add(ops.curve, mac[0], ops.curve.g)])
        return reply[:192] + points_io.points_to_bytes(mac, ops) + reply[288:]
    monkeypatch.setattr(client, "transport", off_by_g)
    with pytest.raises(AuditError):
        client.audit(seed=bytes(range(5, 21)))


def test_kzg_checkpoint_restore_roundtrip(pair):
    """Last in the file: the client goes on with the restored server."""
    client, server = pair
    client.update(3)                      # level 0 occupied when saved
    restored = save_restore_cycle(server.config, server, client.transport,
                                  client)
    assert restored.srs.to_bytes() == client.srs.to_bytes()
