"""The port's protocol slice on the CPU: a porla_tpu_torch client against a
porla_tpu_torch server at n = 8 over the in-process transport — initialize,
an audit that verifies (the MAC equation and the IPA transcript), the typed
update-order error, the audit's padding guard, and entry points that take
an explicit device. Every
kernel-backed call takes its plain torch version here; chip_smoke.py runs
the same cycle through the kernels. Updates are in test_torch_updates.py,
corruption detection in test_torch_corruption.py."""

import pytest
import torch

from porla_tpu_torch import native
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.protocol import auditing
from porla_tpu_torch.protocol.client import PorlaClient, UpdateOrderError
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = PorlaConfig(scheme="ipa",
                      storage_dir=str(tmp_path_factory.mktemp("store")))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server),
                         data_seed=bytes(range(16)), device="cpu")
    client.initialize(8)
    return client, server


def test_audit_after_initialize(pair):
    client, server = pair
    assert server.levels[server.height - 1].x.data.p.device.type == "cpu"
    client.audit(seed=bytes(range(16)))


def test_misaligned_update_rejected(pair):
    client, _ = pair
    expected = (client.write_step % client.num_blocks) + 1
    with pytest.raises(UpdateOrderError):
        client.update(expected % client.num_blocks + 1)


def test_entry_points_take_an_explicit_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    for scheme in ("ipa", "kzg"):
        cfg = PorlaConfig(scheme=scheme, storage_dir=str(tmp_path))
        with pytest.raises(RuntimeError):
            PorlaServer(cfg)              # device="cuda" by default
        with pytest.raises(RuntimeError):
            PorlaClient(cfg, None)
    with pytest.raises(TypeError):     # a mesh is a parallel.sharded.Mesh
        PorlaServer(PorlaConfig(scheme="ipa", storage_dir=str(tmp_path),
                                mesh=object()), device="cpu")
    assert native.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("party", ["client", "server"])
def test_audit_plan_larger_than_its_padding_refused(pair, monkeypatch, party):
    """Both parties pad an audit to `audit_pad_slots`; a plan with more
    samples than that is refused before any work (the client before it
    contacts the server)."""
    client, server = pair
    monkeypatch.setattr(auditing, "audit_pad_slots", lambda n, height: 4)
    sent = []
    monkeypatch.setattr(client, "transport", lambda msg: sent.append(msg))
    with pytest.raises(ValueError, match="padded slots"):
        if party == "client":
            client.audit(seed=bytes(range(16)))
        else:
            server.audit(bytes(range(16)))
    assert not sent
