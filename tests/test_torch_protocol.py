"""The port's protocol slice on the CPU: a porla_tpu_torch client against a
porla_tpu_torch server at n = 8 over the in-process transport — initialize,
an audit that verifies (the MAC equation and the IPA transcript), the typed
update-order error, and entry points that take an explicit device. Every
kernel-backed call takes its plain torch version here; chip_smoke.py runs
the same cycle through the kernels. Updates are in test_torch_updates.py,
corruption detection in test_torch_corruption.py."""

import pytest
import torch

from porla_tpu_torch import native
from porla_tpu_torch.config import PorlaConfig
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
    cfg = PorlaConfig(scheme="ipa", storage_dir=str(tmp_path))
    with pytest.raises(RuntimeError):
        PorlaServer(cfg)                  # device="cuda" by default
    with pytest.raises(RuntimeError):
        PorlaClient(cfg, None)
    with pytest.raises(NotImplementedError):
        PorlaServer(PorlaConfig(scheme="kzg", storage_dir=str(tmp_path)),
                    device="cpu")
    assert native.resolve_device("cpu").type == "cpu"
