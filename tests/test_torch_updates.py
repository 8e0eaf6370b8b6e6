"""Updates on the port at n = 8 on the CPU: round-robin writes through
HAdd (level 0, then a fold of levels 0..1) on both sides, after which the
audit still verifies. Every kernel-backed call takes its plain torch
version here; chip_smoke.py runs the same path through the kernels."""

import torch

from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


def test_updates_fold_and_audit(tmp_path):
    cfg = PorlaConfig(scheme="ipa", storage_dir=str(tmp_path))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server),
                         data_seed=bytes(range(16)), device="cpu")
    client.initialize(8)
    client.update(1)                      # lands in level 0
    assert not server.levels[0].empty
    client.update(2)                      # folds levels 0..1
    assert server.write_step == 2 and not server.levels[1].empty
    assert server.levels[0].empty
    client.audit(seed=bytes(range(3, 19)))
