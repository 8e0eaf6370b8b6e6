"""Checkpoint and resume of the port's server on the CPU at n = 8: after
initialize and an update the server saves its state, a new server restores
it, and the same client then audits, updates and audits against it. The
checkpoint is the reference package's layout key for key
(`checkpoint.npz` + `checkpoint.json`, uint32 limbs), which
tests/test_torch_cross_kzg.py resumes across the packages. Mirrors
tests/test_checkpoint.py for the IPA scheme; tests/test_torch_protocol_kzg.py
runs `save_restore_cycle` for KZG (one initialize a file keeps each file
under a minute)."""

import json
import os

import numpy as np
import pytest
import torch

from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


def _expected_keys(meta: dict) -> set:
    """The array names of the reference's save_checkpoint for `meta`
    (porla_tpu/protocol/server.py:164-206)."""
    keys = {f"mac_u_{c}" for c in "xyz"}
    for li, lm in enumerate(meta["levels"]):
        for side, pm in lm["sides"].items():
            if pm["has_data"]:
                keys |= {f"L{li}{side}_dp", f"L{li}{side}_dq"}
            keys |= {f"L{li}{side}_{nm}{c}" for nm in pm["points"]
                     for c in "xyz"}
    if meta["scheme"] == "kzg":
        keys.add("srs")
    return keys


def save_restore_cycle(cfg, server, transport, client) -> PorlaServer:
    """Checkpoint `server` (a ready server with an occupied level 0), check
    the layout, restore it into a new server behind `transport`, then
    audit, update and audit with `client`. Returns the restored server."""
    path = server.save_checkpoint()
    with open(os.path.join(cfg.storage_dir, "checkpoint.json")) as f:
        meta = json.load(f)
    with np.load(path) as data:
        assert set(data.files) == _expected_keys(meta)
        assert all(data[k].dtype == np.uint32 and data[k].shape[-1] == 16
                   for k in data.files if k != "srs")
    assert meta["write_step"] == server.write_step
    assert not meta["levels"][0]["empty"]

    other = PorlaConfig(scheme="kzg" if cfg.scheme == "ipa" else "ipa",
                        storage_dir=cfg.storage_dir)
    with pytest.raises(ValueError):
        PorlaServer.restore(other, device="cpu")
    restored = PorlaServer.restore(cfg, device="cpu")
    assert restored.write_step == server.write_step
    transport.server = restored
    client.audit(seed=bytes(range(16)))
    client.update(client.write_step % client.num_blocks + 1)
    client.audit(seed=bytes(range(1, 17)))
    return restored


def test_checkpoint_restore_roundtrip(tmp_path):
    cfg = PorlaConfig(scheme="ipa", storage_dir=str(tmp_path))
    server = PorlaServer(cfg, device="cpu")
    transport = InProcTransport(server)
    client = PorlaClient(cfg, transport, data_seed=bytes(range(16)),
                         device="cpu")
    client.initialize(8)
    client.update(1)
    save_restore_cycle(cfg, server, transport, client)
