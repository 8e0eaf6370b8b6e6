"""Disk tier of the port, port against port on the CPU, mirroring
tests/test_disk_tier.py: levels above top_caching_level keep their data in
H_X/H_Y codeword files (reduced mod p, alignment committed), written by the
streamed CRebuild and fold through STG/ staging files, and audits read them
back. n = 8 blocks, top_caching_level = 1, stripes of 3 blocks (which
divide neither a stage's 4 pairs nor a fold's length of 4). This file runs
the IPA scheme's layout, folds and audit; test_torch_disk_tier_resume.py
its corrupted codeword file and checkpoint; test_torch_disk_tier_kzg.py all
of them in the KZG scheme; test_torch_disk_tier_lower.py a fold whose lower
level is itself in files. The helpers below serve all four (one
`initialize` a file: the plain versions are slow on the CPU)."""

import json
import os

import pytest
import torch

from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.protocol import auditing
from porla_tpu_torch.protocol.client import AuditError, PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

N = 8


def make_pair(scheme, root, top_caching_level=1):
    """An initialized client and server at n = 8 with stripes of 3."""
    cfg = PorlaConfig(scheme=scheme, top_caching_level=top_caching_level,
                      stream_stripe_blocks=3, storage_dir=str(root))
    server = PorlaServer(cfg, device="cpu")
    transport = InProcTransport(server)
    client = PorlaClient(cfg, transport, data_seed=bytes([7] * 16),
                         device="cpu")
    client.initialize(N)
    return cfg, client, server, transport


def count_file_reads(server) -> list:
    """Record the (level, is_x, rows) of every codeword-file read."""
    reads = []
    read = server.store.read_codes_256

    def counted(is_x, level, indices, device="cpu"):
        indices = list(indices)
        reads.append((level, is_x, len(indices)))
        return read(is_x, level, indices, device)
    server.store.read_codes_256 = counted
    return reads


def check_top_level_files(server):
    top = server.height - 1
    lv = server.levels[top]
    assert lv.file_backed and lv.x.data is None and lv.y.data is None
    root = server.config.storage_dir
    for sub in ("H_X", "H_Y"):
        # codeword files in the reference's layout: H_X/<level>_<i>
        for i in range(N):
            path = os.path.join(root, sub, f"{top}_{i}")
            assert os.path.getsize(path) == 4096
    assert os.listdir(os.path.join(root, "STG")) == []
    assert all(lv.empty for lv in server.levels[:top])


def check_audit_reads_files(client, server, seed):
    reads = count_file_reads(server)
    client.audit(seed=seed)
    assert reads and all(server.levels[lvl].file_backed
                         for lvl, _, _ in reads)
    # one batched read per (level, side)
    assert len({(lvl, x) for lvl, x, _ in reads}) == len(reads)


def check_corrupted_file_fails(client, server, seed):
    """Flip a bit in a codeword file that the audit of `seed` samples with
    a nonzero coefficient: the audit fails; restored, it passes."""
    plan = auditing.build_audit_plan(seed, server.write_step, N,
                                     server.height)
    hit = next(s for s in plan.samples
               if server.levels[s.level].file_backed
               and s.coeff % server.mod_q.n)
    path = os.path.join(server.config.storage_dir,
                        "H_X" if hit.is_x else "H_Y",
                        f"{hit.level}_{hit.index}")
    with open(path, "rb") as f:
        orig = f.read()
    bad = bytearray(orig)
    bad[40] ^= 4
    with open(path, "wb") as f:
        f.write(bytes(bad))
    try:
        with pytest.raises(AuditError):
            client.audit(seed=seed)
    finally:
        with open(path, "wb") as f:
            f.write(orig)


def check_restore(cfg, server, transport, client, seed):
    """Checkpoint a server with file-backed levels, restore it into a new
    server that reads the same files, and audit it."""
    server.save_checkpoint()
    with open(os.path.join(cfg.storage_dir, "checkpoint.json")) as f:
        meta = json.load(f)
    backed = [i for i, lv in enumerate(server.levels) if lv.file_backed]
    assert backed and [i for i, lm in enumerate(meta["levels"])
                       if lm["file_backed"]] == backed
    assert not any(meta["levels"][i]["sides"][s]["has_data"]
                   for i in backed for s in "xy")
    restored = PorlaServer.restore(cfg, device="cpu")
    assert [i for i, lv in enumerate(restored.levels)
            if lv.file_backed] == backed
    transport.server = restored
    check_audit_reads_files(client, restored, seed)
    return restored


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair("ipa", tmp_path_factory.mktemp("store"))


def test_top_level_is_file_backed(pair):
    check_top_level_files(pair[2])


def test_updates_fold_through_disk_levels(pair):
    cfg, client, server, _ = pair
    # enough writes to occupy level 2 (> top_caching_level = 1): its fold
    # streams through staging files into level 2's codeword files
    for i in range(4):
        client.update(i + 1)
    assert server.levels[2].file_backed and server.levels[3].file_backed
    assert all(lv.empty for lv in server.levels[:2])
    assert os.path.getsize(os.path.join(cfg.storage_dir, "H_Y", "2_3")) \
        == 4096
    assert os.listdir(os.path.join(cfg.storage_dir, "STG")) == []


def test_audit_reads_files(pair):
    # after the updates: the audit samples levels 2 and 3 from their files
    _, client, server, _ = pair
    check_audit_reads_files(client, server, bytes([1] * 16))
