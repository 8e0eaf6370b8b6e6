"""Disk tier of the port in the KZG scheme (BN254, whose r is below p: the
q lane of a file-backed row is recomputed from its p lane), port against
port on the CPU: the checks of test_torch_disk_tier.py at n = 8,
top_caching_level = 1 and stripes of 3, then a flipped bit in a sampled
codeword file, which the audit must refuse, and a checkpoint with
file-backed levels that a new server restores and audits."""

import pytest
import torch

from test_torch_disk_tier import (check_audit_reads_files,
                                  check_corrupted_file_fails, check_restore,
                                  check_top_level_files, make_pair)

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair("kzg", tmp_path_factory.mktemp("store"))


def test_top_level_is_file_backed(pair):
    check_top_level_files(pair[2])


def test_updates_fold_through_disk_levels(pair):
    _, client, server, _ = pair
    for i in range(4):
        client.update(i + 1)
    assert server.levels[2].file_backed and server.levels[3].file_backed


def test_audit_reads_files(pair):
    # after the updates: the audit samples levels 2 and 3 from their files
    _, client, server, _ = pair
    check_audit_reads_files(client, server, bytes([1] * 16))


def test_corrupted_codeword_file_fails_audit(pair):
    _, client, server, _ = pair
    check_corrupted_file_fails(client, server, bytes([3] * 16))


def test_checkpoint_restores_file_backed_levels(pair):
    cfg, client, server, transport = pair
    check_restore(cfg, server, transport, client, bytes([4] * 16))
