"""Disk tier of the port, IPA scheme, port against port on the CPU (n = 8,
top_caching_level = 1, stripes of 3; test_torch_disk_tier_kzg.py runs the
same in the KZG scheme): a flipped bit in a codeword file that the audit
samples with a nonzero coefficient fails the audit, and a checkpoint whose
top level is file-backed restores into a new server that reads the same
files and audits."""

import pytest
import torch

from test_torch_disk_tier import (check_corrupted_file_fails, check_restore,
                                  make_pair)

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair("ipa", tmp_path_factory.mktemp("store"))


def test_corrupted_codeword_file_fails_audit(pair):
    _, client, server, _ = pair
    check_corrupted_file_fails(client, server, bytes([6] * 16))


def test_checkpoint_restores_file_backed_levels(pair):
    cfg, client, server, transport = pair
    check_restore(cfg, server, transport, client, bytes([7] * 16))
