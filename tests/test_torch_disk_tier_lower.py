"""Disk tier of the port, KZG scheme, port against port on the CPU, with
every level above 0 in files (top_caching_level = 0, n = 8, stripes of 3):
update 2 streams level 1 into files, update 4 folds into level 2 through
two streamed mixes, the second with level 1's codeword files as its lower
and the first one's staging files as its upper (the fx0/fx1 tags in turn,
the consumed files deleted); an audit then reads levels 2 and 3 from their
files."""

import os

import pytest
import torch

from test_torch_disk_tier import (check_audit_reads_files, count_file_reads,
                                  make_pair)

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair("kzg", tmp_path_factory.mktemp("store"),
                     top_caching_level=0)


def test_fold_reads_a_file_backed_lower(pair):
    cfg, client, server, _ = pair
    client.update(1)
    client.update(2)
    assert server.levels[1].file_backed
    client.update(3)
    reads = count_file_reads(server)
    client.update(4)
    # the second mix read level 1's files, a stripe at a time, both sides
    assert {(lvl, x) for lvl, x, _ in reads} == {(1, True), (1, False)}
    assert [lv.file_backed for lv in server.levels] == [False, False,
                                                        True, True]
    assert os.listdir(os.path.join(cfg.storage_dir, "STG")) == []
    del server.store.read_codes_256
    check_audit_reads_files(client, server, bytes([5] * 16))
