"""The epoch boundary in the streamed tier, port against the JAX package
on the CPU: n = 8 blocks with levels above 1 in H_X/H_Y codeword files and
stripes of 3 (test_torch_disk_tier.py's `make_pair`). The updates through
write step n - 1 fold into file-backed levels; update n rebuilds the top
level through `_crebuild_streaming` into its H_X/H_Y files and leaves STG/
empty; the files hold the numpy twin's p lane (`porla_tpu.ntt.engine`,
test_torch_epoch.py's `reference_top_level`) byte for byte; the audit after
it reads those files and verifies, as does one after an update past the
epoch."""

import numpy as np
import pytest
import torch

from porla_tpu_torch.tools import soak
from test_torch_disk_tier import (check_audit_reads_files,
                                  check_top_level_files, make_pair)
from test_torch_epoch import (N, as_limbs, check_epoch_closed,
                              reference_top_level, run_epoch)

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def epoch(tmp_path_factory):
    _, client, server, _ = make_pair("ipa", tmp_path_factory.mktemp("store"))
    spans = run_epoch(client, server, tmp_path_factory.mktemp("trace"))
    return client, server, spans


def test_epoch_close_streams_top_level(epoch):
    _, server, spans = epoch
    check_epoch_closed(server, spans)
    # the closing update's CRebuild is the streamed one: staging, the stage
    # passes and the final pass into the level's files
    rebuild = "client.update/server.update/server.crebuild/"
    assert {s["path"][len(rebuild):] for s in spans
            if s["path"].startswith(rebuild)} >= {
        "stream.staging", "stream.stage", "stream.finalize"}
    check_top_level_files(server)
    top = server.height - 1
    for is_x, want in zip((True, False), reference_top_level(server)):
        got = server.store.read_codes_256(is_x, top, range(N))
        assert np.array_equal(as_limbs(got), want.p)


def test_audit_reads_rebuilt_files(epoch):
    client, server, _ = epoch
    check_audit_reads_files(client, server, bytes(range(16)))


def test_post_epoch_update_and_audit(epoch):
    client, server, _ = epoch
    soak.next_update(client)
    assert server.write_step == N + 1 and not server.levels[0].empty
    check_audit_reads_files(client, server, bytes(range(2, 18)))
