"""A full epoch of the port at n = 8 on the CPU in the KZG scheme (BN254),
as test_torch_epoch.py runs it in the IPA scheme (its helpers, the same
zero-tolerance checks of the rebuilt top level against the JAX package);
then the soak tool (`tools/soak.py`) end to end at n = 4: its record,
written after the scheme, and its trace JSONL."""

import json
import os
import tempfile

import pytest
import torch

from porla_tpu_torch.tools import soak
from test_torch_epoch import (N, check_corrupted_top_refused,
                              check_epoch_closed, check_mac_lanes,
                              check_misaligned_rejected, check_top_data,
                              reference_top_level, run_epoch)

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def epoch(tmp_path_factory):
    client, server, _ = soak.open_pair(
        "kzg", N, str(tmp_path_factory.mktemp("store")), "cpu")
    spans = run_epoch(client, server, tmp_path_factory.mktemp("trace"))
    return client, server, spans


def test_full_epoch_triggers_crebuild(epoch):
    client, server, spans = epoch
    check_epoch_closed(server, spans)
    want_x, want_y = reference_top_level(server)
    check_top_data(server, want_x, want_y)
    check_mac_lanes(server, want_x, want_y,
                    [(side, i) for side in (0, 1) for i in range(N)])
    client.audit(seed=bytes(range(16)))


def test_corrupted_rebuilt_codeword_is_refused(epoch):
    client, server, _ = epoch
    check_corrupted_top_refused(client, server, bytes(range(5, 21)))


def test_post_epoch_update_and_audit(epoch):
    client, server, _ = epoch
    soak.next_update(client)
    assert server.write_step == N + 1 and not server.levels[0].empty
    client.audit()


def test_misaligned_update_rejected(epoch):
    client, server, _ = epoch
    check_misaligned_rejected(client, server)
    client.audit()


def test_soak_tool_record(tmp_path, capsys, monkeypatch):
    """The soak tool at n = 4: a warm update, then self_test's epoch of 4
    updates (write steps 2-5, the epoch closing at 4) and 2 audits after
    it; the record holds self_test's stats and the per-level meter, and
    the trace JSONL its spans."""
    out = tmp_path / "soak.json"
    # the stores are made in the temporary directory
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    soak.main(["--n", "4", "--schemes", "kzg", "--audits", "2",
               "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["workload"] == "self_test (Client.hpp:894-919)"
    [r] = rec["results"]
    assert (r["scheme"], r["n"], r["requests"], r["audits"]) == \
        ("kzg", 4, 4, 2)
    assert r["device"] == "cpu" and r["card"] is None
    # write steps 2..5: levels 1 (2), 0 (3, 5), the closing update (4)
    assert {lv: v["updates"] for lv, v in r["by_level"].items()} == \
        {"0": 2, "1": 1, "2": 1}
    assert len(r["epoch_close_s"]) == 1 and r["amortized_update_s"] > 0
    assert os.path.dirname(os.path.dirname(r["trace_jsonl"])) == \
        str(tmp_path)
    spans = soak.read_spans(r["trace_jsonl"])
    assert [s["attrs"]["write_step"] for s in spans
            if s["name"] == "client.update"] == [2, 3, 4, 5]
    assert sum(s["name"] == "client.audit" for s in spans) == 2
    assert "Amortized cost for each request" in capsys.readouterr().out
