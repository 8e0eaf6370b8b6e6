"""A whole run of each kind of cell on the CPU, the harness's look for a
chip skipped: `correct` holds for the program as it is, and comes out
false with each fault the cell can have planted in the timed path
(`porla_bench.faults`). The cells run on one chip, so no fault leaves out
an exchange between chips."""

from __future__ import annotations

import pytest
import torch

from porla_bench import harness

SEED = 2**31 + 11


def _run(root, workload, seconds, fault=None):
    torch.set_num_threads(2)
    return harness.run_cell(workload, SEED, seconds, False, device="cpu",
                            root=root, fault=fault)


@pytest.mark.parametrize("workload,seconds", [("ipa-n1024.update", 6),
                                              ("kzg-n1024.audit", 4)])
def test_sound_runs_are_correct(small_root, workload, seconds):
    r = _run(small_root, workload, seconds)
    assert r["correct"], r
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


@pytest.mark.parametrize("workload,fault,seconds", [
    ("ipa-n1024.update", "stale_update", 4),
    ("kzg-n1024.update", "half_fold", 6),
    ("ipa-n1024.update", "altered_update", 4),
    ("kzg-n1024.audit", "stale_audit", 4),
    ("ipa-n1024.audit", "half_audit", 1),
    ("kzg-n1024.audit", "altered_answer", 1),
])
def test_each_fault_makes_the_run_incorrect(small_root, workload, fault,
                                            seconds):
    r = _run(small_root, workload, seconds, fault)
    assert not r["correct"], r
    named = {k: c["value"] for k, c in r["checks"].items()}
    assert any(v > 0 for k, v in named.items() if k != "failed"), named


@pytest.mark.parametrize("workload", ["ipa-n1024.update", "kzg-n1024.update",
                                      "ipa-n1024.audit", "kzg-n1024.audit"])
def test_runs_with_levels_in_files_are_correct(files_root, workload):
    # update: the window's first op forms level 3 in files through the
    # streamed fold; audit: every audit gathers levels 3 and 4 from files
    r = _run(files_root, workload, 1)
    assert r["correct"], r
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", ["ipa-n1024.update", "kzg-n1024.update"])
def test_an_altered_codeword_file_makes_the_run_incorrect(files_root,
                                                          workload):
    r = _run(files_root, workload, 1, "altered_file")
    assert not r["correct"], r
    assert r["checks"]["data"]["value"] > 0, r["checks"]
