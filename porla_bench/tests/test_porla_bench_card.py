"""The measurement path needs the card: without one the runner exits with
2 and prints no result, and the harness raises rather than fall back to
the CPU. On the card (`-m card`), the control at a size a test can hold:
a run of each cell kind at n = 64 is correct as it is and incorrect with
each fault planted, and so with levels 5 and 6 in files, where an update
folds into level 5 and an altered codeword file must be seen."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from conftest import REPO, make_root


def _hidden_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_runner_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "porla_bench/run.py", "--workload",
         "ipa-n1024.update", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=_hidden_card_env(),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_harness_does_not_fall_back_to_the_cpu():
    code = ("import sys; sys.path.insert(0, '.');"
            "from porla_bench import harness;"
            "harness.run_cell('ipa-n1024.update', 1, 1, False)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_hidden_card_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("workload,fault", [
    ("ipa-n1024.update", None), ("ipa-n1024.update", "stale_update"),
    ("ipa-n1024.update", "half_fold"), ("ipa-n1024.update", "altered_update"),
    ("kzg-n1024.audit", None), ("kzg-n1024.audit", "stale_audit"),
    ("kzg-n1024.audit", "half_audit"), ("kzg-n1024.audit", "altered_answer"),
])
def test_control_on_the_card(card, tmp_path, workload, fault):
    from porla_bench import harness
    root = make_root(str(tmp_path), 64, 21)
    r = harness.run_cell(workload, 2**31 + 21, 3, False, device=str(card),
                         root=root, fault=fault)
    assert r["correct"] == (fault is None), r
    assert r["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("workload,fault", [
    ("ipa-n1024.update", None), ("ipa-n1024.update", "altered_file"),
    ("kzg-n1024.update", None), ("kzg-n1024.update", "altered_file"),
    ("ipa-n1024.audit", None), ("kzg-n1024.audit", None),
])
def test_files_control_on_the_card(card, tmp_path, workload, fault):
    from porla_bench import harness
    root = make_root(str(tmp_path), 64, 45, top_caching_level=4,
                     update_write_step=31)
    r = harness.run_cell(workload, 2**31 + 23, 3, False, device=str(card),
                         root=root, fault=fault)
    assert r["correct"] == (fault is None), r
    if fault is not None:
        assert r["checks"]["data"]["value"] > 0, r["checks"]
