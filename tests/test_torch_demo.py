"""The port's demo (`python -m porla_tpu_torch.tools.demo_e2e`, the
counterpart of examples/demo_e2e.py) in its single-process mode on the CPU
at n = 1, the smallest database the protocol takes (its one update closes
an epoch): the reference's lines, "ALL CHECKS PASSED", and the JSON record
last. Without a card, the default device raises in both roles."""

import json
import os
import subprocess
import sys

import pytest
import torch

from porla_tpu_torch.tools import demo_e2e

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*argv, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "porla_tpu_torch.tools.demo_e2e", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_single_process_demo_on_the_cpu(tmp_path):
    out = _run("--n", "1", "--updates", "1", "--audits", "1", "--device",
               "cpu", "--store", str(tmp_path))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("initialized n=1 in ")
    assert lines[1].startswith("audit #0 PASSED in ")
    assert lines[2].startswith("update 1 in ") and "(write_step=1)" in lines[2]
    assert lines[3].startswith("audit #1 PASSED in ")
    assert lines[4] == "ALL CHECKS PASSED"
    rec = json.loads(lines[5])
    assert rec["role"] == "client" and rec["n"] == 1
    assert len(rec["s"]["update"]) == 1 and len(rec["s"]["audit"]) == 2
    # the generators, the count, the blocks, the deltas; an update; 2 audits
    assert rec["transport"]["round_trips"] == 7
    assert rec["device"] == "cpu"
    assert not any(rec["launches"].values())   # the plain versions


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_e2e.main(["--n", "1", "--store", str(tmp_path)])
    out = _run("--serve", "--store", str(tmp_path), timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
