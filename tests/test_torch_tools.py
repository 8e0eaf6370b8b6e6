"""The port's measurement tools on the CPU at tiny sizes (`--device cpu`,
the plain versions): the bench tool's three lines under bench.py's metric
names, BN254 last, vs_baseline null off the card; the KAT tool's checks
all recorded as passing, and a check made to fail recorded as failing with
a nonzero exit; measure_protocol's summaries; no tool imports jax or the
JAX package; each raises when asked for a card torch cannot find. (The
soak tool runs in test_torch_epoch_kzg.py.)"""

import json
import os
import subprocess
import sys

import pytest
import torch

from porla_tpu_torch.tools import bench, kat_onchip, measure_protocol, soak

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bench", "kat_onchip", "measure_protocol", "soak")


def test_bench_lines(monkeypatch, capsys):
    # one timed round after the warm-up: a plain MSM of 128 points takes
    # about 13 s on one CPU thread (the fold: 65 windows x 128 lanes x 8
    # buckets), 128 points being Pippenger's narrowest lane width
    monkeypatch.setattr(bench, "ROUNDS", 1)
    lines = bench.main(["--device", "cpu", "--encode-n", "16",
                        "--msm-n", "128"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    assert [json.loads(line) for line in out[1:]] == lines
    assert [r["metric"] for r in lines] == [
        "icc_encode_coeffs_per_s", "msm_points_per_s_secp256k1",
        "msm_points_per_s_bn254"]
    assert all(set(r) == {"metric", "value", "unit", "vs_baseline"}
               and r["vs_baseline"] is None and r["value"] > 0
               for r in lines)
    assert lines[0]["unit"] == ("256-bit coeffs/s (n=2^4, C=128, both CRT "
                                "lanes, cpu)")
    assert lines[2]["unit"] == (
        "pts/s (N=2^7, 254-bit order scalars, Pippenger c=4, "
        "device-resident operands, cpu)")


def test_kat_checks_pass(tmp_path):
    out = tmp_path / "kat.json"
    kat_onchip.main(["--device", "cpu", "--msm-n", "128", "--icc-n", "64",
                     "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["all_pass"] and not rec["partial"]
    assert list(rec["kats"]) == list(kat_onchip.CHECKS)
    assert all(r["pass"] for r in rec["kats"].values())
    assert rec["kats"]["icc_encode"]["n"] == 64
    assert len(rec["kats"]["icc_encode"]["sha256"]) == 64


def test_kat_failure_is_recorded_and_exits_nonzero(tmp_path, monkeypatch):
    # a wrong golden model: the encode's exact model returns its input
    monkeypatch.setattr(kat_onchip, "exact_encode",
                        lambda modulus, vals: vals)
    monkeypatch.setattr(kat_onchip, "CHECKS", {
        "fixed_base": kat_onchip.check_fixed_base,
        "ntt_encode": kat_onchip.check_ntt})
    out = tmp_path / "kat.json"
    with pytest.raises(SystemExit) as exc:
        kat_onchip.main(["--device", "cpu", "--out", str(out)])
    assert exc.value.code == "KAT failed: ntt_encode"
    rec = json.loads(out.read_text())
    assert not rec["all_pass"] and not rec["partial"]
    assert rec["kats"]["fixed_base"]["pass"]
    bad = rec["kats"]["ntt_encode"]
    assert not bad["pass"] and "differs from the exact model" in bad["err"]


def test_measure_protocol_summaries(capsys):
    res = measure_protocol.main(["--n", "8", "--updates", "2", "--audits",
                                 "1", "--scheme", "kzg", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "initialized n=8 in" in out
    assert "updates: mean" in out and "audits:  mean" in out
    assert "client.update/server.update" in out
    assert len(res["update_s"]) == 2 and len(res["audit_s"]) == 1


def test_tools_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            + "".join(f"import porla_tpu_torch.tools.{t}\n" for t in TOOLS)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'porla_tpu'))\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"bench": bench.main, "kat_onchip": kat_onchip.main,
            "measure_protocol": measure_protocol.main,
            "soak": soak.main}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
