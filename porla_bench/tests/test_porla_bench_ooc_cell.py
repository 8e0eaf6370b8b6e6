"""The cell `ipa-n16384-ooc.audit` (the deployment
porla_bench/configs/ipa-n16384-ooc.json), on the CPU, in the shared fixture
`files_root`: the benchmark's files with every configuration cut to n = 16
blocks at caching level 2 and the audit mix's set-up at write step 13, so
that every audit reads levels 3 and 4 from their codeword files. A sound
run is correct, each audit fault makes it incorrect, and the readers of
the store's spans read the audit's file reads on a traced run and nothing
on a run without them."""

from __future__ import annotations

import json
import os

import pytest
import torch

from porla_bench import harness, manifest, traffic

CONFIG = "ipa-n16384-ooc"
CELL = CONFIG + ".audit"
SEED = 2**31 + 17
STORAGE = ("file_read_ms.audit", "files_read.audit")


def _run(root, traced=False, fault=None, seconds=1):
    torch.set_num_threads(2)
    return harness.run_cell(CELL, SEED, seconds, traced, device="cpu",
                            root=root, fault=fault)


def _file_samples(root) -> int:
    """The samples an audit of the cell draws from the levels in files."""
    from porla_tpu_torch.protocol import auditing
    bench = manifest.load(root)
    cfg = manifest.config(bench, CONFIG, root)
    mix = manifest.traffic("audit", root)
    n, top = cfg["num_blocks"], cfg["top_caching_level"]
    plan = auditing.build_audit_plan(traffic.seed_bytes(SEED, "audit", 0),
                                     mix["setup"]["write_step"], n,
                                     n.bit_length())
    return sum(s.level > top for s in plan.samples)


def test_the_configuration_keeps_the_published_caching_level():
    with open(os.path.join(manifest.ROOT, "porla_bench", "configs",
                           CONFIG + ".json")) as f:
        cfg = json.load(f)
    ref = manifest.config(manifest.load(), "ipa-n1024")
    assert (cfg["num_blocks"], cfg["top_caching_level"]) == (16384, 10)
    assert cfg["reduced"] == ["num_blocks"]
    same = set(ref) - {"name", "source", "deployment", "num_blocks",
                       "guarantees", "reduced", "assumed"}
    assert {k: cfg[k] for k in same} == {k: ref[k] for k in same}


def test_the_manifest_holds_the_cell_and_its_storage_metrics():
    bench = manifest.load()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "audit", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in STORAGE:
        assert metrics[name]["workloads"] == [CELL]
        assert (metrics[name]["layer"], metrics[name]["moves"]) == (
            "storage", "audit_ms.p90")
    # every metric of the in-memory audit cell is read here too
    for m in metrics.values():
        if "ipa-n1024.audit" in m.get("workloads", ()):
            assert CELL in m["workloads"], m["name"]


def test_the_cell_reads_files(files_root):
    cfg = manifest.config(manifest.load(files_root), CONFIG, files_root)
    assert (cfg["num_blocks"], cfg["top_caching_level"]) == (16, 2)
    # levels 3 and 4 in files: 8 + 8 and 16 + 16 samples
    assert _file_samples(files_root) == 48


def test_a_sound_run_is_correct(files_root):
    r = _run(files_root)
    assert r["correct"], r
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert {k: c["value"] for k, c in r["checks"].items()} == dict.fromkeys(
        harness.LIMITS, 0)
    assert {"audit_ms.p90", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("fault", ["half_audit", "altered_answer"])
def test_each_audit_fault_makes_it_incorrect(files_root, fault):
    r = _run(files_root, fault=fault)
    assert not r["correct"], r
    named = {k: c["value"] for k, c in r["checks"].items()}
    assert any(v > 0 for k, v in named.items() if k != "failed"), named


def test_the_readers_read_the_file_reads(files_root):
    r = _run(files_root, traced=True)
    assert r["correct"], r
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["file_read_ms.audit"] > 0
    assert m["files_read.audit"] == _file_samples(files_root)
    assert r["metrics"]["files_read.audit"]["unit"] == "files/op"


def test_the_readers_read_nothing_without_store_spans():
    ops = [{"kind": "audit", "ms": 1.0, "ok": True, "launches": 0,
            "t0_ns": 0, "t1_ns": 1}] * 3
    gather = {"path": "client.audit/server.audit/server.audit.gather",
              "name": "server.audit.gather", "depth": 2, "id": 2,
              "parent": 1, "root": 1, "ts": 0.0, "elapsed_s": 0.01}
    # an untraced run, and a program whose gather opens no store span
    for run in (harness.Run(ops), harness.Run(ops, spans=[gather])):
        for name in STORAGE:
            assert manifest.reader(name)(run) is None
