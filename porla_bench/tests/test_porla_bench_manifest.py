"""BENCHMARK.json against the benchmark's contract, and discovery by name:
a configuration, a mix and a metric added as new files and new entries
are found without a change to any file already there."""

from __future__ import annotations

import hashlib
import json
import os
import re

import pytest

from porla_bench import manifest, traffic
from porla_bench.harness import Run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["porla_bench"]
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("porla_bench/")
        cfg = manifest.config(BENCH, c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        manifest.traffic(w["traffic"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"] != "setup_s":
            assert callable(manifest.reader(m["name"]))
    for m in BENCH["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        shown = manifest.metrics_for(BENCH, cell, traced=False)
        assert "setup_s" in {m["name"] for m in shown} and len(shown) >= 2
        assert manifest.metrics_for(BENCH, cell, traced=True)


def _digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.join(d, f)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_files_are_found_by_name(tmp_path):
    from conftest import make_root
    root = make_root(str(tmp_path), 1024, 63)
    before = _digest(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # a configuration, a mix and a metric, as new files and new entries
    cfg = manifest.config(bench, "ipa-n1024", root)
    cfg.update(name="ipa-n2048", num_blocks=2048)
    new_cfg = "porla_bench/configs/ipa-n2048.json"
    with open(os.path.join(root, new_cfg), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "porla_bench/traffic/mixed.json"), "w") as f:
        json.dump({"setup": {"write_step": 1, "warm_audits": 1},
                   "window": {"cycle": [["update", 15], ["audit", 1]]},
                   "check_audits": 2}, f)
    reader = os.path.join(root, "porla_bench/metrics/ops.audit.py")
    with open(reader, "w") as f:
        f.write("def read(run):\n"
                "    return sum(op['kind'] == 'audit' for op in run.ops)\n")
    bench["configs"].append({"name": "ipa-n2048", "source": cfg["source"],
                             "file": new_cfg, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ipa-n2048.mixed",
                               "config": "ipa-n2048", "traffic": "mixed",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "ops.audit", "unit": "ops",
                               "better": "higher", "source": "host_clock",
                               "layer": "client", "moves": "audit_ms.p90",
                               "workloads": ["ipa-n2048.mixed"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    # no file that was there changed, but for BENCHMARK.json's new entries
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items()
               if not k.endswith("BENCHMARK.json"))
    bench = manifest.load(root)
    cell = manifest.cell(bench, "ipa-n2048.mixed")
    assert manifest.config(bench, cell["config"], root)["num_blocks"] == 2048
    mix = manifest.traffic(cell["traffic"], root)
    ops = [op for op, _ in zip(traffic.window_ops(mix, 5), range(32))]
    assert [o for o, _ in ops].count("audit") == 2
    assert ops[15][0] == "audit" and ops[15][1] != ops[31][1]
    shown = [m["name"]
             for m in manifest.metrics_for(bench, cell["name"], True)]
    assert shown == ["ops.audit"]
    read = manifest.reader("ops.audit", root)
    run = Run([{"kind": "audit", "ms": 1.0, "ok": True}] * 3)
    assert read(run) == 3


def test_seeds_give_the_same_inputs():
    mix = manifest.traffic("audit")
    a = [x for x, _ in zip(traffic.window_ops(mix, 2**31 + 5), range(4))]
    b = [x for x, _ in zip(traffic.window_ops(mix, 2**31 + 5), range(4))]
    c = [x for x, _ in zip(traffic.window_ops(mix, 2**31 + 6), range(4))]
    assert a == b and a != c and len({s for _, s in a}) == 4
    assert traffic.data_seed(7) == traffic.data_seed(7) != traffic.data_seed(8)
    with pytest.raises(ValueError):
        list(traffic.setup_ops({"setup": {"write_step": 0,
                                          "warm_audits": 0}}, 1))
