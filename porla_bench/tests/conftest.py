"""Test settings of the benchmark's own tests.

    python -m pytest porla_bench/tests -q            # here, on the CPU
    python -m pytest porla_bench/tests -q -m card    # on the card

The `card` marker is for tests that need an NVIDIA card: they decide so in
the `card` fixture, while they run, and skip without one. The CPU tests
run the harness on the port's plain torch versions at n = 8 blocks, on a
copy of the benchmark's files with the configurations cut to that size
(`small_root`).
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    return torch.device("cuda")


def make_root(dest: str, n: int, audit_write_step: int,
              top_caching_level: int | None = None,
              update_write_step: int | None = None) -> str:
    """A copy of BENCHMARK.json and the benchmark's data files under
    `dest`, every configuration at n blocks and the audit mix's set-up at
    `audit_write_step`, with one cell more, `kzg-n1024.audit`, so that the
    tests drive KZG's audit path through the harness too. Given, every
    configuration takes `top_caching_level` (the levels above it in files)
    and the update mix's set-up `update_write_step`."""
    src = os.path.join(REPO, "porla_bench")
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(src, d),
                        os.path.join(dest, "porla_bench", d))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dest, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["num_blocks"] = n
        if top_caching_level is not None:
            cfg["top_caching_level"] = top_caching_level
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name, write_step in (("audit", audit_write_step),
                             ("update", update_write_step)):
        if write_step is None:
            continue
        path = os.path.join(dest, "porla_bench", "traffic", name + ".json")
        with open(path) as f:
            mix = json.load(f)
        mix["setup"]["write_step"] = write_step
        if name == "audit":
            mix["check_audits"] = 2
        with open(path, "w") as f:
            json.dump(mix, f)
    if "kzg-n1024.audit" not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append({"name": "kzg-n1024.audit",
                                   "config": "kzg-n1024", "traffic": "audit",
                                   "chips": 1, "why": "KZG's audit path"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "ipa-n1024.audit" in m.get("workloads", ()):
                m["workloads"].append("kzg-n1024.audit")
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")), 8, 5)


@pytest.fixture(scope="session")
def files_root(tmp_path_factory):
    """n = 16 with caching level 2, so levels 3 and 4 are in files. The
    update mix's set-up stops at write step 7, so the window's first
    update folds levels 0-2 into level 3, in files; the audit mix's at
    write step 13, so an audit reads levels 0 and 2 from memory and 3 and
    4 from files."""
    return make_root(str(tmp_path_factory.mktemp("bench_files")), 16, 13,
                     top_caching_level=2, update_write_step=7)
