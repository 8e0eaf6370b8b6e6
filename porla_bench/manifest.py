"""Find the benchmark's pieces by name.

`BENCHMARK.json`, at the root of the checkout, names the cells, the
configurations (each with its file), the traffic mixes and the metrics.
A mix `<name>` is the data file `porla_bench/traffic/<name>.json`; a
metric `<name>` is read by `porla_bench/metrics/<name>.py`, a module with
`read(run) -> float | None`. Adding a configuration, a mix or a metric
is adding its file and its entry; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "porla_bench"


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def reader(name: str, root: str = ROOT):
    """The `read` function of metric `name`'s reader module."""
    path = os.path.join(root, HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "porla_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell_name: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: with tracing the per-layer
    ones, else the end-to-end ones; a metric with `workloads` only in the
    cells it lists."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]
