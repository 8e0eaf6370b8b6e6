"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program. Names are compared by their
top-level part (before the first dot) whole, so `porla_tpu_torch` is not
taken for `porla_tpu`."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

PROBE = """
import glob, json, os, sys
sys.path.insert(0, {repo!r})
import porla_bench.run, porla_bench.harness, porla_bench.faults
import porla_bench.reference.check, porla_bench.reference.protocol
from porla_bench import manifest
from porla_tpu_torch.protocol import client, server, transport
from porla_tpu_torch import native
bench = manifest.load()
for c in bench["configs"]:
    manifest.config(bench, c["name"])
for w in bench["workloads"]:
    manifest.traffic(w["traffic"])
for m in bench["end_to_end"] + bench["per_layer"]:
    if m["name"] != "setup_s":
        manifest.reader(m["name"])
print(json.dumps(porla_bench.run.forbidden_modules()))
"""


def test_nothing_loads_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=REPO)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_tells_the_names_apart():
    sys.path.insert(0, REPO)
    from porla_bench import run
    assert run.forbidden_modules(["porla_tpu_torch", "porla_tpu_torch.native",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["porla_tpu.fields.mont", "jax", "jaxlib.xla",
                                  "flax", "torch"]) == \
        ["flax", "jax", "jaxlib.xla", "porla_tpu.fields.mont"]


def _top_imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert len(files) >= 5
    for path in files:
        tops = _top_imports(path)
        assert not tops & {"porla_tpu_torch", "porla_tpu", "jax", "jaxlib",
                           "flax", "torch"}, path
        assert tops <= {"__future__", "dataclasses", "hashlib", "hmac",
                        "struct", "random", "numpy", "porla_bench"}, path
