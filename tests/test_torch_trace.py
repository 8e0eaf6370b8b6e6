"""The port's span tracer (porla_tpu_torch/utils/trace.py), mirroring
tests/test_trace.py: nested spans and their summary, counters on the
current span's path, the disabled no-op, the JSONL dump, and the spans a
small protocol cycle on the CPU emits (the soak and measure tools read
their per-update seconds and span tables from these)."""

import json

import torch

from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport
from porla_tpu_torch.utils import trace

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


def setup_function(_):
    trace.reset()
    trace.enable(True)


def teardown_function(_):
    trace.enable(False)
    trace.reset()


def test_nested_spans_and_summary():
    with trace.span("outer", n=4):
        with trace.span("inner"):
            pass
        with trace.span("inner"):
            pass
    s = trace.summary()
    assert s["outer"]["calls"] == 1
    assert s["outer/inner"]["calls"] == 2
    assert s["outer"]["total_s"] >= s["outer/inner"]["total_s"]
    assert s["outer/inner"]["max_s"] <= s["outer/inner"]["total_s"]


def test_counters_and_gauges_attach_to_current_path():
    with trace.span("op"):
        trace.count("bytes", 10)
        trace.count("bytes", 5)
        trace.gauge("depth", 3)
    trace.count("bytes", 1)  # top level
    s = trace.summary()
    assert s["op/bytes"]["count"] == 15
    assert s["bytes"]["count"] == 1
    assert s["op/depth"]["gauge"] == 3


def test_disabled_is_noop():
    trace.enable(False)
    with trace.span("x"):
        trace.count("c")
        trace.gauge("g", 1)
    assert trace.summary() == {}
    assert not trace.enabled()


def test_jsonl_dump(tmp_path):
    with trace.span("a", k="v"):
        with trace.span("b"):
            pass
    out = tmp_path / "t.jsonl"
    assert trace.dump_jsonl(str(out)) == str(out)
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    # spans in the order they finished: the inner one first
    assert [(r["path"], r["depth"]) for r in lines[:-1]] == [("a/b", 1),
                                                              ("a", 0)]
    assert lines[1]["attrs"] == {"k": "v"} and "attrs" not in lines[0]
    assert "summary" in lines[-1]


def test_report_orders_widest_first():
    with trace.span("slow"):
        with trace.span("fast"):
            pass
    rows = trace.report().splitlines()
    assert rows[0].split()[:2] == ["path", "calls"]
    assert [r.split()[0] for r in rows[1:]] == ["slow", "slow/fast"]


def test_protocol_emits_spans(tmp_path):
    """A tiny n = 4 IPA cycle on the CPU emits the expected span tree."""
    cfg = PorlaConfig(storage_dir=str(tmp_path))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server), device="cpu")
    client.initialize(4)
    client.update(1)
    client.audit()
    s = trace.summary()
    assert s["client.initialize"]["calls"] == 1
    assert s["client.initialize/server.crebuild"]["calls"] == 1
    assert s["client.update"]["calls"] == 1
    assert s["client.update/server.update/server.hadd"]["calls"] == 1
    assert s["client.audit/server.audit/server.audit.gather"]["calls"] == 1
    assert s["client.audit/transport.round_trips"]["count"] == 1
    assert any(k.endswith("transport.round_trips") for k in s)
