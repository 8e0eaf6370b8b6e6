"""The port's span tracer (porla_tpu_torch/utils/trace.py), mirroring
tests/test_trace.py: nested spans and their summary, counters on the
current span's path, the disabled no-op, the JSONL dump, the ids that link
each span to its parent and its request, the profiler ranges the spans
open, and the spans a small protocol cycle on the CPU emits in both
schemes (the soak and measure tools and the benchmark's per-layer metrics
read these)."""

import collections
import contextlib
import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

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


def test_counters_attach_to_current_path():
    with trace.span("op"):
        trace.count("bytes", 10)
        trace.count("bytes", 5)
    trace.count("bytes", 1)  # top level
    s = trace.summary()
    assert s["op/bytes"]["count"] == 15
    assert s["bytes"]["count"] == 1


def test_disabled_is_noop():
    trace.enable(False)
    with trace.span("x"):
        trace.count("c")
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
    assert lines[0]["parent"] == lines[1]["id"] == lines[0]["root"]
    assert "summary" in lines[-1]


def test_records_link_parent_and_request():
    """A name that is a leaf in one call and a parent in another: the ids,
    not the paths, tell the two calls apart."""
    with trace.span("request"):
        with trace.span("fold"):
            pass
        with trace.span("fold"):
            with trace.span("mix"):
                pass
    with trace.span("request"):
        pass
    leaf, mix, parent, req, req2 = trace.spans()
    assert [r["name"] for r in (leaf, mix, parent, req, req2)] == [
        "fold", "mix", "fold", "request", "request"]
    assert (req["parent"], req["root"]) == (None, req["id"])
    assert (req2["parent"], req2["root"]) == (None, req2["id"])
    assert leaf["parent"] == parent["parent"] == req["id"]
    assert (mix["parent"], mix["root"]) == (parent["id"], req["id"])
    assert len({r["id"] for r in (leaf, mix, parent, req, req2)}) == 5
    named = {r["parent"] for r in trace.spans()}
    assert [r["id"] in named for r in (leaf, mix, parent)] == [False, False,
                                                              True]


def test_spans_open_profiler_ranges():
    """Under a recording profiler each span is a record_function range of
    its name, inside the span's own interval; with tracing off, none."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).sum()
    ranges = [e for e in prof.events() if e.name in ("outer", "inner")]
    assert sorted(e.name for e in ranges) == ["inner", "outer"]
    outer = next(e for e in ranges if e.name == "outer")
    inner = next(e for e in ranges if e.name == "inner")
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end

    trace.enable(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name == "outer"]
    assert [r["name"] for r in trace.spans()] == ["inner", "outer"]


def test_report_orders_widest_first():
    with trace.span("slow"):
        with trace.span("fast"):
            pass
    rows = trace.report().splitlines()
    assert rows[0].split()[:2] == ["path", "calls"]
    assert [r.split()[0] for r in rows[1:]] == ["slow", "slow/fast"]


# --- a protocol cycle -----------------------------------------------------

class _Ranges:
    """Stands in for `torch.profiler.record_function`: keeps the names of
    the ranges the spans enter."""

    def __init__(self):
        self.names = []

    def __call__(self, name):
        self.names.append(name)
        return contextlib.nullcontext()


def _cycle(scheme, store):
    """Initialize n = 8, four updates (the fourth folds to level 2) and an
    audit with the spans on, a profiler taken as recording; then one more
    update with the spans off."""
    mp = pytest.MonkeyPatch()
    ranges = _Ranges()
    mp.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    mp.setattr(torch.profiler, "record_function", ranges)
    try:
        cfg = PorlaConfig(scheme=scheme, storage_dir=str(store))
        server = PorlaServer(cfg, device="cpu")
        client = PorlaClient(cfg, InProcTransport(server), device="cpu")
        # construction builds the parties' K4 tables in spans: the cycle's
        # spans and ranges both start here
        trace.reset()
        ranges.names.clear()
        trace.enable(True)
        client.initialize(8)
        for _ in range(4):
            client.update(client.write_step % 8 + 1)
        client.audit()
        out = SimpleNamespace(spans=trace.spans(), summary=trace.summary(),
                              ranges=list(ranges.names))
        trace.enable(False)
        trace.reset()
        ranges.names.clear()
        client.update(client.write_step % 8 + 1)
        out.off_spans, out.off_ranges = trace.spans(), list(ranges.names)
    finally:
        trace.enable(False)
        trace.reset()
        mp.undo()
    return out


@pytest.fixture(scope="module")
def ipa_cycle(tmp_path_factory):
    return _cycle("ipa", tmp_path_factory.mktemp("ipa"))


@pytest.fixture(scope="module")
def kzg_cycle(tmp_path_factory):
    return _cycle("kzg", tmp_path_factory.mktemp("kzg"))


@pytest.fixture(params=["ipa", "kzg"])
def cycle(request):
    out = request.getfixturevalue(f"{request.param}_cycle")
    out.scheme = request.param
    return out


# the paths the benchmark's accepted per-layer metrics read
METRIC_PATHS = [
    "client.update", "client.update/server.update",
    "client.update/server.update/server.hadd", "client.audit",
    "client.audit/server.audit",
    "client.audit/server.audit/server.audit.prove",
    "client.audit/server.audit/server.audit.msm"]

UPDATE = "client.update/"
SERVER = "client.update/server.update/"
AUDIT = "client.audit/"
NEW_PATHS = [
    UPDATE + "client.prg", UPDATE + "client.mac", UPDATE + "client.serialize",
    UPDATE + "client.deltas", UPDATE + "client.deltas/client.complements",
    UPDATE + "client.deltas/point_add",
    UPDATE + "client.replay_fold/hlog.fold",
    SERVER + "server.parse", SERVER + "server.block_write",
    SERVER + "server.absorb", SERVER + "server.hadd/server.hadd.scale",
    SERVER + "server.hadd/server.hadd.scale/point_scale",
    SERVER + "server.hadd/server.align", SERVER + "server.hadd/hlog.fold",
    SERVER + "server.hadd/hlog.fold/fold.data",
    AUDIT + "audit.plan", AUDIT + "client.audit.msm",
    AUDIT + "client.audit.mac_check",
    AUDIT + "client.audit.mac_check/ecc.host",
    AUDIT + "server.audit/audit.plan", AUDIT + "server.audit/server.audit.pad",
    AUDIT + "server.audit/server.align",
    AUDIT + "server.audit/server.audit.commit",
    AUDIT + "server.audit/server.audit.serialize"]
IPA_PATHS = [
    AUDIT + "ipa.verify", AUDIT + "ipa.verify/ecc.host",
    AUDIT + "ipa.verify/ipa.msm", AUDIT + "ipa.verify/ipa.transcript",
    AUDIT + "server.audit/server.audit.prove/ipa.transcript",
    AUDIT + "server.audit/server.audit.prove/ipa.scalars",
    AUDIT + "server.audit/server.audit.prove/ipa.msm2"]


def test_cycle_new_spans_at_their_paths(cycle):
    paths = {s["path"] for s in cycle.spans}
    assert set(NEW_PATHS) <= paths
    assert set(IPA_PATHS) & paths == (set(IPA_PATHS) if cycle.scheme == "ipa"
                                      else set())
    # a span around each dispatch of the audit's single-point scalar
    # multiplications to the card: the MAC check's one, the verifier's one;
    # the prover's u terms are lanes of its rounds' K4 launches (ipa.msm2)
    groups = collections.Counter(s["path"] for s in cycle.spans
                                 if s["name"] == "ecc.host")
    assert groups[AUDIT + "client.audit.mac_check/ecc.host"] == 1
    if cycle.scheme == "ipa":
        assert groups[AUDIT + "ipa.verify/ecc.host"] == 1
        assert groups[AUDIT + "server.audit/server.audit.prove/ecc.host"] \
            == 0


def test_cycle_metric_paths_unchanged(cycle):
    by_path = collections.defaultdict(list)
    for s in cycle.spans:
        by_path[s["path"]].append(s)
    assert all(by_path[p] for p in METRIC_PATHS)
    assert len(by_path["client.update"]) == 4
    assert len(by_path["client.update/server.update/server.hadd"]) == 4
    # no span put around one the metrics read: each sits under the next
    ids = {s["id"]: s for s in cycle.spans}
    for p in (p for p in METRIC_PATHS if "/" in p):
        for s in by_path[p]:
            assert ids[s["parent"]]["path"] == p.rsplit("/", 1)[0]


def test_cycle_records_nest(cycle):
    ids = {s["id"]: s for s in cycle.spans}
    assert len(ids) == len(cycle.spans)
    for s in cycle.spans:
        if s["parent"] is None:
            assert (s["root"], s["depth"]) == (s["id"], 0)
            continue
        up = ids[s["parent"]]
        assert s["root"] == up["root"] and s["depth"] == up["depth"] + 1
        assert s["path"] == up["path"] + "/" + s["name"]
        # both clocks are rounded to the microsecond, so an end may pass
        # its parent's by two roundings
        assert s["ts"] >= up["ts"]
        assert s["ts"] + s["elapsed_s"] <= up["ts"] + up["elapsed_s"] + 2e-6


def test_cycle_leaf_and_parent_calls_of_one_name(cycle):
    """`client.replay_fold` folds at levels 1 and 2 and only scales at
    level 0: the ids give each call its own children, where the paths would
    give every call the children of all."""
    children = collections.defaultdict(set)
    for s in cycle.spans:
        children[s["parent"]].add(s["name"])
    replays = [s for s in cycle.spans if s["name"] == "client.replay_fold"]
    assert sorted(s["attrs"]["level"] for s in replays) == [0, 0, 1, 2]
    for s in replays:
        want = {"point_scale"} if s["attrs"]["level"] == 0 else {
            "point_scale", "client.complements", "hlog.fold"}
        assert children[s["id"]] == want
    # each request's leaves lie inside it, one after another
    for root in (s for s in cycle.spans if s["parent"] is None):
        leaves = sorted((s["ts"], s["ts"] + s["elapsed_s"])
                        for s in cycle.spans
                        if s["root"] == root["id"] and s is not root
                        and s["id"] not in children)
        assert all(b0 >= a1 - 2e-6 for (_, a1), (b0, _) in
                   zip(leaves, leaves[1:]))
        assert sum(b - a for a, b in leaves) <= root["elapsed_s"] + 1e-5


def test_cycle_record_function_per_span(cycle):
    assert collections.Counter(cycle.ranges) == collections.Counter(
        s["name"] for s in cycle.spans)


def test_cycle_tracing_off_records_nothing(cycle):
    assert cycle.off_spans == [] and cycle.off_ranges == []


def test_protocol_emits_spans(ipa_cycle):
    """An n = 8 IPA cycle on the CPU emits the expected span tree."""
    s = ipa_cycle.summary
    assert s["client.initialize"]["calls"] == 1
    assert s["client.initialize/server.crebuild"]["calls"] == 1
    assert s["client.update"]["calls"] == 4
    assert s["client.update/server.update/server.hadd"]["calls"] == 4
    assert s["client.audit/server.audit/server.audit.gather"]["calls"] == 1
    assert s["client.audit/transport.round_trips"]["count"] == 1
    assert any(k.endswith("transport.round_trips") for k in s)
