"""The metric arithmetic: means and percentiles over every op, not medians
of chunks; a span's self time; the device timeline's busy and idle time,
its kernels by name and its idle gaps by host span."""

from __future__ import annotations

import os
import statistics

import numpy as np
import pytest

from porla_bench import devtrace, manifest, spans
from porla_bench.harness import Run


def _ops(kind, values, t0=0):
    out = []
    for i, ms in enumerate(values):
        start = t0 + 1000 * i
        out.append({"kind": kind, "ms": ms, "ok": True, "launches": i,
                    "t0_ns": start, "t1_ns": start + 500})
    return out


def test_mean_and_percentiles_over_every_op():
    # ten fast ops then two slow ones: chunks of four have medians that
    # miss the slow tail, which the mean and the percentile must keep
    values = [10.0] * 10 + [100.0, 300.0]
    run = Run(_ops("update", values) + _ops("audit", [5.0]))
    mean = manifest.reader("update_ms.mean")(run)
    assert mean == pytest.approx(sum(values) / len(values))
    chunk_medians = [statistics.median(values[i:i + 4]) for i in (0, 4, 8)]
    assert mean != pytest.approx(statistics.median(chunk_medians))
    assert manifest.reader("update_ms.p95")(run) == pytest.approx(
        np.percentile(values, 95))
    assert manifest.reader("audit_ms.p90")(run) == 5.0
    assert manifest.reader("op_ms.audit")(run) == 5.0
    assert spans.percentile([1, 2, 3, 4], 50) == 2.5
    assert spans.percentile([], 50) is None


def test_failed_ops_and_absent_kinds_read_nothing():
    run = Run(_ops("update", [1.0, 2.0]))
    run.ops[1]["ok"] = False
    assert manifest.reader("update_ms.mean")(run) == 1.0
    assert manifest.reader("op_ms.audit")(run) is None
    assert manifest.reader("launches.audit")(run) is None
    assert manifest.reader("launches.update")(run) == 0


def _span(path, ts, s, depth=None):
    return {"path": path, "name": path.rsplit("/", 1)[-1],
            "depth": path.count("/") if depth is None else depth,
            "ts": ts, "elapsed_s": s}


def test_span_self_time():
    run = Run(_ops("update", [30.0, 30.0]), spans=[
        _span("client.update/server.update/server.hadd", 0.001, 0.004),
        _span("client.update/server.update", 0.0, 0.010),
        _span("client.update", 0.0, 0.025),
        _span("client.update/server.update", 1.0, 0.020),
        _span("client.update", 1.0, 0.035)])
    assert manifest.reader("client_ms.update")(run) == pytest.approx(15.0)
    assert manifest.reader("server_ms.update")(run) == pytest.approx(15.0)
    assert manifest.reader("hadd_ms.update")(run) == pytest.approx(2.0)
    assert manifest.reader("client_ms.audit")(run) is None
    assert manifest.reader("prove_ms.audit")(run) is None


def test_device_timeline():
    iv = [(0, 10, "void fixed_base_kernel<true>(unsigned int const*)"),
          (5, 20, "ntt_pass_kernel(long const*, long*)"),
          (30, 40, "void at::native::elementwise_kernel<128, 4>(int)"),
          (100, 150, "Memcpy DtoH (Device -> Pageable)")]
    assert devtrace.union(iv) == [(0, 20), (30, 40), (100, 150)]
    assert devtrace.busy_ns(iv, [(0, 200)]) == 80
    assert devtrace.busy_ns(iv, [(15, 35), (120, 130)]) == 20
    names = {"fixed_base_kernel", "ntt_pass_kernel"}
    assert [devtrace.is_kernel(n, names) for *_, n in iv] == \
        [True, True, False, False]
    trace = devtrace.DeviceTrace(iv, 0, 200)
    ops = _ops("update", [1e-4, 1e-4], t0=0)
    ops[0].update(t0_ns=0, t1_ns=60)
    ops[1].update(t0_ns=60, t1_ns=200)
    run = Run(ops, device=trace, kernel_names=names)
    assert manifest.reader("kernel_ms.update")(run) == pytest.approx(10e-6)
    assert manifest.reader("device_idle_pct.update")(run) == \
        pytest.approx(100 * (1 - 80 / 200))
    top = dict(devtrace.device_ops(trace))
    assert top["Memcpy DtoH"] == pytest.approx(50e-9)
    assert top["fixed_base_kernel<true>"] == pytest.approx(10e-9)


def test_idle_gaps_go_to_the_deepest_span():
    clock = devtrace.Clock()
    clock.pc0, clock.ns0 = 0.0, 0
    trace = devtrace.DeviceTrace([(0, 100, "k"), (300, 400, "k")], 0, 1000)
    spans_ = [_span("client.update", 0.0, 1e-6),
              _span("client.update/client.commit", 150e-9, 200e-9)]
    gaps = dict(devtrace.idle_gaps(trace, spans_, clock))
    assert gaps == pytest.approx({"client.update/client.commit": 200e-9,
                                  "client.update": 600e-9})


def test_kernel_names_come_from_the_port_sources():
    from porla_tpu_torch import native
    root = os.path.dirname(os.path.dirname(native.__file__))
    names = devtrace.kernel_names(os.path.join(root, k.source)
                                  for k in native.KERNELS.values())
    assert {"ntt_pass_kernel", "fixed_base_kernel", "group_sum_kernel",
            "scalar_mul_glv_kernel", "glv_butterfly_kernel"} <= names
