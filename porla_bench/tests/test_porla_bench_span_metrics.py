"""The readers of the spans that name the host's time: each on a synthetic
run, through the `parent` and `root` ids the program's spans carry, and
nothing read from spans without ids (a program that records none)."""

from __future__ import annotations

import pytest

from porla_bench import manifest
from porla_bench.harness import Run

NEW = ["unspanned_ms.update", "unspanned_ms.audit", "prg_ms.update",
       "wire_ms.update", "absorb_ms.update", "store_ms.update",
       "align_ms.update", "fold_data_ms.update", "verify_ms.audit",
       "host_ec_ms.audit"]


def _ops(kind, n):
    return [{"kind": kind, "ms": 1.0, "ok": True, "launches": 0,
             "t0_ns": 0, "t1_ns": 1} for _ in range(n)]


class _Spans:
    """Spans of requests, recorded as the program records them: each with
    its id, its parent's id and its request's root id."""

    def __init__(self):
        self.records, self.next_id = [], 1

    def add(self, path, ts, s, parent=None):
        rec = {"path": path, "name": path.rsplit("/", 1)[-1],
               "depth": path.count("/"), "ts": ts, "elapsed_s": s,
               "id": self.next_id,
               "parent": None if parent is None else parent["id"],
               "root": self.next_id if parent is None else parent["root"]}
        self.next_id += 1
        self.records.append(rec)
        return rec


def _update_run():
    """Two updates of 100 and 60 ms. The first has leaves of 92 ms and
    8 ms in no leaf; the second names only its PRG and its replay, 20 ms.
    `client.replay_fold` is a parent in the first update and a leaf in
    the second."""
    sp = _Spans()
    u = sp.add("client.update", 0.0, 0.100)
    sp.add("client.update/client.prg", 0.001, 0.010, u)
    sp.add("client.update/client.serialize", 0.011, 0.005, u)
    r = sp.add("client.update/client.replay_fold", 0.016, 0.020, u)
    sp.add("client.update/client.replay_fold/fold.data", 0.017, 0.003, r)
    sp.add("client.update/client.replay_fold/hlog.fold", 0.020, 0.016, r)
    sp.add("client.update/client.serialize", 0.036, 0.005, u)
    s = sp.add("client.update/server.update", 0.041, 0.058, u)
    p = "client.update/server.update/"
    sp.add(p + "server.block_write", 0.041, 0.010, s)
    sp.add(p + "server.parse", 0.051, 0.005, s)
    h = sp.add(p + "server.hadd", 0.056, 0.034, s)
    sp.add(p + "server.hadd/server.align", 0.056, 0.020, h)
    f = sp.add(p + "server.hadd/hlog.fold", 0.078, 0.010, h)
    sp.add(p + "server.hadd/hlog.fold/fold.data", 0.078, 0.005, f)
    sp.add(p + "server.hadd/hlog.fold/fold.data", 0.083, 0.005, f)
    sp.add(p + "server.parse", 0.090, 0.005, s)
    sp.add(p + "server.absorb", 0.095, 0.003, s)
    u2 = sp.add("client.update", 1.0, 0.060)
    sp.add("client.update/client.prg", 1.0, 0.010, u2)
    sp.add("client.update/client.replay_fold", 1.01, 0.010, u2)
    return Run(_ops("update", 2), spans=sp.records)


def test_update_readers():
    run = _update_run()
    # 160 ms of requests less their leaves: 10 + 5 + 3 + 16 + 5 + 10 + 5
    # + 20 + 5 + 5 + 5 + 3 = 92 in the first, 10 + 10 in the second
    assert manifest.reader("unspanned_ms.update")(run) == pytest.approx(
        (160 - 112) / 2)
    assert manifest.reader("prg_ms.update")(run) == pytest.approx(10.0)
    assert manifest.reader("wire_ms.update")(run) == pytest.approx(10.0)
    assert manifest.reader("store_ms.update")(run) == pytest.approx(5.0)
    assert manifest.reader("absorb_ms.update")(run) == pytest.approx(1.5)
    assert manifest.reader("align_ms.update")(run) == pytest.approx(10.0)
    # the client's fold.data is not the server's
    assert manifest.reader("fold_data_ms.update")(run) == pytest.approx(5.0)
    assert manifest.reader("unspanned_ms.audit")(run) is None


def test_audit_readers():
    sp = _Spans()
    a = sp.add("client.audit", 0.0, 0.200)
    sp.add("client.audit/audit.plan", 0.0, 0.010, a)
    s = sp.add("client.audit/server.audit", 0.010, 0.100, a)
    pr = sp.add("client.audit/server.audit/server.audit.prove", 0.02, 0.08,
                s)
    for k in range(4):
        sp.add("client.audit/server.audit/server.audit.prove/ecc.host",
               0.02 + 0.02 * k, 0.015, pr)
    m = sp.add("client.audit/client.audit.mac_check", 0.11, 0.01, a)
    sp.add("client.audit/client.audit.mac_check/ecc.host", 0.11, 0.008, m)
    v = sp.add("client.audit/ipa.verify", 0.12, 0.07, a)
    sp.add("client.audit/ipa.verify/ecc.host", 0.12, 0.03, v)
    sp.add("client.audit/ipa.verify/ipa.msm", 0.15, 0.02, v)
    run = Run(_ops("audit", 2), spans=sp.records)
    # leaves: plan 10, prover's curve 4 x 15, the check's 8, the
    # verifier's 30 and its MSM 20 = 128 of the audit's 200 ms
    assert manifest.reader("unspanned_ms.audit")(run) == pytest.approx(36.0)
    assert manifest.reader("verify_ms.audit")(run) == pytest.approx(35.0)
    assert manifest.reader("host_ec_ms.audit")(run) == pytest.approx(49.0)
    assert manifest.reader("unspanned_ms.update")(run) is None


def test_a_root_without_children_is_all_unspanned():
    sp = _Spans()
    sp.add("client.update", 0.0, 0.050)
    run = Run(_ops("update", 1), spans=sp.records)
    assert manifest.reader("unspanned_ms.update")(run) == pytest.approx(50.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(name):
    """No spans (an untraced run), or spans without ids and without the
    new names (a program that records neither): every reader gives None."""
    kind = name.rsplit(".", 1)[1]
    assert manifest.reader(name)(Run(_ops(kind, 3))) is None
    old = [{"path": "client." + kind, "name": "client." + kind, "depth": 0,
            "ts": 0.0, "elapsed_s": 0.1},
           {"path": f"client.{kind}/server.{kind}", "name": "server." + kind,
            "depth": 1, "ts": 0.0, "elapsed_s": 0.05}]
    assert manifest.reader(name)(Run(_ops(kind, 3), spans=old)) is None
