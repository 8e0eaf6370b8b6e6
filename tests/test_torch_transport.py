"""The reference's two-process deployment on the port, on the CPU: a server
process (`python -m porla_tpu_torch.tools.demo_e2e --serve --device cpu`,
one torch thread, on a free port) and this process's client over the
port's ZMQ wire (`ZmqClientTransport`).

- An IPA cycle at n = 8: initialize, an audit, 2 updates, an audit, each
  audit verified by the client. The transport's trace counters equal the
  lengths of the messages and replies, and the server's record (printed at
  SIGTERM, rc 0) counts the same requests and bytes.
- Slow tier: the same cycle in KZG; a checkpoint written by an in-process
  server resumed by `--serve --resume` and audited, updated and audited
  over the wire; the port's client against a `porla_tpu` server under
  pyzmq's `serve_zmq`, and `porla_tpu`'s client (pyzmq) against the port's
  server.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import pytest
import torch

from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import (InProcTransport,
                                                ZmqClientTransport)
from porla_tpu_torch.tools.demo_e2e import transport_counts
from porla_tpu_torch.utils import trace

torch.set_num_threads(1)     # two processes side by side
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
WAIT_S = 600                 # a reply's bound: an initialize's CRebuild


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(argv, log=subprocess.PIPE) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=_env(),
                            stdout=log, stderr=subprocess.STDOUT)


def _serve(port, store, *extra, scheme="ipa") -> subprocess.Popen:
    return _start(["-m", "porla_tpu_torch.tools.demo_e2e", "--serve",
                   "--device", "cpu", "--port", str(port), "--store",
                   str(store), "--scheme", scheme, *extra])


def _stop(proc) -> dict:
    """SIGTERM the demo server; its last line is its record."""
    try:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = out.decode(errors="replace")
    assert proc.returncode == 0, out[-3000:]
    return json.loads(out.strip().splitlines()[-1])


class Lengths(ZmqClientTransport):
    """The port's client transport, keeping each message's and reply's
    length."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.sent, self.received = [], []

    def __call__(self, msg):
        reply = super().__call__(msg)
        self.sent.append(len(msg))
        self.received.append(len(reply))
        return reply


def _cycle(scheme, tmp_path):
    """initialize -> audit -> 2 updates -> audit against a server process;
    returns (the client's transport, its trace counters, the server's
    record)."""
    port = _free_port()
    proc = _serve(port, tmp_path, scheme=scheme)
    try:
        tr = Lengths(f"tcp://localhost:{port}", timeout_s=WAIT_S)
        cfg = PorlaConfig(scheme=scheme)
        client = PorlaClient(cfg, tr, data_seed=bytes(range(16)),
                             device="cpu")
        trace.reset()
        trace.enable()
        try:
            client.initialize(N)
            client.audit(seed=bytes(16))
            client.update(1)
            client.update(2)
            client.audit(seed=bytes(range(16)))
            counts = transport_counts()
        finally:
            trace.enable(False)
            trace.reset()
        tr.close()
    finally:
        record = _stop(proc)
    return tr, counts, record


def test_ipa_cycle_between_processes(tmp_path):
    tr, counts, record = _cycle("ipa", tmp_path)
    request_s = counts.pop("request_s")
    assert counts == {"round_trips": len(tr.sent),
                      "bytes_sent": sum(tr.sent),
                      "bytes_received": sum(tr.received)}
    assert set(request_s) == {"initialize", "update", "audit"}
    # initialize: the generators, the count, one message of blocks, the
    # deltas; then 2 updates and 2 audits
    assert len(tr.sent) == 4 + 2 + 2
    reqs = record["requests"]
    assert {k: r["calls"] for k, r in reqs.items()} == {
        "initialize": 4, "update": 2, "audit": 2}
    assert sum(r["bytes_received"] for r in reqs.values()) == sum(tr.sent)
    assert sum(r["bytes_sent"] for r in reqs.values()) == sum(tr.received)
    assert record["mode"] == "fresh" and record["device"] == "cpu"


@pytest.mark.slow
def test_kzg_cycle_between_processes(tmp_path):
    tr, counts, record = _cycle("kzg", tmp_path)
    assert counts["bytes_sent"] == sum(tr.sent)
    assert record["requests"]["initialize"]["calls"] == 4


@pytest.mark.slow
def test_resume_across_processes(tmp_path):
    cfg = PorlaConfig(scheme="ipa", storage_dir=str(tmp_path))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server),
                         data_seed=bytes(range(16)), device="cpu")
    client.initialize(N)
    client.update(1)
    server.save_checkpoint()
    port = _free_port()
    proc = _serve(port, tmp_path, "--resume")
    try:
        client.transport = ZmqClientTransport(f"tcp://localhost:{port}",
                                              timeout_s=WAIT_S)
        client.audit(seed=bytes(range(16)))
        client.update(2)
        client.audit(seed=bytes(16))
        client.transport.close()
    finally:
        record = _stop(proc)
    assert record["mode"] == "resumed"
    assert {k: r["calls"] for k, r in record["requests"].items()} == {
        "audit": 2, "update": 1}


# the reference server compiles its kernels on the CPU at its first
# CRebuild and audit: minutes, more beside other compiling tests
REFERENCE_WAIT_S = 1800
_REFERENCE_SERVER = """
import os, sys
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.expanduser("~/.jax_cache"))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
from porla_tpu.config import PorlaConfig
from porla_tpu.protocol.server import PorlaServer
from porla_tpu.protocol.transport import serve_zmq
serve_zmq(PorlaServer(PorlaConfig(storage_dir=sys.argv[1])), sys.argv[2])
"""


@pytest.mark.slow
def test_port_client_against_reference_server(tmp_path):
    pytest.importorskip("zmq")
    port = _free_port()
    # a file, not a pipe: the reference server logs more than a pipe holds,
    # and nothing reads the pipe until the server is killed
    with open(tmp_path / "server.log", "wb") as log:
        proc = _start(["-c", _REFERENCE_SERVER, str(tmp_path),
                       f"tcp://127.0.0.1:{port}"], log)
    try:
        tr = ZmqClientTransport(f"tcp://localhost:{port}",
                                timeout_s=REFERENCE_WAIT_S)
        client = PorlaClient(PorlaConfig(), tr, data_seed=bytes(range(16)),
                             device="cpu")
        client.initialize(N)
        client.audit(seed=bytes(16))
        client.update(1)
        client.audit(seed=bytes(range(16)))
        tr.close()
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.slow
def test_reference_client_against_port_server(tmp_path):
    zmq = pytest.importorskip("zmq")
    from porla_tpu.config import PorlaConfig as RefConfig
    from porla_tpu.protocol.client import PorlaClient as RefClient
    from porla_tpu.protocol.transport import ZmqClientTransport as RefZmq

    port = _free_port()
    proc = _serve(port, tmp_path)
    try:
        tr = RefZmq(f"tcp://127.0.0.1:{port}")
        tr.sock.setsockopt(zmq.RCVTIMEO, WAIT_S * 1000)
        tr.sock.setsockopt(zmq.LINGER, 0)
        client = RefClient(RefConfig(), tr, data_seed=bytes(range(16)))
        client.initialize(N)
        client.audit(seed=bytes(16))
        client.update(1)
        client.audit(seed=bytes(range(16)))
        tr.sock.close()
    finally:
        record = _stop(proc)
    assert {k: r["calls"] for k, r in record["requests"].items()} == {
        "initialize": 4, "audit": 2, "update": 1}
