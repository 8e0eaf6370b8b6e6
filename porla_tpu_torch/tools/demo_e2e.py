"""End-to-end demo of the port: initialize a database, run updates and
audits (the counterpart of examples/demo_e2e.py, with its flags and its
lines).

One process:     python -m porla_tpu_torch.tools.demo_e2e --n 16
Two processes:   python -m porla_tpu_torch.tools.demo_e2e --serve &
                 python -m porla_tpu_torch.tools.demo_e2e --n 16 \\
                     --connect tcp://localhost:8888

The two processes are the reference's deployment: a server bound to
tcp://*:8888 (`--port`) and a client, over ZeroMQ REQ/REP
(`protocol/transport.py`); either end may be the reference package's.
Start the client once the server has printed its "serving on" line (on
the card, the server builds the kernels first). `--device cpu` runs the
plain versions; the default is the card, and no card raises.

The client checks every audit (a failed one raises, and the process exits
nonzero), prints "ALL CHECKS PASSED", then as its last line a JSON record:
seconds per phase, the transport's counters (`transport.round_trips`,
`transport.bytes_sent`, `transport.bytes_received`) and the seconds of
its round trips per phase (`transport.request` spans), this process's
kernel launches, and on the card its name and power limit. The server
(`--serve`) runs until SIGTERM, then prints a JSON record of the requests
it handled (per kind: initialize's messages, updates, audits; their count,
seconds, bytes and kernel launches) and exits 0. `--resume` serves the
checkpoint that `PorlaServer.save_checkpoint` of either package wrote in
`--store`.
"""

from __future__ import annotations

import argparse
import json
import signal
import tempfile
import time

import torch


class Stopped(Exception):
    """SIGTERM reached the server."""


class Meter:
    """A server's `handle` that records each request's kind, seconds, bytes
    and kernel launches (`requests`)."""

    def __init__(self, server):
        self.server = server
        self.requests = {}

    def handle(self, msg: bytes) -> bytes:
        from porla_tpu_torch import native
        kind = ("initialize" if self.server._state != "ready" else
                "update" if msg[:1] == b"U" else "audit")
        before = native.launches()
        t0 = time.perf_counter()
        reply = self.server.handle(msg)
        if self.server.device.type == "cuda":
            torch.cuda.synchronize(self.server.device)
        dt = time.perf_counter() - t0
        rec = self.requests.setdefault(kind, {
            "calls": 0, "s": 0.0, "bytes_received": 0, "bytes_sent": 0,
            "launches": {k: 0 for k in before}})
        rec["calls"] += 1
        rec["s"] += dt
        rec["bytes_received"] += len(msg)
        rec["bytes_sent"] += len(reply)
        for k, v in native.launches().items():
            rec["launches"][k] += v - before[k]
        return reply


def transport_counts() -> dict:
    """The transport's trace counters, summed over the spans they were
    counted in, and the seconds of its round trips (`transport.request`
    spans) under each client phase's span."""
    from porla_tpu_torch.utils import trace
    out = {"round_trips": 0, "bytes_sent": 0, "bytes_received": 0,
           "request_s": {}}
    for path, rec in trace.summary().items():
        parent, _, name = path.rpartition("/")
        if name == "transport.request":
            phase = parent.split("/")[0].removeprefix("client.")
            out["request_s"][phase] = (out["request_s"].get(phase, 0.0)
                                       + rec["total_s"])
        elif name.startswith("transport.") and "count" in rec:
            out[name[len("transport."):]] += int(rec["count"])
    return out


def device_record(dev) -> dict:
    from porla_tpu_torch import native
    rec = {"device": str(dev), "launches": native.launches()}
    if dev.type == "cuda":
        rec["card"] = native.card_line(dev.index or 0)
    return rec


def serve(args, cfg) -> int:
    from porla_tpu_torch import native
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import serve_zmq

    def stop(signum, frame):
        raise Stopped

    server = (PorlaServer.restore(cfg, device=args.device) if args.resume
              else PorlaServer(cfg, device=args.device))
    if server.device.type == "cuda":
        native.library()            # build or load before the first request
    meter = Meter(server)
    mode = "resumed" if args.resume else "fresh"
    bind = f"tcp://*:{cfg.server_port}"
    signal.signal(signal.SIGTERM, stop)
    print(f"serving on {bind}, store={cfg.storage_dir} ({mode})", flush=True)
    try:
        serve_zmq(meter, bind)
    except Stopped:
        pass
    print(json.dumps({"role": "server", "scheme": cfg.scheme, "mode": mode,
                      "requests": meter.requests,
                      **device_record(server.device)}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16, help="number of 4KB blocks")
    ap.add_argument("--updates", type=int, default=2)
    ap.add_argument("--audits", type=int, default=2)
    ap.add_argument("--serve", action="store_true", help="run a ZMQ server")
    ap.add_argument("--connect", type=str, default=None,
                    help="ZMQ endpoint of a running server")
    ap.add_argument("--port", type=int, default=None,
                    help="with --serve: the tcp port to bind (default 8888, "
                         "the reference's SERVER_PORT)")
    ap.add_argument("--store", type=str, default=None)
    ap.add_argument("--scheme", choices=["ipa", "kzg"], default="ipa")
    ap.add_argument("--top", type=int, default=None,
                    help="top_caching_level (lower it to drive the "
                         "out-of-core streamed tier)")
    ap.add_argument("--stripe", type=int, default=None,
                    help="stream_stripe_blocks for the out-of-core tier")
    ap.add_argument("--resume", action="store_true",
                    help="with --serve: resume from a checkpoint in "
                         "--store (see PorlaServer.save_checkpoint)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.resume and not (args.serve and args.store):
        ap.error("--resume needs --serve and --store")

    from porla_tpu_torch import native
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.protocol.client import PorlaClient
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import (InProcTransport,
                                                    ZmqClientTransport)
    from porla_tpu_torch.utils import trace

    extra = {}
    if args.top is not None:
        extra["top_caching_level"] = args.top
    if args.stripe is not None:
        extra["stream_stripe_blocks"] = args.stripe
    if args.port is not None:
        extra["server_port"] = args.port
    store = args.store
    if store is None and not args.connect:
        store = tempfile.mkdtemp(prefix="porla_store_")
    if store is not None:
        extra["storage_dir"] = store
    cfg = PorlaConfig(scheme=args.scheme, **extra)
    if args.serve:
        return serve(args, cfg)

    dev = native.resolve_device(args.device)
    if args.connect:
        transport = ZmqClientTransport(args.connect)
        where = f"server at {args.connect}"
    else:
        transport = InProcTransport(PorlaServer(cfg, device=dev))
        where = f"store={store}"
    client = PorlaClient(cfg, transport, data_seed=bytes(range(16)),
                         device=dev)
    trace.enable()
    phases = {"initialize": 0.0, "audit": [], "update": []}

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    phases["initialize"] = dt = timed(lambda: client.initialize(args.n))
    print(f"initialized n={args.n} in {dt:.1f}s ({where})", flush=True)
    phases["audit"].append(timed(client.audit))
    print(f"audit #0 PASSED in {phases['audit'][-1]:.1f}s", flush=True)
    for i in range(args.updates):
        block = client.write_step % args.n + 1     # round robin
        phases["update"].append(timed(lambda: client.update(block)))
        print(f"update {i + 1} in {phases['update'][-1]:.1f}s "
              f"(write_step={client.write_step})", flush=True)
    for i in range(args.audits):
        phases["audit"].append(timed(client.audit))
        print(f"audit #{i + 1} PASSED in {phases['audit'][-1]:.1f}s",
              flush=True)
    print("ALL CHECKS PASSED", flush=True)
    if args.connect:
        transport.close()
    print(json.dumps({"role": "client", "scheme": args.scheme, "n": args.n,
                      "s": phases, "transport": transport_counts(),
                      **device_record(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
