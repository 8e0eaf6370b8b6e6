"""One run of one cell: set-up, the measured window, the check.

The cell names a configuration and a mix (`manifest`). The set-up builds a
`PorlaServer` and a `PorlaClient` of `porla_tpu_torch` on the device,
coupled in process by a transport whose reply leaves once the server's
work on the card is done, initializes n blocks and runs the mix's warm
ops. The window then issues the mix's ops back to back for `seconds`,
each timed on the host clock from its call to its return, the card
synchronised. With `traced` the program's spans are on (each waiting for
the card before its clock stops) and `torch.profiler` records the card.

After the window the server's state is read to the host and freed (the
data of a level above the caching level from the store's codeword files,
before the store is removed), and the reference (`porla_bench.reference`)
replays the same requests from the same seed: the state and a sample of
the audit replies must be what it works out, exactly.
"""

from __future__ import annotations

import gc
import os
import random
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import torch

from porla_bench import devtrace, manifest, state, traffic
from porla_bench.reference import check
from porla_bench.reference.protocol import Deployment, Replay

# the numbers `correct` compares and their limits: every one is exact
LIMITS = {"failed": 0, "data": 0, "planes": 0, "blocks": 0, "replies": 0}


@dataclass
class Run:
    """What a metric reader reads: the window's ops (kind, ms, ok, the
    port's kernel launches, [t0_ns, t1_ns) on the profiler's clock), and
    in a traced run the program's spans, the card's trace and the port's
    kernel function names."""
    ops: list
    spans: list = field(default_factory=list)
    device: devtrace.DeviceTrace | None = None
    kernel_names: set = field(default_factory=set)


def deployment(cfg: dict) -> Deployment:
    return Deployment(cfg["scheme"], cfg["num_blocks"], cfg["num_chunks"],
                      cfg["num_check_audit"], bytes.fromhex(cfg["secret_key"]),
                      bytes.fromhex(cfg["tau_key"]), cfg["top_caching_level"])


def _program(cfg: dict, store: str, dev, seed: int):
    """A client and server of the port, coupled in process."""
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.protocol.client import PorlaClient
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import InProcTransport

    class Transport(InProcTransport):
        """Each reply waits for the server's card work, as one over a wire
        does; the last reply is kept for the check."""
        last_reply = b""

        def __call__(self, msg: bytes) -> bytes:
            reply = super().__call__(msg)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.last_reply = reply
            return reply

    pcfg = PorlaConfig(
        scheme=cfg["scheme"], num_chunks=cfg["num_chunks"],
        num_check_audit=cfg["num_check_audit"],
        top_caching_level=cfg["top_caching_level"],
        max_blocks_sent=cfg["max_blocks_sent"],
        secret_key=bytes.fromhex(cfg["secret_key"]),
        tau_key=bytes.fromhex(cfg["tau_key"]), storage_dir=store)
    server = PorlaServer(pcfg, device=dev)
    transport = Transport(server)
    client = PorlaClient(pcfg, transport, data_seed=traffic.data_seed(seed),
                         device=dev)
    return client, server, transport


def _issue(client, op: str, arg) -> None:
    if op == "update":
        client.update(client.write_step % client.num_blocks + 1)
    else:
        client.audit(arg)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", root: str = manifest.ROOT, t_start=None,
             fault=None) -> dict:
    """One run; returns the result line's object. `fault`, for the
    control and the tests, plants a fault in the timed path
    (`porla_bench.faults`)."""
    from porla_tpu_torch import native
    from porla_tpu_torch.utils import trace

    t_call = time.perf_counter()
    t_start = t_call if t_start is None else t_start
    bench = manifest.load(root)
    cell = manifest.cell(bench, workload)
    cfg = manifest.config(bench, cell["config"], root)
    mix = manifest.traffic(cell["traffic"], root)
    wanted = manifest.metrics_for(bench, workload, traced)
    readers = {m["name"]: manifest.reader(m["name"], root)
               for m in wanted if m["name"] != "setup_s"}
    dep = deployment(cfg)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    store = tempfile.mkdtemp(prefix="porla_bench_")
    try:
        client, server, transport = _program(cfg, store, dev, seed)
        t_init = time.perf_counter()
        client.initialize(dep.n)
        sync()
        t_warm = time.perf_counter()
        for op, arg in traffic.setup_ops(mix, seed):
            _issue(client, op, arg)
        sync()
        setup_s = time.perf_counter() - t_start
        phases = {"setup": setup_s, "imports": t_call - t_start,
                  "open": t_init - t_call, "initialize": t_warm - t_init,
                  "warm": t_start + setup_s - t_warm}

        planted = None
        if fault is not None:
            from porla_bench import faults
            planted = faults.plant(fault, client, server, transport)
        if traced:
            trace.reset()
            trace.enable(True, sync=sync)
        clock = devtrace.Clock()
        prof = devtrace.profiler() if traced and cuda else None
        ops, replies = [], []
        t_win = time.perf_counter()
        deadline = t_win + seconds
        for op, arg in traffic.window_ops(mix, seed):
            if time.perf_counter() >= deadline:
                break
            native.reset_launches()
            t0 = time.perf_counter()
            ok, err = True, None
            try:
                _issue(client, op, arg)
                sync()
            except Exception as e:      # a failed op is counted, not fatal
                ok, err = False, f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
            ops.append({"kind": op, "ms": 1e3 * (t1 - t0), "ok": ok,
                        "launches": sum(native.launches().values()),
                        "t0_ns": clock.ns(t0), "t1_ns": clock.ns(t1),
                        "error": err})
            if op == "audit":
                replies.append((len(ops) - 1, arg, transport.last_reply))
            if not ok:
                break
        t_end = time.perf_counter()
        phases["window"] = t_end - t_win
        run = Run(ops)
        if traced:
            run.spans = trace.spans()
            trace.enable(False)
        if prof is not None:
            run.device = devtrace.collect(prof, clock.ns(t_win),
                                          clock.ns(t_end))
            run.kernel_names = devtrace.kernel_names(
                os.path.join(os.path.dirname(os.path.dirname(native.__file__)),
                             k.source) for k in native.KERNELS.values())
        phases["trace"] = time.perf_counter() - t_end
        if planted is not None:
            planted.close()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        prog = state.server_state(server, dep.curve.p, dep.q, store)
        del client, server, transport
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(store, ignore_errors=True)

    t_check = time.perf_counter()
    checks = _check(dep, mix, seed, ops, replies, prog)
    phases["check"] = time.perf_counter() - t_check
    failed = sum(not op["ok"] for op in ops)
    checks["failed"] = failed
    correct = bool(ops) and all(checks[k] <= LIMITS[k] for k in LIMITS)

    metrics = {}
    for m in wanted:
        v = setup_s if m["name"] == "setup_s" else readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(ops), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if run.device is not None:
        dev_info["busy_s"] = devtrace.busy_ns(
            run.device.intervals,
            [(run.device.start_ns, run.device.end_ns)]) / 1e9
        dev_info["window_s"] = run.device.window_s
        result["breakdown"] = {
            "device_ops": devtrace.device_ops(run.device),
            "idle_gaps": devtrace.idle_gaps(run.device, run.spans, clock)}
    errors = [op["error"] for op in ops if op["error"]]
    if errors:
        result["errors"] = errors[:3]
    result["phases_s"] = phases
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]}
                        for k in LIMITS}
    return result


def _check(dep: Deployment, mix: dict, seed: int, ops: list, replies: list,
           prog: dict) -> dict:
    """Replay the run's requests on the reference; count what differs."""
    rng = random.Random(f"porla_bench check {seed}")
    k = min(mix["check_audits"], len(replies))
    sampled = {replies[i][0]: replies[i]
               for i in rng.sample(range(len(replies)), k)}
    ref = Replay(dep, traffic.data_seed(seed))
    ref.initialize()
    for op, _ in traffic.setup_ops(mix, seed):
        if op == "update":
            ref.update()
    bad_replies = 0
    for i, op in enumerate(ops):
        if op["kind"] == "update":
            ref.update()
        elif i in sampled:
            _, arg, reply = sampled[i]
            bad_replies += not check.reply_matches(dep, ref.audit_reply(arg),
                                                   reply)
    out = check.check_state(dep, ref, prog, rng)
    out["replies"] = bad_replies
    return out
