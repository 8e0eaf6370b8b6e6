"""A protocol epoch over a multi-process run: in every process the client
and the server, the server sharded over the run's mesh
(`parallel.multihost`).

Launch the same command in every process (process 0 serves the run's
store at the coordinator's address):

    python -m porla_tpu_torch.tools.run_multihost --coordinator host0:9876 \\
        --nprocs 2 --proc-id $I --backend nccl --n 4096

One card, two processes, each with a logical mesh of two shards on it
(gloo between the processes, through pinned host buffers):

    python -m porla_tpu_torch.tools.run_multihost --coordinator \\
        localhost:9876 --nprocs 2 --proc-id $I --backend gloo \\
        --device cuda:0,cuda:0

`--device cpu,cpu` runs the plain versions on the CPU. The backend is
always named: gloo (TCP) or nccl (one card a process). Each process joins
the run, builds the mesh of `multihost.make_mesh()` (dp across the
processes, tp = 2 within each when it holds an even number of shards) and
runs initialize, one update and one audit, which must verify ("audit
PASSED"). Its last line is a JSON record: the mesh, seconds per phase,
the bytes it moved through torch.distributed, the kernels' launches, and
on the card its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", required=True, help="host0:port")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--backend", choices=["gloo", "nccl"], required=True)
    ap.add_argument("--device", default=None,
                    help="this process's shard devices, comma-separated "
                         "(default: every card torch finds)")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--scheme", choices=["ipa", "kzg"], default="ipa")
    args = ap.parse_args(argv)

    from porla_tpu_torch import native
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.parallel import multihost
    from porla_tpu_torch.protocol.client import PorlaClient
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import InProcTransport

    devices = None if args.device is None else args.device.split(",")
    t0 = time.perf_counter()
    multihost.init_distributed(args.coordinator, args.nprocs, args.proc_id,
                               args.backend, devices)
    rec = {"proc": args.proc_id, "nprocs": args.nprocs,
           "backend": args.backend, "init_s": time.perf_counter() - t0}
    mesh = multihost.make_mesh()
    dev = mesh.primary
    rec["mesh"] = mesh.shape
    rec["devices"] = [str(d) for d in mesh.grid[mesh.rows[0]]]
    print(f"proc {args.proc_id}/{args.nprocs}: mesh {mesh.shape}, rows "
          f"{mesh.rows} on {rec['devices']}", flush=True)

    multihost.reset_traffic()
    native.reset_launches()
    with tempfile.TemporaryDirectory(prefix="porla_mh_") as store:
        cfg = PorlaConfig(scheme=args.scheme, mesh=mesh, storage_dir=store)
        server = PorlaServer(cfg, device=dev)
        client = PorlaClient(cfg, InProcTransport(server),
                             data_seed=bytes([9] * 16), device=dev)
        phases = {}
        for name, fn in (("initialize", lambda: client.initialize(args.n)),
                         ("update", lambda: client.update(1)),
                         ("audit", lambda: client.audit(
                             seed=bytes([2] * 16)))):
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            phases[name] = time.perf_counter() - t0
            print(f"proc {args.proc_id}: {name}(n={args.n}) in "
                  f"{phases[name]:.3f}s", flush=True)
    print(f"proc {args.proc_id}: audit PASSED", flush=True)
    rec.update(n=args.n, scheme=args.scheme, s=phases,
               epoch_s=sum(phases.values()), traffic=dict(multihost.TRAFFIC),
               launches=native.launches())
    if dev.type == "cuda":
        rec["card"] = native.card_line(dev.index or 0)
    multihost.close()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
