"""Multi-process runs over torch.distributed: init, a process-aware mesh,
the shard exchange and the gathers.

Counterpart of `porla_tpu/parallel/multihost.py`. Every process runs the
same program (the client and the server, each process its own copy of the
protocol's host state) under `init_distributed`, and every sharded function
of `parallel.sharded` then spans the processes' shards: a process runs its
own rows of the mesh, exchanges shards with a partner in another process
(`exchange`, paired `batch_isend_irecv`) and gathers results from all of
them (`all_gather`, the reference's `fetch_many` across processes).

The backend is the caller's choice, never guessed:
- "gloo": TCP between host buffers, the stand-in for the reference's DCN
  (its CPU backend over TCP). A shard on a card goes through a pinned host
  copy, explicitly, in `host_staging`.
- "nccl": card tensors go directly; each process has its own card, and
  `init_distributed` raises when two processes of a host name the same one.

Layout (`make_mesh`): the "blocks" axis holds process 0's rows first, so a
stage's low-stride partners share a process and only the widest
log2(processes) exchange stages cross between processes; the "chunks" axis
stays within a process.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from porla_tpu_torch.parallel.sharded import Mesh

# bytes this process moved through torch.distributed since the last
# `reset_traffic()`: shards sent and received by `exchange`, and the other
# processes' rows that `all_gather` brought in
TRAFFIC = {"sent": 0, "received": 0, "gathered": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


@dataclass
class _Fleet:
    store: dist.Store
    rank: int
    world: int
    backend: str
    devices: list          # this process's shard devices
    claims: list           # every process's shard devices, by rank


_FLEET: _Fleet | None = None


def _fleet() -> _Fleet:
    if _FLEET is None:
        raise RuntimeError("call init_distributed first")
    return _FLEET


def _resolve(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str, devices=None) -> None:
    """Join a run of `num_processes` processes. Call once per process
    before any device use. coordinator: "host:port" where process 0 serves
    the run's TCPStore; backend: "gloo" or "nccl" (see the module's
    docstring); devices: this process's shard devices, default every card
    torch finds (a logical mesh repeats one, e.g. ["cuda:0"] * 2).

    In order: the store; the processes' devices, exchanged through it (NCCL
    with two processes on one card raises here, before any NCCL call); the
    process group; the kernels' library (when a shard is on a card) and
    the native runtime, built now; `barrier` (a peer still compiling, 12-24
    s of nvcc, must not strand another inside a collective); and
    `share_fleet_seed`, so no collective runs lazily inside a first MSM."""
    global _FLEET
    if _FLEET is not None:
        raise RuntimeError("init_distributed was already called")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: name gloo or nccl")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError("torch finds no CUDA device; pass devices")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_resolve(d) for d in devices]
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=600))
    store.set(f"porla/devices/{process_id}", json.dumps(
        [socket.gethostname(), [str(d) for d in devices]]))
    keys = [f"porla/devices/{r}" for r in range(num_processes)]
    store.wait(keys)
    claims = [json.loads(store.get(k)) for k in keys]
    # every process has read every claim before any may fail on them; and
    # process 0, which serves the store, may fail (and exit) only once every
    # other process has left that wait, which polls the store
    _wait_all(store, num_processes, "porla/claims", 600.0)
    if process_id == 0:
        _wait_all(store, num_processes, "porla/claims_left", 600.0)
    else:
        store.add("porla/claims_left", 1)
    if len({len(c[1]) for c in claims}) != 1:
        raise ValueError(f"processes hold different shard counts: {claims}")
    if backend == "nccl":
        _check_nccl_devices(claims)
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes)
    _FLEET = _Fleet(store, process_id, num_processes, backend, devices,
                    [[torch.device(d) for d in c[1]] for c in claims])
    if any(d.type == "cuda" for d in devices):
        from porla_tpu_torch import native
        native.library()
    from porla_tpu_torch.runtime import lib as rt
    rt.library()
    barrier("init")
    share_fleet_seed()


def _check_nccl_devices(claims) -> None:
    """NCCL runs one process a card: each process's shards on CUDA, and no
    card of a host named by two processes."""
    owner: dict = {}
    for rank, (hostname, devs) in enumerate(claims):
        for d in {torch.device(x) for x in devs}:
            if d.type != "cuda":
                raise ValueError(f"NCCL needs CUDA shards; process {rank} "
                                 f"names {d}")
            other = owner.setdefault((hostname, d.index), rank)
            if other != rank:
                raise ValueError(f"processes {other} and {rank} share "
                                 f"{d} on {hostname}: NCCL needs a card "
                                 f"per process (use gloo for a logical "
                                 f"mesh on one card)")


def close() -> None:
    """Leave the run once every process has come here (process 0 serves
    the store): destroy the process group and drop the store."""
    global _FLEET
    if _FLEET is not None:
        barrier("close")
        dist.destroy_process_group()
        _FLEET = None


def _wait_all(store, world: int, key: str, timeout_s: float) -> None:
    """Count this process in at `key` and wait until all `world` have come
    (a key may be used again: each use is a new round)."""
    target = -(-store.add(key, 1) // world) * world
    deadline = time.monotonic() + timeout_s
    while store.add(key, 0) < target:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{key}: not every process came")
        time.sleep(0.005)


def barrier(tag: str, timeout_s: float = 3600.0) -> None:
    """Wait until every process reaches `barrier(tag)`, on the run's
    TCPStore, not on a device collective (which times out while a peer is
    still compiling). A tag may be used again: each use is a new round.
    No-op in a one-process run."""
    f = _FLEET
    if f is not None and f.world > 1:
        _wait_all(f.store, f.world, f"porla/barrier/{tag}", timeout_s)


def share_fleet_seed() -> int:
    """Broadcast 32 random bytes from process 0 and make them this
    process's MSM blinding seed (`cuda_msm.set_fleet_seed`): every shard of
    a sharded Pippenger MSM, in any process, must start its buckets at the
    same points. Called by `init_distributed`, a known synchronisation
    point."""
    from porla_tpu_torch.curves import cuda_msm
    f = _fleet()
    dev = f.devices[0] if f.backend == "nccl" else torch.device("cpu")
    t = torch.tensor(list(os.urandom(32)) if f.rank == 0 else [0] * 32,
                     dtype=torch.uint8, device=dev)
    dist.broadcast(t, src=0)
    seed = int.from_bytes(bytes(t.cpu().tolist()), "little")
    cuda_msm.set_fleet_seed(seed)
    return seed


def make_mesh(tp: int | None = None) -> Mesh:
    """The run's ("blocks", "chunks") mesh over every process's shard
    devices: per process (its shards / tp) rows of tp, the rows in process
    order (local partners innermost), tp = 2 when a process's shard count
    is even and above 1."""
    f = _fleet()
    per = len(f.devices)
    if tp is None:
        tp = 2 if per % 2 == 0 and per > 1 else 1
    if per % tp:
        raise ValueError(f"tp = {tp} must divide a process's {per} shards "
                         f"(the chunks axis stays in a process)")
    rows = per // tp
    return Mesh([d for c in f.claims for d in c], f.world * rows, tp,
                ranks=[r for r in range(f.world) for _ in range(rows)],
                rank=f.rank)


def process_local_slice(global_rows: int) -> slice:
    """The rows this process feeds: a contiguous split in process order,
    as `make_mesh` lays out the blocks axis."""
    f = _fleet()
    per = global_rows // f.world
    return slice(f.rank * per, (f.rank + 1) * per)


def host_staging(t: torch.Tensor, device=None) -> torch.Tensor:
    """What torch.distributed moves for `t`. Under gloo a card tensor is
    copied here to a pinned host buffer (device None: before a send or a
    gather) and a received host buffer back to its card (`device`); under
    NCCL, and for CPU tensors, the tensor itself."""
    if _fleet().backend == "nccl":
        return t
    if device is not None:
        return t.to(device, non_blocking=True) if device.type == "cuda" \
            else t
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def exchange(payloads: dict, peers: dict) -> dict:
    """Swap shards with other processes: for each local shard k, send
    payloads[k] to process peers[k][0] and receive the partner's tensor of
    the same shape, matched by the pair's tag peers[k][1]. All sends and
    receives go out as one `batch_isend_irecv`. -> {k: received tensor} on
    payloads[k]'s device."""
    ops, recv = [], {}
    for k in sorted(payloads):
        rank, tag = peers[k]
        out = host_staging(payloads[k].contiguous())
        recv[k] = torch.empty_like(out)
        ops.append(dist.P2POp(dist.isend, out, rank, tag=tag))
        ops.append(dist.P2POp(dist.irecv, recv[k], rank, tag=tag))
        TRAFFIC["sent"] += out.nbytes
        TRAFFIC["received"] += out.nbytes
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return {k: host_staging(t, payloads[k].device) for k, t in recv.items()}


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every process's `t` (same shape in all), in rank order, on t's
    device."""
    f = _fleet()
    out = host_staging(t.contiguous())
    parts = [torch.empty_like(out) for _ in range(f.world)]
    dist.all_gather(parts, out)
    TRAFFIC["gathered"] += out.nbytes * (f.world - 1)
    return [host_staging(p, t.device) for p in parts]
