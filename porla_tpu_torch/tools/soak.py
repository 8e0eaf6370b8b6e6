"""The reference workload on the card: the self-test meter at the
reference's default n = 1024 (Client.cpp:7, Client.hpp:894-919), recorded
as a JSON file.

    python -m porla_tpu_torch.tools.soak --n 1024 --schemes ipa,kzg \\
        --audits 5 --epochs 1 --out soak.json

Per scheme: `initialize`, one warm update that continues the round-robin
rotation and an audit, then `client.self_test` with the host spans on
(`utils/trace.py`): an epoch of n round-robin updates, so every fold depth
from level 0 to log2(n) - 1 and the epoch-closing update (the server's and
the client's full CRebuild) run, with `--audits` audits after the epoch's
last write. The spans go to `trace.jsonl` in the scheme's store. The
record adds to self_test's stats the seconds of each epoch-closing update,
the mean and slowest update per fold level (from the `client.update`
spans), the device and the card's name and power limit. It is rewritten
after each scheme, so a run cut short keeps the schemes that finished.

Each reply of the in-process transport waits for the server's work on the
card (`SyncedTransport`), as a reply over a wire does, so a request's
seconds are its own. The entry points run on the card and raise without
one; `--device cpu` runs the plain versions (use a small `--n`).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from porla_tpu_torch import native
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport
from porla_tpu_torch.utils import trace

DATA_SEED = bytes(range(16))    # the reference soak's data seed


class SyncedTransport(InProcTransport):
    """The in-process transport whose reply leaves once the server's work
    on its card is done."""

    def __call__(self, msg: bytes) -> bytes:
        reply = super().__call__(msg)
        if self.server.device.type == "cuda":
            torch.cuda.synchronize(self.server.device)
        return reply


def open_pair(scheme: str, n: int, store: str, device,
              data_seed: bytes = DATA_SEED):
    """An initialized client and server at n blocks on `device`, the server's
    store in `store`. Returns (client, server, initialize seconds)."""
    config = PorlaConfig(scheme=scheme, storage_dir=store)
    server = PorlaServer(config, device=device)
    client = PorlaClient(config, SyncedTransport(server),
                         data_seed=data_seed, device=device)
    t0 = time.perf_counter()
    client.initialize(n)
    return client, server, time.perf_counter() - t0


def next_update(client) -> None:
    """The update that continues the round-robin rotation (the protocol's
    only order, `UpdateOrderError`)."""
    client.update(client.write_step % client.num_blocks + 1)


def fold_level(write_step: int, n: int) -> int:
    """The level an update at `write_step` (after its increment) forms: its
    lowest set bit, or log2(n) for the epoch-closing update (the CRebuild
    of the top level)."""
    if write_step % n == 0:
        return n.bit_length() - 1
    return (write_step & -write_step).bit_length() - 1


def epoch_stats(times, n: int) -> dict:
    """Per-update seconds [(write_step, s), ...] -> each epoch-closing
    update's seconds, and per fold level its updates, mean and slowest
    seconds (the top level's are the closing updates)."""
    by_level: dict[int, list[float]] = {}
    for ws, s in times:
        by_level.setdefault(fold_level(ws, n), []).append(s)
    top = n.bit_length() - 1
    return {
        "epoch_close_s": by_level.get(top, []),
        "by_level": {str(lv): {"updates": len(v), "mean_s": sum(v) / len(v),
                               "max_s": max(v)}
                     for lv, v in sorted(by_level.items())},
    }


def update_times(spans) -> list[tuple[int, float]]:
    """(write_step, seconds) of every `client.update` span at the top of
    the span tree, in order."""
    return [(s["attrs"]["write_step"], s["elapsed_s"]) for s in spans
            if s["name"] == "client.update" and s["depth"] == 0]


def read_spans(path: str) -> list[dict]:
    """The spans of a `trace.dump_jsonl` file (its last line is the
    summary)."""
    with open(path) as f:
        return [json.loads(line) for line in f][:-1]


def run_scheme(scheme: str, n: int, audits: int, epochs: int,
               device) -> dict:
    dev = native.resolve_device(device)
    store = tempfile.mkdtemp(prefix=f"porla_soak_{scheme}_")
    client, _, t_init = open_pair(scheme, n, store, dev)
    print(f"[{scheme}] initialized n={n} in {t_init:.3f}s", flush=True)

    # a warm update and audit before the metered epochs; the update continues
    # the rotation, as every update must
    next_update(client)
    client.audit()

    trace.reset()
    trace.enable()
    try:
        stats = client.self_test(epochs=epochs, audits_per_epoch=audits)
    finally:
        trace.enable(False)
    path = trace.dump_jsonl(os.path.join(store, "trace.jsonl"))
    stats.update(epoch_stats(update_times(read_spans(path)), n))
    stats.update({"scheme": scheme, "n": n, "init_s": t_init,
                  "device": str(dev),
                  "card": native.card_line(dev.index or 0)
                  if dev.type == "cuda" else None,
                  "trace_jsonl": path})
    print(f"[{scheme}] {json.dumps(stats)}", flush=True)
    return stats


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--audits", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--schemes", default="ipa,kzg")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    results = []
    for scheme in args.schemes.split(","):
        results.append(run_scheme(scheme, args.n, args.audits, args.epochs,
                                  args.device))
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"workload": "self_test (Client.hpp:894-919)",
                           "epochs": args.epochs, "results": results},
                          f, indent=1)
            print(f"wrote {args.out} ({len(results)} scheme(s))", flush=True)
    return results


if __name__ == "__main__":
    main()
