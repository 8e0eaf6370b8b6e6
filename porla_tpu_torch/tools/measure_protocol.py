"""Protocol-level measurement at a realistic n, with the host spans on.

    python -m porla_tpu_torch.tools.measure_protocol --n 1024 --updates 16 \\
        --audits 3 --scheme ipa

Initializes a database, warms one update (continuing the round-robin
rotation) and an audit, then runs a window of `--updates` updates, whose
folds grow deeper, and `--audits` audits with the spans of `utils/trace.py`
on, and prints the initialize seconds, the updates' mean, fastest and
slowest seconds, the audits' mean and the span table. The profiling
companion of the self-test meter (`tools/soak.py`). The entry points run on
the card and raise without one; `--device cpu` runs the plain versions
(use a small `--n`).
"""

from __future__ import annotations

import argparse
import tempfile
import time

from porla_tpu_torch import native
from porla_tpu_torch.tools.soak import next_update, open_pair
from porla_tpu_torch.utils import trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--updates", type=int, default=16)
    ap.add_argument("--audits", type=int, default=3)
    ap.add_argument("--scheme", choices=["ipa", "kzg"], default="ipa")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = native.resolve_device(args.device)
    store = tempfile.mkdtemp(prefix="porla_meas_")
    client, _, t_init = open_pair(args.scheme, args.n, store, dev)
    print(f"initialized n={args.n} in {t_init:.3f}s", flush=True)

    next_update(client)
    client.audit()

    trace.reset()
    trace.enable()
    try:
        upd, aud = [], []
        for _ in range(args.updates):
            t0 = time.perf_counter()
            next_update(client)
            upd.append(time.perf_counter() - t0)
        for _ in range(args.audits):
            t0 = time.perf_counter()
            client.audit()
            aud.append(time.perf_counter() - t0)
    finally:
        trace.enable(False)

    if upd:
        print(f"updates: mean {sum(upd) / len(upd):.3f}s "
              f"min {min(upd):.3f}s max {max(upd):.3f}s")
    if aud:
        print(f"audits:  mean {sum(aud) / len(aud):.3f}s")
    print(trace.report())
    return {"init_s": t_init, "update_s": upd, "audit_s": aud}


if __name__ == "__main__":
    main()
