"""The one traffic generator: a closed loop of one client.

A mix is a data file of parameters:

- `setup.write_step`: round-robin updates after `initialize` until the
  log stands at this write step (at least 1: the warm update);
- `setup.warm_audits`: audits after them, with seeds of their own;
- `window.cycle`: [[op, count], ...], repeated for the whole window, op
  "update" (the next round-robin block, the protocol's only order) or
  "audit" (a challenge seed drawn from the run's seed);
- `check_audits`: how many of the window's audit replies the reference
  recomputes, drawn from the seed.

Every input is drawn from the run's seed: the client's data seed and each
audit's challenge seed.
"""

from __future__ import annotations

import hashlib
import itertools


def seed_bytes(seed: int, label: str, k: int = 0) -> bytes:
    """16 bytes for `label` (and index k) of run seed `seed`."""
    return hashlib.sha256(f"porla_bench {label} {seed} {k}".encode()
                          ).digest()[:16]


def data_seed(seed: int) -> bytes:
    return seed_bytes(seed, "data")


def setup_ops(mix: dict, seed: int):
    """The set-up's ops after `initialize`: (op, audit seed or None)."""
    st = mix["setup"]
    if st["write_step"] < 1:
        raise ValueError("the set-up warms at least one update")
    return ([("update", None)] * st["write_step"]
            + [("audit", seed_bytes(seed, "warm", k))
               for k in range(st["warm_audits"])])


def window_ops(mix: dict, seed: int):
    """The window's ops, without end: (op, audit seed or None)."""
    cycle = [(op, count) for op, count in mix["window"]["cycle"]]
    for op, count in cycle:
        if op not in ("update", "audit") or count < 1:
            raise ValueError(f"bad cycle entry {op!r} x {count}")
    audits = itertools.count()
    for op, count in itertools.cycle(cycle):
        for _ in range(count):
            yield op, (seed_bytes(seed, "audit", next(audits))
                       if op == "audit" else None)
