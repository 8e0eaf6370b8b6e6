"""Faults planted in the timed path, for the control and the tests.

The benchmark's own runs never plant one. `plant(name, client, server,
transport)` breaks the program underneath the window and returns an
object whose `close()` takes the fault out again. Each fault breaks a
guarantee the configurations state, so `correct` has to come out false:

- `stale_update`: the server acknowledges the window's first update and
  applies nothing (a step that returns its state unchanged);
- `half_fold`: every data butterfly of a fold leaves out the second half
  of its rows (half of the batch left out);
- `altered_update`: one data limb of each level a fold forms is altered
  (an answer altered where it is produced);
- `stale_audit`: the server answers each audit with the reply it gave
  before (a step that returns its state unchanged);
- `half_audit`: the server combines only the first half of an audit's
  samples (half of the batch left out);
- `altered_answer`: one byte of each audit reply is flipped where the
  server produces it;
- `altered_file`: one byte of a codeword file is flipped each time the
  server has written the data of a level in files (an answer altered
  where it is produced, for a configuration with levels above its
  caching level and a window that forms one).
"""

from __future__ import annotations

import os

import torch

FAULTS = ("stale_update", "half_fold", "altered_update", "stale_audit",
          "half_audit", "altered_answer", "altered_file")


class _Planted:
    def __init__(self):
        self._undo = []

    def set(self, obj, name: str, value) -> None:
        had = name in vars(obj)
        old = vars(obj).get(name)
        setattr(obj, name, value)
        self._undo.append((obj, name, had, old))

    def close(self) -> None:
        for obj, name, had, old in reversed(self._undo):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo.clear()


def plant(name: str, client, server, transport) -> _Planted:
    from porla_tpu_torch.ntt.engine import CrtArray
    from porla_tpu_torch.protocol import compute, hlog, stream
    from porla_tpu_torch.protocol import server as server_mod

    p = _Planted()
    if name == "stale_update":
        real = server._update_impl
        state = {"done": False}

        def update(payload: bytes) -> bytes:
            if state["done"]:
                return real(payload)
            state["done"] = True
            return f"BLOCK {int.from_bytes(payload[:8], 'little')} IS " \
                   f"UPDATED.".encode()
        p.set(server, "_update_impl", update)
    elif name == "half_fold":
        real = compute.data_butterfly

        def butterfly(mod_q, a0, a1, tw):
            hi, lo = real(mod_q, a0, a1, tw)
            h = a0.p.shape[0] // 2

            def keep(out):
                return CrtArray(torch.cat([out.p[:h], a0.p[h:]]),
                                torch.cat([out.q[:h], a0.q[h:]]))
            return keep(hi), keep(lo)
        p.set(hlog.compute, "data_butterfly", butterfly)
    elif name == "altered_update":
        real = server._hadd

        def hadd(chunks, mac):
            level = real(chunks, mac)
            d = server.levels[level].x.data
            d.p[0, 0, 0] ^= 1
            return level
        p.set(server, "_hadd", hadd)
    elif name == "stale_audit":
        real = server.audit

        def audit(seed: bytes) -> bytes:
            real(seed)
            return transport.last_reply
        p.set(server, "audit", audit)
    elif name == "half_audit":
        real_mod = server_mod.auditing

        class Halved:
            def __getattr__(self, attr):
                return getattr(real_mod, attr)

            @staticmethod
            def build_audit_plan(*args):
                plan = real_mod.build_audit_plan(*args)
                for s in plan.samples[len(plan.samples) // 2:]:
                    s.coeff = 0
                return plan
        p.set(server_mod, "auditing", Halved())
    elif name == "altered_answer":
        real = server.audit

        def audit(seed: bytes) -> bytes:
            reply = bytearray(real(seed))
            reply[-1] ^= 1
            return bytes(reply)
        p.set(server, "audit", audit)
    elif name == "altered_file":
        real = stream.finalize_staged_level

        def finalize(srv, tag, is_x, level, n, stripe):
            out = real(srv, tag, is_x, level, n, stripe)
            path = os.path.join(srv.store.root, "H_X" if is_x else "H_Y",
                                f"{level}_0")
            with open(path, "r+b") as f:
                byte = f.read(1)[0]
                f.seek(0)
                f.write(bytes([byte ^ 1]))
            return out
        p.set(stream, "finalize_staged_level", finalize)
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    return p
