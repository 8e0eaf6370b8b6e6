"""Read the program's server state into plain values for the check.

The port keeps a 256-bit value as 16 little-endian 16-bit limbs in an
int64 tensor, data lanes in standard form and curve coordinates in
Montgomery form (R = 2^256). This module decodes them without the
program's own codecs, so that the check does not lean on what it judges.
"""

from __future__ import annotations

import numpy as np
import torch


def limb_ints(t: torch.Tensor) -> np.ndarray:
    """(..., 16) limbs -> object array of Python ints of shape (...)."""
    a = t.detach().to("cpu").numpy()
    if a.size and (a.min() < 0 or a.max() > 0xFFFF):
        raise ValueError("limb outside 16 bits")
    raw = a.astype("<u2").tobytes()
    out = np.empty(a.shape[:-1], dtype=object)
    out.reshape(-1)[:] = [int.from_bytes(raw[32 * i:32 * i + 32], "little")
                          for i in range(out.size)]
    return out


def jacobian(pts, p: int) -> list[tuple[int, int, int]]:
    """A batched Jacobian point (x, y, z tensors, Montgomery form mod p)
    -> standard-form triples."""
    rinv = pow(1 << 256, -1, p)
    xs, ys, zs = (limb_ints(c).reshape(-1) for c in pts)
    return [(x * rinv % p, y * rinv % p, z * rinv % p)
            for x, y, z in zip(xs, ys, zs)]


def server_state(server, p: int) -> dict:
    """The levels, the MAC plane of U, the write step and the block files
    of a `PorlaServer` whose levels are all held in memory."""
    levels = []
    for lv in server.levels:
        if lv.empty:
            levels.append(None)
            continue
        sides = {}
        for name in ("x", "y"):
            planes = getattr(lv, name)
            if planes.data is None:
                raise ValueError("a level in files: the check reads levels "
                                 "held in memory only")
            sides[name] = {"p": limb_ints(planes.data.p),
                           "q": limb_ints(planes.data.q),
                           "c": jacobian(planes.points["c"], p),
                           "a": jacobian(planes.points["a"], p)}
        levels.append(sides)
    return {"write_step": server.write_step, "levels": levels,
            "mac_u": jacobian(server.mac_u, p),
            "blocks": [server.store.read_block(i)
                       for i in range(server.num_blocks)]}
