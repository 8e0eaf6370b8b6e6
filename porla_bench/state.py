"""Read the program's server state into plain values for the check.

The port keeps a 256-bit value as 16 little-endian 16-bit limbs in an
int64 tensor, data lanes in standard form and curve coordinates in
Montgomery form (R = 2^256). A level above the caching level keeps its
data in the store's codeword files, `H_X/<level>_<i>` and `H_Y/<level>_<i>`:
128 little-endian 32-byte values mod p each. This module decodes both
without the program's own codecs, so that the check does not lean on what
it judges.
"""

from __future__ import annotations

import os

import numpy as np
import torch

CHUNKS = 128


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


def code_ints(store: str, side: str, level: int) -> np.ndarray:
    """A level's codeword files `<store>/<side>/<level>_<i>`, i < 2^level,
    -> (2^level, 128) object array of Python ints. Every element of a
    missing or short file is None, so that it counts as differing."""
    out = np.full((1 << level, CHUNKS), None, dtype=object)
    for i in range(out.shape[0]):
        try:
            with open(os.path.join(store, side, f"{level}_{i}"), "rb") as f:
                raw = f.read(32 * CHUNKS)
        except FileNotFoundError:
            continue
        if len(raw) == 32 * CHUNKS:
            out[i] = [int.from_bytes(raw[32 * k:32 * k + 32], "little")
                      for k in range(CHUNKS)]
    return out


def server_state(server, p: int, q: int, store: str) -> dict:
    """The levels, the MAC plane of U, the write step and the block files
    of a `PorlaServer` whose store directory is `store`. A level in files
    gives its p lane as read and its q lane as that value mod q, as the
    server loads it; its MAC and alignment planes are on the device."""
    levels = []
    for k, lv in enumerate(server.levels):
        if lv.empty:
            levels.append(None)
            continue
        sides = {}
        for name, files in (("x", "H_X"), ("y", "H_Y")):
            planes = getattr(lv, name)
            if planes.data is not None:
                lanes = {"p": limb_ints(planes.data.p),
                         "q": limb_ints(planes.data.q)}
            elif lv.file_backed:
                v = code_ints(store, files, k)
                vq = np.empty_like(v)
                vq.reshape(-1)[:] = [None if x is None else x % q
                                     for x in v.reshape(-1)]
                lanes = {"p": v, "q": vq}
            else:
                raise ValueError(f"level {k} holds no data plane")
            sides[name] = {**lanes, "c": jacobian(planes.points["c"], p),
                           "a": jacobian(planes.points["a"], p)}
        levels.append(sides)
    return {"write_step": server.write_step, "levels": levels,
            "mac_u": jacobian(server.mac_u, p),
            "blocks": [server.store.read_block(i)
                       for i in range(server.num_blocks)]}
