"""Hold what the program produced against the reference.

The program's state is handed over as plain values: per level and side
the data lanes as integer arrays (mod p and mod q) and the MAC and
alignment planes as Jacobian triples in standard form; the MAC plane of U
and the bytes of every block file. Integers are compared one by one. A
plane of group elements is compared through a random linear combination:
with weights w_i drawn from the seed, sum w_i P_i must equal the point
whose exponents are sum w_i e_i, where e_i are the exponents the reference
worked out (over the IPA generators and h, or over G1 for KZG). Weights of
128 bits leave a wrong plane a chance of 2^-128 to pass; every point must
also lie on the curve.
"""

from __future__ import annotations

import random

import numpy as np

from porla_bench.reference import ecc
from porla_bench.reference.protocol import FFT_PRIME, Deployment, Replay


def _points(cv, jac) -> tuple[list, int]:
    """Jacobian triples -> (affine points, how many lie off the curve)."""
    aff = ecc.batch_to_affine(cv, jac)
    return aff, sum(not ecc.is_on_curve(cv, pt) for pt in aff)


def _combination_holds(dep: Deployment, rng: random.Random, jac: list,
                       g_rows: np.ndarray, h_rows) -> bool:
    """sum w_i P_i == Commit(sum w_i g_i) + (sum w_i h_i) h."""
    if len(jac) != g_rows.shape[0]:
        return False
    aff, off = _points(dep.curve, jac)
    if off:
        return False
    w = np.empty(len(jac), dtype=object)
    w[:] = [rng.getrandbits(128) | 1 for _ in range(len(jac))]
    g = (w @ g_rows) % dep.q
    h = int(w @ h_rows) % dep.q if len(jac) else 0
    return ecc.msm(dep.curve, aff, list(w)) == dep.commit_point(g, h)


def check_state(dep: Deployment, ref: Replay, prog: dict,
                rng: random.Random) -> dict:
    """Mismatches between the program's server state and the reference's:
    data elements, planes of group elements and block files."""
    q = dep.q
    data = planes = 0
    if prog["write_step"] != ref.write_step:
        planes += 1
    for lv_ref, lv_prog in zip(ref.levels, prog["levels"]):
        if (lv_ref is None) != (lv_prog is None):
            planes += 1
            continue
        if lv_ref is None:
            continue
        g_rows, h_rows, jac = [], [], []
        for side, pside in zip(lv_ref, (lv_prog["x"], lv_prog["y"])):
            for lane, mod in (("p", FFT_PRIME), ("q", q)):
                got = pside[lane]
                want = side.v % mod
                data += want.size if got.shape != want.shape else \
                    int(np.count_nonzero(got != want))
            jac += pside["c"] + pside["a"]
            g_rows += [(dep.alpha * side.u) % q, side.e(q)]
            h_rows += [side.r, np.zeros(len(side.r), dtype=object)]
        if not _combination_holds(dep, rng, jac, np.concatenate(g_rows),
                                  np.concatenate(h_rows)):
            planes += 1
    ids = range(1, dep.n + 1)
    g_u = np.empty((dep.n, dep.chunks), dtype=object)
    for k, bid in enumerate(ids):
        g_u[k] = [dep.alpha * c % q for c in ref.blocks[bid]]
    h_u = np.empty(dep.n, dtype=object)
    h_u[:] = [ref.mac_r[bid] for bid in ids]
    if not _combination_holds(dep, rng, prog["mac_u"], g_u, h_u):
        planes += 1
    blocks = sum(got != b"".join(c.to_bytes(32, "little")
                                 for c in ref.blocks[bid])
                 for bid, got in zip(ids, prog["blocks"]))
    blocks += abs(len(prog["blocks"]) - dep.n)
    return {"data": data, "planes": planes, "blocks": blocks}


def reply_matches(dep: Deployment, want: dict, reply: bytes) -> bool:
    """The program's audit reply against the reference's: its bytes, and
    KZG's two Jacobian triples (96 bytes each, little-endian standard
    form) as group elements."""
    head = want["bytes"]
    if reply[:len(head)] != head:
        return False
    tail = reply[len(head):]
    if len(tail) != 96 * len(want["points"]):
        return False
    jac = [tuple(int.from_bytes(tail[96 * k + 32 * i:96 * k + 32 * i + 32],
                                "little") for i in range(3))
           for k in range(len(want["points"]))]
    aff, off = _points(dep.curve, jac)
    return not off and aff == want["points"]
