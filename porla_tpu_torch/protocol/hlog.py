"""Hierarchical log structure H and its fold (mix / HRebuild) routines.

The log has `height = log2(n)+1` levels; level i holds two erasure-coded
arrays X and Y of 2^i blocks (reference Server.hpp:61-70, utils.h:50-55).
A write lands in level 0; when levels 0..l-1 are occupied they are folded
upward by FFT `mix` steps into level l (reference HAdd/HRebuildX/Y at
Server.hpp:1330-1477; the client runs the identical structure over MAC
complements, Client.hpp:921-1038).

Planes: the server folds data (CRT lanes), MAC commitments and MAC
alignments; the client folds complement points only. One `fold_to_level`
routine serves both — the point planes of X and Y share twiddles and go
through one K3 launch per mix step. All planes stay on their device. A
plane without data (the client's, or the point planes of a level whose
data the server streams through files, protocol/stream.py) folds its
points alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from porla_tpu_torch.curves.weierstrass import JacPoint, cat
from porla_tpu_torch.ntt.engine import CrtArray, NttContext
from porla_tpu_torch.protocol import compute
from porla_tpu_torch.utils import trace


def infinity_points(n: int, ops, device="cpu") -> JacPoint:
    return ops.infinity((n,), device)


def concat_crt(a: CrtArray, b: CrtArray) -> CrtArray:
    return CrtArray(torch.cat([a.p, b.p]), torch.cat([a.q, b.q]))


@dataclass
class Planes:
    """One side (X or Y) of a level: optional data plane + point planes."""
    data: CrtArray | None = None
    points: dict = field(default_factory=dict)  # name -> JacPoint

    def point_names(self):
        return sorted(self.points)


@dataclass
class Level:
    x: Planes
    y: Planes
    empty: bool = True
    file_backed: bool = False  # data planes in H_X/H_Y files (stream.py)


def mix_planes(ctx: NttContext, lower_x: Planes, lower_y: Planes,
               upper_x: Planes, upper_y: Planes,
               length: int) -> tuple[Planes, Planes]:
    """mix(level) -> level+1 planes of size 2*length
    (reference Server.hpp:1209-1328 / Client.hpp:921-976):
       out[i] = lower[i] + v^i * upper[i]
       out[i+length] = lower[i] - v^i * upper[i]
    """
    tw = ctx.twiddles(length)
    out_x = Planes()
    out_y = Planes()

    if lower_x.data is not None:
        with trace.span("fold.data", lanes=2 * length):
            a0 = concat_crt(lower_x.data, lower_y.data)
            a1 = concat_crt(upper_x.data, upper_y.data)
            tw2 = type(tw)(*(np.concatenate([t, t], 0) for t in tw))
            hi, lo = compute.data_butterfly(ctx.mod_q, a0, a1, tw2)
            out_x.data = concat_crt(CrtArray(hi.p[:length], hi.q[:length]),
                                    CrtArray(lo.p[:length], lo.q[:length]))
            out_y.data = concat_crt(CrtArray(hi.p[length:], hi.q[length:]),
                                    CrtArray(lo.p[length:], lo.q[length:]))

    names = lower_x.point_names()
    m0 = [lower_x.points[n] for n in names] + [lower_y.points[n] for n in names]
    m1 = [upper_x.points[n] for n in names] + [upper_y.points[n] for n in names]
    his, los = compute.point_butterfly(m0, m1, tw, ops=ctx.curve_ops)
    k = len(names)
    for idx, n in enumerate(names):
        out_x.points[n] = cat([his[idx], los[idx]])
        out_y.points[n] = cat([his[k + idx], los[k + idx]])
    return out_x, out_y


def fold_to_level(ctx: NttContext, levels: list[Level], target: int,
                  slot1_x: Planes, slot1_y: Planes) -> None:
    """HRebuildX+Y combined: fold level-0 slot 0 with the incoming slot 1
    through levels 1..target-1, depositing the result as level `target`'s
    content. Marks levels < target empty."""
    with trace.span("hlog.fold", level=target):
        st_x, st_y = mix_planes(ctx, levels[0].x, levels[0].y, slot1_x,
                                slot1_y, 1)
        for i in range(1, target):
            st_x, st_y = mix_planes(ctx, levels[i].x, levels[i].y, st_x,
                                    st_y, 1 << i)
    levels[target].x, levels[target].y = st_x, st_y
    levels[target].empty = False
    levels[target].file_backed = False
    clear_below(levels, target)


def clear_below(levels: list[Level], target: int) -> None:
    """Mark levels < target empty (their content folded upward)."""
    for lv in levels[:target]:
        lv.x, lv.y = Planes(), Planes()
        lv.empty = True
        lv.file_backed = False
