"""Protocol compute: data/MAC butterflies, point scaling, linear combinations.

Every `mix`/`CRebuild` stage is one data butterfly (per CRT lane) plus one
point butterfly over the MAC planes (reference Server.hpp:1209-1328,
1548-1830). The kernel-backed operations are `encode_crt` (K1),
`point_butterfly`/`point_stage` (K3) and `point_scale` (K2); the data
butterfly, the Y-copy time twist and the audit combination are plain torch
on whatever device the tensors live on.
"""

from __future__ import annotations

import numpy as np
import torch

from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint, cat, index
from porla_tpu_torch.fields import limbs, mont
from porla_tpu_torch.ntt import cuda_stage
from porla_tpu_torch.ntt.engine import MOD_P, CrtArray, Twiddles
from porla_tpu_torch.utils import trace


def _dev(arr, device):
    return limbs.to_torch(arr, device)


# --- data plane (plain torch) -------------------------------------------------

def data_butterfly(mod_q, a0: CrtArray, a1: CrtArray,
                   tw: Twiddles) -> tuple[CrtArray, CrtArray]:
    """(L, C, 16) CRT pairs -> (a0 + v*a1, a0 - v*a1) with per-row twiddle."""
    dev = a0.p.device
    twp = _dev(tw.mont_p, dev)[:, None, :]
    twq = _dev(tw.mont_q, dev)[:, None, :]
    t_p = mont.mont_mul(a1.p, twp, MOD_P)
    t_q = mont.mont_mul(a1.q, twq, mod_q)
    return (CrtArray(mont.add_mod(a0.p, t_p, MOD_P),
                     mont.add_mod(a0.q, t_q, mod_q)),
            CrtArray(mont.sub_mod(a0.p, t_p, MOD_P),
                     mont.sub_mod(a0.q, t_q, mod_q)))


def scale_crt(mod_q, a: CrtArray, tw: Twiddles) -> CrtArray:
    """a * v for a single scalar v (the Y-part time twist)."""
    dev = a.p.device
    return CrtArray(mont.mont_mul(a.p, _dev(tw.mont_p, dev)[0], MOD_P),
                    mont.mont_mul(a.q, _dev(tw.mont_q, dev)[0], mod_q))


def encode_crt(mod_q, ctx, arr: CrtArray) -> CrtArray:
    """All CRebuild butterfly stages s = 1..height-1 over an (n, C, 16) CRT
    array (reference stage loop, Server.hpp:1548-1687): K1 per lane, one
    launch for every pass of `cuda_stage.pass_plan(n)` (one at n <= 1024)."""
    with trace.span("encode_crt", n=ctx.n):
        return CrtArray(cuda_stage.encode_lane(ctx, arr.p, MOD_P, "p"),
                        cuda_stage.encode_lane(ctx, arr.q, mod_q, "q"))


# --- MAC plane (points) -------------------------------------------------------

def point_butterfly(M0s: list[JacPoint], M1s: list[JacPoint],
                    tw: Twiddles, ops=None):
    """Butterfly several point planes with shared twiddles: returns
    ([M0 + v*M1], [M0 - v*M1]) per plane, all planes in one K3 launch."""
    with trace.span("point_butterfly", L=M0s[0].x.shape[0],
                    planes=len(M0s)):
        ops = ops or secp256k1()
        nplanes = len(M0s)
        L = M0s[0].x.shape[0]
        dev = M0s[0].x.device
        tws = _dev(tw.std[:L], dev).repeat(nplanes, 1)
        hi, lo = cuda_curve.point_butterfly(ops, cat(M0s), cat(M1s), tws)
        his = [index(hi, slice(i * L, (i + 1) * L)) for i in range(nplanes)]
        los = [index(lo, slice(i * L, (i + 1) * L)) for i in range(nplanes)]
        return his, los


def point_stage(ctx, s: int, planes: list[JacPoint],
                ops=None) -> list[JacPoint]:
    """One radix-2 CRebuild stage over each (n,) point plane (the MAC
    mirror of the data stage loop, Server.hpp:1548-1687); all planes go
    through one K3 launch."""
    n = planes[0].x.shape[0]
    m = 1 << s
    m2 = m >> 1
    tw = ctx.twiddles(m2)

    def split(a, half):
        a2 = a.reshape(n // m, m, limbs.NLIMBS)
        return a2[:, half * m2:(half + 1) * m2].reshape(n // 2, limbs.NLIMBS)

    def join(hi, lo):
        return torch.cat([hi.reshape(n // m, m2, limbs.NLIMBS),
                          lo.reshape(n // m, m2, limbs.NLIMBS)],
                         dim=1).reshape(n, limbs.NLIMBS)

    tw_tiled = Twiddles(*(np.tile(t, (n // m, 1)) for t in tw))
    us = [JacPoint(*(split(c, 0) for c in p)) for p in planes]
    ts = [JacPoint(*(split(c, 1) for c in p)) for p in planes]
    his, los = point_butterfly(us, ts, tw_tiled, ops=ops)
    return [JacPoint(*(join(h, lo) for h, lo in zip(hi, lo_)))
            for hi, lo_ in zip(his, los)]


def point_scale(M: JacPoint, scalars, nbits: int = 256, ops=None) -> JacPoint:
    """Batched v_i * M_i (K2); scalars (L, 16) or one (1, 16) row
    broadcast over the batch."""
    with trace.span("point_scale", L=M.x.shape[0], nbits=nbits):
        L = M.x.shape[0]
        sc = scalars if isinstance(scalars, torch.Tensor) else \
            limbs.to_torch(scalars)
        sc = sc.to(M.x.device).expand(L, limbs.NLIMBS).contiguous()
        return cuda_curve.scalar_mul(ops or secp256k1(), M, sc, nbits)


# --- audit linear combination -------------------------------------------------

def linear_combine_crt(mod_q, blocks: CrtArray, coeffs: list[int]) -> CrtArray:
    """B = sum_i coeff_i * block_i over Z (exact in both CRT lanes) — the
    audit combination (Server.hpp:790-828). blocks: (N, C, 16) -> (C, 16)."""
    dev = blocks.p.device
    cp = limbs.ints_to_tensor([MOD_P.to_mont_int(c) for c in coeffs], dev)
    cq = limbs.ints_to_tensor([mod_q.to_mont_int(c % mod_q.n)
                               for c in coeffs], dev)
    tp = mont.mont_mul(blocks.p, cp[:, None, :], MOD_P)
    tq = mont.mont_mul(blocks.q, cq[:, None, :], mod_q)
    return CrtArray(_sum_mod(tp, MOD_P), _sum_mod(tq, mod_q))


def _sum_mod(t, mod):
    """Modular sum over the leading axis, pairwise (log depth)."""
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        s = mont.add_mod(t[:half], t[half:2 * half], mod)
        t = torch.cat([s, t[2 * half:]]) if t.shape[0] % 2 else s
    return t[0]
