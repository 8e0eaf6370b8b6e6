"""Batched elliptic-curve kernels on the card: K2 `scalar_mul`, K3/K7
`point_butterfly`, K4 `fixed_base`, `group_sum` and `point_add`.

Counterpart of `porla_tpu/curves/pallas_curve.py`. Each public function
takes (B, 16)-limb tensors (Montgomery points, standard-form scalars) and
returns JacPoints on the same device. A CPU tensor goes to the function's
plain torch version (`*_plain`, the same formulas in the same order lane
for lane, so the outputs are bit-identical Jacobian limbs); a CUDA tensor
launches the kernel or raises.

- K2 (`csrc/scalar_mul.cu`): windowed mode for nbits < 256 (the audit
  MSMs run at nbits = 32; `CurveOps.scalar_mul`'s limbs) and GLV mode for
  nbits = 256, with the scalar split done on the host (`curves/glv.py`) and
  the halves as two chains added at the end (`glv_halves_plain`'s limbs);
  each mode has its own launch count.
- K3 and K7 (`csrc/point_butterfly.cu`): (m0 + s*m1, m0 - s*m1) with the
  GLV halves k1*q1 and k2*q2 as two chains added at the end for 256-bit
  scalars (K3) and K2's windowed scalar mul, one group of 8 threads a lane,
  for every other width (K7, `point_butterfly_window`), counted apart.
- K4 (`csrc/fixed_base.cu`): scalar_i * G_(i mod ng) from packed
  per-window affine tables, per lane or summed within lane groups
  (`fb_msm_groups`) in the same launch.
- `group_sum` (`csrc/group_sum.cu`): the sum of each of nout contiguous
  groups of points in `CurveOps.tree_sum`'s order, for `msm_parts` after K2
  and for K4's groups too wide for a block; a group's wide levels spread
  over the blocks of `group_sum_plan`, one launch a call.
- `point_add` (`csrc/point_add.cu`): the protocol's general point add,
  a[i] + b[i] or a[i] - b[i] (`CurveOps.add`'s limbs), one launch a call.

K2, K3, K7, `group_sum` and `point_add` share the cooperative arithmetic of
`csrc/porla_coop.cuh` (8 threads a field element, one 32-bit word each).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from porla_tpu_torch import native
from porla_tpu_torch.curves import glv
from porla_tpu_torch.curves.weierstrass import (CurveOps, JacPoint, index,
                                                select)
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.utils import trace


def _nibble(scalars, w: int):
    """4-bit window w (LSB first) of (B, 16) limb scalars -> (B,)."""
    return (scalars[..., w // 4] >> (4 * (w % 4))) & 0xF


def _check_points(p: JacPoint, B: int):
    for c in p:
        if c.shape != (B, L.NLIMBS):
            raise ValueError(f"point coordinate shape {tuple(c.shape)}, "
                             f"expected ({B}, {L.NLIMBS})")


def _empty_points(like: torch.Tensor) -> JacPoint:
    return JacPoint(torch.empty_like(like), torch.empty_like(like),
                    torch.empty_like(like))


# --- point_add ----------------------------------------------------------------

def point_add_plain(ops: CurveOps, a: JacPoint, b: JacPoint,
                    negate: bool = False) -> JacPoint:
    return ops.add(a, ops.neg(b) if negate else b)


def point_add(ops: CurveOps, a: JacPoint, b: JacPoint,
              negate: bool = False) -> JacPoint:
    """a[i] + b[i], or a[i] - b[i] with `negate`, for two (B, 16)-limb
    batches of Jacobian points: the full-cased add (infinity on either
    side, P == Q, P == -Q), limb for limb `CurveOps.add`. One launch on the
    card."""
    B = a.x.shape[0]
    _check_points(a, B)
    _check_points(b, B)
    if a.x.device.type == "cpu":
        return point_add_plain(ops, a, b, negate)
    dev = a.x.device
    a = JacPoint(*(c.contiguous() for c in a))
    b = JacPoint(*(c.contiguous() for c in b))
    native.require(dev, *a, *b)
    out = _empty_points(a.x)
    lib = native.library()
    rc = lib.porla_point_add(*map(native.ptr, a), *map(native.ptr, b),
                             *map(native.ptr, out), B, int(negate),
                             native.mod_words(ops.fp), native.stream(dev))
    native.KERNELS["point_add"].launches += 1
    native.check(rc, "point_add")
    return out


# --- GLV split (host) --------------------------------------------------------

class GlvScalars:
    """Host GLV decomposition of a (B, 16) scalar batch: magnitudes k1, k2
    (B, 16) limbs < 2^128, sign flags g1, g2 (B,), and beta's Montgomery
    form (the endomorphism's field constant)."""

    def __init__(self, ops: CurveOps, scalars: torch.Tensor):
        gp = glv.params_for(ops.curve)
        cache: dict = {}
        rows = []
        for k in L.tensor_to_ints(scalars):
            d = cache.get(k)
            if d is None:
                d = cache[k] = glv.decompose(k, gp)
            rows.append(d)
        dev = scalars.device
        self.k1 = L.ints_to_tensor([d[0] for d in rows], dev)
        self.k2 = L.ints_to_tensor([d[2] for d in rows], dev)
        self.g1 = torch.tensor([d[1] for d in rows], dtype=torch.int64,
                               device=dev)
        self.g2 = torch.tensor([d[3] for d in rows], dtype=torch.int64,
                               device=dev)
        self.beta_mont = ops.fp.to_mont_int(gp.beta)
        self.beta = L.ints_to_tensor([self.beta_mont], dev)[0]


def _check_glv(g: GlvScalars, B: int, device) -> None:
    native.require(device, g.k1, g.k2, g.g1, g.g2)
    if g.k1.shape != (B, L.NLIMBS) or g.k2.shape != (B, L.NLIMBS) \
            or g.g1.shape != (B,) or g.g2.shape != (B,):
        raise ValueError(f"GLV split does not match {B} lanes")


def glv_halves_plain(ops: CurveOps, p: JacPoint, g: GlvScalars) -> JacPoint:
    """k*P as k1*(±P) + k2*(±phi(P)): each half by the windowed scalar mul
    over 128 bits (its own chain of 32 windows of 4 doublings and one table
    add), then one full-cased add — the order of K2's GLV mode and of K3,
    and the plain version of K2's GLV mode."""
    p2 = JacPoint(mont.mont_mul(p.x, g.beta.expand_as(p.x), ops.fp), p.y, p.z)
    q1 = select(g.g1 != 0, ops.neg(p), p)
    q2 = select(g.g2 != 0, ops.neg(p2), p2)
    q = JacPoint(*(torch.stack([a, b]) for a, b in zip(q1, q2)))
    r = ops.scalar_mul(q, torch.stack([g.k1, g.k2]), 128)
    return ops.add(index(r, 0), index(r, 1))


# --- K2 scalar_mul ------------------------------------------------------------

def scalar_mul_plain(ops: CurveOps, p: JacPoint, scalars, nbits: int = 256):
    if nbits == 256:
        return glv_halves_plain(ops, p, GlvScalars(ops, scalars))
    return ops.scalar_mul(p, scalars, nbits)


def scalar_mul(ops: CurveOps, p: JacPoint, scalars: torch.Tensor,
               nbits: int = 256) -> JacPoint:
    """scalars[i] * p[i] for (B, 16) points and standard-form scalars (the
    low nbits used; nbits = 256 takes the GLV mode after a host split)."""
    B = p.x.shape[0]
    _check_points(p, B)
    if scalars.shape != (B, L.NLIMBS) or nbits % 4 or not 0 < nbits <= 256:
        raise ValueError(f"scalars {tuple(scalars.shape)} / nbits {nbits}")
    if p.x.device.type == "cpu":
        return scalar_mul_plain(ops, p, scalars, nbits)
    native.require(p.x.device, *p, scalars)
    if nbits == 256:
        return launch_scalar_mul_glv(ops, p, GlvScalars(ops, scalars))
    return launch_scalar_mul_window(ops, p, scalars, nbits)


def launch_scalar_mul_window(ops: CurveOps, p: JacPoint, scalars, nbits):
    """K2's windowed mode on checked CUDA operands: 8 threads a lane."""
    B = p.x.shape[0]
    dev = p.x.device
    lib = native.library()
    out = _empty_points(p.x)
    rc = lib.porla_scalar_mul_window(
        *map(native.ptr, p), native.ptr(scalars), nbits,
        *map(native.ptr, out), B, native.mod_words(ops.fp),
        native.stream(dev))
    native.KERNELS["scalar_mul_window"].launches += 1
    native.check(rc, "scalar_mul_window")
    return out


def launch_scalar_mul_glv(ops: CurveOps, p: JacPoint, g: GlvScalars):
    """K2's GLV mode on checked CUDA operands and a host split `g`: 16
    threads a lane, each GLV half on 8 threads."""
    B = p.x.shape[0]
    dev = p.x.device
    _check_glv(g, B, dev)
    lib = native.library()
    out = _empty_points(p.x)
    rc = lib.porla_scalar_mul_glv(
        *map(native.ptr, p), native.ptr(g.k1), native.ptr(g.k2),
        native.ptr(g.g1), native.ptr(g.g2), native.fe_words(g.beta_mont),
        *map(native.ptr, out), B, native.mod_words(ops.fp),
        native.stream(dev))
    native.KERNELS["scalar_mul_glv"].launches += 1
    native.check(rc, "scalar_mul_glv")
    return out


# --- K3 point_butterfly, K7 point_butterfly_window ---------------------------

def glv_butterfly_plain(ops: CurveOps, m0: JacPoint, m1: JacPoint,
                        g: GlvScalars):
    """The plain version of K3 for a host split `g`."""
    t = glv_halves_plain(ops, m1, g)
    return ops.add(m0, t), ops.add(m0, ops.neg(t))


def point_butterfly_plain(ops: CurveOps, m0: JacPoint, m1: JacPoint, scalars):
    return glv_butterfly_plain(ops, m0, m1, GlvScalars(ops, scalars))


def window_butterfly_plain(ops: CurveOps, m0: JacPoint, m1: JacPoint,
                           scalars, nbits: int):
    """The plain version of K7: s*m1 by the windowed scalar mul over the
    low nbits, then both full-cased adds."""
    t = ops.scalar_mul(m1, scalars, nbits)
    return ops.add(m0, t), ops.add(m0, ops.neg(t))


def point_butterfly(ops: CurveOps, m0: JacPoint, m1: JacPoint,
                    scalars: torch.Tensor, nbits: int = 256):
    """(m0 + s*m1, m0 - s*m1) per lane — the MAC-mirror butterfly
    (reference Server.hpp:1592-1609) as one kernel: K3 (the GLV body, split
    on the host) for 256-bit scalars, K7 (the windowed body over the low
    nbits) for every other width."""
    B = m0.x.shape[0]
    _check_points(m0, B)
    _check_points(m1, B)
    if scalars.shape != (B, L.NLIMBS) or nbits % 4 or not 0 < nbits <= 256:
        raise ValueError(f"scalars {tuple(scalars.shape)} / nbits {nbits}")
    if m0.x.device.type == "cpu":
        if nbits == 256:
            return point_butterfly_plain(ops, m0, m1, scalars)
        return window_butterfly_plain(ops, m0, m1, scalars, nbits)
    native.require(m0.x.device, *m0, *m1, scalars)
    if nbits == 256:
        return launch_point_butterfly(ops, m0, m1, GlvScalars(ops, scalars))
    return launch_window_butterfly(ops, m0, m1, scalars, nbits)


def launch_point_butterfly(ops: CurveOps, m0: JacPoint, m1: JacPoint,
                           g: GlvScalars):
    """K3 on checked CUDA operands and a host split `g`: 16 threads a lane,
    each GLV half on 8 threads holding a word of every field element."""
    B = m0.x.shape[0]
    dev = m0.x.device
    _check_glv(g, B, dev)
    lib = native.library()
    hi = _empty_points(m0.x)
    lo = _empty_points(m0.x)
    rc = lib.porla_point_butterfly(
        *map(native.ptr, m0), *map(native.ptr, m1), native.ptr(g.k1),
        native.ptr(g.k2), native.ptr(g.g1), native.ptr(g.g2),
        native.fe_words(g.beta_mont), *map(native.ptr, hi),
        *map(native.ptr, lo), B, native.mod_words(ops.fp),
        native.stream(dev))
    native.KERNELS["point_butterfly"].launches += 1
    native.check(rc, "point_butterfly")
    return hi, lo


def launch_window_butterfly(ops: CurveOps, m0: JacPoint, m1: JacPoint,
                            scalars, nbits: int):
    """K7 on checked CUDA operands, 8 threads a lane, at any nbits that is
    a multiple of 4 up to 256 (256 is reached only from here, never from
    `point_butterfly`)."""
    B = m0.x.shape[0]
    dev = m0.x.device
    lib = native.library()
    hi = _empty_points(m0.x)
    lo = _empty_points(m0.x)
    rc = lib.porla_point_butterfly_window(
        *map(native.ptr, m0), *map(native.ptr, m1), native.ptr(scalars),
        nbits, *map(native.ptr, hi), *map(native.ptr, lo), B,
        native.mod_words(ops.fp), native.stream(dev))
    native.KERNELS["point_butterfly_window"].launches += 1
    native.check(rc, "point_butterfly_window")
    return hi, lo


# --- K4 fixed_base ----------------------------------------------------------

class FbTable:
    """Per-window affine lookup tables for a fixed set of ng bases:
    coords (nwin, 16, ng, 16) int64 limbs (Montgomery; z in {0, R}), built
    once on the host. Each device gets the form it needs once: the limbs
    for the plain version (`on`), the packed words for K4 (`packed`). A
    table of `parts` (`fb_table_cat`) holds their bases side by side and
    joins their forms where asked, so no part's points are packed again."""

    def __init__(self, ops: CurveOps, coords, nbits: int, ng: int,
                 parts=()):
        self.ops = ops
        self.coords = coords            # host JacPoint (None for parts)
        self.nbits = nbits
        self.ng = ng
        self.parts = tuple(parts)
        self._dev: dict = {}

    def on(self, device) -> JacPoint:
        key = ("limbs", str(device))
        t = self._dev.get(key)
        if t is None:
            if self.parts:
                t = JacPoint(*(torch.cat(cs, 2) for cs in zip(
                    *(p.on(device) for p in self.parts))))
            else:
                t = self.coords.to(device)
            self._dev[key] = t
        return t

    def packed(self, device) -> torch.Tensor:
        """(nwin, 16, ng, 16) int32 words: an entry's x then y, infinity as
        all zeros, 64 bytes an entry. Zeros are free to mean infinity
        because no affine point of these curves has y = 0 (their groups
        have odd order); the packing checks it."""
        key = ("packed", str(device))
        t = self._dev.get(key)
        if t is None and self.parts:
            t = self._dev[key] = torch.cat(
                [p.packed(device) for p in self.parts], 2)
        elif t is None:
            inf = self.coords.z.eq(0).all(-1)
            y0 = self.coords.y.eq(0).all(-1)
            if bool((y0 & ~inf).any()):
                raise ValueError("a table point with y = 0 would read as "
                                 "infinity")
            xy = torch.cat([L.words32(self.coords.x),
                            L.words32(self.coords.y)], -1)
            xy = xy.masked_fill(inf[..., None], 0)
            t = self._dev[key] = xy.contiguous().to(device)
        return t

    def bases(self, B: int, device) -> torch.Tensor:
        """The base of each of B lanes, as an index into the table's own
        bases (`on`): lane i takes base i mod ng."""
        return torch.arange(B, device=device) % self.ng


class FbColumns(FbTable):
    """A table whose base i is base columns[i] of `source`: K4's lanes can
    then hold any of its bases, in any order and as often as needed, with
    no table point computed again. The plain version reads the source's
    points through `columns`; K4 gets the source's packed words gathered,
    once a device."""

    def __init__(self, source: FbTable, columns):
        super().__init__(source.ops, None, source.nbits, len(columns))
        self.source = source
        self.columns = torch.tensor(columns, dtype=torch.int64)

    def on(self, device) -> JacPoint:
        return self.source.on(device)

    def packed(self, device) -> torch.Tensor:
        key = ("packed", str(device))
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = self.source.packed(device).index_select(
                2, self.columns.to(device)).contiguous()
        return t

    def bases(self, B: int, device) -> torch.Tensor:
        return self.columns.to(device)[super().bases(B, device)]


def fb_table_cat(tables) -> FbTable:
    """The bases of `tables` side by side in one table (numbered on from
    the first table's), for `FbColumns` to choose from."""
    first = tables[0]
    assert all(t.ops is first.ops and t.nbits == first.nbits
               and not isinstance(t, FbColumns) for t in tables)
    return FbTable(first.ops, None, first.nbits, sum(t.ng for t in tables),
                   parts=tables)


def _batch_add_affine(cv: ecc.Curve, ps: list, qs: list) -> list:
    """Pairwise affine sums p_i + q_i (ecc.add semantics, INF allowed) with
    one modular inversion for the whole batch (Montgomery's trick)."""
    p = cv.p
    dens, kinds = [], []
    for a, b in zip(ps, qs):
        if a is ecc.INF or b is ecc.INF:
            kinds.append(0)
            dens.append(1)
        elif a[0] != b[0]:
            kinds.append(1)
            dens.append((b[0] - a[0]) % p)
        elif (a[1] + b[1]) % p == 0:
            kinds.append(0)
            dens.append(1)
        else:
            kinds.append(2)
            dens.append(2 * a[1] % p)
    prefix = [1]
    for d in dens:
        prefix.append(prefix[-1] * d % p)
    inv = pow(prefix[-1], -1, p)
    out = [None] * len(dens)
    for i in range(len(dens) - 1, -1, -1):
        d_inv = inv * prefix[i] % p
        inv = inv * dens[i] % p
        a, b = ps[i], qs[i]
        if kinds[i] == 0:
            out[i] = ecc.add(cv, a, b)
            continue
        if kinds[i] == 1:
            lam = (b[1] - a[1]) * d_inv % p
        else:
            lam = 3 * a[0] * a[0] * d_inv % p
        x3 = (lam * lam - a[0] - b[0]) % p
        out[i] = (x3, (lam * (a[0] - x3) - a[1]) % p)
    return out


def build_fb_table(ops: CurveOps, gens_affine, nbits: int = 256) -> FbTable:
    """T_w[d] = d * 16^w * G_g on the host (exact affine arithmetic) for
    every base (affine (x, y) int pairs or INF)."""
    cur = ops.curve
    ng = len(gens_affine)
    nwin = nbits // 4
    flat = []                                  # (w, d, g) order
    bases = list(gens_affine)
    for w in range(nwin):
        row = [ecc.INF] * ng                   # d = 0
        e = [ecc.INF] * ng
        for _ in range(1, 16):
            e = _batch_add_affine(cur, e, bases)
            row += e
        flat += row
        if w != nwin - 1:
            for _ in range(4):
                bases = _batch_add_affine(cur, bases, bases)
    jp = ops.from_affine(flat)
    shape = (nwin, 16, ng, L.NLIMBS)
    return FbTable(ops, JacPoint(*(c.reshape(shape) for c in jp)), nbits, ng)


_TABLES: dict = {}


def fixed_base_table(ops: CurveOps, bases, nbits: int = 256) -> FbTable:
    """The K4 table of `bases` (affine (x, y) int pairs or INF), built once a
    process for each (curve, nbits, bases). Only the owner of a base set
    calls this, when it is built (an `ipa.IpaKey`, a `kzg.KzgSrs`, the
    client's h and alpha generators) and holds the table: no operation
    looks a table up. The memo exists because the benchmark runs client
    and server in one process and both hold the IPA generators; without it
    their table (about 1.4 s of host integers) would be built twice in
    set-up."""
    key = (ops.curve, nbits, tuple(bases))
    tbl = _TABLES.get(key)
    if tbl is None:
        with trace.span("fb_table", ng=len(key[2]), nbits=nbits):
            tbl = _TABLES[key] = build_fb_table(ops, key[2], nbits)
    return tbl


# K4's launch: threads a lane, a power of two. A lane's windows are
# independent table points, so where the lanes are too few to fill the card a
# lane's windows are spread over up to FB_SPLIT threads, as long as B * split
# stays within the threads the card holds at once (FB_RESIDENT); a group-mode
# block holds at most FB_THREADS (csrc/fixed_base.cu).
FB_SPLIT = 4
FB_RESIDENT = 1 << 16
FB_THREADS = 512


def fb_split(B: int, group: int = 1) -> int:
    """Threads a lane of K4 for B lanes in groups of `group` lanes."""
    split = FB_SPLIT
    while split > 1 and (B * split > FB_RESIDENT
                         or group * split > FB_THREADS):
        split //= 2
    return split


def fb_lanes_plain(table: FbTable, scalars, split: int) -> JacPoint:
    """The plain version of K4 per lane with `split` threads a lane: thread
    j's partial sum walks windows j, j + split, ... with full-cased mixed
    adds, and the partials are added in a lane-halving tree."""
    ops = table.ops
    B = scalars.shape[0]
    dev = scalars.device
    t = table.on(dev)
    flat = JacPoint(*(c.reshape(-1, L.NLIMBS) for c in t))
    lane_g = table.bases(B, dev)
    ng = t.x.shape[2]
    acc = ops.infinity((split, B), dev)
    nwin = table.nbits // 4
    for r in range(0, nwin, split):
        ws = [min(w, nwin - 1) for w in range(r, r + split)]
        digit = torch.stack([_nibble(scalars, w) for w in ws])
        e = (torch.tensor(ws, device=dev)[:, None] * 16 + digit) \
            * ng + lane_g
        # past the last window a thread adds nothing: a masked-off lane
        # keeps its accumulator, as the kernel's loop ends there
        new = ops.madd(acc, index(flat, e))
        live = torch.tensor([w < nwin for w in range(r, r + split)],
                            device=dev)[:, None].expand(split, B)
        acc = select(live, new, acc)
    return index(ops.tree_sum(acc), 0)


def fb_scalar_mul_plain(table: FbTable, scalars) -> JacPoint:
    return fb_lanes_plain(table, scalars, fb_split(scalars.shape[0]))


def fb_scalar_mul(table: FbTable, scalars: torch.Tensor) -> JacPoint:
    """scalars[i] * base[i % ng] for (B, 16)-limb standard-form scalars
    (< 2^nbits), lanes cycling through the table's base pattern."""
    B = scalars.shape[0]
    if scalars.shape != (B, L.NLIMBS):
        raise ValueError(f"scalars {tuple(scalars.shape)}, expected (B, 16)")
    if scalars.device.type == "cpu":
        return fb_scalar_mul_plain(table, scalars)
    native.require(scalars.device, scalars)
    return launch_fixed_base(table, scalars, 0)


def launch_fixed_base(table: FbTable, scalars: torch.Tensor,
                      nout: int) -> JacPoint:
    """K4 on checked CUDA scalars, `fb_split` threads a lane: per lane with
    nout = 0 -> (B, 16), else summed within nout groups -> (nout, 16). One
    launch where a group fits a block (group * split <= FB_THREADS), else K4
    per lane into packed words and `group_sum` over them."""
    B = scalars.shape[0]
    if nout < 0 or nout and B % nout:
        raise ValueError(f"{B} lanes do not split into {nout} groups")
    dev = scalars.device
    g = B // nout if nout else 0
    split = fb_split(B, max(g, 1))
    wide = g * split > FB_THREADS
    tab = table.packed(dev)
    if wide:
        part = torch.empty((24, B), dtype=torch.int32, device=dev)
        dst = [None] * 3 + [native.ptr(part)]
    else:
        out = JacPoint(*(torch.empty((nout or B, L.NLIMBS), dtype=torch.int64,
                                     device=dev) for _ in range(3)))
        dst = list(map(native.ptr, out)) + [None]
    lib = native.library()
    rc = lib.porla_fixed_base(
        native.ptr(tab), native.ptr(scalars), *dst, B, table.ng,
        table.nbits // 4, split, 0 if wide else g,
        native.mod_words(table.ops.fp), native.stream(dev))
    native.KERNELS["fixed_base"].launches += 1
    native.check(rc, "fixed_base")
    if wide:
        return _launch_group_sum(table.ops, part, nout, B)
    return out


def fb_msm_groups(table: FbTable, scalars: torch.Tensor,
                  nout: int) -> JacPoint:
    """scalars[i] * base[i % ng] summed within nout contiguous lane groups
    -> (nout, 16) JacPoint, each group in `CurveOps.tree_sum`'s order: the
    reference's one-dispatch IPA round, one K4 launch here. The group width
    must be a power of two, as in the reference (whose lane-halving sum
    would drop lanes otherwise)."""
    B = scalars.shape[0]
    if scalars.shape != (B, L.NLIMBS):
        raise ValueError(f"scalars {tuple(scalars.shape)}, expected (B, 16)")
    assert nout >= 1 and B % nout == 0, "groups must tile the lane width"
    g = B // nout
    assert g & (g - 1) == 0, f"group width must be a power of two: {g}"
    if scalars.device.type == "cpu":
        return group_sum_plain(table.ops,
                               fb_lanes_plain(table, scalars, fb_split(B, g)),
                               nout)
    native.require(scalars.device, scalars)
    return launch_fixed_base(table, scalars, nout)


# --- group_sum ---------------------------------------------------------------

def group_sum_plain(ops: CurveOps, points: JacPoint, nout: int) -> JacPoint:
    """`ops.tree_sum` of each of nout contiguous groups, all groups in one
    batch -> (nout, 16)."""
    g = points.x.shape[0] // nout
    p = JacPoint(*(c.reshape(nout, g, L.NLIMBS).transpose(0, 1)
                   for c in points))
    return index(ops.tree_sum(p), 0)


def group_sum(ops: CurveOps, points: JacPoint, nout: int) -> JacPoint:
    """(nout*g, 16)-limb Jacobian points -> (nout, 16): the sum of each of
    nout contiguous groups of g >= 1 points, limb for limb `ops.tree_sum`
    of each group (an odd level carries its last point). One launch on the
    card."""
    B = points.x.shape[0]
    _check_points(points, B)
    if nout < 1 or B % nout:
        raise ValueError(f"{B} points do not split into {nout} groups")
    if points.x.device.type == "cpu":
        return group_sum_plain(ops, points, nout)
    native.require(points.x.device, *points)
    return _launch_group_sum(ops, points, nout, B)


@dataclass(frozen=True)
class GroupSumPlan:
    """How `group_sum`'s kernel sums one group: nb blocks, each running the
    levels of widths `apart` over its residue class of slots mod nb, then
    the group's last block running the levels of widths `last` over the
    partial sums."""
    nb: int
    apart: tuple[int, ...]
    last: tuple[int, ...]


@functools.lru_cache(maxsize=None)
def group_sum_plan(g: int) -> GroupSumPlan:
    """The launch plan of a group of g >= 1 points (csrc/group_sum.cu). A
    block of 128 threads runs 16 cooperative adds a round, so a group of
    up to 32 points takes one block (a level is one round there anyway);
    a wider one takes nb = 2^floor(log2(g) / 2) blocks, about sqrt(g),
    which balances the rounds the blocks run apart (about g / (16 nb))
    against the last block's (about nb / 16). The blocks run the first
    level (it reads only the input) and each later level while nb divides
    the half of its width; the last block runs the rest."""
    nb = 1 if g <= 32 else 1 << (g.bit_length() - 1) // 2
    widths = []
    m = g
    while m > 1:
        widths.append(m)
        m = m // 2 + m % 2
    k = next((i for i, m in enumerate(widths) if i and (m // 2) % nb),
             len(widths))
    return GroupSumPlan(nb, tuple(widths[:k]), tuple(widths[k:]))


def _launch_group_sum(ops: CurveOps, points, nout: int, B: int) -> JacPoint:
    """group_sum's kernel over `points`: a JacPoint of (B, 16) limbs, or
    K4's packed (24, B) words; `group_sum_plan` of the group width."""
    packed = isinstance(points, torch.Tensor)
    dev = points.device if packed else points.x.device
    g = B // nout
    nb = group_sum_plan(g).nb
    out = JacPoint(*(torch.empty((nout, L.NLIMBS), dtype=torch.int64,
                                 device=dev) for _ in range(3)))
    src = ([None] * 3 + [native.ptr(points)] if packed
           else list(map(native.ptr, points)) + [None])
    part = torch.empty((24, B), dtype=torch.int32, device=dev)
    count = torch.zeros(nout if nb > 1 else 0, dtype=torch.int32, device=dev)
    lib = native.library()
    rc = lib.porla_group_sum(*src, native.ptr(part), native.ptr(count),
                             *map(native.ptr, out), B, g, nb,
                             native.mod_words(ops.fp), native.stream(dev))
    native.KERNELS["group_sum"].launches += 1
    native.check(rc, "group_sum")
    return out
