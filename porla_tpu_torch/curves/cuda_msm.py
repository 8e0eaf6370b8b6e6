"""Variable-base multi-scalar multiplication by Pippenger's bucket method on
the card: K5 `pip_bucket` and K6 `bucket_fold`, and the host code around
them.

Counterpart of `porla_tpu/curves/pallas_msm.py` (itself the counterpart of
libsecp256k1's `ecmult_multi_var`). The N points are laid out as `steps`
rows of `bt` lanes; every lane is an independent accumulator that sweeps
its `steps` points one after the other:

- The scalars are split into signed width-c windows (digits in
  [-2^(c-1), 2^(c-1)], `signed_digits`), so a lane needs only nb = 2^(c-1)
  buckets per window; a negative digit adds the negated point.
- K5 (`csrc/pip_bucket.cu`) keeps, for every (window, lane) pair, nb buckets
  that start at blinding points d_s*G with secret scalars d_s, and adds each
  step's point into the bucket its digit selects. Because a bucket is never
  infinity and never equals an incoming point except with negligible
  probability, the add is the raw formula without case handling.
- K6 (`csrc/bucket_fold.cu`) folds each pair's buckets to sum_s s*B_s by the
  suffix-run trick.
- `reduce_lanes` sums the bt lanes of every window with full-cased adds (lane
  partials can collide), in plain torch as the reference does in XLA.
- The host finishes in exact Python ints: Horner over the windows from the
  top down, minus the known blinding contribution
  bt * (sum_w 2^(cw)) * (sum_s s*d_s) * G.

The result is exact and independent of the blinding values. An adversary
who picks the MSM's inputs cannot steer a bucket into the unhandled doubling
case, because the blinding scalars come from `random.SystemRandom()`.

The bucket state between K5 and K6 is internal to them: (nwin, nb, 3, 8, bt)
32-bit words (a coordinate is 8 words), the lane the fastest axis.
`pack_state` / `unpack_state` convert it to and from limb points.

A CPU tensor goes to the plain torch versions (`pip_bucket_plain`,
`bucket_fold_plain`), which give bit-identical state; a CUDA tensor launches
the kernels or raises.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import torch

from porla_tpu_torch import native
from porla_tpu_torch.curves.weierstrass import (CurveOps, JacPoint, index,
                                                select)
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont
from porla_tpu_torch.golden import ecc

# The sign flag of a packed digit (|d| | sign) is bit 8, not bit 7: signed
# width-c digits reach |d| = 2^(c-1), which at c = 8 is exactly 128.
SIGN = 256
MAX_C = 8            # nb = 2^(c-1) <= 128 keeps |d| below the sign flag
DEFAULT_BT = 512     # lanes per step
CHUNK_STEPS = 256    # steps per chunk of the streamed form


# --- policy -------------------------------------------------------------------

def _nwin_for(nbits: int, c: int) -> tuple[int, bool]:
    """Window count and `tight` flag. W = ceil(nbits/c) raw windows; when
    c*W > nbits strictly, the top raw window spans fewer than c-1 scalar
    bits, so top_raw + carry_in <= 2^(nbits - c*(W-1)) <= nb: the top
    window absorbs the signed-digit carry unsigned and the extra carry
    window disappears (nwin = W instead of W+1; 37 instead of 38 windows at
    c = 7 for 256-bit scalars). Sound for any scalar < 2^nbits."""
    W = -(-nbits // c)
    tight = c * W > nbits
    return (W, True) if tight else (W + 1, False)


def choose_c(n: int, nbits: int = 256) -> int:
    """Window width from the point count: c = 4 below 2^15 points (the
    per-window fold and fixed overheads dominate, fewer buckets win); above,
    c = 8 where its window count is tight at this scalar bound (254-bit
    BN254 scalars), else c = 7 (tight at 256 bits). The table is the
    reference package's, which was tuned by sweeps on a TPU v5e; it has not
    been re-tuned on the H100. `pippenger_msm` takes `c=` to override it."""
    if n < (1 << 15):
        return 4
    return 8 if _nwin_for(nbits, 8)[1] else 7


# --- operand prep (plain torch, on the operands' device) ----------------------

def signed_digits(scalars: torch.Tensor, z: torch.Tensor, c: int, nwin: int,
                  tight: bool) -> torch.Tensor:
    """(npad, 16) standard-form scalar limbs -> (nwin, npad) int32 packed
    signed width-c digits, `|d| | (SIGN if d < 0)`, window 0 the lowest.

    Lanes whose point is at infinity (z == 0, which includes padding lanes)
    get digit 0 in every window and are never added, so the kernels never
    see an infinity operand. With `tight` the top window is unsigned and
    absorbs the carry (see `_nwin_for`)."""
    nb = 1 << (c - 1)
    nwin_u = nwin if tight else nwin - 1
    npad = scalars.shape[0]
    scp = torch.cat([scalars, scalars.new_zeros((npad, 1))], 1)
    vals = []
    for w in range(nwin_u):
        i, s = divmod(w * c, L.LIMB_BITS)
        raw = scp[:, i] >> s
        if s + c > L.LIMB_BITS:                 # window straddles two limbs
            raw = raw | (scp[:, i + 1] << (L.LIMB_BITS - s))
        vals.append(raw & ((1 << c) - 1))
    carry = torch.zeros_like(vals[0])
    digs = []
    for v in (vals[:-1] if tight else vals):
        v = v + carry
        carry = (v > nb).to(v.dtype)
        digs.append(v - 2 * nb * carry)
    # tight: top_raw + carry <= nb by _nwin_for; else the carry window
    digs.append(vals[-1] + carry if tight else carry)
    d = torch.stack(digs)                                   # (nwin, npad)
    pack = d.abs() | torch.where(d < 0, SIGN, 0)
    valid = ~mont.is_zero(z)
    return (pack * valid[None]).to(torch.int32)


class Blinding(NamedTuple):
    """Bucket start points D_s = d_s*G, s = 1..nb, as affine Montgomery
    limbs (nb, 16), and tsum = sum_s s*d_s mod n for the exact correction."""
    x: torch.Tensor
    y: torch.Tensor
    tsum: int


_BLINDINGS: dict = {}


def blinding(ops: CurveOps, nb: int, seed: int | None = None,
             device="cpu") -> Blinding:
    """The process's blinding points for nb buckets, on `device`. The
    secret scalars are drawn once per process, curve and nb from
    `random.SystemRandom()`; a `seed` (tests, reproducible debugging) draws
    them from `random.Random(seed)` in the same order."""
    cv = ops.curve
    key = (cv, nb, seed)
    host = _BLINDINGS.get(key)
    if host is None:
        rng = random.SystemRandom() if seed is None else random.Random(seed)
        d = [rng.randrange(1, cv.n) for _ in range(nb)]
        jp = ops.from_affine([ecc.mul(cv, cv.g, k) for k in d])
        tsum = sum((s + 1) * d[s] for s in range(nb)) % cv.n
        host = _BLINDINGS[key] = Blinding(jp.x, jp.y, tsum)
    return Blinding(host.x.to(device), host.y.to(device), host.tsum)


# --- bucket state layout --------------------------------------------------------

def pack_state(buckets: JacPoint) -> torch.Tensor:
    """(nwin, nb, bt, 16)-limb points -> (nwin, nb, 3, 8, bt) int32 words."""
    lim = torch.stack(list(buckets), 2)                  # (nwin, nb, 3, bt, 16)
    w = lim[..., 0::2] | (lim[..., 1::2] << 16)          # in [0, 2^32)
    w = w - ((w >> 31) << 32)                            # as signed 32-bit
    return w.to(torch.int32).transpose(-1, -2).contiguous()


def unpack_state(state: torch.Tensor) -> JacPoint:
    """(nwin, nb, 3, 8, bt) int32 words -> (nwin, nb, bt, 16)-limb points."""
    w = state.transpose(-1, -2).to(torch.int64) & 0xFFFFFFFF
    lim = torch.stack([w & L.LIMB_MASK, w >> 16], -1).flatten(-2)
    return JacPoint(lim[:, :, 0], lim[:, :, 1], lim[:, :, 2])


def _check_bucket_args(points: JacPoint, digits, blind: Blinding, bt: int,
                       state):
    nwin, npts = digits.shape
    nb = blind.x.shape[0]
    if digits.dtype != torch.int32 or npts % bt:
        raise ValueError(f"digits {digits.dtype} {tuple(digits.shape)} do "
                         f"not tile {bt} lanes")
    for t in points:
        if t.shape != (npts, L.NLIMBS):
            raise ValueError(f"point coordinate shape {tuple(t.shape)}, "
                             f"expected ({npts}, {L.NLIMBS})")
    if blind.x.shape != (nb, L.NLIMBS) or blind.y.shape != (nb, L.NLIMBS):
        raise ValueError("blinding points must be (nb, 16) limbs")
    if state is not None:
        _check_state(state, (nwin, nb, 3, 8, bt))
    return nwin, nb, npts // bt


def _check_state(state, shape=None):
    if state.dtype != torch.int32 or state.dim() != 5 \
            or state.shape[2:4] != (3, 8) \
            or (shape is not None and state.shape != shape):
        raise ValueError(f"bucket state {state.dtype} {tuple(state.shape)}, "
                         f"expected int32 {shape or '(nwin, nb, 3, 8, bt)'}")


def _require_contiguous(device, t: torch.Tensor):
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"operand on {t.device} (contiguous: "
                         f"{t.is_contiguous()}), expected contiguous on "
                         f"{device}")


# --- K5 pip_bucket ------------------------------------------------------------

def pip_bucket_plain(ops: CurveOps, points: JacPoint, digits, blind: Blinding,
                     bt: int, affine: bool, state=None) -> torch.Tensor:
    """The plain version of K5, batched over all (window, lane) pairs: a
    Python loop over the steps, a gather of the selected bucket, one raw
    add, and a scatter that writes only where the digit is nonzero."""
    nwin, nb, steps = _check_bucket_args(points, digits, blind, bt, state)
    dev = digits.device
    if state is None:
        shape = (nwin, nb, bt, L.NLIMBS)
        one = ops.fp.const("r_limbs", dev)
        buckets = JacPoint(
            blind.x[None, :, None].expand(shape).clone(),
            blind.y[None, :, None].expand(shape).clone(),
            one.expand(shape).clone())
    else:
        buckets = unpack_state(state)
    for k in range(steps):
        sl = slice(k * bt, (k + 1) * bt)
        v = digits[:, sl].to(torch.int64)                    # (nwin, bt)
        slot = v & (SIGN - 1)
        p = index(points, sl)                                # (bt, 16)
        p = select((v >> 8) != 0, ops.neg(p), p)             # (nwin, bt, 16)
        idx = (slot - 1).clamp(min=0)[:, None, :, None].expand(
            nwin, 1, bt, L.NLIMBS)
        cur = JacPoint(*(b.gather(1, idx)[:, 0] for b in buckets))
        new = ops.madd_raw(cur, p) if affine else ops.add_raw(cur, p)
        new = select(slot != 0, new, cur)        # digit 0 writes nowhere
        for b, n in zip(buckets, new):
            b.scatter_(1, idx, n[:, None])
    return pack_state(buckets)


def pip_bucket(ops: CurveOps, points: JacPoint, digits: torch.Tensor,
               blind: Blinding, bt: int, affine: bool,
               state: torch.Tensor | None = None) -> torch.Tensor:
    """Accumulate `steps` rows of bt points into the buckets their digits
    select -> bucket state (nwin, nb, 3, 8, bt).

    points: (steps*bt, 16)-limb JacPoint (Montgomery; with `affine` every z
    is R or 0 and is not read); digits: (nwin, steps*bt) from
    `signed_digits`. Without `state` the buckets start at the blinding
    points; with it, the accumulation goes on from that state (in place on
    the card) — the carry mode of the streamed form."""
    if points.x.device.type == "cpu":
        return pip_bucket_plain(ops, points, digits, blind, bt, affine, state)
    nwin, nb, steps = _check_bucket_args(points, digits, blind, bt, state)
    dev = points.x.device
    native.require(dev, *points, blind.x, blind.y)
    _require_contiguous(dev, digits)
    first = state is None
    if first:
        state = torch.empty((nwin, nb, 3, 8, bt), dtype=torch.int32,
                            device=dev)
    else:
        _require_contiguous(dev, state)
    lib = native.library()
    rc = lib.porla_pip_bucket(
        *map(native.ptr, points), native.ptr(digits), native.ptr(state),
        native.ptr(blind.x), native.ptr(blind.y), nwin, nb, bt, steps,
        int(affine), int(first), native.mod_words(ops.fp),
        native.stream(dev))
    native.KERNELS["pip_bucket"].launches += 1
    native.check(rc, "pip_bucket")
    return state


# --- K6 bucket_fold -----------------------------------------------------------

def bucket_fold_plain(ops: CurveOps, state: torch.Tensor) -> JacPoint:
    """The plain version of K6: walking s = nb .. 1, run += B_s; acc +=
    run, for all (window, lane) pairs at once."""
    _check_state(state)
    buckets = unpack_state(state)
    nb = state.shape[1]
    run = index(buckets, (slice(None), nb - 1))
    acc = run
    for s in range(nb - 2, -1, -1):
        run = ops.add_raw(run, index(buckets, (slice(None), s)))
        acc = ops.add_raw(acc, run)
    return acc


def bucket_fold(ops: CurveOps, state: torch.Tensor) -> JacPoint:
    """sum_s s*B_s of every (window, lane) pair's buckets -> (nwin, bt,
    16)-limb JacPoint (never infinity: the buckets are blinded)."""
    if state.device.type == "cpu":
        return bucket_fold_plain(ops, state)
    _check_state(state)
    dev = state.device
    _require_contiguous(dev, state)
    nwin, nb, _, _, bt = state.shape
    out = JacPoint(*(torch.empty((nwin, bt, L.NLIMBS), dtype=torch.int64,
                                 device=dev) for _ in range(3)))
    lib = native.library()
    rc = lib.porla_bucket_fold(native.ptr(state), *map(native.ptr, out),
                               nwin, nb, bt, native.mod_words(ops.fp),
                               native.stream(dev))
    native.KERNELS["bucket_fold"].launches += 1
    native.check(rc, "bucket_fold")
    return out


# --- after the kernels ----------------------------------------------------------

def reduce_lanes(ops: CurveOps, p: JacPoint) -> JacPoint:
    """(nwin, bt, 16) folded lane partials -> (nwin, 16) window totals by
    log2(bt) lane-halving adds. Full-cased adds: lane partials can
    legitimately collide. bt must be a power of two, or lanes would be
    dropped silently."""
    w = p.x.shape[1]
    if w & (w - 1):
        raise ValueError(f"lane width must be a power of two: {w}")
    while w > 1:
        w //= 2
        p = ops.add(JacPoint(*(c[:, :w] for c in p)),
                    JacPoint(*(c[:, w:2 * w] for c in p)))
    return JacPoint(*(c[:, 0] for c in p))


def horner(ops: CurveOps, wins: list, c: int, bt: int, tsum: int):
    """Window totals (affine, window 0 first) -> the MSM's affine point:
    sum_w 2^(cw) * W_w from the top window down, minus the blinding
    contribution bt * (sum_w 2^(cw)) * tsum * G. Exact Python ints."""
    cv = ops.curve
    acc = wins[-1]
    for win in reversed(wins[:-1]):
        acc = ecc.add(cv, ecc.mul(cv, acc, 1 << c), win)
    wsum = sum(1 << (c * w) for w in range(len(wins))) % cv.n
    kappa = (bt * wsum * tsum) % cv.n
    return ecc.add(cv, acc, ecc.neg(cv, ecc.mul(cv, cv.g, kappa)))


def _is_affine(ops: CurveOps, z: torch.Tensor) -> bool:
    """Every z is R (affine) or 0 (infinity): one reduction, one host read."""
    r = ops.fp.const("r_limbs", z.device)
    return bool((mont.eq(z, r) | mont.is_zero(z)).all())


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


# --- entry point --------------------------------------------------------------

def pippenger_msm(ops: CurveOps, points: JacPoint, scalars: torch.Tensor,
                  nbits: int = 256, bt: int | None = None,
                  c: int | None = None, affine: bool | None = None,
                  blind_seed: int | None = None, device=None,
                  chunk_steps: int = CHUNK_STEPS) -> JacPoint:
    """sum_i scalars[i] * points[i] -> (1,) JacPoint (affine, on the host).

    points: (N, 16)-limb JacPoint (Montgomery); scalars: (N, 16)
    standard-form limbs below 2^nbits, on the points' device. N is padded
    with (infinity, 0) lanes. `affine` marks inputs whose z is R or 0 and
    selects the mixed add (detected when not given). `device` is where the
    MSM runs, by default the operands' device; CPU operands with a CUDA
    `device` and more than `chunk_steps` steps are streamed: chunks are
    copied from pinned memory on a side stream while K5 runs on the chunk
    before, carrying the bucket state in place. `blind_seed` fixes the
    blinding scalars for tests; the protocol never passes one."""
    N = points.x.shape[0]
    src = points.x.device
    dev = src if device is None else native.resolve_device(device)
    if src.type != "cpu" and dev != src:
        raise ValueError(f"operands on {src} cannot run on {dev}")
    if scalars.shape != (N, L.NLIMBS) or scalars.device != src:
        raise ValueError(f"scalars {tuple(scalars.shape)} on "
                         f"{scalars.device}, expected ({N}, 16) on {src}")
    bt = DEFAULT_BT if bt is None else bt
    bt = min(bt, max(128, 1 << (N - 1).bit_length()))
    if bt & (bt - 1):
        raise ValueError(f"lane width must be a power of two: {bt}")
    if c is None:
        c = choose_c(N, nbits)
    if not 2 <= c <= MAX_C:
        raise ValueError(f"window width {c} outside 2..{MAX_C}")
    nwin, tight = _nwin_for(nbits, c)
    steps = -(-N // bt)
    if affine is None:
        affine = _is_affine(ops, points.z)
    blind = blinding(ops, 1 << (c - 1), blind_seed, dev)

    if src.type == "cpu" and dev.type == "cuda" and steps > chunk_steps:
        state = _stream_buckets(ops, points, scalars, blind, bt, c, nwin,
                                tight, affine, dev, chunk_steps)
    else:
        npad = steps * bt
        pts = JacPoint(*(_pad_rows(t.to(dev), npad) for t in points))
        digits = signed_digits(_pad_rows(scalars.to(dev), npad), pts.z, c,
                               nwin, tight)
        state = pip_bucket(ops, pts, digits, blind, bt, affine)
    wins = reduce_lanes(ops, bucket_fold(ops, state))
    total = horner(ops, ops.to_affine(wins), c, bt, blind.tsum)
    return ops.from_affine([total])


def _stream_buckets(ops, points, scalars, blind, bt, c, nwin, tight, affine,
                    dev, chunk_steps) -> torch.Tensor:
    """K5 over host-resident operands in chunks of `chunk_steps` steps: the
    copy of chunk i+1 (host to pinned memory, then to the card on a side
    stream) overlaps K5 on chunk i, which goes on from the state in place."""
    rows = chunk_steps * bt
    nchunks = -(-points.x.shape[0] // rows)
    host = [_pad_rows(t, nchunks * rows) for t in (*points, scalars)]
    side = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)

    def load(ci):
        with torch.cuda.stream(side):
            chunk = [t[ci * rows:(ci + 1) * rows].pin_memory()
                     .to(dev, non_blocking=True) for t in host]
        return chunk, side.record_event()

    state = None
    nxt = load(0)
    for ci in range(nchunks):
        (x, y, z, sc), ready = nxt
        if ci + 1 < nchunks:
            nxt = load(ci + 1)
        main.wait_event(ready)
        for t in (x, y, z, sc):
            t.record_stream(main)
        digits = signed_digits(sc, z, c, nwin, tight)
        state = pip_bucket(ops, JacPoint(x, y, z), digits, blind, bt, affine,
                           state)
    return state
