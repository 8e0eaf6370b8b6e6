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
  suffix-run trick and sums the bt lanes of every window with full-cased
  adds (lane partials can collide): `fold_windows`. Its plain version is
  `bucket_fold_plain` followed by `reduce_lanes`, which pairs the lanes as
  the reference's lane-halving sum does, so the window totals are the same
  Jacobian limbs.
- The host finishes in exact Python ints: Horner over the windows from the
  top down, minus the known blinding contribution
  bt * (sum_w 2^(cw)) * (sum_s s*d_s) * G.

The result is exact and independent of the blinding values. An adversary
who picks the MSM's inputs cannot steer a bucket into the unhandled doubling
case, because the blinding scalars come from `random.SystemRandom()`.

The bucket state between K5 and K6 is internal to them: (nwin, nb, bt, 3, 8)
32-bit words (a coordinate is 8 words), a bucket 96 contiguous bytes: the
lanes of a warp select different slots, so a lane-fastest state would cost
K5 a 32-byte sector of device memory for every 4-byte word. `pack_state` /
`unpack_state` convert it to and from limb points. K5 reads its points, which
all lanes take from the same step, with the lane the fastest axis: (steps, 2
or 3, 8, bt) words (`pack_points`, once per call, per chunk in the streamed
form).

A CPU tensor goes to the plain torch versions (`pip_bucket_plain`,
`bucket_fold_plain`, `reduce_lanes`), which give bit-identical state and
totals; a CUDA tensor launches the kernels or raises.
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
DEFAULT_BT = 1024    # lanes per step
CHUNK_STEPS = 128    # steps per chunk of the streamed form (2^17 points)


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
_FLEET_SEED: int | None = None


def set_fleet_seed(seed: int) -> None:
    """Draw every later blinding of this process from `seed` instead of the
    system's random source. In a multi-process run every process sets the
    same 256-bit seed at init (`parallel.multihost.share_fleet_seed`), so
    the shards of a sharded MSM, in whatever process, start their buckets at
    the same points and the host's correction holds for all of them."""
    global _FLEET_SEED
    _FLEET_SEED = seed


def blinding(ops: CurveOps, nb: int, seed: int | None = None,
             device="cpu") -> Blinding:
    """The process's blinding points for nb buckets, on `device`. The
    secret scalars are drawn once per process, curve and nb from
    `random.SystemRandom()`, or from `random.Random` of the fleet seed
    (`set_fleet_seed`) in a multi-process run; a `seed` (tests,
    reproducible debugging) draws them from `random.Random(seed)` in the
    same order."""
    cv = ops.curve
    if seed is None and _FLEET_SEED is not None:
        seed = _FLEET_SEED
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
    """(nwin, nb, bt, 16)-limb points -> (nwin, nb, bt, 3, 8) int32 words."""
    return L.words32(torch.stack(list(buckets), 3)).contiguous()


def pack_points(points: JacPoint, bt: int, affine: bool) -> torch.Tensor:
    """(steps*bt, 16)-limb points -> (steps, 2 or 3, 8, bt) int32 words, the
    form K5 reads: step k of lane l is point k*bt + l, x then y (then z
    unless `affine`), the lane the fastest axis."""
    coords = points[:2] if affine else points
    w = torch.stack([L.words32(c) for c in coords])      # (nc, npts, 8)
    w = w.reshape(len(coords), -1, bt, 8)
    return w.permute(1, 0, 3, 2).contiguous()


def unpack_state(state: torch.Tensor) -> JacPoint:
    """(nwin, nb, bt, 3, 8) int32 words -> (nwin, nb, bt, 16)-limb points."""
    w = state.to(torch.int64) & 0xFFFFFFFF
    lim = torch.stack([w & L.LIMB_MASK, w >> 16], -1).flatten(-2)
    return JacPoint(lim[..., 0, :], lim[..., 1, :], lim[..., 2, :])


def _check_bucket_args(digits, blind: Blinding, bt: int, state):
    """Shapes and dtypes of K5's operands other than the points (both the
    kernel's launch and the plain version check them) -> nwin, nb, steps."""
    if digits.dtype != torch.int32 or digits.dim() != 2 \
            or digits.shape[1] % bt:
        raise ValueError(f"digits {digits.dtype} {tuple(digits.shape)} do "
                         f"not tile {bt} lanes")
    nwin, npts = digits.shape
    nb = blind.x.shape[0]
    if blind.x.shape != (nb, L.NLIMBS) or blind.y.shape != (nb, L.NLIMBS):
        raise ValueError("blinding points must be (nb, 16) limbs")
    if state is not None:
        _check_state(state, (nwin, nb, bt, 3, 8))
    return nwin, nb, npts // bt


def _check_points(points: JacPoint, npts: int):
    for t in points:
        if t.shape != (npts, L.NLIMBS):
            raise ValueError(f"point coordinate shape {tuple(t.shape)}, "
                             f"expected ({npts}, {L.NLIMBS})")


def _check_state(state, shape=None):
    if state.dtype != torch.int32 or state.dim() != 5 \
            or state.shape[3:] != (3, 8) \
            or (shape is not None and state.shape != shape):
        raise ValueError(f"bucket state {state.dtype} {tuple(state.shape)}, "
                         f"expected int32 {shape or '(nwin, nb, bt, 3, 8)'}")


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
    nwin, nb, steps = _check_bucket_args(digits, blind, bt, state)
    _check_points(points, digits.shape[1])
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
    select -> bucket state (nwin, nb, bt, 3, 8).

    points: (steps*bt, 16)-limb JacPoint (Montgomery; with `affine` every z
    is R or 0 and is not read); digits: (nwin, steps*bt) from
    `signed_digits`. Without `state` the buckets start at the blinding
    points; with it, the accumulation goes on from that state (in place on
    the card) — the carry mode of the streamed form."""
    if points.x.device.type == "cpu":
        return pip_bucket_plain(ops, points, digits, blind, bt, affine, state)
    _check_points(points, digits.shape[-1])
    native.require(points.x.device, *points)
    return launch_pip_bucket(ops, pack_points(points, bt, affine), digits,
                             blind, bt, affine, state)


def launch_pip_bucket(ops: CurveOps, packed: torch.Tensor,
                      digits: torch.Tensor, blind: Blinding, bt: int,
                      affine: bool,
                      state: torch.Tensor | None = None) -> torch.Tensor:
    """K5's launch alone, on points already packed by `pack_points`."""
    dev = packed.device
    nwin, nb, steps = _check_bucket_args(digits, blind, bt, state)
    if packed.dtype != torch.int32 \
            or packed.shape != (steps, 2 if affine else 3, 8, bt):
        raise ValueError(f"packed points {packed.dtype} "
                         f"{tuple(packed.shape)} do not match {steps} steps "
                         f"of {bt} lanes")
    native.require(dev, blind.x, blind.y)
    _require_contiguous(dev, packed)
    _require_contiguous(dev, digits)
    first = state is None
    if first:
        state = torch.empty((nwin, nb, bt, 3, 8), dtype=torch.int32,
                            device=dev)
    else:
        _require_contiguous(dev, state)
    lib = native.library()
    rc = lib.porla_pip_bucket(
        native.ptr(packed), native.ptr(digits), native.ptr(state),
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


def _launch_bucket_fold(ops: CurveOps, state: torch.Tensor,
                        lanes: bool) -> JacPoint:
    """K6 on the card: with `lanes` the fold alone, (nwin, bt, 16) limbs, one
    launch; without, the fold and the lane sum, (nwin, 16) limbs, two
    launches (the sum needs a barrier across the fold's blocks), both
    counted."""
    _check_state(state)
    dev = state.device
    _require_contiguous(dev, state)
    nwin, nb, bt = state.shape[:3]
    shape = (nwin, bt, L.NLIMBS) if lanes else (nwin, L.NLIMBS)
    out = JacPoint(*(torch.empty(shape, dtype=torch.int64, device=dev)
                     for _ in range(3)))
    # the fold's lane partials as packed words, summed in place
    part = None if lanes else torch.empty((nwin, 3, 8, bt),
                                          dtype=torch.int32, device=dev)
    lib = native.library()
    rc = lib.porla_bucket_fold(
        native.ptr(state), None if part is None else native.ptr(part),
        *map(native.ptr, out), nwin, nb, bt, int(lanes),
        native.mod_words(ops.fp), native.stream(dev))
    native.KERNELS["bucket_fold"].launches += 1 if lanes else 2
    native.check(rc, "bucket_fold")
    return out


def bucket_fold(ops: CurveOps, state: torch.Tensor) -> JacPoint:
    """sum_s s*B_s of every (window, lane) pair's buckets -> (nwin, bt,
    16)-limb JacPoint (never infinity: the buckets are blinded)."""
    if state.device.type == "cpu":
        return bucket_fold_plain(ops, state)
    return _launch_bucket_fold(ops, state, lanes=True)


def fold_windows(ops: CurveOps, state: torch.Tensor) -> JacPoint:
    """sum over the lanes of sum_s s*B_s -> (nwin, 16)-limb window totals:
    `reduce_lanes` of `bucket_fold`, limb for limb, in one call of K6 (two
    launches on the card: the fold, then the lane sum)."""
    _check_state(state)
    bt = state.shape[2]
    if bt & (bt - 1):
        raise ValueError(f"lane width must be a power of two: {bt}")
    if state.device.type == "cpu":
        return reduce_lanes(ops, bucket_fold_plain(ops, state))
    return _launch_bucket_fold(ops, state, lanes=False)


def reduce_lanes(ops: CurveOps, p: JacPoint) -> JacPoint:
    """(nwin, bt, 16) folded lane partials -> (nwin, 16) window totals by
    log2(bt) lane-halving adds. Full-cased adds: lane partials can
    legitimately collide. bt must be a power of two, or lanes would be
    dropped silently. Plain torch: the second half of K6's plain version."""
    w = p.x.shape[1]
    if w & (w - 1):
        raise ValueError(f"lane width must be a power of two: {w}")
    while w > 1:
        w //= 2
        p = ops.add(JacPoint(*(c[:, :w] for c in p)),
                    JacPoint(*(c[:, w:2 * w] for c in p)))
    return JacPoint(*(c[:, 0] for c in p))


# --- after the kernels ----------------------------------------------------------

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
    wins = fold_windows(ops, state)
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
