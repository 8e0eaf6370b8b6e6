#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`porla_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   `porla_tpu_torch/csrc/` (six sources, one `nvcc` each, in parallel) and
   prints the build seconds.
2. Holds each kernel (K1 ntt_stage, K2 scalar_mul in its windowed and
   GLV modes, K3 point_butterfly, K4 fixed_base, K5 pip_bucket, K6
   bucket_fold, K7 point_butterfly_window) at the shapes of the paths
   below against its plain torch version on the card (tolerance: exact,
   bit-identical limbs or bucket words, so points are the same affine
   points, infinity included) and against exact Python integers on a few
   lanes, including edge lanes. Times both with CUDA events (median after
   a warm-up). K5 and K6 are also held against their plain versions in
   every mode (affine, Jacobian, first then carry) at 2^14 points with
   runs of the same digit in consecutive steps of a lane; K6 means both
   `bucket_fold` (per lane) and `fold_windows` (with the lane sum), also
   on a constructed state whose lane sum meets P + P, P + (-P) and
   infinity.
3. Runs the IPA protocol at n = 1024 blocks on the card: initialize, an
   audit, 4 updates, another audit (both must verify), then a corrupted
   codeword that the next audit must reject. K1-K4's launch counts must
   rise during this run.
4. Runs the variable-base MSM entry point `curves.kernels.msm` on operands
   on the card: 2^20 points on secp256k1 and on BN254 G1 and 4096 points
   (the Pippenger crossover), built as `bench.py` builds them, every run
   checked against the golden sum; 2^16 distinct points; the streamed form
   from CPU tensors at 2^20; the reference-C vector (n = 300); `msm_parts`
   at 4096 stacked lanes; and the public `point_butterfly` at nbits = 64.
   K5-K7's launch counts must rise during this run. One MSM must take
   exactly one K5 launch and K6's two (the fold, then the lane sum) and no
   plain torch point arithmetic. Prints seconds per MSM and points per
   second, and where one MSM's seconds go (at 2^20 on both curves and at
   4096), with K6 held against its plain version at each of those shapes;
   then K5's, K6's and the packing's milliseconds at 512, 1024 and 2048
   lanes on both curves, each width's MSM checked against the golden sum.
5. Prints one JSON line of per-kernel results, the card line again, and
   as its last line {"ok": true, "device": {...}}.

Any failed phase raises, so the script exits nonzero and prints no result.
It exits nonzero when torch finds no CUDA device or the port's package is
not beside it.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

N_BLOCKS = 1024          # the reference's default workload (Client.cpp)
N_UPDATES = 4
SEED = 20261016
MSM_N = 1 << 20          # the MSM entry point's size of record (bench.py)
MSM_CHECK_N = 1 << 14    # K5/K6 against their plain versions in every mode
BLIND_SEED = 77          # fixed blinding for the bucket-state comparisons

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s, and
# float32 operations/s outside the tensor cores, which stands in for the
# integer rate the data sheet does not give (Hopper issues 32-bit IMAD at
# half of it, so the bound errs low). A 32x32->64-bit product is two
# multiply-adds (low and high word) of 2 operations each.
HBM_BYTES_S = 3.35e12
CORE_OPS_S = 67e12
OPS_PER_FE_MUL = 136 * 2 * 2   # CIOS over 8 words: 136 wide products
FE_BYTES = 32                  # one 256-bit field element, packed
# field products (multiplies and squares) per lane that the algorithms
# need, secp256k1 (a = 0), Jacobian: doubling 3M+4S, add 12M+4S, mixed add
# 7M+4S. The kernels' branchless adds also compute the P == Q doubling;
# that is the implementation's cost, not the function's, and not counted.
DBL, ADD, MADD = 7, 16, 11
TABLE16 = 7 * DBL + 7 * ADD    # 2P..15P of a 16-entry window table


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_ms(fn, device, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() on the card's timeline (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / CORE_OPS_S * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --- inputs -------------------------------------------------------------------

def rand_below(rng, n: int, count: int) -> list[int]:
    """`count` uniform-ish ints in [0, n) from a numpy Generator."""
    words = rng.integers(0, 1 << 32, size=(count, 8), dtype="uint64")
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % n
            for row in words]


def rand_points(rng, cv, count: int) -> list:
    """Random affine points of the curve (random x, lifted where square)."""
    from porla_tpu_torch.golden import ecc
    pts = []
    while len(pts) < count:
        x = rand_below(rng, cv.p, 1)[0]
        pt = ecc.lift_x(cv, x, int(rng.integers(0, 2)))
        if pt is not None:
            pts.append(pt)
    return pts


def jacobian(ops, pts, zs, device):
    """Affine points (or INF) as Jacobian points with the given Z's
    (X = x Z^2, Y = y Z^3), Montgomery form, on `device`."""
    from porla_tpu_torch.curves.weierstrass import JacPoint
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc
    p = ops.curve.p
    m = ops.fp.to_mont_int
    xs, ys, zz = [], [], []
    for pt, z in zip(pts, zs):
        if pt is ecc.INF:
            xs.append(m(1)), ys.append(m(1)), zz.append(0)
        else:
            xs.append(m(pt[0] * z * z % p))
            ys.append(m(pt[1] * z * z * z % p))
            zz.append(m(z))
    return JacPoint(*(L.ints_to_tensor(c, device) for c in (xs, ys, zz)))


def limb_err(a, b) -> int:
    """Max absolute difference of two limb tensors (or point batches)."""
    if isinstance(a, tuple):
        return max(limb_err(x, y) for x, y in zip(a, b))
    return int((a - b).abs().max().item()) if a.numel() else 0


def check_points(ops, name, got, plain, lanes, expect) -> int:
    """Kernel vs plain version and the listed lanes vs exact golden points.
    The kernels use the plain versions' formulas lane for lane, so their
    Jacobian limbs must be identical (which makes the affine points, and
    infinity, equal too). Returns the max limb error (0)."""
    err = limb_err(got, plain)
    if err != 0:
        raise AssertionError(f"{name}: kernel limbs differ from the plain "
                             f"version (max abs err {err})")
    from porla_tpu_torch.curves.weierstrass import index
    idx = torch.tensor(lanes, device=got.x.device)
    aff = ops.to_affine(index(got, idx))
    for lane, a, e in zip(lanes, aff, expect):
        if a != e:
            raise AssertionError(f"{name}: lane {lane} differs from the "
                                 f"golden model")
    return err


# --- phase 2: the kernels ---------------------------------------------------

def check_k1(dev, rng, n=N_BLOCKS, chunks=128, reps=10):
    """K1 at (n, 128, 16) per CRT lane, every stage of the CRebuild."""
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.ntt import cuda_stage, engine

    ctx = engine.NttContext(n, "ipa")
    rows, max_err = [], 0
    for lane, mod in (("p", ctx.mod_p), ("q", ctx.mod_q)):
        vals = rand_below(rng, mod.n, n * chunks)
        for k, v in enumerate((0, mod.n - 1, 1, mod.n - 1)):
            vals[k * chunks] = v                      # edge values
        a = L.ints_to_tensor(vals, dev).reshape(n, chunks, L.NLIMBS)
        ref = vals[::chunks]                          # chunk 0 of each row
        got_a, plain_a = a, a
        for s in range(1, ctx.height):
            m2 = 1 << (s - 1)
            tw = L.to_torch(getattr(ctx.twiddles(m2), "mont_" + lane), dev)
            got = cuda_stage.ntt_stage(got_a, tw, m2, mod)
            plain = cuda_stage.stage_plain(plain_a, tw, m2, mod)
            max_err = max(max_err, limb_err(got, plain))
            if max_err:
                raise AssertionError(f"K1 lane {lane} stage {s}: max abs "
                                     f"err {max_err}")
            got_a, plain_a = got, plain
            # exact ints on 8 butterflies of chunk 0
            std = L.limbs_to_ints(ctx.twiddles(m2).std)
            out = L.tensor_to_ints(got[:, 0])
            for k in [j for j in range(n) if j % (2 * m2) < m2][:8]:
                w = std[k % m2] % mod.n
                u, t = ref[k], ref[k + m2]
                if (out[k], out[k + m2]) != ((u + w * t) % mod.n,
                                             (u - w * t) % mod.n):
                    raise AssertionError(f"K1 lane {lane} stage {s}: pair "
                                         f"{k} differs from exact ints")
            ref = out
        tw1 = L.to_torch(getattr(ctx.twiddles(1), "mont_" + lane), dev)
        ms = timed_ms(lambda: cuda_stage.ntt_stage(a, tw1, 1, mod), dev, reps)
        plain_ms = timed_ms(lambda: cuda_stage.stage_plain(a, tw1, 1, mod),
                            dev, 3)
        rows.append((ms, plain_ms))
    ms = statistics.mean(r[0] for r in rows)
    plain_ms = statistics.mean(r[1] for r in rows)
    pairs = n // 2 * chunks
    b_ms, b_by = bound(pairs * OPS_PER_FE_MUL,
                       (2 * n * chunks + 1) * FE_BYTES)
    return dict(name="ntt_stage", shape=[n, chunks, 16], ms=ms,
                plain_ms=plain_ms, max_abs_err=max_err, bound_ms=b_ms,
                bound_by=b_by)


def check_k2(dev, rng, ops):
    """K2 windowed at the server's audit-MSM shape (2048 lanes, nbits 32)
    and GLV at the MAC-plane scaling shape (1024 lanes, 256 bits). The
    timed calls are the launches alone: the GLV split is made once."""
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    out = []
    for B, nbits in ((2 * N_BLOCKS, 32), (N_BLOCKS, 256)):
        pts = rand_points(rng, cv, B)
        pts[0] = ecc.INF                               # infinity input
        zs = [1 + v for v in rand_below(rng, cv.p - 1, B)]
        P = jacobian(ops, pts, zs, dev)
        top = (1 << nbits) if nbits < 256 else cv.n
        k = rand_below(rng, top, B)
        k[1] = 0                                       # zero scalar
        k[2] = 1
        k[3] = top - 1                                 # all-ones / n - 1
        sc = L.ints_to_tensor(k, dev)
        got = cc.scalar_mul(ops, P, sc, nbits)
        if nbits == 256:
            g = cc.GlvScalars(ops, sc)
            name = "scalar_mul_glv"
            plain_fn = lambda: cc.glv_scalar_mul_plain(ops, P, g)
            kern_fn = lambda: cc.launch_scalar_mul_glv(ops, P, g)
            muls = 1 + 2 * TABLE16 + 32 * (4 * DBL + 2 * ADD)
            # points in and out, two 128-bit halves and their sign bits
            nbytes = B * (6 * FE_BYTES + 2 * 16) + (2 * B + 7) // 8
        else:
            name = "scalar_mul_window"
            plain_fn = lambda: ops.scalar_mul(P, sc, nbits)
            kern_fn = lambda: cc.launch_scalar_mul_window(ops, P, sc, nbits)
            muls = TABLE16 + nbits // 4 * (4 * DBL + ADD)
            nbytes = B * (6 * FE_BYTES + nbits // 8)
        plain = plain_fn()
        lanes = list(range(min(12, B)))
        err = check_points(ops, name, got, plain, lanes,
                           [ecc.mul(cv, pts[i], k[i]) for i in lanes])
        ms = timed_ms(kern_fn, dev, 10)
        plain_ms = timed_ms(plain_fn, dev, 3)
        b_ms, b_by = bound(B * muls * OPS_PER_FE_MUL, nbytes)
        out.append(dict(name=name, shape=[B, 16], nbits=nbits, ms=ms,
                        plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                        bound_by=b_by))
    return out


def check_k3(dev, rng, ops, B=N_BLOCKS):
    """K3 at a CRebuild MAC stage's launch (2 planes x n/2 lanes)."""
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    m1 = rand_points(rng, cv, B)
    m0 = rand_points(rng, cv, B)
    k = rand_below(rng, cv.n, B)
    m1[0] = ecc.INF                                    # infinity input
    k[1] = 0                                           # zero scalar
    m0[2] = ecc.mul(cv, m1[2], k[2])                   # m0 == s*m1: the hi
    #                                                    add doubles, lo = inf
    m0[3] = ecc.neg(cv, ecc.mul(cv, m1[3], k[3]))      # m0 == -s*m1
    m0[4] = ecc.INF
    M0 = jacobian(ops, m0, [1 + v for v in rand_below(rng, cv.p - 1, B)], dev)
    M1 = jacobian(ops, m1, [1 + v for v in rand_below(rng, cv.p - 1, B)], dev)
    sc = L.ints_to_tensor(k, dev)
    g = cc.GlvScalars(ops, sc)
    hi, lo = cc.point_butterfly(ops, M0, M1, sc)
    phi, plo = cc.glv_butterfly_plain(ops, M0, M1, g)
    lanes = list(range(12))
    t = [ecc.mul(cv, m1[i], k[i]) for i in lanes]
    err = max(
        check_points(ops, "K3 hi", hi, phi, lanes,
                     [ecc.add(cv, m0[i], ti) for i, ti in zip(lanes, t)]),
        check_points(ops, "K3 lo", lo, plo, lanes,
                     [ecc.add(cv, m0[i], ecc.neg(cv, ti))
                      for i, ti in zip(lanes, t)]))
    ms = timed_ms(lambda: cc.launch_point_butterfly(ops, M0, M1, g),
                  dev, 10)
    plain_ms = timed_ms(lambda: cc.glv_butterfly_plain(ops, M0, M1, g),
                        dev, 3)
    muls = 1 + 2 * TABLE16 + 32 * (4 * DBL + 2 * ADD) + 2 * ADD
    # two points in, two out, two 128-bit halves and their sign bits
    b_ms, b_by = bound(B * muls * OPS_PER_FE_MUL,
                       B * (12 * FE_BYTES + 2 * 16) + (2 * B + 7) // 8)
    return dict(name="point_butterfly", shape=[B, 16], ms=ms,
                plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by)


def check_k4(dev, rng, ops, nblocks=N_BLOCKS):
    """K4 at the client's initialize commitment: every chunk of n blocks
    against the 128 Pedersen generators (n x 128 lanes, 256-bit)."""
    from porla_tpu_torch.commit import pedersen
    from porla_tpu_torch.config import NUM_CHUNKS
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    gens, _, gens_aff = pedersen.ipa_generators()
    tbl = cc.fb_table_for(ops, gens)
    B = nblocks * NUM_CHUNKS
    k = rand_below(rng, 1 << 256, B)
    k[0], k[1], k[2] = 0, 1, (1 << 256) - 1
    sc = L.ints_to_tensor(k, dev)
    got = cc.fb_scalar_mul(tbl, sc)
    plain = cc.fb_scalar_mul_plain(tbl, sc)
    lanes = list(range(8)) + [B - 1 - i for i in range(4)]
    err = check_points(ops, "K4", got, plain, lanes,
                       [ecc.mul(cv, gens_aff[i % NUM_CHUNKS], k[i])
                        for i in lanes])
    ms = timed_ms(lambda: cc.fb_scalar_mul(tbl, sc), dev, 10)
    plain_ms = timed_ms(lambda: cc.fb_scalar_mul_plain(tbl, sc), dev, 3)
    nwin = 256 // 4
    # affine (x, y) tables, scalars in, Jacobian points out
    b_ms, b_by = bound(B * nwin * MADD * OPS_PER_FE_MUL,
                       nwin * 16 * NUM_CHUNKS * 2 * FE_BYTES
                       + B * (FE_BYTES + 3 * FE_BYTES))
    return dict(name="fixed_base", shape=[B, 16], ms=ms, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by)


def state_err(a, b) -> int:
    """Max absolute difference of two packed bucket states (int32 words)."""
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def check_buckets_golden(ops, pts, digits, blind, state, folded, bt, pairs):
    """A few (window, lane) pairs of K5's state and K6's output against
    exact Python ints: bucket s is d_s*G plus the signed sum of the lane's
    points whose digit selects it; the fold is sum_s s*B_s."""
    from porla_tpu_torch.curves import cuda_msm as cm
    from porla_tpu_torch.curves.weierstrass import JacPoint, index
    from porla_tpu_torch.golden import ecc
    cv = ops.curve
    nb = blind.x.shape[0]
    one = ops.fp.const("r_limbs", blind.x.device).expand_as(blind.x)
    start = ops.to_affine(JacPoint(blind.x, blind.y, one))
    for w, lane in pairs:
        want = list(start)
        col = digits[w, lane::bt].tolist()
        for k, v in enumerate(col):
            slot, neg = v & 255, v >> 8
            q = pts[k * bt + lane]
            if slot:
                want[slot - 1] = ecc.add(cv, want[slot - 1],
                                         ecc.neg(cv, q) if neg else q)
        words = state[w:w + 1, :, lane:lane + 1]
        got = ops.to_affine(JacPoint(*(c.reshape(nb, 16)
                                       for c in cm.unpack_state(words))))
        if got != want:
            raise AssertionError(f"K5: buckets of window {w}, lane {lane} "
                                 f"differ from exact ints")
        fold = ops.to_affine(index(folded, (w, slice(lane, lane + 1))))[0]
        if fold != ecc.msm(cv, want, range(1, nb + 1)):
            raise AssertionError(f"K6: fold of window {w}, lane {lane} "
                                 f"differs from exact ints")


def collision_state(ops, state):
    """A bucket state whose lane sum meets every case of the full add: lane
    bt/2 holds lane 0's buckets (P + P at the first level), lane bt/2 + 1 the
    negation of lane 1's (P + (-P) there, and infinity on one side one level
    deeper)."""
    from porla_tpu_torch.curves import cuda_msm as cm
    from porla_tpu_torch.curves.weierstrass import JacPoint
    from porla_tpu_torch.fields import mont
    h = state.shape[2] // 2
    out = state.clone()
    out[:, :, h] = state[:, :, 0]
    b = cm.unpack_state(state[:, :, 1:2])
    neg = cm.pack_state(JacPoint(b.x, mont.neg_mod(b.y, ops.fp), b.z))
    out[:, :, h + 1] = neg[:, :, 0]
    return out


def check_fold(ops, state, golden_windows=()):
    """K6 on `state` against its plain version, limb for limb: `bucket_fold`
    (the per-lane fold) against `bucket_fold_plain`, `fold_windows` against
    `reduce_lanes` of that; and the listed windows' totals against the sum
    of the lanes' folds in exact Python ints. Returns (max abs err, plain
    seconds, window totals)."""
    from porla_tpu_torch.curves import cuda_msm as cm
    from porla_tpu_torch.curves.weierstrass import index
    from porla_tpu_torch.golden import ecc
    dev = state.device
    lanes = cm.bucket_fold(ops, state)
    wins = cm.fold_windows(ops, state)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    plain_lanes = cm.bucket_fold_plain(ops, state)
    plain_wins = cm.reduce_lanes(ops, plain_lanes)
    torch.cuda.synchronize(dev)
    plain_s = time.perf_counter() - t0
    err = max(limb_err(lanes, plain_lanes), limb_err(wins, plain_wins))
    if err:
        raise AssertionError(f"K6 at {tuple(state.shape)}: max abs err {err} "
                             f"against the plain version")
    for w in golden_windows:
        want = ecc.INF
        for q in ops.to_affine(index(plain_lanes, w)):
            want = ecc.add(ops.curve, want, q)
        if ops.to_affine(index(wins, slice(w, w + 1)))[0] != want:
            raise AssertionError(f"K6: total of window {w} differs from "
                                 f"exact ints")
    return err, plain_s, wins


def check_fold_collisions(ops, state):
    """K6 on the constructed collision state of `state`."""
    from porla_tpu_torch.curves import cuda_msm as cm
    from porla_tpu_torch.curves.weierstrass import index
    from porla_tpu_torch.golden import ecc
    cstate = collision_state(ops, state)
    h = state.shape[2] // 2
    fold = cm.bucket_fold_plain(ops, cstate)
    pair = ops.to_affine(index(fold, (0, [0, h, 1, h + 1])))
    if pair[0] != pair[1] or pair[2] != ecc.neg(ops.curve, pair[3]):
        raise AssertionError("the collision state does not collide")
    err, _, _ = check_fold(ops, cstate, golden_windows=(0,))
    return err


def check_k5_k6_modes(dev, rng, ops, N=MSM_CHECK_N, c=7):
    """K5 and K6 at N = 2^14, c = 7 and the default lane width, with a
    fixed blinding seed: bit-identical to the plain versions for affine and
    for Jacobian inputs, and `first` then `carry` over two chunks against
    one launch over both. Lanes 0-3 carry the same scalar in every step, so
    consecutive steps select the same bucket there (lanes 1 and 2 with
    negative digits): the case in which a bucket loaded ahead is stale."""
    from porla_tpu_torch.curves import cuda_msm as cm
    from porla_tpu_torch.curves.weierstrass import index
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    bt = cm.DEFAULT_BT
    nbits = 256
    nwin, tight = cm._nwin_for(nbits, c)
    pts = rand_points(rng, cv, N)
    pts[5] = ecc.INF                                   # never added
    k = rand_below(rng, cv.n, N)
    k[0], k[1], k[2] = 0, cv.n - 1, (1 << 256) - 1
    for lane in range(4):
        k[lane::bt] = [k[lane]] * (N // bt)
    sc = L.ints_to_tensor(k, dev)
    blind = cm.blinding(ops, 1 << (c - 1), BLIND_SEED, dev)
    out = {}
    for affine in (True, False):
        zs = [1] * N if affine else [1 + v for v in
                                     rand_below(rng, cv.p - 1, N)]
        P = jacobian(ops, pts, zs, dev)
        digits = cm.signed_digits(sc, P.z, c, nwin, tight)
        got = cm.pip_bucket(ops, P, digits, blind, bt, affine)
        t0 = time.perf_counter()
        plain = cm.pip_bucket_plain(ops, P, digits, blind, bt, affine)
        torch.cuda.synchronize(dev)
        plain_s = time.perf_counter() - t0
        err = state_err(got, plain)
        half = N // 2
        st = cm.pip_bucket(ops, index(P, slice(0, half)),
                           digits[:, :half].contiguous(), blind, bt, affine)
        st = cm.pip_bucket(ops, index(P, slice(half, N)),
                           digits[:, half:].contiguous(), blind, bt, affine,
                           st)
        err = max(err, state_err(st, got))
        if err:
            raise AssertionError(f"K5 (affine={affine}): max abs err {err} "
                                 f"against the plain version")
        ferr, fold_plain_s, _ = check_fold(ops, got, golden_windows=(3,))
        ferr = max(ferr, check_fold_collisions(ops, got))
        check_buckets_golden(ops, pts, digits, blind, got,
                             cm.bucket_fold(ops, got), bt,
                             [(0, 0), (nwin - 1, 1), (17, 2), (17, 5),
                              (3, bt - 1)])
        ms = timed_ms(lambda: cm.pip_bucket(ops, P, digits, blind, bt,
                                            affine), dev, 5)
        fold_ms = timed_ms(lambda: cm.fold_windows(ops, got), dev, 5)
        out["affine" if affine else "jacobian"] = dict(
            pip_bucket_ms=ms, pip_bucket_plain_ms=plain_s * 1e3,
            fold_windows_ms=fold_ms, fold_windows_plain_ms=fold_plain_s * 1e3,
            max_abs_err=max(err, ferr))
    return dict(check="pip_bucket+bucket_fold modes",
                shape=[nwin, N // bt, bt], c=c, **out)


def check_k7(dev, rng, ops, B=N_BLOCKS, nbits=64):
    """K7 at K3's shape (1024 lanes, 2 planes of 512) with 64-bit scalars
    against its plain version and the golden model on K3's edge lanes; and
    at nbits = 256 through its launch function: the same affine points as
    K3."""
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.curves.weierstrass import index
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    m1 = rand_points(rng, cv, B)
    m0 = rand_points(rng, cv, B)
    k = rand_below(rng, 1 << nbits, B)
    m1[0] = ecc.INF
    k[1] = 0
    m0[2] = ecc.mul(cv, m1[2], k[2])                   # hi doubles, lo = inf
    m0[3] = ecc.neg(cv, ecc.mul(cv, m1[3], k[3]))
    m0[4] = ecc.INF
    k[5] = (1 << nbits) - 1
    M0 = jacobian(ops, m0, [1 + v for v in rand_below(rng, cv.p - 1, B)], dev)
    M1 = jacobian(ops, m1, [1 + v for v in rand_below(rng, cv.p - 1, B)], dev)
    sc = L.ints_to_tensor(k, dev)
    hi, lo = cc.point_butterfly(ops, M0, M1, sc, nbits)
    phi, plo = cc.window_butterfly_plain(ops, M0, M1, sc, nbits)
    lanes = list(range(12))
    t = [ecc.mul(cv, m1[i], k[i]) for i in lanes]
    err = max(
        check_points(ops, "K7 hi", hi, phi, lanes,
                     [ecc.add(cv, m0[i], ti) for i, ti in zip(lanes, t)]),
        check_points(ops, "K7 lo", lo, plo, lanes,
                     [ecc.add(cv, m0[i], ecc.neg(cv, ti))
                      for i, ti in zip(lanes, t)]))
    # 256 bits through the launch function: K3's affine points
    k256 = L.ints_to_tensor(rand_below(rng, cv.n, B), dev)
    whi, wlo = cc.launch_window_butterfly(ops, M0, M1, k256, 256)
    ghi, glo = cc.point_butterfly(ops, M0, M1, k256)
    idx = torch.arange(min(64, B), device=dev)
    for name, a, b in (("hi", whi, ghi), ("lo", wlo, glo)):
        if ops.to_affine(index(a, idx)) != ops.to_affine(index(b, idx)):
            raise AssertionError(f"K7 at 256 bits: {name} differs from K3")
    ms = timed_ms(lambda: cc.launch_window_butterfly(ops, M0, M1, sc, nbits),
                  dev, 10)
    plain_ms = timed_ms(lambda: cc.window_butterfly_plain(ops, M0, M1, sc,
                                                          nbits), dev, 3)
    muls = TABLE16 + nbits // 4 * (4 * DBL + ADD) + 2 * ADD
    b_ms, b_by = bound(B * muls * OPS_PER_FE_MUL,
                       B * (12 * FE_BYTES + nbits // 8))
    return dict(name="point_butterfly_window", shape=[B, 16], nbits=nbits,
                ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by)


# --- phase 4: the MSM entry point -------------------------------------------

def msm_inputs(ops, n, dev, nbases=8):
    """Operands as `bench.py` builds them: 8 random bases tiled over n
    lanes (the golden sum stays O(n) host ints), scalars below the group
    order from a seed, on `dev`."""
    from porla_tpu_torch.curves.weierstrass import JacPoint
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc
    rng = random.Random(7)
    cv = ops.curve
    bases = [ecc.mul(cv, cv.g, rng.randrange(1, cv.n)) for _ in range(nbases)]
    sc = [rng.getrandbits(256) % cv.n for _ in range(n)]
    ph = ops.from_affine(bases)
    points = JacPoint(*(c.repeat(n // nbases, 1).to(dev) for c in ph))
    want = ecc.INF
    for g in range(nbases):
        want = ecc.add(cv, want, ecc.mul(cv, bases[g],
                                         sum(sc[g::nbases]) % cv.n))
    return points, L.ints_to_tensor(sc, dev), want


def msm_stages(dev, ops, points, scalars, nbits, plain: bool, bt=None):
    """One MSM taken apart as `cuda_msm.pippenger_msm` runs it, on operands
    on the card: host-clock seconds per stage (synchronised), K5's and K6's
    times by CUDA events, their bounds from this run's digits, K6 against
    its plain version (limb-identical totals required, also on the
    collision state), and with `plain` K5 against its plain version
    (bit-identical state required). Returns (stage record, K5 row, K6 row,
    the MSM's point)."""
    from porla_tpu_torch.curves import cuda_msm as cm
    N = points.x.shape[0]
    bt = cm.DEFAULT_BT if bt is None else bt
    c = cm.choose_c(N, nbits)
    nb = 1 << (c - 1)
    nwin, tight = cm._nwin_for(nbits, c)
    steps = N // bt
    blind = cm.blinding(ops, nb, BLIND_SEED, dev)
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        stages[name] = time.perf_counter() - t0
        return out

    affine = stage("affine_detect", lambda: cm._is_affine(ops, points.z))
    digits = stage("digits", lambda: cm.signed_digits(
        scalars, points.z, c, nwin, tight))
    packed = stage("pack_points", lambda: cm.pack_points(points, bt, affine))
    state = stage("pip_bucket", lambda: cm.launch_pip_bucket(
        ops, packed, digits, blind, bt, affine))
    wins = stage("fold_windows", lambda: cm.fold_windows(ops, state))
    got = stage("host_horner", lambda: cm.horner(
        ops, ops.to_affine(wins), c, bt, blind.tsum))

    k5_ms = timed_ms(lambda: cm.launch_pip_bucket(ops, packed, digits, blind,
                                                  bt, affine), dev, 3)
    k6_ms = timed_ms(lambda: cm.fold_windows(ops, state), dev, 5)
    lanes_ms = timed_ms(lambda: cm.bucket_fold(ops, state), dev, 5)
    adds = int(((digits & 255) != 0).sum().item())     # digit 0 adds nowhere
    state_bytes = nwin * nb * bt * 3 * FE_BYTES
    k5_b, k5_by = bound(adds * (MADD if affine else ADD) * OPS_PER_FE_MUL,
                        N * ((2 if affine else 3) * FE_BYTES + nbits // 8)
                        + nb * 2 * FE_BYTES + state_bytes)
    # the fold's 2(nb-1) adds a (window, lane) and the lane sum's bt-1 a
    # window; the state in, one point a window out
    k6_b, k6_by = bound(nwin * (bt * 2 * (nb - 1) + bt - 1) * ADD
                        * OPS_PER_FE_MUL,
                        state_bytes + nwin * 3 * FE_BYTES)
    k5 = dict(name="pip_bucket", shape=[nwin, steps, bt], c=c, nbits=nbits,
              bucket_adds=adds, ms=k5_ms, bound_ms=k5_b, bound_by=k5_by)
    k6 = dict(name="bucket_fold", shape=[nwin, nb, bt], ms=k6_ms,
              lanes_only_ms=lanes_ms, bound_ms=k6_b, bound_by=k6_by)
    err, plain_s, plain_wins = check_fold(ops, state)
    k6["plain_ms"] = plain_s * 1e3
    k6["max_abs_err"] = max(err, limb_err(wins, plain_wins),
                            check_fold_collisions(ops, state))
    if plain:
        t0 = time.perf_counter()
        pstate = cm.pip_bucket_plain(ops, points, digits, blind, bt, affine)
        torch.cuda.synchronize(dev)
        k5["plain_ms"] = (time.perf_counter() - t0) * 1e3
        k5["max_abs_err"] = state_err(state, pstate)
        del pstate
        if k5["max_abs_err"]:
            raise AssertionError(
                f"K5 at {N} points: max abs err {k5['max_abs_err']} against "
                f"the plain version")
    rec = {"msm_stages": {"curve": ops.fp.name, "n": N, "c": c, "nwin": nwin,
                          "bt": bt, "s": stages}}
    return rec, k5, k6, got


def assert_kernels_only(ops, fn):
    """Run fn() (one MSM on operands on the card) and require that it took
    one K5 launch, one K6 call (two launches: the fold and the lane sum)
    and no plain torch point arithmetic: between the digits and `to_affine`
    everything is the two kernels."""
    from porla_tpu_torch import native
    from porla_tpu_torch.curves.weierstrass import CurveOps
    names = ("add", "madd", "add_raw", "madd_raw", "double", "tree_sum")
    real = {n: getattr(CurveOps, n) for n in names}
    calls = []

    def counted(name):
        def f(*a, **k):
            calls.append(name)
            return real[name](*a, **k)
        return f

    before = native.launches()
    for n in names:
        setattr(CurveOps, n, counted(n))
    try:
        out = fn()
    finally:
        for n in names:
            setattr(CurveOps, n, real[n])
    took = {k: v - before[k] for k, v in native.launches().items()
            if v - before[k]}
    if calls or took != {"pip_bucket": 1, "bucket_fold": 2}:
        raise AssertionError(f"one MSM took launches {took} and plain torch "
                             f"point ops {calls}")
    return out


def run_msm(dev, kat_path):
    """The variable-base MSM entry point on the card. Returns (per-run
    records, launches over the whole phase, K5 row, K6 row)."""
    from porla_tpu_torch import native
    from porla_tpu_torch.crypto import testrand
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.curves import cuda_msm as cm
    from porla_tpu_torch.curves import kernels
    from porla_tpu_torch.curves.instances import bn254, secp256k1
    from porla_tpu_torch.curves.weierstrass import JacPoint
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    runs = []

    def run(name, ops, fn, want, n, timed=3):
        """Warm-up plus `timed` runs through `fn`, each checked against the
        golden point with an explicit raise; host clock around the call,
        which ends with the result on the host."""
        times, per_run = [], []
        for i in range(1 + timed):
            before = native.launches()
            t0 = time.perf_counter()
            got = fn()
            dt = time.perf_counter() - t0
            if ops.to_affine(got)[0] != want:
                raise RuntimeError(f"MSM mismatch vs golden ({name}, n={n})")
            if i:
                times.append(dt)
            per_run.append({k: v - before[k] for k, v in
                            native.launches().items() if v - before[k]})
        t = min(times) if times else dt
        rec = {"msm": name, "n": n, "s_per_msm": t, "points_per_s": n / t,
               "runs_s": times, "launches_per_run": per_run[-1]}
        runs.append(rec)
        emit(rec)
        return got

    secp, bn = secp256k1(), bn254()
    native.reset_launches()

    # the three shapes of record, operands on the card
    p20, s20, want20 = msm_inputs(secp, MSM_N, dev)
    nbits = secp.curve.n.bit_length()
    res20 = run("secp256k1", secp,
                lambda: kernels.msm(secp, p20, s20, nbits), want20, MSM_N)
    pb, sb, wantb = msm_inputs(bn, MSM_N, dev)
    bbits = bn.curve.n.bit_length()
    run("bn254", bn, lambda: kernels.msm(bn, pb, sb, bbits), wantb, MSM_N)
    nx = kernels.PIPPENGER_CROSSOVER
    px, sx, wantx = msm_inputs(secp, nx, dev)
    run("secp256k1_crossover", secp,
        lambda: kernels.msm(secp, px, sx, nbits), wantx, nx)
    for ops_, p_, s_, b_, want_ in ((secp, p20, s20, nbits, want20),
                                    (secp, px, sx, nbits, wantx)):
        got = assert_kernels_only(ops_, lambda: kernels.msm(ops_, p_, s_, b_))
        if ops_.to_affine(got)[0] != want_:
            raise RuntimeError("MSM mismatch vs golden (kernels-only run)")

    # the streamed form from CPU tensors (8 chunks) equals the resident run
    p20h = JacPoint(*(c.cpu() for c in p20))
    s20h = s20.cpu()
    streamed = run("secp256k1_streamed", secp,
                   lambda: cm.pippenger_msm(secp, p20h, s20h, nbits,
                                            device=dev),
                   want20, MSM_N, timed=1)
    if limb_err(streamed, res20):
        raise AssertionError("streamed MSM differs from the resident run")
    if runs[-1]["launches_per_run"].get("pip_bucket") != 8:
        raise AssertionError("the streamed run did not take 8 chunks")
    del p20h, s20h

    # distinct points (i+1)*G by host chain adds; golden (sum k_i (i+1))*G
    cv = secp.curve
    nd = 1 << 16
    chain, q = [], cv.g
    for _ in range(nd):
        chain.append(q)
        q = ecc.add(cv, q, cv.g)
    rng = random.Random(11)
    kd = [rng.getrandbits(256) % cv.n for _ in range(nd)]
    pd, sd = secp.from_affine(chain, dev), L.ints_to_tensor(kd, dev)
    wantd = ecc.mul(cv, cv.g, sum(k * (i + 1) for i, k in enumerate(kd)))
    run("secp256k1_distinct", secp,
        lambda: kernels.msm(secp, pd, sd, nbits), wantd, nd, timed=1)

    # libsecp256k1's own result for n = 300, 64-bit scalars
    with open(kat_path) as f:
        case = json.load(f)["ecmult_multi"][1]
    gens = testrand.derive_ipa_generators(128)[0]
    nk = case["n"]
    pk = secp.from_affine([gens[i % 128] for i in range(nk)], dev)
    sk = L.ints_to_tensor([((i + 1) * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
                           for i in range(nk)], dev)
    run("secp256k1_reference_c_vector", secp,
        lambda: cm.pippenger_msm(secp, pk, sk, nbits=64),
        (int(case["result"][0], 16), int(case["result"][1], 16)), nk,
        timed=1)

    # K7 through the public butterfly (64-bit scalars)
    kb = L.ints_to_tensor([rng.getrandbits(64) for _ in range(nk)], dev)
    cc.point_butterfly(secp, pk, pk, kb, nbits=64)
    torch.cuda.synchronize(dev)
    total = native.launches()

    # where one MSM's seconds go, and K5 / K6 at the shapes of record; on
    # secp256k1 also their plain versions at that shape
    rec, k5, k6, got = msm_stages(dev, secp, p20, s20, nbits, plain=True)
    if got != want20:
        raise RuntimeError("staged MSM mismatch vs golden (secp256k1)")
    emit(rec)
    emit({"check": "pip_bucket secp256k1", **k5})
    emit({"check": "bucket_fold secp256k1", **k6})
    recb, k5b, k6b, got = msm_stages(dev, bn, pb, sb, bbits, plain=False)
    if got != wantb:
        raise RuntimeError("staged MSM mismatch vs golden (bn254)")
    emit(recb)
    emit({"check": "pip_bucket bn254", **k5b})
    emit({"check": "bucket_fold bn254", **k6b})
    recx, k5x, k6x, got = msm_stages(dev, secp, px, sx, nbits, plain=True)
    if got != wantx:
        raise RuntimeError("staged MSM mismatch vs golden (crossover)")
    emit(recx)
    emit({"check": "pip_bucket crossover", **k5x})
    emit({"check": "bucket_fold crossover", **k6x})
    lane_widths(dev, secp, p20, s20, nbits, want20)
    lane_widths(dev, bn, pb, sb, bbits, wantb)
    return runs, total, k5, k6


LANE_WIDTHS = (512, 1024, 2048)


def lane_widths(dev, ops, points, scalars, nbits, want, widths=LANE_WIDTHS):
    """K5, K6 and the packing at each lane width on one MSM's operands:
    CUDA-event milliseconds of K5's launch, of `fold_windows` and of
    `pack_points`, and the MSM's point from each width's state against the
    golden point. What `cuda_msm.DEFAULT_BT` was chosen from."""
    from porla_tpu_torch.curves import cuda_msm as cm
    N = points.x.shape[0]
    c = cm.choose_c(N, nbits)
    nwin, tight = cm._nwin_for(nbits, c)
    digits = cm.signed_digits(scalars, points.z, c, nwin, tight)
    blind = cm.blinding(ops, 1 << (c - 1), BLIND_SEED, dev)
    for bt in widths:
        packed = cm.pack_points(points, bt, True)
        state = cm.launch_pip_bucket(ops, packed, digits, blind, bt, True)
        wins = cm.fold_windows(ops, state)
        if cm.horner(ops, ops.to_affine(wins), c, bt, blind.tsum) != want:
            raise RuntimeError(f"MSM mismatch vs golden at {bt} lanes "
                               f"({ops.fp.name})")
        emit({"lane_width": bt, "curve": ops.fp.name, "n": N, "c": c,
              "k5_ms": timed_ms(lambda: cm.launch_pip_bucket(
                  ops, packed, digits, blind, bt, True), dev, 3),
              "k6_ms": timed_ms(lambda: cm.fold_windows(ops, state), dev, 3),
              "pack_ms": timed_ms(lambda: cm.pack_points(points, bt, True),
                                  dev, 3)})
        del packed, state


def check_msm_parts(dev, ops):
    """The server's stacked audit route above the old limit: 4096 stacked
    lanes at nbits = 32 (two parts of 2048, some lanes at infinity with
    scalar 0) equal the plain version and the golden sums."""
    from porla_tpu_torch.curves import kernels
    from porla_tpu_torch.curves.weierstrass import JacPoint, index
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc
    cv = ops.curve
    n, nbases = 4096, 8
    rng = random.Random(13)
    bases = [ecc.mul(cv, cv.g, rng.randrange(1, cv.n)) for _ in range(nbases)]
    sc = [rng.getrandbits(32) for _ in range(n)]
    ph = ops.from_affine(bases)
    x, y, z = (c.repeat(n // nbases, 1) for c in ph)
    for i in (0, 7, 2047, 2048, 4095):
        z[i] = 0
        sc[i] = 0
    P = JacPoint(x.to(dev), y.to(dev), z.to(dev))
    S = L.ints_to_tensor(sc, dev)
    got = kernels.msm_parts(ops, P, S, 2, nbits=32)
    plain = ops.scalar_mul(P, S, 32)
    for h, part in enumerate(got):
        lanes = range(h * n // 2, (h + 1) * n // 2)
        want = ecc.INF
        for g in range(nbases):
            want = ecc.add(cv, want, ecc.mul(
                cv, bases[g], sum(sc[i] for i in lanes if i % nbases == g)))
        psum = ops.tree_sum(index(plain, slice(lanes.start, lanes.stop)))
        if limb_err(part, psum):
            raise AssertionError(f"msm_parts: part {h} differs from the "
                                 f"plain version")
        if ops.to_affine(part)[0] != want:
            raise AssertionError(f"msm_parts: part {h} differs from the "
                                 f"golden sum")
    return {"check": "msm_parts", "lanes": n, "nbits": 32, "parts": 2}


# --- phase 3: the protocol --------------------------------------------------

def run_protocol(dev, store_dir, n=N_BLOCKS, n_updates=N_UPDATES):
    """initialize -> audit -> updates -> audit -> corrupted audit, on
    `dev`. Returns (per-phase records, launches over the whole cycle)."""
    import numpy as np
    from porla_tpu_torch import native
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.protocol.client import AuditError, PorlaClient
    from porla_tpu_torch.protocol import auditing
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import InProcTransport
    rng = np.random.default_rng(SEED + 1)
    seed = lambda: rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    cfg = PorlaConfig(scheme="ipa", storage_dir=store_dir)
    server = PorlaServer(cfg, device=dev)
    client = PorlaClient(cfg, InProcTransport(server), data_seed=seed(),
                         device=dev)
    phases = []

    def phase(name, fn):
        before = native.launches()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = {"phase": name, "s": time.perf_counter() - t0,
               "launches": {k: v - before[k]
                            for k, v in native.launches().items()}}
        phases.append(rec)
        emit(rec)

    native.reset_launches()
    phase("initialize", lambda: client.initialize(n))
    phase("audit", lambda: client.audit(seed=seed()))
    for _ in range(n_updates):
        phase("update", lambda: client.update(
            client.write_step % client.num_blocks + 1))
    phase("audit", lambda: client.audit(seed=seed()))
    total = native.launches()

    # one flipped bit in a stored codeword (its q residue, as in
    # tests/test_protocol_e2e.py::test_corruption_is_detected) must fail
    # the next audit. An audit samples 128 of the top level's 2n codewords,
    # so the corrupted one is a codeword that this audit's plan samples
    # with a nonzero coefficient.
    audit_seed = seed()
    plan = auditing.build_audit_plan(audit_seed, server.write_step, n,
                                     server.height)
    hit = next(s for s in plan.samples
               if s.level == server.height - 1 and s.coeff % server.mod_q.n)
    side = server.levels[hit.level].x if hit.is_x else \
        server.levels[hit.level].y
    orig = side.data
    bad = orig.q.clone()
    bad[hit.index, 0, 0] ^= 1
    side.data = type(orig)(orig.p, bad)

    def corrupted():
        try:
            client.audit(seed=audit_seed)
        except AuditError:
            return
        raise AssertionError("the audit accepted a corrupted codeword")

    phase("audit_corrupted", corrupted)
    side.data = orig
    return phases, total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "porla_tpu_torch")):
        print("chip_smoke: porla_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    from porla_tpu_torch import native
    from porla_tpu_torch.curves.instances import secp256k1
    from porla_tpu_torch.utils import trace

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    so = native.build()
    native.library()
    emit({"build_s": time.perf_counter() - t0,
          "library": os.path.relpath(so, HERE)})
    for src, log in native.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line and \
                    "0 bytes stack" not in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)

    rng = np.random.default_rng(SEED)
    ops = secp256k1()
    k1 = check_k1(dev, rng)
    emit(dict(check="ntt_stage", launches=native.launches()["ntt_stage"],
              **{k: v for k, v in k1.items() if k != "name"}))
    k2 = check_k2(dev, rng, ops)
    for row in k2:
        emit(dict(check=row["name"], launches=native.launches()[row["name"]],
                  **{k: v for k, v in row.items() if k != "name"}))
    k3 = check_k3(dev, rng, ops)
    emit(dict(check="point_butterfly",
              launches=native.launches()["point_butterfly"],
              **{k: v for k, v in k3.items() if k != "name"}))
    k4 = check_k4(dev, rng, ops)
    emit(dict(check="fixed_base", launches=native.launches()["fixed_base"],
              **{k: v for k, v in k4.items() if k != "name"}))
    emit(check_k5_k6_modes(dev, rng, ops))
    k7 = check_k7(dev, rng, ops)
    emit(dict(check="point_butterfly_window",
              **{k: v for k, v in k7.items() if k != "name"}))

    # each path is driven with the counts set to 0 just before it and read
    # just after; a kernel must be launched by the path that owns it
    store = os.path.join(HERE, "porla_store_chip_smoke")
    shutil.rmtree(store, ignore_errors=True)
    trace.reset()
    trace.enable()
    try:
        phases, total = run_protocol(dev, store)
    finally:
        trace.enable(False)
        shutil.rmtree(store, ignore_errors=True)
    # host-clock spans of the protocol run (a span ends where its result
    # reaches the host, so it covers the card's work it waited for)
    for line in trace.report().splitlines():
        if "count" not in line and "gauge" not in line:
            print("trace", line, flush=True)
    protocol_kernels = ("ntt_stage", "scalar_mul_window", "scalar_mul_glv",
                        "point_butterfly", "fixed_base")
    msm_kernels = ("pip_bucket", "bucket_fold", "point_butterfly_window")
    missing = [k for k in protocol_kernels if total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the protocol run: "
                             f"{missing}")

    msm_runs, msm_total, k5, k6 = run_msm(
        dev, os.path.join(HERE, "tests", "vectors", "secp256k1_kat.json"))
    emit({"phase": "run_msm", "launches": msm_total})
    missing = [k for k in msm_kernels if msm_total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the MSM run: "
                             f"{missing}")
    emit(check_msm_parts(dev, ops))

    rows = []
    for r in (k1, *k2, k3, k4, k5, k6, k7):
        name = r["name"]
        k = native.KERNELS[name]
        per_phase = {}
        for rec in phases:
            per_phase.setdefault(rec["phase"], []).append(
                rec["launches"][name])
        per_phase["run_msm"] = [msm_total[name]]
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": total[name] + msm_total[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": r["shape"],
            "launches_per_phase": per_phase,
        })
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
