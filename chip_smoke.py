#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`porla_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   `porla_tpu_torch/csrc/` (eight sources, one `nvcc` each, in parallel)
   and the native host runtime (`runtime/native/porla_rt.cc`, g++) and
   prints the build seconds.
2. Holds each kernel (K1 ntt_stage, K2 scalar_mul in its windowed and
   GLV modes, K3 point_butterfly, K4 fixed_base, group_sum, K5 pip_bucket,
   K6 bucket_fold, K7 point_butterfly_window, point_add) at the shapes of
   the paths below against its plain torch version on the card
   (tolerance: exact, bit-identical limbs or bucket words, so points are
   the same affine points, infinity included) and against exact Python
   integers on a few lanes, including edge lanes. Times both with CUDA
   events (median after a warm-up). K1 per CRT lane at (1024, 128, 16) (one launch, beside the
   same stages as one-stage launches) and at n = 2^14 (two passes); K2 GLV
   at 1024 lanes and at 1 (an update's); K4 at each of the path's shapes
   (per lane and in groups at the commit shape, the IPA rounds' shape, the
   complements) and at one group too wide for a block (K4 then group_sum);
   group_sum at GS_SHAPES (the audit's part sums, odd widths, 2^14 points
   in one group spread over 128 blocks, and the one- and two-add groups
   whose difference gives the depth floor's unit), one launch each; K7 at
   1024 lanes and at `run_msm`'s 300 (a ragged last block); point_add at
   PA_SHAPES (1 to 2048 lanes, a ragged block at 17), negate off and on,
   with lanes at infinity on either side, P + P and P + (-P), and a warp
   whose lanes need the doubling in only some lanes. One
   `fb_msm_groups`, one `commit_blocks`, one `msm_parts`, one `point_scale`
   and one `encode_crt` call must be their kernels' launches alone, with no
   plain torch point (or, for the last two, field) arithmetic. K5 and K6
   are also held against their plain versions in every mode (affine,
   Jacobian, first then carry) at 2^14 points with runs of the same digit
   in consecutive steps of a lane; K6 means both `bucket_fold` (per lane)
   and `fold_windows` (with the lane sum), also on a constructed state
   whose lane sum meets P + P, P + (-P) and infinity.
   The KZG path's kernels are held the same way on BN254 G1 operands at
   its shapes: K1's q lane mod BN254's r, K2 in both modes, K3, K4 over the
   SRS (the server's commitments, 131072 lanes in 1024 groups and 128 in
   one) and on h (the client's complements), group_sum at GS_SHAPES,
   point_add at PA_SHAPES and K7 at 1024 lanes and 64 bits, as on
   secp256k1. Then the IPA prover and verifier alone (`check_ipa`): the
   proof byte for byte the golden prover's, tampered proofs refused, the
   launches of a prove, a verify and an audit at n = 16 counted, and the
   MAC check's alpha products against the golden model.
3. Runs the protocol at n = 1024 blocks on the card, first the IPA scheme
   (secp256k1), then the KZG scheme (BN254): initialize, an audit, 4
   updates, another audit (both must verify), then a corrupted codeword
   that the next audit must reject; then a checkpoint, a new server
   restored from it on the card, and an audit, an update and an audit
   against it that verify. In each scheme K1-K4's and group_sum's launch
   counts must rise up to the second audit, initialize must launch K1
   exactly 4 times (two CRT arrays of two lanes) and no update any, and
   point_add must be launched 5 times an update and twice an audit. K3 is
   then checked and timed at the widest butterfly the IPA updates
   launched.
4. Runs the MSM entry point (see `run_msm`).
5. Runs the out-of-core tier (`run_ooc`): (d) the IPA scheme at n = 2^14
   blocks with the default caching level (10) and stripe (4096 blocks):
   initialize, whose streamed CRebuild writes level 14 into H_X/H_Y files
   through staging files, an audit, 4 updates, an audit, an audit of a
   flipped bit in a sampled codeword file (refused; the byte is then
   restored), a checkpoint, a restored server on the card and its audit;
   the peak host RSS and `torch.cuda.max_memory_allocated` over the
   initialize, and the host spans (`stream.*`, `server.crebuild`). (e) both
   schemes at n = 1024 with levels above 4 in files and stripes of 8: 64
   updates, an audit after update 32 (level 5 streamed into files) and 64
   (level 6, whose lower is level 5's files), then the same corrupted
   audit, checkpoint, restore and audit. K2, K3, K4 and group_sum must be
   launched by each run, K1 by no streamed CRebuild; K3 and K4 are then
   checked and timed at (d)'s widest launches (K2, K4 and group_sum at
   every other shape they launched after path (h), step 8). Beside the
   runs: the native runtime's file IO at (d)'s staging shape and the
   card's time for the plain butterfly over one stripe.
6. Runs ICC erasure recovery (`run_icc`, path (f)): a level of m = 2^15
   blocks of 128 chunks in the hardened context at n = 2^16, encoded on K1
   in the p lane and secp256k1's n lane, recovered from 128 erased columns
   (the `icc_recover` tool's pattern, then all from the X half) bit-exact
   in each lane and by CRT to the 256-bit chunk values; the reference mode
   on an epoch-CRebuild level at m = 1024 (a recoverable pattern, and an
   erased X/Y pair that must raise); BN254's r lane at m = 1024. Every fold
   must launch its K1 passes; K1 is then held against its plain version at
   the widest fold shape, (2^15, e + C, 16), in both lanes.
7. Runs the multi-device paths (path (g)) on logical meshes of the card
   (several shards on cuda:0: every shard-local kernel and the whole
   exchange schedule run, no interconnect does): (g1) the cycles of step
   3, IPA then KZG, with the server on a (2, 2) mesh (`run_mesh_protocol`):
   every reply equal to the one-device server's (byte for byte; a KZG
   audit's two Jacobian points as group elements), the corrupted audit
   refused, the restored server sharded too, and one more audit with
   force_sharded_pippenger (K5 and K6 a shard); (g2) the distributed NTT
   at n = 2^14, C = 128, both lanes, on dp = 4, limb for limb
   `encode_crt`'s, timed beside it, its exchange launch (`pair_stage`)
   held against its plain version; (g3) the sharded Pippenger MSM at 2^20
   points on dp = 4 on both curves, each result the golden point, timed
   beside the one-device MSM; (g4) two processes of
   `porla_tpu_torch/tools/run_multihost.py` over gloo, two shards each on
   cuda:0, the IPA epoch at n = 1024, both printing "audit PASSED", with
   the bytes each moved.
8. Runs the reference's self-test workload (path (h)): a full epoch at
   n = 1024 blocks in each scheme, IPA then KZG, as step 3's cycle
   (`run_protocol`) with n + 1 updates: initialize, an audit, round-robin
   updates through write step n - 1, whose folds reach every level from 0
   to 9, update n, which closes the epoch (the server's CRebuild from the
   update path, the client's over the epoch's complements; the top level
   full, every level below it empty), an audit, an update past the epoch,
   an audit, an audit of a corrupted q residue of a rebuilt codeword that
   it samples (refused), then the checkpoint, restore, audit, update and
   audit with the codeword restored. Initialize and the closing update
   must each launch K1 exactly 4 times, every other update none; K3 is
   held at the widest butterfly each epoch's updates launched; the
   amortized update, the closing update, the slowest update per fold
   level and the audits are printed (`epoch_summary`).
   Then the bench tool (`tools/bench.py`) runs once as a subprocess and
   must print bench.py's three metric lines, BN254 last (printed again).
9. Runs the reference's two-process deployment (path (i)): (i1) IPA and
   (i2) KZG, a server process (`tools/demo_e2e.py --serve`, bound to
   tcp://*:8888, the reference's port, which must be free) and a client
   process (`--connect tcp://localhost:8888`, n = 1024, an audit, 4
   updates, 2 audits) over the port's own ZMTP 3 wire: the client must
   print "ALL CHECKS PASSED", the server its record at SIGTERM, both rc 0;
   K1 4 times, all in the server at initialize; the client's transport
   counters equal to the server's; each phase's seconds beside path
   (a)'s, and the wire's seconds a request. (i3) resume across processes
   (`run_resume_deploy`): a checkpoint written in this process served by
   `--serve --resume`, the same client over a `ZmqClientTransport`: a
   copy with a sampled codeword corrupted must have its audit refused, the
   intact one an audit, an update and an audit verified.
10. Runs the out-of-core bench tool as a user runs it (path (j),
   `run_bench_ooc`): `python -m porla_tpu_torch.tools.bench_ooc` as a
   subprocess in each scheme, the two side by side, at n = 2^11 blocks in
   stripes of 256 (two passes of stages over the files a side) with
   `--check`, each in a fresh store removed afterwards: it must exit 0 with its check exact in all
   three parts (the streamed codeword files against K1's encode of U, the
   first and last stripes' alignment points against the plain K4, sampled
   MAC codewords against the golden model), and its phases, memory and
   disk breakdown are printed (`bench_ooc` lines).
   Last, K2, K4 and group_sum are held at every other shape that paths
   (a), (b), (d), (e) and (h) launched and phase 2 did not check, on each
   path's curve (`LaunchShapes`; the `path shapes` lines). The script's
   total seconds are printed before the kernels line.
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
# 7M+4S. The full-cased adds compute the P == Q doubling only where a lane
# meets that case, which these inputs' random lanes do not.
DBL, ADD, MADD = 7, 16, 11
TABLE16 = 7 * DBL + 7 * ADD    # 2P..15P of a 16-entry window table


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# A spin of the card's own clock queued ahead of a timed call (about 1 ms):
# long enough for the host to queue the call's launches behind it
SPIN_CYCLES = 2_000_000


def timed_ms(fn, device, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn()'s work on the card's timeline (CUDA
    events). Each timed call is queued behind a spin kernel, so the card is
    busy while the host prepares the call's launches and the events bracket
    the device work alone, not the host's launch cost (which the phase
    spans see)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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

def check_k1(dev, rng, n=N_BLOCKS, chunks=128, big=1 << 14, scheme="ipa",
             lanes=("p", "q")):
    """K1 per CRT lane at the CRebuild shape (n, 128, 16): the lane's stages
    in one launch, bit-identical to the plain stage loop, chunk 0 equal to
    exact ints (edge values 0, n - 1, 1 in it); timed beside the same
    stages as one-stage launches of the kernel (the old form's launch
    count). Then at n = `big`, C = 128 (two passes at 2^14) against the
    plain loop. The q lane is mod the scheme's group order (secp256k1's n,
    BN254's r). Returns the kernels line's row, with the `big` shape in
    `shapes`."""
    import numpy as np
    from porla_tpu_torch import native
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.ntt import cuda_stage, engine
    from porla_tpu_torch.tools.bench import lane_limbs
    from porla_tpu_torch.tools.kat_onchip import exact_encode

    rows = []
    for nn in sorted({n, big}):
        ctx = engine.NttContext(nn, scheme)
        plan = cuda_stage.pass_plan(nn)
        for lane, mod in (("p", ctx.mod_p), ("q", ctx.mod_q)):
            if lane not in lanes:
                continue
            a = lane_limbs(rng, mod, (nn, chunks), dev)
            for k, v in enumerate((0, mod.n - 1, 1, mod.n - 1)):
                a[k, 0] = L.ints_to_tensor([v], dev)[0]  # edge values
            before = native.launches()["ntt_stage"]
            got = cuda_stage.encode_lane(ctx, a, mod, lane)
            if native.launches()["ntt_stage"] - before != len(plan):
                raise AssertionError(f"K1 at n = {nn}: not {len(plan)} "
                                     f"launches")
            err = limb_err(got, cuda_stage.encode_lane_plain(ctx, a, mod,
                                                             lane))
            if err:
                raise AssertionError(f"K1 lane {lane} at n = {nn}: max abs "
                                     f"err {err} against the stage loop")
            col = np.array(L.tensor_to_ints(a[:, :1]),
                           dtype=object).reshape(nn, 1)
            if nn == n and L.tensor_to_ints(got[:, 0]) != list(
                    exact_encode(mod.n, col).ravel()):
                raise AssertionError(f"K1 lane {lane}: chunk 0 differs from "
                                     f"exact ints")
            tws = [L.to_torch(getattr(ctx.twiddles(1 << (s - 1)),
                                      "mont_" + lane), dev)
                   for s in range(1, ctx.height)]

            def by_stage():
                x = a
                for s, tw in enumerate(tws):
                    x = cuda_stage.ntt_stage(x, tw, 1 << s, mod)
                return x
            err = max(err, limb_err(by_stage(), got))
            if err:
                raise AssertionError(f"K1 lane {lane} at n = {nn}: one-stage "
                                     f"launches differ from the fused pass")
            ms = timed_ms(lambda: cuda_stage.encode_lane(ctx, a, mod, lane),
                          dev, 10)
            stage_ms = timed_ms(by_stage, dev, 5)
            plain_ms = timed_ms(lambda: cuda_stage.encode_lane_plain(
                ctx, a, mod, lane), dev, 1 if nn > n else 3)
            stages = ctx.height - 1
            b_ms, b_by = bound(stages * nn // 2 * chunks * OPS_PER_FE_MUL,
                               2 * nn * chunks * FE_BYTES
                               + (nn - 1) * FE_BYTES)
            rows.append(dict(name="ntt_stage", shape=[nn, chunks, 16],
                             lane=lane, modulus=mod.name, passes=plan, ms=ms,
                             one_stage_launches_ms=stage_ms,
                             plain_ms=plain_ms, max_abs_err=err,
                             bound_ms=b_ms, bound_by=b_by))
            emit({"check": "ntt_stage", **{k: v for k, v in rows[-1].items()
                                           if k != "name"}})
            del a, got
    main = [r for r in rows if r["shape"][0] == n]
    return dict(main[0], lane=" and ".join(lanes) + " (mean)",
                ms=statistics.mean(r["ms"] for r in main),
                one_stage_launches_ms=statistics.mean(
                    r["one_stage_launches_ms"] for r in main),
                plain_ms=statistics.mean(r["plain_ms"] for r in main),
                max_abs_err=max(r["max_abs_err"] for r in rows),
                shapes=[{k: r[k] for k in ("shape", "lane", "passes", "ms",
                                           "one_stage_launches_ms",
                                           "plain_ms", "bound_ms")}
                        for r in rows])


# K2's checked shapes (lanes, nbits): windowed at the server's audit-MSM
# shape, GLV (nbits 256) at the MAC-plane scaling shapes (1024 lanes at
# initialize, 1 lane in every update)
K2_SHAPES = ((2 * N_BLOCKS, 32), (N_BLOCKS, 256), (1, 256))


def check_k2(dev, rng, ops, shapes=K2_SHAPES):
    """K2 at `shapes` (the windowed mode below 256 bits, GLV at 256):
    bit-identical to the plain versions, the edge lanes (infinity, scalars
    0, 1, n - 1 or 2^nbits - 1) equal to the golden model. The timed calls
    are the launches alone: the GLV split is made once. Returns one row a
    shape."""
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    rows = []
    for B, nbits in shapes:
        pts = rand_points(rng, cv, B)
        zs = [1 + v for v in rand_below(rng, cv.p - 1, B)]
        top = (1 << nbits) if nbits < 256 else cv.n
        k = rand_below(rng, top, B)
        if B > 3:
            pts[0] = ecc.INF                           # infinity input
            k[1], k[2], k[3] = 0, 1, top - 1           # 0, 1, n - 1 / 2^nbits - 1
        P = jacobian(ops, pts, zs, dev)
        sc = L.ints_to_tensor(k, dev)
        got = cc.scalar_mul(ops, P, sc, nbits)
        if nbits == 256:
            g = cc.GlvScalars(ops, sc)
            name = "scalar_mul_glv"
            plain_fn = lambda: cc.glv_halves_plain(ops, P, g)
            kern_fn = lambda: cc.launch_scalar_mul_glv(ops, P, g)
            # the function's least work: the interleaved GLV order's shared
            # doublings, whatever order the kernel takes
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
        err = check_points(ops, f"{name} at {B} lanes", got, plain, lanes,
                           [ecc.mul(cv, pts[i], k[i]) for i in lanes])
        ms = timed_ms(kern_fn, dev, 10)
        plain_ms = timed_ms(plain_fn, dev, 3)
        b_ms, b_by = bound(B * muls * OPS_PER_FE_MUL, nbytes)
        rows.append(dict(name=name, shape=[B, 16], nbits=nbits, ms=ms,
                         plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                         bound_by=b_by))
        emit(dict(check=name, **{k: v for k, v in rows[-1].items()
                                 if k != "name"}))
    return rows


def k2_rows(rows) -> list[dict]:
    """The kernels line's two K2 rows (windowed, GLV), each at its first
    checked shape, with the worst error and every shape under `shapes`."""
    out = []
    for name in ("scalar_mul_window", "scalar_mul_glv"):
        mode = [r for r in rows if r["name"] == name]
        out.append(dict(mode[0], max_abs_err=max(r["max_abs_err"]
                                                 for r in mode),
                        shapes=k2_shapes(mode)))
    return out


def k2_shapes(rows) -> dict:
    return {f"{r['shape'][0]} lanes, {r['nbits']} bits":
            {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
            for r in rows}


def k3_inputs(dev, rng, ops, B):
    """K3's operands at B lanes with check_k3's edge lanes (B >= 5): an
    infinity input, a zero scalar, m0 == s*m1 (the hi add doubles, lo is
    infinity), m0 == -s*m1, an infinity m0. Returns (M0, M1, scalars, GLV
    split, golden hi, golden lo) with the golden points of the first 12
    lanes."""
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
    t = [ecc.mul(cv, m1[i], k[i]) for i in range(min(12, B))]
    return (M0, M1, sc, cc.GlvScalars(ops, sc),
            [ecc.add(cv, m0[i], ti) for i, ti in enumerate(t)],
            [ecc.add(cv, m0[i], ecc.neg(cv, ti)) for i, ti in enumerate(t)])


def k3_bound(B):
    """The function's least work: the interleaved GLV order's shared
    doublings (32 windows of 4 doublings and 2 adds, two 16-entry tables),
    whatever order the kernel takes; two points in and two out, two 128-bit
    halves and their sign bits."""
    muls = 1 + 2 * TABLE16 + 32 * (4 * DBL + 2 * ADD) + 2 * ADD
    return bound(B * muls * OPS_PER_FE_MUL,
                 B * (12 * FE_BYTES + 2 * 16) + (2 * B + 7) // 8)


def check_k3(dev, rng, ops, B=N_BLOCKS):
    """K3 at a CRebuild MAC stage's launch (2 planes x n/2 lanes) or at
    another shape of the path: bit-identical to its plain version, the
    edge lanes equal to the golden points; timed."""
    from porla_tpu_torch.curves import cuda_curve as cc

    M0, M1, sc, g, ghi, glo = k3_inputs(dev, rng, ops, B)
    hi, lo = cc.point_butterfly(ops, M0, M1, sc)
    phi, plo = cc.glv_butterfly_plain(ops, M0, M1, g)
    lanes = list(range(min(12, B)))
    err = max(check_points(ops, "K3 hi", hi, phi, lanes, ghi),
              check_points(ops, "K3 lo", lo, plo, lanes, glo))
    ms = timed_ms(lambda: cc.launch_point_butterfly(ops, M0, M1, g), dev, 10)
    plain_ms = timed_ms(lambda: cc.glv_butterfly_plain(ops, M0, M1, g),
                        dev, 3)
    b_ms, b_by = k3_bound(B)
    return dict(name="point_butterfly", shape=[B, 16], ms=ms,
                plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by)


def fb_bound(sc, nout, ng, nbits):
    """K4's least work on this run's scalars `sc`: a mixed add for each
    nonzero digit and a group's g - 1 full adds; the distinct table entries
    (x, y) the digits select, the scalars and the points out."""
    from porla_tpu_torch.curves import cuda_curve as cc
    B = sc.shape[0]
    nwin = nbits // 4
    d = torch.stack([cc._nibble(sc, w) for w in range(nwin)], 1)
    e = (torch.arange(nwin, device=sc.device) * 16 + d) * ng \
        + (torch.arange(B, device=sc.device) % ng)[:, None]
    entries = torch.unique(e[d != 0]).numel()
    madds = int((d != 0).sum().item())
    g = B // nout if nout else 1
    adds = (nout or B) * (g - 1)
    return bound((madds * MADD + adds * ADD) * OPS_PER_FE_MUL,
                 entries * 2 * FE_BYTES + B * nbits // 8
                 + (nout or B) * 3 * FE_BYTES)


def fb_edge_scalars(rng, B, nbits, n):
    """Random scalars below 2^nbits with the edge lanes 0, 1, n - 1, n and
    2^nbits - 1 (n the group order; past the width only what fits) first."""
    top = 1 << nbits
    k = rand_below(rng, top, B)
    edges = [0, 1] + [v for v in (n - 1, n) if v < top] + [top - 1]
    k[:len(edges)] = edges[:B]
    return k


# the main path's shapes of K4: (name, lanes, groups (0: per lane), bases,
# scalar bits); and one group too wide for a block, which no caller on the
# path makes: K4 per lane, then group_sum
FB_SHAPES = (
    ("commit_lanes", N_BLOCKS * 128, 0, 128, 256),        # fb_scalar_mul
    ("commit_blocks", N_BLOCKS * 128, N_BLOCKS, 128, 256),
    ("ipa_round", 256, 2, 256, 256),     # ipa's rounds and final MSM
    ("complements", 2 * N_BLOCKS, 0, 1, 128),
    ("wide_group", 2 * N_BLOCKS, 1, 128, 256),
)


# the KZG path's shapes of K4, on BN254: the server's SRS commitments
# (align_MAC over 1024 blocks' worth of lanes, and commit_msm's C and H),
# and the client's complements on h
KZG_FB_SHAPES = (
    ("commit_blocks", N_BLOCKS * 128, N_BLOCKS, 128, 256),
    ("commit_msm", 128, 1, 128, 256),
    ("complements", 2 * N_BLOCKS, 0, 1, 128),
)


def check_k4(dev, rng, ops, shapes=FB_SHAPES, gens_aff=None):
    """K4 at each of `shapes` over the bases `gens_aff` (the IPA generators
    by default, random points past them; a random point where a shape has
    one base): bit-identical
    to its plain version, the edge lanes (or the first groups) equal to the
    golden model, timed with its plain version and bound. The wide group
    must be one K4 launch and one group_sum, with no plain torch point op.
    Returns one row per shape."""
    from porla_tpu_torch.commit import pedersen
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    if gens_aff is None:
        gens_aff = pedersen.ipa_generators()[0]
    h = rand_points(rng, cv, 1)
    more = max(sh[3] for sh in shapes) - len(gens_aff)
    gens_aff = list(gens_aff) + rand_points(rng, cv, max(more, 0))
    rows = []
    for name, B, nout, ng, nbits in shapes:
        bases = gens_aff[:ng] if ng > 1 else h
        tbl = cc.fixed_base_table(ops, bases, nbits)
        k = fb_edge_scalars(rng, B, nbits, cv.n)
        sc = L.ints_to_tensor(k, dev)
        if nout:
            g = B // nout
            run = lambda: cc.fb_msm_groups(tbl, sc, nout)
            plain = lambda: cc.group_sum_plain(
                ops, cc.fb_lanes_plain(tbl, sc, cc.fb_split(B, g)), nout)
            lanes = sorted({0, min(1, nout - 1), nout - 1})
            want = [ecc.msm(cv, [bases[i % ng] for i in range(o * g,
                                                             (o + 1) * g)],
                            k[o * g:(o + 1) * g]) for o in lanes]
        else:
            run = lambda: cc.fb_scalar_mul(tbl, sc)
            plain = lambda: cc.fb_scalar_mul_plain(tbl, sc)
            lanes = sorted({*range(8), *(B - 1 - i for i in range(4))}
                           & set(range(B)))
            want = [ecc.mul(cv, bases[i % ng], k[i]) for i in lanes]
        split = cc.fb_split(B, B // nout if nout else 1)
        if name == "wide_group":
            if (B // nout) * split <= cc.FB_THREADS:
                raise AssertionError("K4's wide group fits a block")
            got = assert_kernels_only(ops, run, {"fixed_base": 1,
                                                 "group_sum": 1},
                                      "K4 on a group wider than a block")
        else:
            got = run()
        err = check_points(ops, f"K4 {name}", got, plain(), lanes, want)
        big = B > 4096
        ms = timed_ms(run, dev, 10)
        plain_ms = timed_ms(plain, dev, 1 if big else 3, 0 if big else 1)
        b_ms, b_by = fb_bound(sc, nout, ng, nbits)
        rows.append(dict(name="fixed_base", shape=[B, 16], case=name,
                         nout=nout, nbits=nbits, ms=ms, plain_ms=plain_ms,
                         max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                         split=split))
    return rows


# group_sum's checked shapes (points, groups): one and two dependent adds
# (their difference is one cooperative add's latency, the depth floor's
# unit), widths whose first level alone splits (300 on 16 blocks; 4095,
# odd, its carry in the first block, on 32), an odd width of 1025 whose
# levels split down to 33 on 32 blocks, the audit's `msm_parts` (the kernels
# line's row) and one group of 2^14 on 128 blocks
GS_SHAPES = ((2, 1), (4, 1), (300, 1), (4095, 1), (1025, 1),
             (2 * N_BLOCKS, 2), (1 << 14, 1))


def check_group_sum(dev, rng, ops, shapes=GS_SHAPES, add_ms=None,
                    row_at=(2 * N_BLOCKS, 2)):
    """group_sum at `shapes` (some lanes at infinity, P + P and P + (-P)
    in the first level where a group has room): limb for limb `ops.tree_sum`
    of each group, equal to the golden sums, one launch a call; timed, with
    the plan it ran and the depth floor (levels x one add's latency
    `add_ms`, by default the difference of the (4, 1) and (2, 1) shapes).
    Returns the row at `row_at` with every shape in `shapes`."""
    from porla_tpu_torch import native
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.curves.weierstrass import index
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    rows = {}
    for B, nout in shapes:
        g = B // nout
        pts = rand_points(rng, cv, B)
        for i in (0, 7, B - 1):
            if B > 8:
                pts[i] = ecc.INF
        half = g // 2                                   # first level pairs
        if half > 10:
            pts[half + 8] = pts[8]                      # P + P
            pts[half + 10] = ecc.neg(cv, pts[10])       # P + (-P)
        P = jacobian(ops, pts, [1 + v for v in rand_below(rng, cv.p - 1, B)],
                     dev)
        before = native.launches()["group_sum"]
        got = cc.group_sum(ops, P, nout)
        if native.launches()["group_sum"] - before != 1:
            raise AssertionError(f"group_sum at ({B}, {nout}): not one "
                                 f"launch")
        trees = [ops.tree_sum(index(P, slice(o * g, (o + 1) * g)))
                 for o in range(nout)]
        err = max(limb_err(index(got, slice(o, o + 1)), trees[o])
                  for o in range(nout))
        if err:
            raise AssertionError(f"group_sum at ({B}, {nout}): max abs err "
                                 f"{err} against tree_sum")
        err = max(err, limb_err(got, cc.group_sum_plain(ops, P, nout)))
        want = [ecc.msm(cv, pts[o * g:(o + 1) * g], [1] * g)
                for o in range(nout)]
        if ops.to_affine(got) != want:
            raise AssertionError(f"group_sum at ({B}, {nout}) differs from "
                                 f"the golden sums")
        ms = timed_ms(lambda: cc.group_sum(ops, P, nout), dev, 10)
        plain_ms = timed_ms(lambda: cc.group_sum_plain(ops, P, nout), dev, 3)
        b_ms, b_by = bound(nout * (g - 1) * ADD * OPS_PER_FE_MUL,
                           (B + nout) * 3 * FE_BYTES)
        plan = cc.group_sum_plan(g)
        rows[(B, nout)] = dict(
            name="group_sum", shape=[B, 16], nout=nout, ms=ms,
            plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            nb=plan.nb, levels=len(plan.apart) + len(plan.last))
    if add_ms is None:
        add_ms = rows[(4, 1)]["ms"] - rows[(2, 1)]["ms"]
    for row in rows.values():
        row["depth_ms"] = row["levels"] * add_ms
        emit({"check": "group_sum", **{k: v for k, v in row.items()
                                       if k != "name"}})
    return dict(rows[row_at], add_ms=add_ms, shapes={
        f"{B}x{nout}": {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "depth_ms", "nb")}
        for (B, nout), r in rows.items()})


# point_add's checked lane counts: an update's MAC add (1), its deltas and
# absorbs (2 to 2048 lanes at fold levels 0 to 10; 1024 is the kernels
# line's row), one block of 16 lanes and a ragged block at 17
PA_SHAPES = (1, 2, 16, 17, 512, 1024, 2048)


def point_add_inputs(dev, rng, ops, B, negate):
    """point_add's operands at B lanes and the golden sums of every lane.
    Lanes by their index mod 8 (from B = 3): a at infinity, the added point
    at infinity, the doubling (the same point in another Jacobian form), the
    inverse pair, then four generic lanes; so warp 0 (lanes 0-3) needs the
    doubling in one lane and warp 1 in none. B = 2: the doubling, then a
    generic lane; B = 1: a generic lane. With `negate` the added point is
    passed negated."""
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    a = rand_points(rng, cv, B)
    c = rand_points(rng, cv, B)
    for i in range(B):
        case = (i % 8 if B > 2 else 2 if B == 2 and i == 0 else 7)
        if case == 0:
            a[i] = ecc.INF
        elif case == 1:
            c[i] = ecc.INF
        elif case == 2:
            c[i] = a[i]
        elif case == 3:
            c[i] = ecc.neg(cv, a[i])
    b = [ecc.neg(cv, q) for q in c] if negate else c
    zs = lambda: [1 + v for v in rand_below(rng, cv.p - 1, B)]
    return (jacobian(ops, a, zs(), dev), jacobian(ops, b, zs(), dev),
            [ecc.add(cv, p, q) for p, q in zip(a, c)])


def check_point_add(dev, rng, ops, shapes=PA_SHAPES, add_ms=None,
                    row_at=N_BLOCKS):
    """point_add at `shapes`, negate off and on: limb for limb
    `point_add_plain`, every lane equal to the golden sum, one launch a
    call; timed on the card's timeline (`ms`, `plain_ms`) and as the host
    waits for a call, launch to synchronise (`call_ms`, `plain_call_ms`),
    beside the bound and the latency of one cooperative add (`add_ms`,
    group_sum's). Returns the row at `row_at`, negate off, with every
    shape under `shapes`."""
    from porla_tpu_torch import native
    from porla_tpu_torch.curves import cuda_curve as cc

    def call_ms(fn, reps):
        fn()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    rows = {}
    for B in shapes:
        for negate in (False, True):
            A, Bp, want = point_add_inputs(dev, rng, ops, B, negate)
            before = native.launches()["point_add"]
            got = cc.point_add(ops, A, Bp, negate)
            if native.launches()["point_add"] - before != 1:
                raise AssertionError(f"point_add at {B} lanes: not one "
                                     f"launch")
            plain = cc.point_add_plain(ops, A, Bp, negate)
            err = check_points(ops, f"point_add at {B} lanes, negate "
                               f"{negate}", got, plain, list(range(B)), want)
            kern = lambda: cc.point_add(ops, A, Bp, negate)
            plain_fn = lambda: cc.point_add_plain(ops, A, Bp, negate)
            b_ms, b_by = bound(B * ADD * OPS_PER_FE_MUL, B * 9 * FE_BYTES)
            row = dict(name="point_add", shape=[B, 16], negate=negate,
                       ms=timed_ms(kern, dev, 10),
                       plain_ms=timed_ms(plain_fn, dev, 3),
                       call_ms=call_ms(kern, 20),
                       plain_call_ms=call_ms(plain_fn, 5), max_abs_err=err,
                       bound_ms=b_ms, bound_by=b_by, add_ms=add_ms)
            rows[(B, negate)] = row
            emit({"check": "point_add", **{k: v for k, v in row.items()
                                           if k != "name"}})
    return dict(rows[(row_at, False)],
                max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                shapes={f"{B}{' neg' if neg else ''}": {
                    k: r[k] for k in ("ms", "plain_ms", "call_ms",
                                      "plain_call_ms", "bound_ms")}
                    for (B, neg), r in rows.items()})


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


# run_msm's K7 lanes (the libsecp256k1 vector's n): 18 blocks of 16 lanes
# and a ragged block of 12
K7_RAGGED = 300


def check_k7(dev, rng, ops, B=N_BLOCKS, nbits=64, ragged=K7_RAGGED):
    """K7 at K3's shape (1024 lanes, 2 planes of 512) and at `ragged` lanes
    with 64-bit scalars against its plain version and the golden model on
    K3's edge lanes; and at nbits = 256 through its launch function: the
    same affine points as K3. Timed at K3's shape."""
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.curves.weierstrass import index
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    err = 0
    for n in (ragged, B):
        m1 = rand_points(rng, cv, n)
        m0 = rand_points(rng, cv, n)
        k = rand_below(rng, 1 << nbits, n)
        m1[0] = ecc.INF
        k[1] = 0
        m0[2] = ecc.mul(cv, m1[2], k[2])               # hi doubles, lo = inf
        m0[3] = ecc.neg(cv, ecc.mul(cv, m1[3], k[3]))
        m0[4] = ecc.INF
        k[5] = (1 << nbits) - 1
        M0 = jacobian(ops, m0, [1 + v for v in rand_below(rng, cv.p - 1, n)],
                      dev)
        M1 = jacobian(ops, m1, [1 + v for v in rand_below(rng, cv.p - 1, n)],
                      dev)
        sc = L.ints_to_tensor(k, dev)
        hi, lo = cc.point_butterfly(ops, M0, M1, sc, nbits)
        phi, plo = cc.window_butterfly_plain(ops, M0, M1, sc, nbits)
        lanes = list(range(12)) + [n - 1]
        t = [ecc.mul(cv, m1[i], k[i]) for i in lanes]
        err = max(
            err,
            check_points(ops, f"K7 hi at {n}", hi, phi, lanes,
                         [ecc.add(cv, m0[i], ti) for i, ti in zip(lanes, t)]),
            check_points(ops, f"K7 lo at {n}", lo, plo, lanes,
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


MSM_LAUNCHES = {"pip_bucket": 1, "bucket_fold": 2}


def assert_kernels_only(ops, fn, expect=MSM_LAUNCHES, what="one MSM",
                        field_ops=False):
    """Run fn() on operands on the card and require that it took exactly
    the launches `expect` and no plain torch point arithmetic (no CurveOps
    point op at all); with `field_ops`, no plain torch field arithmetic
    either (`fields/mont.py`'s products, sums and differences). By default
    fn is one MSM: one K5 launch and one K6 call (two launches: the fold and
    the lane sum)."""
    from porla_tpu_torch import native
    from porla_tpu_torch.curves.weierstrass import CurveOps
    from porla_tpu_torch.fields import mont
    names = ("add", "madd", "add_raw", "madd_raw", "double", "tree_sum",
             "scalar_mul", "table16")
    targets = [(CurveOps, n) for n in names]
    if field_ops:
        targets += [(mont, n) for n in ("mont_mul", "add_mod", "sub_mod",
                                        "neg_mod")]
    real = {(o, n): getattr(o, n) for o, n in targets}
    calls = []

    def counted(key):
        def f(*a, **k):
            calls.append(key[1])
            return real[key](*a, **k)
        return f

    before = native.launches()
    for key in targets:
        setattr(*key, counted(key))
    try:
        out = fn()
    finally:
        for key in targets:
            setattr(*key, real[key])
    took = {k: v - before[k] for k, v in native.launches().items()
            if v - before[k]}
    if calls or took != expect:
        raise AssertionError(f"{what} took launches {took} and plain torch "
                             f"ops {calls}; expected {expect} and none")
    return out


def check_kernels_only(dev, rng, ops):
    """One `fb_msm_groups` call (an IPA round's shape), one
    `commit_blocks` call (an update's, and 1024 blocks at initialize) and one
    `msm_parts` call (the audit's MAC and alignment MSMs) run on the card as
    their kernels alone, and give the golden points."""
    from porla_tpu_torch.commit import pedersen
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.curves import kernels
    from porla_tpu_torch.curves.weierstrass import index
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc

    cv = ops.curve
    gens_aff, _ = pedersen.ipa_generators()
    tbl = cc.fixed_base_table(ops, gens_aff)
    k = rand_below(rng, cv.n, 256)
    got = assert_kernels_only(
        ops, lambda: cc.fb_msm_groups(tbl, L.ints_to_tensor(k, dev), 2),
        {"fixed_base": 1}, "one fb_msm_groups call")
    if ops.to_affine(got) != [ecc.msm(cv, gens_aff, k[:128]),
                              ecc.msm(cv, gens_aff, k[128:])]:
        raise AssertionError("fb_msm_groups differs from the golden sums")
    for nb in (1, N_BLOCKS):
        kb = rand_below(rng, cv.n, nb * 128)
        sc = L.ints_to_tensor(kb, dev).reshape(nb, 128, 16)
        got = assert_kernels_only(
            ops, lambda: pedersen.commit_blocks(tbl, sc),
            {"fixed_base": 1},
            f"one commit_blocks call of {nb} blocks")
        want = [ecc.msm(cv, gens_aff, kb[b * 128:(b + 1) * 128])
                for b in (0, nb - 1)]
        if ops.to_affine(index(got, [0, nb - 1])) != want:
            raise AssertionError("commit_blocks differs from the golden "
                                 "commitments")
    n = 2 * N_BLOCKS
    pts = rand_points(rng, cv, 8)
    P = ops.from_affine([pts[i % 8] for i in range(n)], dev)
    kc = [int(v) for v in rng.integers(0, 1 << 32, n)]
    parts = assert_kernels_only(
        ops, lambda: kernels.msm_parts(ops, P, L.ints_to_tensor(kc, dev), 2,
                                       nbits=32),
        {"scalar_mul_window": 1, "group_sum": 1}, "one msm_parts call")
    for h, part in enumerate(parts):
        lanes = range(h * n // 2, (h + 1) * n // 2)
        want = ecc.msm(cv, [pts[i % 8] for i in lanes], [kc[i] for i in lanes])
        if ops.to_affine(part)[0] != want:
            raise AssertionError(f"msm_parts: part {h} differs from the "
                                 f"golden sum")
    return {"check": "kernels_only",
            "calls": ["fb_msm_groups", "commit_blocks x1",
                      "commit_blocks x1024", "msm_parts"]}


def check_compute_kernels_only(dev, rng, ops, n=N_BLOCKS):
    """One `point_scale` call (an update's, 1 lane) and one `encode_crt`
    call (a CRebuild's data plane at n) run on the card as their kernels
    alone, with no plain torch point or field arithmetic, and give the
    golden point and the plain stage loop's limbs."""
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc
    from porla_tpu_torch.ntt import cuda_stage, engine
    from porla_tpu_torch.protocol import compute
    from porla_tpu_torch.tools.bench import lane_limbs

    cv = ops.curve
    q = rand_points(rng, cv, 1)
    M = jacobian(ops, q, [1 + rand_below(rng, cv.p - 1, 1)[0]], dev)
    v = rand_below(rng, cv.n, 1)[0]
    got = assert_kernels_only(
        ops, lambda: compute.point_scale(M, L.ints_to_limbs([v]), ops=ops),
        {"scalar_mul_glv": 1}, "one point_scale call", field_ops=True)
    if ops.to_affine(got) != [ecc.mul(cv, q[0], v)]:
        raise AssertionError("point_scale differs from the golden point")
    ctx = engine.NttContext(n, "ipa")
    arr = engine.CrtArray(*(lane_limbs(rng, m, (n, 128), dev)
                            for m in (ctx.mod_p, ctx.mod_q)))
    got = assert_kernels_only(
        ops, lambda: compute.encode_crt(ctx.mod_q, ctx, arr),
        {"ntt_stage": 2 * len(cuda_stage.pass_plan(n))},
        "one encode_crt call", field_ops=True)
    want = engine.encode_stages(ctx, arr)
    if limb_err(got.p, want.p) or limb_err(got.q, want.q):
        raise AssertionError("encode_crt differs from the plain stage loop")
    return {"check": "kernels_only",
            "calls": ["point_scale x1", f"encode_crt n={n}"]}


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
    from porla_tpu_torch.tools.bench import msm_inputs

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

    # K7 through the public butterfly (64-bit scalars), held limb for limb
    # against its plain version after the count is read
    kb = L.ints_to_tensor([rng.getrandbits(64) for _ in range(nk)], dev)
    k7 = cc.point_butterfly(secp, pk, pk, kb, nbits=64)
    torch.cuda.synchronize(dev)
    total = native.launches()
    if limb_err(k7, cc.window_butterfly_plain(secp, pk, pk, kb, 64)):
        raise AssertionError(f"K7 at {nk} lanes differs from its plain "
                             f"version")

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


# byte offsets of tests/test_torch_ipa.py's tampered proofs: the inner
# product, L of rounds 1, 3 and 6 (the sign byte, or a bit of x), R of
# round 6, b1 (its lowest and highest byte)
IPA_TAMPERED = (3, 40, 555, 32, 164, 362, 370, 395, 524)
# an IPA audit's launches of K2, group_sum and point_add: the audit MSMs'
# (K2 windowed and group_sum, each side) and the align's point_add, then
# the verifier's L and R terms (K2 GLV and group_sum) and the MAC check's
# alpha products and adds (K2 windowed and point_add); K4 besides (the
# prover's 6 rounds, the verifier's final MSM, the complements, the align)
IPA_AUDIT_LAUNCHES = {"scalar_mul_window": 3, "scalar_mul_glv": 1,
                      "group_sum": 3, "point_add": 2}


def check_ipa(dev, n=16) -> dict:
    """The IPA prover and verifier on the card, every curve operation on
    the kernels: the proof byte for byte the golden prover's (host
    integers, `golden/ipa.py`), on random vectors and on vectors whose
    first round has cL = 0 (u's lane at infinity); the verifier accepts
    both and refuses a wrong commitment and every `IPA_TAMPERED` proof;
    one prove is 6 K4 launches, one verify a K4, a K2 GLV and a group_sum
    launch. The MAC check's alpha products (K2 windowed at 128 bits for
    IPA's alpha, GLV for a 254-bit BN254 alpha) equal the golden model's
    lane by lane. Then an n-block IPA pair on the card: two audits, each
    launching `IPA_AUDIT_LAUNCHES` and the same K4 launches."""
    import tempfile

    import numpy as np
    from porla_tpu_torch import native
    from porla_tpu_torch.commit import ipa, pedersen
    from porla_tpu_torch.config import NUM_CHUNKS, SECRET_KEY, PorlaConfig
    from porla_tpu_torch.curves.instances import bn254, secp256k1
    from porla_tpu_torch.golden import ecc
    from porla_tpu_torch.golden import ipa as golden_ipa
    from porla_tpu_torch.protocol.client import PorlaClient, alpha_products
    from porla_tpu_torch.protocol.server import PorlaServer

    rng = np.random.default_rng(SEED + 7)
    Q = ipa.Q
    cv = ecc.SECP256K1
    a = [int.from_bytes(rng.bytes(31), "little") for _ in range(NUM_CHUNKS)]
    b = [pow(int(rng.integers(1, 1 << 31)), 1 << i, Q)
         for i in range(NUM_CHUNKS)]
    half = NUM_CHUNKS // 2
    zero = list(a)
    zero[0] = -sum(a[i] * b[half + i] for i in range(1, half)) \
        * pow(b[half], -1, Q) % Q
    affine, u = pedersen.ipa_generators()
    key = ipa.IpaKey(affine, u, dev)

    def launched(fn):
        native.reset_launches()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        return ms, {k: v for k, v in native.launches().items() if v}

    out = {"check": "ipa", "prove_ms": [], "verify_ms": []}
    for name, vec in (("random", a), ("u_lane_zero", zero)):
        ipa.prove(vec, b, key)                    # the tables, once
        proof = []
        ms, got = launched(lambda: proof.append(ipa.prove(vec, b, key)))
        if got != {"fixed_base": 6}:
            raise AssertionError(f"ipa.prove launched {got}")
        out["prove_ms"].append(ms)
        proof = proof[0]
        if proof != golden_ipa.prove(vec, b, affine, u):
            raise AssertionError(f"ipa.prove ({name}) differs from the "
                                 f"golden prover")
        commitment = ecc.msm(cv, affine, [x % Q for x in vec])
        ms, got = launched(lambda: ipa.verify(commitment, proof, key))
        if got != {"fixed_base": 1, "scalar_mul_glv": 1, "group_sum": 1}:
            raise AssertionError(f"ipa.verify launched {got}")
        out["verify_ms"].append(ms)
    refused = 0
    bad = [(ecc.add(cv, commitment, affine[17]), proof)]
    for byte in IPA_TAMPERED:
        t = bytearray(proof)
        t[byte] ^= 1
        bad.append((commitment, bytes(t)))
    for c, p in bad:
        try:
            ipa.verify(c, p, key)
        except (ipa.IpaVerificationError, ValueError):
            refused += 1
            continue
        raise AssertionError("ipa.verify accepted a tampered proof or a "
                             "wrong commitment")
    out["refused"] = refused

    alphas = ((secp256k1(), int.from_bytes(SECRET_KEY, "little")),
              (bn254(), bn254().curve.n - 0x1234567))
    for ops, alpha in alphas:
        c = ops.curve
        pts = [ecc.mul(c, c.g, 3), ecc.mul(c, c.g, 1 << 200), ecc.INF]
        got = ops.to_affine(alpha_products(ops, alpha,
                                           ops.from_affine(pts, dev)))
        if got != [ecc.mul(c, q, alpha) for q in pts]:
            raise AssertionError(f"alpha products at {alpha.bit_length()} "
                                 f"bits differ from the golden model")

    with tempfile.TemporaryDirectory(dir=HERE) as store:
        cfg = PorlaConfig(scheme="ipa", storage_dir=store)
        server = PorlaServer(cfg, device=dev)
        client = PorlaClient(cfg, Recording(server, []),
                             data_seed=bytes(range(16)), device=dev)
        client.initialize(n)
        out["audit_launches"] = []
        for i in range(2):
            ms, got = launched(lambda: client.audit(seed=bytes([i] * 16)))
            k4 = got.pop("fixed_base", 0)
            if got != IPA_AUDIT_LAUNCHES or i and k4 != out["audit_k4"]:
                raise AssertionError(f"an IPA audit launched {got} and K4 "
                                     f"{k4} times")
            out["audit_k4"] = k4
            out["audit_launches"].append(k4 + sum(got.values()))
    return out


# --- phase 3: the protocol --------------------------------------------------

class Recording:
    """The in-process transport, keeping every (request opcode, reply)."""

    def __init__(self, server, replies):
        self.server, self.replies = server, replies

    def __call__(self, msg: bytes) -> bytes:
        reply = self.server.handle(bytes(msg))
        self.replies.append((bytes(msg[:1]), reply))
        return reply


def refuse(client, seed: bytes, what: str):
    """A function that runs the audit of `seed` and raises unless the
    client refuses it."""
    from porla_tpu_torch.protocol.client import AuditError

    def audit():
        try:
            client.audit(seed=seed)
        except AuditError:
            return
        raise AssertionError(f"the audit accepted {what}")
    return audit


def corrupt_sampled_codeword(server, seed: bytes):
    """Flip one bit in the q residue of a top-level codeword (as
    tests/test_protocol_e2e.py::test_corruption_is_detected does) that the
    audit of `seed` samples with a nonzero coefficient: an audit samples
    128 of the top level's 2n codewords. Returns a function that restores
    the codeword."""
    from porla_tpu_torch.protocol import auditing
    top = server.height - 1
    plan = auditing.build_audit_plan(seed, server.write_step,
                                     server.num_blocks, server.height)
    hit = next(s for s in plan.samples
               if s.level == top and s.coeff % server.mod_q.n)
    side = server.levels[top].x if hit.is_x else server.levels[top].y
    orig = side.data
    bad = orig.q.clone()
    bad[hit.index, 0, 0] ^= 1
    side.data = type(orig)(orig.p, bad)

    def restore():
        side.data = orig
    return restore


class PhaseLog:
    """Runs a path's phases, each with its host seconds (the card
    synchronised at its end) and its kernels' launches; emits a line each,
    except for the phases named in `quiet` (see `merged`)."""

    def __init__(self, path: str, scheme: str, dev, quiet=()):
        self.path, self.scheme, self.dev = path, scheme, dev
        self.quiet = quiet
        self.records = []

    def __call__(self, name, fn, **attrs):
        from porla_tpu_torch import native
        before = native.launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(self.dev)
        rec = {"path": self.path, "phase": name, "scheme": self.scheme,
               **attrs, "s": time.perf_counter() - t0,
               "launches": {k: v - before[k]
                            for k, v in native.launches().items()}}
        self.records.append(rec)
        if name not in self.quiet:
            emit(rec)
        return out


def merged(records, name) -> dict:
    """The records of the phase `name` as one: its calls, and their
    seconds and launches summed."""
    recs = [r for r in records if r["phase"] == name]
    return {"path": recs[0]["path"], "phase": name,
            "scheme": recs[0]["scheme"], "calls": len(recs),
            "s": sum(r["s"] for r in recs),
            "launches": {k: sum(r["launches"][k] for r in recs)
                         for k in recs[0]["launches"]}}


class LaunchShapes:
    """While active, records the shape of every K2, K3, K4 and group_sum
    launch by wrapping `cuda_curve`'s launch functions: "k3" the (phase,
    lanes) of every 256-bit K3 launch (`phase` is what the caller last set),
    "k4" the (lanes, groups, bases, nbits) of every K4 launch, "k2" the
    (lanes, nbits) of every K2 launch, "group_sum" the (points, groups) of
    every group_sum call on points."""

    WRAPPED = ("point_butterfly", "launch_fixed_base",
               "launch_scalar_mul_window", "launch_scalar_mul_glv",
               "group_sum")

    def __init__(self):
        self.shapes = {"k3": [], "k4": [], "k2": [], "group_sum": []}
        self.phase = None

    def __enter__(self):
        from porla_tpu_torch.curves import cuda_curve as cc
        self.cc = cc
        fns = self.saved = {name: getattr(cc, name) for name in self.WRAPPED}
        sh = self.shapes

        def k3(ops, m0, m1, scalars, nbits=256):
            if nbits == 256:
                sh["k3"].append((self.phase, m0.x.shape[0]))
            return fns["point_butterfly"](ops, m0, m1, scalars, nbits)

        def k4(table, scalars, nout):
            sh["k4"].append((scalars.shape[0], nout, table.ng, table.nbits))
            return fns["launch_fixed_base"](table, scalars, nout)

        def k2_window(ops, p, scalars, nbits):
            sh["k2"].append((p.x.shape[0], nbits))
            return fns["launch_scalar_mul_window"](ops, p, scalars, nbits)

        def k2_glv(ops, p, g):
            sh["k2"].append((p.x.shape[0], 256))
            return fns["launch_scalar_mul_glv"](ops, p, g)

        def group_sum(ops, points, nout):
            sh["group_sum"].append((points.x.shape[0], nout))
            return fns["group_sum"](ops, points, nout)

        for name, fn in zip(self.WRAPPED,
                            (k3, k4, k2_window, k2_glv, group_sum)):
            setattr(cc, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cc, name, fn)


def run_protocol(dev, store_dir, scheme="ipa", n=N_BLOCKS,
                 n_updates=N_UPDATES, audit_after=(), mesh=None,
                 path="protocol", quiet=()):
    """initialize -> audit -> `n_updates` round-robin updates (an audit
    after each count in `audit_after`) -> audit -> corrupted audit, then
    checkpoint -> restore into a new server -> audit -> update -> audit, on
    `dev`, in `scheme`; with a `mesh`, the server sharded over it (the
    restored one too), and last an audit with force_sharded_pippenger. An
    update that closes an epoch (write step a multiple of n) is the phase
    "epoch_close"; every update's record holds its write step. Returns
    (per-phase records, launches over the cycle up to the audit after the
    updates, the shapes of its K2, K3, K4 and group_sum launches (K3 by
    phase; `LaunchShapes`), every (opcode, reply) in order)."""
    import dataclasses

    import numpy as np
    from porla_tpu_torch import native
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.protocol.client import PorlaClient
    from porla_tpu_torch.protocol.server import PorlaServer
    rng = np.random.default_rng(SEED + 1)
    seed = lambda: rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    cfg = PorlaConfig(scheme=scheme, storage_dir=store_dir, mesh=mesh)
    server = PorlaServer(cfg, device=dev)
    replies = []
    client = PorlaClient(cfg, Recording(server, replies), data_seed=seed(),
                         device=dev)
    log = PhaseLog(path, scheme if mesh is None else f"mesh {scheme}", dev,
                   quiet)
    recorder = LaunchShapes()

    def phase(name, fn, **attrs):
        recorder.phase = name
        log(name, fn, **attrs)

    def update(name="update"):
        ws = client.write_step + 1
        if name == "update" and ws % n == 0:
            name = "epoch_close"
        phase(name, lambda: client.update(client.write_step % n + 1),
              write_step=ws)
        top = server.height - 1
        if name == "epoch_close" and (server.levels[top].empty or any(
                not lv.empty for lv in server.levels[:top])):
            raise AssertionError(f"{scheme}: the update at write step {ws} "
                                 f"did not close the epoch into level {top}")

    with recorder:
        native.reset_launches()
        phase("initialize", lambda: client.initialize(n))
        phase("audit", lambda: client.audit(seed=seed()))
        for step in range(1, n_updates + 1):
            update()
            if step in audit_after:
                phase("audit", lambda: client.audit(seed=seed()))
        phase("audit", lambda: client.audit(seed=seed()))
        total = native.launches()

        # one flipped bit in a stored codeword of the top level that the
        # next audit samples must fail it
        audit_seed = seed()
        restore_codeword = corrupt_sampled_codeword(server, audit_seed)
        phase("audit_corrupted", refuse(client, audit_seed,
                                        "a corrupted codeword"))
        restore_codeword()

        # checkpoint and resume: a new server restored on the card from the
        # files takes over, and the client goes on with it
        def restore():
            client.transport = Recording(PorlaServer.restore(cfg, device=dev),
                                         replies)
        phase("checkpoint", server.save_checkpoint)
        phase("restore", restore)
        phase("resume_audit", lambda: client.audit(seed=seed()))
        update("resume_update")
        phase("resume_audit", lambda: client.audit(seed=seed()))
        if mesh is not None:
            resumed = client.transport.server
            resumed.config = dataclasses.replace(cfg,
                                                 force_sharded_pippenger=True)
            phase("audit_forced_pippenger",
                  lambda: client.audit(seed=seed()))
    return log.records, total, recorder.shapes, replies


def check_protocol_launches(scheme, phases, total, init_k1=4) -> None:
    """K1-K4, group_sum and point_add were launched by the cycle,
    initialize and every update that closed an epoch (the server's CRebuild
    from the update path) launched K1 exactly `init_k1` times (two CRT
    arrays of two lanes, one K1 pass a lane on one device), and every other
    update none; point_add as `POINT_ADDS` counts, at every fold level."""
    missing = [k for k in PROTOCOL_KERNELS if total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the {scheme} protocol "
                             f"run: {missing}")
    for rec in phases:
        want = {"initialize": init_k1, "epoch_close": init_k1, "update": 0,
                "resume_update": 0}.get(rec["phase"])
        if want is not None and rec["launches"]["ntt_stage"] != want:
            raise AssertionError(
                f"{scheme} {rec['phase']} (write step "
                f"{rec.get('write_step', 0)}) launched K1 "
                f"{rec['launches']['ntt_stage']} times, not {want}")
        want = POINT_ADDS.get(rec["phase"])
        if want is not None and rec["launches"]["point_add"] != want:
            raise AssertionError(
                f"{scheme} {rec['phase']} (write step "
                f"{rec.get('write_step', 0)}) launched point_add "
                f"{rec['launches']['point_add']} times, not {want}")


PROTOCOL_KERNELS = ("ntt_stage", "scalar_mul_window", "scalar_mul_glv",
                    "point_butterfly", "fixed_base", "group_sum", "point_add")

# point_add's launches a phase of the cycle: an update's client MAC and
# deltas, the server's two absorbs and its align; an audit's align and the
# client's MAC check; the update that closes an epoch has no align (the
# CRebuild in place of HAdd)
POINT_ADDS = {"update": 5, "resume_update": 5, "epoch_close": 4, "audit": 2,
              "resume_audit": 2}


def check_bn254(dev, rng) -> dict:
    """Every curve kernel held on BN254 G1 operands, as the secp256k1
    checks hold them: K1's q lane mod r at (1024, 128, 16), K2 in both
    modes, K3 at 1024 lanes, K4 at KZG_FB_SHAPES over the SRS of a random
    tau (not the protocol's, so the KZG cycle builds its own table),
    group_sum at GS_SHAPES, point_add at PA_SHAPES, K7 at 1024 lanes and
    64 bits (no path of the KZG scheme runs it). Returns kernel name -> its
    BN254 row."""
    from porla_tpu_torch.commit import kzg
    from porla_tpu_torch.config import NUM_CHUNKS
    from porla_tpu_torch.curves.instances import bn254
    from porla_tpu_torch.fields.constants import BN254_R

    ops = bn254()
    rows = {"ntt_stage": check_k1(dev, rng, big=N_BLOCKS, scheme="kzg",
                                  lanes=("q",))}
    window, glv = k2_rows(check_k2(dev, rng, ops))
    rows[window["name"]], rows[glv["name"]] = window, glv
    rows["point_butterfly"] = check_k3(dev, rng, ops)
    srs = kzg.KzgSrs.from_tau(rand_below(rng, BN254_R, 1)[0], NUM_CHUNKS)
    k4_rows = check_k4(dev, rng, ops, KZG_FB_SHAPES, srs.g1_powers)
    rows["fixed_base"] = k4_row(k4_rows)
    rows["group_sum"] = check_group_sum(dev, rng, ops)
    rows["point_add"] = check_point_add(dev, rng, ops,
                                        add_ms=rows["group_sum"]["add_ms"])
    rows["point_butterfly_window"] = check_k7(dev, rng, ops)
    for name, row in rows.items():
        emit(dict(check=f"{name} bn254", **{k: v for k, v in row.items()
                                            if k != "name"}))
    return rows


def k4_row(k4_rows) -> dict:
    """The kernels line's K4 row: the commit_blocks shape (initialize's,
    or the KZG server's), with every shape beside it."""
    return dict(next(r for r in k4_rows if r["case"] == "commit_blocks"),
                shapes=k4_shapes(k4_rows))


def k4_shapes(k4_rows) -> dict:
    return {r["case"]: {k: r[k] for k in ("shape", "nout", "nbits", "ms",
                                          "plain_ms", "bound_ms", "split")}
            for r in k4_rows}


# --- phase 5: the out-of-core tier ---------------------------------------------

OOC_N = 1 << 14      # path (d): 64 MiB of data, 16x the cached path's n
OOC_UPDATES = 4
# path (e): the streamed fold at the cached path's n, levels above 4 in
# files, stripes of 8 blocks; audits after updates 32 and 64
OOC_E = dict(top_caching_level=4, stream_stripe_blocks=8)
OOC_E_UPDATES = 64
OOC_KERNELS = ("scalar_mul_window", "scalar_mul_glv", "point_butterfly",
               "fixed_base", "group_sum")


def store_io(store_dir, n=OOC_N, record=8192):
    """The native runtime's batched file IO on this host's disk at (d)'s
    staging shape (n files of one 8 KiB staging record), on 8 and 32
    threads: seconds to write and read them, then to delete them (32
    threads)."""
    import numpy as np
    from porla_tpu_torch.runtime import lib as rt
    os.makedirs(store_dir, exist_ok=True)
    paths = [os.path.join(store_dir, f"io_{i}") for i in range(n)]
    data = np.random.default_rng(SEED).integers(0, 256, n * record,
                                                dtype=np.uint8)
    for threads in (8, 32):
        t0 = time.perf_counter()
        rt.write_files(paths, record, data, threads)
        t1 = time.perf_counter()
        back = rt.read_files(paths, record, threads=threads)
        t2 = time.perf_counter()
        if not np.array_equal(back, data):
            raise AssertionError("store_io: the files read back differ")
        emit({"store_io": {"files": n, "bytes": record, "threads": threads,
                           "write_s": t1 - t0, "read_s": t2 - t1}})
    t0 = time.perf_counter()
    rt.delete_files(paths)
    emit({"store_io": {"files": n, "delete_s": time.perf_counter() - t0}})


def stripe_butterfly(dev, pairs: int) -> None:
    """The card's part of a streamed stage over one stripe: the plain torch
    butterfly (`compute.data_butterfly`) over `pairs` pairs of (128,
    16)-limb CRT lanes, ms on the card's timeline (median of 3)."""
    import numpy as np
    from porla_tpu_torch.ntt.engine import CrtArray, NttContext
    from porla_tpu_torch.protocol import compute
    ctx = NttContext(OOC_N, "ipa")
    rng = np.random.default_rng(SEED + 3)
    a0, a1 = (CrtArray(*(torch.from_numpy(rng.integers(
        0, 1 << 15, (pairs, 128, 16))).to(dev) for _ in range(2)))
        for _ in range(2))
    tw = ctx.twiddles(pairs)
    ms = timed_ms(lambda: compute.data_butterfly(ctx.mod_q, a0, a1, tw),
                  dev, 3)
    emit({"stripe_butterfly": {"pairs": pairs, "ms": ms}})


def corrupt_sampled_file(server, seed: bytes):
    """Flip one bit in a codeword file that the audit of `seed` samples
    with a nonzero coefficient from a file-backed level. Returns (path,
    original bytes) to restore."""
    from porla_tpu_torch.protocol import auditing
    plan = auditing.build_audit_plan(seed, server.write_step,
                                     server.num_blocks, server.height)
    hit = next(s for s in plan.samples
               if server.levels[s.level].file_backed
               and s.coeff % server.mod_q.n)
    path = os.path.join(server.config.storage_dir,
                        "H_X" if hit.is_x else "H_Y",
                        f"{hit.level}_{hit.index}")
    with open(path, "rb") as f:
        orig = f.read()
    bad = bytearray(orig)
    bad[33] ^= 1
    with open(path, "wb") as f:
        f.write(bytes(bad))
    return path, orig


def check_staging_empty(store_dir, where) -> None:
    left = os.listdir(os.path.join(store_dir, "STG"))
    if left:
        raise AssertionError(f"{len(left)} staging files left after {where}")


def run_ooc(dev, store_dir, scheme, n, updates, audit_after, **cfg_kw):
    """An out-of-core cycle on the card through the entry points: initialize
    (the streamed CRebuild of the top level into H_X/H_Y files), an audit,
    `updates` round-robin updates with an audit after each count in
    `audit_after` (and after the last), an audit of a corrupted codeword
    file (refused; the byte is then restored), a checkpoint, a server
    restored from it on the card and an audit. Returns (PhaseLog, launches
    over the path, the shapes its kernels were launched at
    (`LaunchShapes`), the initialize's memory line)."""
    import numpy as np
    from porla_tpu_torch import native
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.protocol.client import PorlaClient
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import InProcTransport
    from porla_tpu_torch.tools.bench_ooc import RssSampler

    rng = np.random.default_rng(SEED + 2)
    seed = lambda: rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    cfg = PorlaConfig(scheme=scheme, storage_dir=store_dir, **cfg_kw)
    server = PorlaServer(cfg, device=dev)
    client = PorlaClient(cfg, InProcTransport(server), data_seed=seed(),
                         device=dev)
    path = "ooc" if n == OOC_N else "ooc_e"
    log = PhaseLog(path, scheme, dev)

    def update():
        client.update(client.write_step % client.num_blocks + 1)

    recorder = LaunchShapes()
    with recorder:
        native.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        with RssSampler() as rss:
            log("initialize", lambda: client.initialize(n))
        memory = {"path": path, "scheme": scheme, "phase": "initialize",
                  "host_rss_peak_mib": rss.peak_mib,
                  "cuda_max_allocated_mib":
                      torch.cuda.max_memory_allocated(dev) / 2 ** 20}
        emit(memory)
        top = server.height - 1
        size = os.path.getsize(os.path.join(store_dir, "H_X", f"{top}_0"))
        if not server.levels[top].file_backed or size != 4096:
            raise AssertionError(f"{path}: level {top} is not in its files")
        if log.records[0]["launches"]["ntt_stage"]:
            raise AssertionError(f"{path}: the streamed CRebuild launched K1")
        check_staging_empty(store_dir, "initialize")
        log("audit", lambda: client.audit(seed=seed()))
        for step in range(1, updates + 1):
            log("update", update, step=step)
            # the level this update folded into: above the caching level
            # it must now live in files, the levels below it emptied
            level = (step & -step).bit_length() - 1
            if cfg.top_caching_level < level < top and (
                    not server.levels[level].file_backed
                    or not all(lv.empty for lv in server.levels[:level])):
                raise AssertionError(f"{path}: update {step} did not fold "
                                     f"into the files of level {level}")
            check_staging_empty(store_dir, f"update {step}")
            if step in audit_after or step == updates:
                log("audit", lambda: client.audit(seed=seed()))

        audit_seed = seed()
        bad_path, orig = corrupt_sampled_file(server, audit_seed)
        try:
            log("audit_corrupted", refuse(client, audit_seed,
                                          f"a corrupted codeword file "
                                          f"({path})"))
        finally:
            with open(bad_path, "wb") as f:
                f.write(orig)

        def restore():
            client.transport = InProcTransport(PorlaServer.restore(
                cfg, device=dev))
        log("checkpoint", server.save_checkpoint)
        log("restore", restore)
        log("resume_audit", lambda: client.audit(seed=seed()))
        total = native.launches()
    missing = [k for k in OOC_KERNELS if total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the {path} {scheme} "
                             f"run: {missing}")
    return log, total, recorder.shapes, memory


# --- phase 6: ICC erasure recovery ------------------------------------------

ICC_N = 1 << 16       # (f1): the reference's record, a level of m = 2^15
ICC_ERASE = 128       # erased codeword columns of the level's 2m
ICC_CHUNKS = 128      # a full block
ICC_SMALL_N = 1 << 11  # (f2), (f3): a level of m = 1024 blocks


def crt_combine(rp, rq, mod_q):
    """(..., 32) limbs of the value below p * q whose residues are rp mod p
    and rq mod q: rp + p * ((rq - rp) * p^-1 mod q), exact, on the card,
    over column chunks."""
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.fields import mont
    from porla_tpu_torch.ntt import engine, icc_device
    P = engine.MOD_P
    pinv = L.ints_to_tensor([mod_q.to_mont_int(pow(P.n, -1, mod_q.n))],
                            rp.device)[0]
    out = torch.empty(rp.shape[:-1] + (2 * L.NLIMBS,), dtype=rp.dtype,
                      device=rp.device)
    step = max(1, icc_device.CHUNK_ELEMS // rp.shape[0])
    for c in range(0, rp.shape[1], step):
        a, b = rp[:, c:c + step], rq[:, c:c + step]
        k = mont.mont_mul(mont.sub_mod(b, engine.q_lane_from_p(a, mod_q),
                                       mod_q), pinv, mod_q)
        cols = torch.nn.functional.pad(
            mont._cols(k, P.const("limbs", k.device).expand_as(k)), (0, 1))
        cols[..., :L.NLIMBS] += a                 # columns < 2^37
        out[:, c:c + step] = mont._normalize(cols, 2 * L.NLIMBS, 2)
    return out


def run_icc(dev):
    """Path (f), ICC erasure recovery (`ntt/icc_device.py`) on the card.
    (f1) The hardened context at n = 2^16: a level of m = 2^15 blocks of
    128 chunks (`tools/icc_recover.py`'s data), encoded on K1 in the p lane
    and in secp256k1's n lane; 128 erased columns in the tool's pattern
    (random over both halves), then 128 all from the X half (e = 128, the
    widest solve); each recovery must equal the blocks, and the two lanes'
    recoveries combined by CRT the original 256-bit chunk values. (f2) The
    reference (non-hardened) mode on an epoch-CRebuild level (every block
    written at one step, so Y = wt * X) at m = 1024, through the dict entry
    point `recover_level_device`: 128 erased X columns whose Y columns
    survive must recover (the first e + slack rows are singular there, so
    this takes the retry on all rows); an erased pair (j, m + j) must raise
    the singular ValueError. (f3) BN254's r lane (the KZG scheme's q lane)
    at m = 1024. Every fold must launch K1 its planned passes, and the path
    K1 at all (f5). Then (f4) K1 against its plain version, limb for limb,
    at the widest fold shape recovery launched, (2^15, e + C, 16), in both
    lanes, and timed. Prints per lane the encode and recover seconds, the
    recovery's spans (`icc.*`, each synchronised at its end), its peak
    device allocation and the card (f6). Returns (launches over the path,
    K1's row at the fold shape)."""
    import random
    import numpy as np
    from porla_tpu_torch import native
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.ntt import cuda_stage, engine, icc_device
    from porla_tpu_torch.tools import icc_recover as tool
    from porla_tpu_torch.tools.bench import lane_limbs
    from porla_tpu_torch.utils import trace

    card = native.card_line()
    folds = []                       # (shape, launches, planned passes)
    fold_lane = cuda_stage.fold_lane

    def counted(ctx, a, mod, lane):
        before = native.KERNELS["ntt_stage"].launches
        out = fold_lane(ctx, a, mod, lane)
        folds.append((list(a.shape),
                      native.KERNELS["ntt_stage"].launches - before,
                      len(cuda_stage.pass_plan(a.shape[0]))))
        return out

    def encode(ctx, B, wts, mod):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        X, Y = tool.encode_level(ctx, B, wts, mod)
        torch.cuda.synchronize(dev)
        return X, Y, time.perf_counter() - t0

    def recover(ctx, wts, X, Y, B, erased, mod):
        Xe, Ye = tool.erase(X, Y, erased)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        trace.reset()
        trace.enable()
        try:
            t0 = time.perf_counter()
            got = icc_device.recover_level_tensors(ctx, wts, Xe, Ye, erased,
                                                   mod)
            torch.cuda.synchronize(dev)
            s = time.perf_counter() - t0
        finally:
            trace.enable(False)
        if not torch.equal(got, B):
            raise AssertionError(f"icc: the level recovered mod {mod} "
                                 f"differs from its blocks")
        m = X.shape[0]
        return got, {
            "m": m, "chunks": X.shape[1], "erased": len(erased),
            "x_erased": sum(j < m for j in erased), "recover_s": s,
            "spans_s": {k: v["total_s"] for k, v in trace.summary().items()
                        if k.startswith("icc.")},
            "cuda_max_allocated_mib":
                torch.cuda.max_memory_allocated(dev) / 2 ** 20,
            "bitexact": True, "card": card}

    cuda_stage.fold_lane = counted
    try:
        native.reset_launches()
        # (f1)
        ctx = engine.NttContext(ICC_N, "ipa", hardened=True)
        m = ICC_N // 2
        wts = [3 + i for i in range(m)]
        raw = tool.level_data(m, ICC_CHUNKS, dev)
        bench_rng = random.Random(17)
        x_only = set(random.Random(18).sample(range(m), ICC_ERASE))
        recovered = {}
        for lane, mod in (("p", ctx.mod_p), ("q", ctx.mod_q)):
            B = tool.reduce_lane(raw, mod)
            X, Y, enc_s = encode(ctx, B, wts, mod)
            for pattern, erased in (
                    ("tool", set(bench_rng.sample(range(2 * m), ICC_ERASE))),
                    ("x_only", x_only)):
                recovered[lane, pattern], rec = recover(ctx, wts, X, Y, B,
                                                        erased, mod)
                emit({"icc": "f1", "lane": lane, "modulus": mod.name,
                      "pattern": pattern, "encode_s": enc_s, **rec})
            del X, Y, B
        for pattern in ("tool", "x_only"):
            v = crt_combine(recovered["p", pattern], recovered["q", pattern],
                            ctx.mod_q)
            if not torch.equal(v[..., :L.NLIMBS], raw) or \
                    v[..., L.NLIMBS:].any():
                raise AssertionError(f"icc: the CRT of the recovered lanes "
                                     f"({pattern}) is not the chunk values")
            emit({"icc": "f1 crt", "pattern": pattern, "values": m
                  * ICC_CHUNKS, "equal": True})
        del recovered, raw, v

        # (f2) reference mode, an epoch-CRebuild level, the dict form
        ctx2 = engine.NttContext(ICC_SMALL_N, "ipa")
        m2 = ICC_SMALL_N // 2
        wts2 = [ICC_SMALL_N + 5] * m2
        B = tool.reduce_lane(tool.level_data(m2, 8, dev), ctx2.mod_p)
        X, Y, _ = encode(ctx2, B, wts2, ctx2.mod_p)
        xs, ys = (L.tensor_to_ints(h) for h in (X, Y))
        cols = {j: (xs if j < m2 else ys)[(j % m2) * 8:(j % m2 + 1) * 8]
                for j in range(2 * m2)}
        erased = set(random.Random(19).sample(range(m2), ICC_ERASE))
        t0 = time.perf_counter()
        got = icc_device.recover_level_device(
            ctx2, wts2, {j: v for j, v in cols.items() if j not in erased},
            device=dev)
        s2 = time.perf_counter() - t0
        if sum(got, []) != L.tensor_to_ints(B):
            raise AssertionError("icc (f2): the epoch level did not recover")
        try:
            icc_device.recover_level_device(
                ctx2, wts2, {j: v for j, v in cols.items()
                             if j not in (7, m2 + 7)}, device=dev)
        except ValueError as exc:
            if "singular" not in str(exc):
                raise
        else:
            raise AssertionError("icc (f2): an erased X/Y pair of an epoch "
                                 "level did not raise")
        emit({"icc": "f2", "mode": "reference", "m": m2, "chunks": 8,
              "x_erased": ICC_ERASE, "recover_s": s2, "recovered": True,
              "pair_erased": "singular ValueError", "card": card})

        # (f3) BN254's r lane
        ctx3 = engine.NttContext(ICC_SMALL_N, "kzg", hardened=True)
        wts3 = [3 + i for i in range(m2)]
        B = tool.reduce_lane(tool.level_data(m2, ICC_CHUNKS, dev),
                             ctx3.mod_q)
        X, Y, enc_s = encode(ctx3, B, wts3, ctx3.mod_q)
        _, rec = recover(ctx3, wts3, X, Y, B, set(random.Random(17).sample(
            range(2 * m2), ICC_ERASE)), ctx3.mod_q)
        emit({"icc": "f3", "lane": "q", "modulus": ctx3.mod_q.name,
              "encode_s": enc_s, **rec})
        del X, Y, B
        total = native.launches()
    finally:
        cuda_stage.fold_lane = fold_lane

    # (f5) every fold launched K1 its planned passes
    bad = [f for f in folds if f[1] != f[2] or not f[1]]
    if bad or not total["ntt_stage"]:
        raise AssertionError(f"icc: folds without their K1 passes: {bad}, "
                             f"{total['ntt_stage']} K1 launches")
    emit({"icc": "f5", "folds": len(folds), "k1_launches":
          total["ntt_stage"], "fold_shapes": sorted(
              {(*f[0], f[1]) for f in folds})})

    # (f4) K1 at the widest fold shape, against the plain stage loop (over
    # column chunks: the plain products would not fit at once)
    shape = max((f[0] for f in folds), key=lambda sh: sh[0] * sh[1])
    rng = np.random.default_rng(SEED + 4)
    ctx = engine.NttContext(ICC_N, "ipa", hardened=True)
    mm, width = shape[0], shape[1]
    rows = []
    for lane, mod in (("p", ctx.mod_p), ("q", ctx.mod_q)):
        a = lane_limbs(rng, mod, (mm, width), dev)

        def plain():
            return icc_device.map_columns(
                lambda x: cuda_stage.fold_lane_plain(ctx, x, mod, lane), a)
        err = limb_err(cuda_stage.fold_lane(ctx, a, mod, lane), plain())
        if err:
            raise AssertionError(f"K1 at the fold shape {shape}, lane "
                                 f"{lane}: max abs err {err}")
        ms = timed_ms(lambda: cuda_stage.fold_lane(ctx, a, mod, lane), dev,
                      10)
        plain_ms = timed_ms(plain, dev, 1)
        b_ms, b_by = bound((mm.bit_length() - 1) * mm // 2 * width
                           * OPS_PER_FE_MUL,
                           2 * mm * width * FE_BYTES + (mm - 1) * FE_BYTES)
        rows.append(dict(shape=shape, lane=lane, modulus=mod.name,
                         passes=cuda_stage.pass_plan(mm), ms=ms,
                         plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                         bound_by=b_by))
        emit({"check": "ntt_stage icc", **rows[-1], "card": card})
        del a
    return total, dict(rows[0], lane="p and q (mean)",
                       ms=statistics.mean(r["ms"] for r in rows),
                       plain_ms=statistics.mean(r["plain_ms"] for r in rows),
                       max_abs_err=max(r["max_abs_err"] for r in rows),
                       launches=total["ntt_stage"])


# --- phase 7: the multi-device mesh ------------------------------------------
# A logical mesh: every shard on the one card, so the exchange schedule and
# the shard-local kernels run as on a mesh of cards, and no time here is an
# interconnect's (NVLink or network).

MESH_ENCODE_N = 1 << 14   # the bench's encode size (C = 128, both lanes)
MESH_DP = 4               # the distributed NTT's and the sharded MSM's dp


def mesh_encode_launches(n: int, dp: int) -> int:
    """K1 launches of one lane's sharded encode: the local passes of every
    shard, then one launch a shard pair at each exchange stage."""
    from porla_tpu_torch.ntt import cuda_stage
    n_loc = n // dp
    return (dp * len(cuda_stage.pass_plan(n_loc))
            + (n.bit_length() - n_loc.bit_length()) * dp // 2)


def same_reply(ops, kzg: bool, op: bytes, a: bytes, b: bytes) -> bool:
    """Two servers' replies to one request agree: byte for byte, except the
    two Jacobian points that end a KZG audit reply, which must be the same
    group elements."""
    if a == b:
        return True
    if op != b"A" or not kzg or len(a) != len(b):
        return False
    from porla_tpu_torch.protocol import points_io
    pa = points_io.points_from_bytes(a[192:], ops, "cpu")
    pb = points_io.points_from_bytes(b[192:], ops, "cpu")
    return a[:192] == b[:192] and ops.to_affine(pa) == ops.to_affine(pb)


def run_mesh_protocol(dev, store, runs, card) -> dict:
    """(g1): path (a)'s IPA cycle and path (b)'s KZG cycle on a logical
    (2, 2) mesh of `dev`, with the same client seeds: every reply must equal
    the one-device server's (`same_reply`), the corrupted audit is refused,
    the restored server is sharded too, and one more audit forces the
    per-shard Pippenger MSMs. Returns {scheme: (phases, launches)}."""
    from porla_tpu_torch.curves.instances import bn254, secp256k1
    from porla_tpu_torch.parallel import sharded
    from porla_tpu_torch.utils import trace
    mesh = sharded.make_mesh([dev] * 4)
    out = {}
    for scheme, ops in (("ipa", secp256k1()), ("kzg", bn254())):
        shutil.rmtree(store, ignore_errors=True)
        trace.reset()
        trace.enable()
        try:
            phases, total, _, replies = run_protocol(dev, store, scheme,
                                                     mesh=mesh)
        finally:
            trace.enable(False)
            shutil.rmtree(store, ignore_errors=True)
        for line in trace.report().splitlines():
            if "count" not in line:
                print("trace mesh", scheme, line, flush=True)
        n_loc = N_BLOCKS // mesh.dp
        init_k1 = 4 * mesh_encode_launches(N_BLOCKS, mesh.dp)
        check_protocol_launches(f"mesh {scheme}", phases, total, init_k1)
        one_phases, _, _, one_replies = runs[scheme]
        if len(replies) != len(one_replies) + 1:
            raise AssertionError(f"mesh {scheme}: {len(replies)} replies, "
                                 f"one device {len(one_replies)} + 1")
        for i, ((op, a), (_, b)) in enumerate(zip(replies, one_replies)):
            if not same_reply(ops, scheme == "kzg", op, a, b):
                raise AssertionError(f"mesh {scheme}: reply {i} ({op!r}) "
                                     f"differs from the one-device server's")
        forced = phases[-1]["launches"]
        if forced["pip_bucket"] != 2 * mesh.dp or \
                forced["bucket_fold"] != 4 * mesh.dp:
            raise AssertionError(f"mesh {scheme}: the forced audit took "
                                 f"{forced['pip_bucket']} K5 launches")
        compare = [{"phase": m["phase"], "s_mesh": m["s"], "s_one": o["s"],
                    "launches_mesh": {k: v for k, v in m["launches"].items()
                                      if v},
                    "launches_one": {k: v for k, v in o["launches"].items()
                                     if v}}
                   for m, o in zip(phases, one_phases)]
        emit({"check": f"mesh {scheme}", "mesh": mesh.shape, "n": N_BLOCKS,
              "n_loc": n_loc, "replies_equal": len(one_replies),
              "initialize_k1": init_k1, "phases": compare,
              "forced_pippenger_audit": {
                  "s": phases[-1]["s"],
                  "launches": {k: v for k, v in forced.items() if v}},
              "card": card})
        out[scheme] = (phases, total)
    return out


def run_mesh_encode(dev, rng, card) -> dict:
    """(g2): the distributed NTT at n = 2^14, C = 128, both lanes, on a
    logical dp = 4 mesh: limb for limb `compute.encode_crt`'s lanes, its K1
    launches as planned, the card's time beside `encode_lane`'s (and the
    host's, which the exchange stages' Python adds to), and `pair_stage`
    held against its plain version at the last exchange's shape."""
    from porla_tpu_torch import native
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.ntt import cuda_stage, engine
    from porla_tpu_torch.parallel import sharded
    from porla_tpu_torch.tools.bench import lane_limbs
    n, C = MESH_ENCODE_N, 128
    ctx = engine.NttContext(n, "ipa")
    mesh = sharded.make_mesh([dev] * MESH_DP, tp=1)
    n_loc = n // mesh.dp
    want_k1 = mesh_encode_launches(n, mesh.dp)
    rows, launches = [], 0
    for lane, mod in (("p", ctx.mod_p), ("q", ctx.mod_q)):
        a = lane_limbs(rng, mod, (n, C), dev)
        enc = sharded.sharded_encode_fn(ctx, mesh, mod)
        before = native.launches()["ntt_stage"]
        shards = enc(a)
        torch.cuda.synchronize(dev)
        k1 = native.launches()["ntt_stage"] - before
        launches += k1
        if k1 != want_k1:
            raise AssertionError(f"sharded encode lane {lane}: {k1} K1 "
                                 f"launches, planned {want_k1}")
        one = cuda_stage.encode_lane(ctx, a, mod, lane)
        err = limb_err(sharded.gather(mesh, shards, dev), one)
        if err:
            raise AssertionError(f"sharded encode lane {lane}: max abs err "
                                 f"{err} against encode_crt's lane")
        u, t = a[:n_loc], a[n // 2:n // 2 + n_loc]
        m2 = n // 2
        pair = cuda_stage.pair_stage(ctx, u, t, mod, lane, m2, 0)
        err = max(err, limb_err(torch.cat(pair), cuda_stage.pair_stage_plain(
            ctx, torch.cat([u, t]), mod, lane, m2, 0)))
        if err:
            raise AssertionError(f"pair_stage lane {lane}: max abs err {err} "
                                 f"against its plain version")
        ms = timed_ms(lambda: enc(a), dev, 10)
        one_ms = timed_ms(lambda: cuda_stage.encode_lane(ctx, a, mod, lane),
                          dev, 10)
        host = []
        for _ in range(5):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            enc(a)
            torch.cuda.synchronize(dev)
            host.append((time.perf_counter() - t0) * 1e3)
        rows.append({"lane": lane, "ms": ms, "encode_crt_lane_ms": one_ms,
                     "host_ms": statistics.median(host), "k1_launches": k1,
                     "max_abs_err": err})
        del a, one, shards
    rec = {"check": "mesh encode", "n": n, "chunks": C, "mesh": mesh.shape,
           "n_loc": n_loc, "exchange_stages": n.bit_length()
           - n_loc.bit_length(), "lanes": rows, "card": card}
    emit(rec)
    return {"launches": launches, "max_abs_err": max(r["max_abs_err"]
                                                     for r in rows)}


def run_mesh_msm(dev, card) -> dict:
    """(g3): `sharded_pippenger_msm_fn` at 2^20 points on a logical dp = 4
    mesh (n_local = 2^18), secp256k1 and BN254, on `run_msm`'s operands:
    every result the golden point; best of 3 (host clock, the result on the
    host) beside the one-device `kernels.msm` on the same operands."""
    from porla_tpu_torch import native
    from porla_tpu_torch.curves import kernels
    from porla_tpu_torch.curves.instances import bn254, secp256k1
    from porla_tpu_torch.parallel import sharded
    from porla_tpu_torch.tools.bench import msm_inputs
    mesh = sharded.make_mesh([dev] * MESH_DP, tp=1)
    n_loc = MSM_N // mesh.dp
    total = {k: 0 for k in native.launches()}
    recs = []
    for ops in (secp256k1(), bn254()):
        points, scalars, want = msm_inputs(ops, MSM_N, dev)
        nbits = ops.curve.n.bit_length()
        fn, finish = sharded.sharded_pippenger_msm_fn(mesh, ops, nbits=nbits,
                                                      n_local=n_loc)
        times, one_times, per_run = [], [], None
        for i in range(4):
            before = native.launches()
            t0 = time.perf_counter()
            got = finish(fn(points, scalars))
            dt = time.perf_counter() - t0
            if ops.to_affine(got)[0] != want:
                raise AssertionError(f"sharded MSM on {ops.fp.name}: not the "
                                     f"golden point")
            per_run = {k: v - before[k] for k, v in native.launches().items()}
            for k, v in per_run.items():
                total[k] += v              # the sharded runs' launches only
            t0 = time.perf_counter()
            one = kernels.msm(ops, points, scalars, nbits)
            one_dt = time.perf_counter() - t0
            if ops.to_affine(one)[0] != want:
                raise AssertionError("one-device MSM mismatch vs golden")
            if i:
                times.append(dt)
                one_times.append(one_dt)
        if per_run["pip_bucket"] != mesh.dp or per_run["group_sum"] != 1:
            raise AssertionError(f"sharded MSM launches {per_run}")
        recs.append({"curve": ops.fp.name, "n": MSM_N, "n_local": n_loc,
                     "s_per_msm": min(times), "runs_s": times,
                     "one_device_s": min(one_times),
                     "one_device_runs_s": one_times,
                     "launches_per_run": {k: v for k, v in per_run.items()
                                          if v}})
        del points, scalars
    emit({"check": "mesh msm", "mesh": mesh.shape, "runs": recs,
          "card": card})
    return total


def run_mesh_cluster(card) -> dict:
    """(g4): two processes of tools/run_multihost.py with gloo, each with 2
    shards on cuda:0 (the mesh of `multihost.make_mesh()`: dp = 2 across
    the processes, so every exchange stage crosses them, tp = 2 within
    each), the IPA epoch at n = 1024. Both must print "audit PASSED".
    Returns each process's record (seconds, bytes, launches)."""
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "porla_tpu_torch.tools.run_multihost",
         "--coordinator", f"localhost:{port}", "--nprocs", "2",
         "--proc-id", str(r), "--backend", "gloo", "--device",
         "cuda:0,cuda:0", "--n", str(N_BLOCKS)], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=400)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            print(f"cluster {r}: {line}", flush=True)
        if p.returncode != 0 or "audit PASSED" not in out:
            raise AssertionError(f"cluster process {r} failed "
                                 f"(rc {p.returncode})")
        recs.append(json.loads(out.strip().splitlines()[-1]))
        if recs[-1]["mesh"] != {"blocks": 2, "chunks": 2}:
            raise AssertionError(f"cluster mesh {recs[-1]['mesh']}")
    emit({"check": "mesh cluster", "backend": "gloo", "n": N_BLOCKS,
          "processes": [{k: rec[k] for k in ("proc", "mesh", "s", "epoch_s",
                                             "init_s", "traffic", "launches")}
                        for rec in recs], "card": card})
    return {r: rec["launches"] for r, rec in enumerate(recs)}


# --- path (h): the reference's self-test epoch -------------------------------

def epoch_summary(scheme, records, n=N_BLOCKS) -> dict:
    """(h)'s record of one scheme's epoch (`run_protocol` with n + 1
    updates): the updates' line (`merged`), then the amortized update over
    write steps 1..n, the epoch-closing update, the mean and slowest update
    per fold level (`tools.soak.epoch_stats`) and the seconds of every
    audit that verified."""
    from porla_tpu_torch.tools import soak
    emit(merged(records, "update"))
    times = [(r["write_step"], r["s"]) for r in records
             if r["phase"] in ("update", "epoch_close")
             and r["write_step"] <= n]
    stats = soak.epoch_stats(times, n)
    summary = {"path": "h", "scheme": scheme, "n": n,
               "amortized_update_s": sum(s for _, s in times) / n,
               "epoch_close_s": stats["epoch_close_s"][0],
               "slowest_update_s_by_level": {
                   lv: r["max_s"] for lv, r in stats["by_level"].items()},
               "by_level": stats["by_level"],
               "audit_s": [r["s"] for r in records
                           if r["phase"] in ("audit", "resume_audit")]}
    emit(summary)
    return summary


def run_bench_tool() -> dict:
    """The bench tool (`tools/bench.py`) once as a subprocess, as a user
    runs it: it must exit 0 and print bench.py's three metric lines, BN254
    last, which are emitted again here. Returns its record (the lines and
    its kernels' launches)."""
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "porla_tpu_torch.tools.bench", "--out",
             out], cwd=HERE, env=env, capture_output=True, text=True,
            timeout=600)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"bench: {line}", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"the bench tool failed (rc "
                                 f"{proc.returncode})")
        with open(out) as f:
            rec = json.load(f)
    finally:
        os.remove(out)
    lines = [json.loads(line) for line in proc.stdout.splitlines()[-3:]]
    names = ["icc_encode_coeffs_per_s", "msm_points_per_s_secp256k1",
             "msm_points_per_s_bn254"]
    if [r["metric"] for r in lines] != names or lines != rec["lines"]:
        raise AssertionError(f"the bench tool's lines: {lines}")
    for r in lines:
        emit(r)
    emit({"check": "bench", "card": rec["card"],
          "launches": rec["launches"]})
    return rec


# --- path (i): the reference's two-process deployment ----------------------

DEPLOY_PORT = 8888      # the reference's SERVER_PORT (config.hpp:19)
DEPLOY_ENDPOINT = f"tcp://localhost:{DEPLOY_PORT}"
DEPLOY_UPDATES, DEPLOY_AUDITS = 4, 2


def check_port_free(port: int = DEPLOY_PORT) -> None:
    """Raises unless a server may bind `port` (as `zmtp.RepSocket` binds
    it, with SO_REUSEADDR)."""
    import socket
    with socket.socket() as sk:
        sk.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sk.bind(("", port))
        except OSError as e:
            raise AssertionError(f"port {port} is taken: {e}") from e


def demo(*argv) -> subprocess.Popen:
    """A process of `porla_tpu_torch/tools/demo_e2e.py` on the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "porla_tpu_torch.tools.demo_e2e",
         "--device", "cuda", *argv], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish(proc, name: str, timeout: float, stop: bool = False,
           want: str | None = None) -> dict:
    """Waits for `proc` (SIGTERM first with `stop`), prints its lines, and
    returns its last line's JSON record; raises unless it exited 0 (and
    printed `want`)."""
    import signal
    if stop:
        proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=timeout)
    out = out.decode(errors="replace")
    for line in out.splitlines():
        print(f"{name}: {line}", flush=True)
    if proc.returncode != 0 or (want is not None and want not in out):
        raise AssertionError(f"{name} failed (rc {proc.returncode})")
    return json.loads(out.strip().splitlines()[-1])


def kill(*procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def check_deploy_launches(what, server, client) -> None:
    """K1 launched 4 times in the server process, all at initialize (its
    CRebuild), and nowhere else; each kernel of the cycle (PROTOCOL_KERNELS)
    launched by one of the two processes."""
    reqs = server["requests"]
    k1 = {kind: r["launches"]["ntt_stage"] for kind, r in reqs.items()}
    if k1.get("initialize") != 4 or sum(k1.values()) != 4 or \
            client["launches"]["ntt_stage"]:
        raise AssertionError(f"{what}: K1 launches {k1} in the server, "
                             f"{client['launches']['ntt_stage']} in the "
                             f"client, not 4 at the server's initialize")
    missing = [k for k in PROTOCOL_KERNELS
               if not server["launches"][k] + client["launches"][k]]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")


def wire_line(path, scheme, client, server, inproc, card) -> dict:
    """The deployment's seconds per phase over the wire beside path (a)'s
    in-process seconds of the same run, the wire's seconds a request (a
    round trip less the server's handling of it), the bytes and round
    trips (the client's transport counters, each equal to the server's own
    count), and each process's launches."""
    reqs = server["requests"]
    counts = dict(client["transport"])
    request_s = counts.pop("request_s")
    got = {"round_trips": sum(r["calls"] for r in reqs.values()),
           "bytes_sent": sum(r["bytes_received"] for r in reqs.values()),
           "bytes_received": sum(r["bytes_sent"] for r in reqs.values())}
    if got != counts:
        raise AssertionError(f"{path} {scheme}: the client's transport "
                             f"counters {counts} are not the server's {got}")
    line = {"path": path, "scheme": scheme, "n": N_BLOCKS,
            "wire_s": client["s"],
            "inproc_s": {k: [r["s"] for r in inproc if r["phase"] == k]
                         for k in ("initialize", "update", "audit")},
            "server_s": {k: r["s"] for k, r in reqs.items()},
            # a round trip's seconds less the server's handling of it: the
            # wire (both processes' framing, the socket, the wake-ups)
            "wire_overhead_s_per_request": {
                k: (request_s[k] - r["s"]) / r["calls"]
                for k, r in reqs.items()},
            "transport": counts,
            "server_requests": {k: {f: r[f] for f in (
                "calls", "bytes_received", "bytes_sent")}
                for k, r in reqs.items()},
            "launches": {"server": server["launches"],
                         "client": client["launches"]},
            "card": card}
    emit(line)
    return line


def run_deploy(scheme, store, inproc, card) -> dict:
    """(i1) / (i2): the reference's deployment on the card, two processes
    of tools/demo_e2e.py: a server bound to tcp://*:8888 and a client that
    connects to it and runs initialize at n = 1024, an audit, 4 updates and
    2 audits (every audit must verify: "ALL CHECKS PASSED"); then SIGTERM
    ends the server, which prints its record and exits 0. Returns the
    launches of each process (the server's by request kind)."""
    check_port_free()
    t0 = time.perf_counter()
    server = client = None
    try:
        server = demo("--serve", "--scheme", scheme, "--store", store)
        client = demo("--connect", DEPLOY_ENDPOINT, "--scheme", scheme,
                      "--n", str(N_BLOCKS), "--updates", str(DEPLOY_UPDATES),
                      "--audits", str(DEPLOY_AUDITS))
        crec = finish(client, f"deploy {scheme} client", 300,
                      want="ALL CHECKS PASSED")
        srec = finish(server, f"deploy {scheme} server", 60, stop=True)
    finally:
        kill(client, server)
    path = "i1" if scheme == "ipa" else "i2"
    check_deploy_launches(f"({path})", srec, crec)
    line = wire_line(path, scheme, crec, srec, inproc, card)
    line["s"] = time.perf_counter() - t0
    emit({"path": path, "phase": "deploy", "s": line["s"]})
    return {**{f"{path} server {k}": r["launches"]
               for k, r in srec["requests"].items()},
            f"{path} client": crec["launches"]}


def corrupt_checkpoint_codeword(store, seed: bytes) -> dict:
    """Flip one bit in the q residue of a top-level codeword of the
    checkpoint in `store` (checkpoint.npz, as `save_checkpoint` wrote it)
    that the audit of `seed` samples with a nonzero coefficient, the file
    counterpart of `corrupt_sampled_codeword`. Returns what was flipped."""
    import numpy as np
    from porla_tpu_torch.ntt.engine import NttContext
    from porla_tpu_torch.protocol import auditing
    with open(os.path.join(store, "checkpoint.json")) as f:
        meta = json.load(f)
    height = len(meta["levels"])
    top = height - 1
    mod_q = NttContext(meta["num_blocks"], meta["scheme"]).mod_q
    plan = auditing.build_audit_plan(seed, meta["write_step"],
                                     meta["num_blocks"], height)
    hit = next(s for s in plan.samples
               if s.level == top and s.coeff % mod_q.n)
    key = f"L{top}{'x' if hit.is_x else 'y'}_dq"
    path = os.path.join(store, "checkpoint.npz")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays[key][hit.index, 0, 0] ^= 1
    np.savez(path, **arrays)
    return {"array": key, "index": hit.index}


def run_resume_deploy(dev, store, card) -> dict:
    """(i3): resume across processes. In this process, a client and a
    server on the card: initialize at n = 1024, 2 updates, the server's
    checkpoint; the server is dropped. A copy of the store whose checkpoint
    has one codeword flipped that a chosen audit samples is served by
    `demo_e2e.py --serve --resume`, and the same client, now over a
    `ZmqClientTransport`, must refuse that audit; then a server resumed
    from the intact checkpoint must answer an audit, an update and an
    audit that verify. Both servers end on SIGTERM with rc 0. Returns the
    launches: this process's per phase, each server's."""
    import numpy as np
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.protocol.client import PorlaClient
    from porla_tpu_torch.protocol.server import PorlaServer
    from porla_tpu_torch.protocol.transport import (InProcTransport,
                                                    ZmqClientTransport)
    rng = np.random.default_rng(SEED + 3)
    seed = lambda: rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    cfg = PorlaConfig(scheme="ipa", storage_dir=store)
    server = PorlaServer(cfg, device=dev)
    client = PorlaClient(cfg, InProcTransport(server), data_seed=seed(),
                         device=dev)
    log = PhaseLog("i3", "ipa", dev)
    log("initialize", lambda: client.initialize(N_BLOCKS))
    for _ in range(2):
        log("update", lambda: client.update(client.write_step % N_BLOCKS + 1),
            write_step=client.write_step + 1)
    log("checkpoint", server.save_checkpoint)
    client.transport = server = None
    bad_store = store + "_corrupt"
    shutil.rmtree(bad_store, ignore_errors=True)
    shutil.copytree(store, bad_store)
    audit_seed = seed()
    flipped = corrupt_checkpoint_codeword(bad_store, audit_seed)
    records = {}
    try:
        for name, where, phases in (
                ("refused", bad_store, [("audit_corrupted", refuse(
                    client, audit_seed, "a corrupted checkpoint codeword"))]),
                ("resumed", store, [
                    ("audit", lambda: client.audit(seed=seed())),
                    ("update", lambda: client.update(
                        client.write_step % N_BLOCKS + 1)),
                    ("audit", lambda: client.audit(seed=seed()))])):
            check_port_free()
            proc = demo("--serve", "--resume", "--store", where)
            try:
                client.transport = ZmqClientTransport(DEPLOY_ENDPOINT,
                                                      timeout_s=120)
                for phase, fn in phases:
                    log(f"wire_{phase}", fn)
                client.transport.close()
                records[name] = finish(proc, f"resume {name} server", 60,
                                       stop=True)
            finally:
                kill(proc)
            if records[name]["mode"] != "resumed":
                raise AssertionError(f"(i3) the {name} server did not "
                                     f"resume")
    finally:
        shutil.rmtree(bad_store, ignore_errors=True)
    emit({"path": "i3", "phase": "resume_deploy", "flipped": flipped,
          "s": time.perf_counter() - t0,
          "server_requests": {name: rec["requests"]
                              for name, rec in records.items()},
          "card": card})
    out = {}
    for r in log.records:
        acc = out.setdefault(f"i3 {r['phase']}", dict.fromkeys(r["launches"],
                                                               0))
        for k, v in r["launches"].items():
            acc[k] += v
    for name, rec in records.items():
        out[f"i3 {name} server"] = rec["launches"]
    return out


# --- path (j): the out-of-core bench tool as a user runs it ----------------

BENCH_OOC_N = 1 << 11      # two passes of stages a side at stripes of 256
BENCH_OOC_STRIPE = 256


def run_bench_ooc(store) -> dict:
    """The out-of-core bench tool (`tools/bench_ooc.py`) as a user runs it,
    one subprocess a scheme, IPA and KZG side by side: n = 2^11 blocks in
    stripes of 256 (two passes of stages over the files a side),
    `--check`, each in its own fresh store (`store` + the scheme), removed
    afterwards. Each must exit 0 with a record whose check is exact in all
    three parts (the data plane against K1 block by block, the first and
    last stripes' alignment points against the plain K4, 64 MAC codewords
    a plane against t_i * G); a `bench_ooc` line prints its phases and its
    memory and disk breakdown. Returns {scheme: the launches of its
    CRebuild and its check}."""
    import tempfile
    from porla_tpu_torch.protocol import stream
    if len(stream.stage_passes(BENCH_OOC_N, BENCH_OOC_STRIPE)) != 2:
        raise AssertionError("path (j) no longer streams in two passes")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    runs = {}
    t0 = time.perf_counter()
    try:
        for scheme in ("ipa", "kzg"):
            root = f"{store}_{scheme}"
            shutil.rmtree(root, ignore_errors=True)
            fd, out = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            runs[scheme] = (root, out, subprocess.Popen(
                [sys.executable, "-m", "porla_tpu_torch.tools.bench_ooc",
                 "--n", str(BENCH_OOC_N), "--stripe", str(BENCH_OOC_STRIPE),
                 "--scheme", scheme, "--check", "--store", root, "--out",
                 out], cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        recs = {}
        for scheme, (_, out, proc) in runs.items():
            stdout, stderr = proc.communicate(timeout=300)
            for line in stdout.splitlines()[:-1] + stderr.splitlines():
                print(f"bench_ooc {scheme}: {line}", flush=True)
            if proc.returncode != 0:
                raise AssertionError(f"the bench_ooc tool failed in {scheme} "
                                     f"(rc {proc.returncode})")
            with open(out) as f:
                recs[scheme] = rec = json.load(f)
            if json.loads(stdout.splitlines()[-1]) != rec:
                raise AssertionError("bench_ooc's last line is not its record")
            recs[scheme]["s"] = time.perf_counter() - t0
    finally:
        for root, out, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            os.remove(out)
            shutil.rmtree(root, ignore_errors=True)
    launched = {}
    for scheme, rec in recs.items():
        if rec["check"] != {"data": "exact", "align": "exact",
                            "mac": "exact"}:
            raise AssertionError(f"bench_ooc {scheme}: {rec['check']}")
        mem, disk = rec["memory"], rec["disk"]
        emit({"bench_ooc": scheme, "n": rec["n"],
              "stripe_blocks": rec["stripe_blocks"], "s": rec["s"],
              "seed_s": rec["seed_s"], "phases_s": rec["phases_s"],
              "total_s": rec["total_s"], "check": rec["check"],
              "check_s": rec["check_detail"]["check_s"],
              "rss_mib": mem["rss_mib"], "rss_peak_mib": mem["rss_peak_mib"],
              "cuda_max_allocated_bytes": mem["cuda_max_allocated_bytes"],
              "pinned_buffer_bytes": mem["pinned_buffer_bytes"],
              "disk_at_peak_bytes": disk["at_peak"]["total_bytes"],
              "fs_used_delta_peak_bytes": disk["fs_used_delta_peak_bytes"],
              "filesystem": disk["filesystem"]["fstype"],
              "launches": rec["launches"],
              "check_launches": rec["check_detail"]["launches"]})
        launched[f"{scheme} crebuild"] = rec["launches"]
        launched[f"{scheme} check"] = rec["check_detail"]["launches"]
    return launched


def main() -> int:
    script_t0 = time.perf_counter()
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
    from porla_tpu_torch.config import PorlaConfig
    from porla_tpu_torch.curves.instances import bn254, secp256k1
    from porla_tpu_torch.runtime import lib as rt
    from porla_tpu_torch.utils import trace

    card = native.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    so = native.build()
    native.library()
    t1 = time.perf_counter()
    rt_so = rt.build()
    rt.library()
    emit({"build_s": t1 - t0, "library": os.path.relpath(so, HERE),
          "runtime_build_s": time.perf_counter() - t1,
          "runtime": os.path.relpath(rt_so, HERE)})
    for src, log in native.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line and \
                    "0 bytes stack" not in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)

    rng = np.random.default_rng(SEED)
    ops = secp256k1()
    k1 = check_k1(dev, rng)
    k2 = k2_rows(check_k2(dev, rng, ops))
    k3 = check_k3(dev, rng, ops)
    emit(dict(check="point_butterfly",
              launches=native.launches()["point_butterfly"],
              **{k: v for k, v in k3.items() if k != "name"}))
    k4_rows = check_k4(dev, rng, ops)
    for row in k4_rows:
        emit(dict(check="fixed_base", **{k: v for k, v in row.items()
                                         if k != "name"}))
    k4 = k4_row(k4_rows)
    gs = check_group_sum(dev, rng, ops)
    pa = check_point_add(dev, rng, ops, add_ms=gs["add_ms"])
    emit(check_kernels_only(dev, rng, ops))
    emit(check_compute_kernels_only(dev, rng, ops))
    emit(check_k5_k6_modes(dev, rng, ops))
    k7 = check_k7(dev, rng, ops)
    emit(dict(check="point_butterfly_window",
              **{k: v for k, v in k7.items() if k != "name"}))
    bn = check_bn254(dev, rng)
    emit(check_ipa(dev))

    # each path is driven with the counts set to 0 just before it and read
    # just after; a kernel must be launched by the path that owns it
    store = os.path.join(HERE, "porla_store_chip_smoke")
    runs = {}
    for scheme in ("ipa", "kzg"):
        shutil.rmtree(store, ignore_errors=True)
        trace.reset()
        trace.enable()
        try:
            runs[scheme] = run_protocol(dev, store, scheme)
        finally:
            trace.enable(False)
            shutil.rmtree(store, ignore_errors=True)
        # host-clock spans of the protocol run (a span ends where its result
        # reaches the host, so it covers the card's work it waited for)
        for line in trace.report().splitlines():
            if "count" not in line:
                print("trace", scheme, line, flush=True)
        check_protocol_launches(scheme, *runs[scheme][:2])
    phases, total, protocol_shapes, _ = runs["ipa"]
    kzg_phases, kzg_total, _, _ = runs["kzg"]
    msm_kernels = ("pip_bucket", "bucket_fold", "point_butterfly_window")

    msm_runs, msm_total, k5, k6 = run_msm(
        dev, os.path.join(HERE, "tests", "vectors", "secp256k1_kat.json"))
    emit({"phase": "run_msm", "launches": msm_total})
    missing = [k for k in msm_kernels if msm_total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the MSM run: "
                             f"{missing}")
    emit(check_msm_parts(dev, ops))
    # K3 at the widest butterfly the updates launched
    widest = max(b for ph, b in protocol_shapes["k3"] if ph == "update")
    k3["update_fold"] = check_k3(dev, rng, ops, B=widest)
    emit(dict(check="point_butterfly update_fold", **{
        k: v for k, v in k3["update_fold"].items() if k != "name"}))

    # (d) the out-of-core tier at n = 2^14 with the default caching level
    # and stripe, then (e) its streamed folds at n = 1024 in both schemes
    shutil.rmtree(store, ignore_errors=True)
    try:
        store_io(store)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    stripe_butterfly(dev, PorlaConfig().stream_stripe_blocks)
    ooc = {}
    for key, scheme, n, updates, after, kw in (
            ("d", "ipa", OOC_N, OOC_UPDATES, (), {}),
            ("e ipa", "ipa", N_BLOCKS, OOC_E_UPDATES, (32,), OOC_E),
            ("e kzg", "kzg", N_BLOCKS, OOC_E_UPDATES, (32,), OOC_E)):
        shutil.rmtree(store, ignore_errors=True)
        trace.reset()
        trace.enable()
        try:
            ooc[key] = run_ooc(dev, store, scheme, n, updates, after, **kw)
        finally:
            trace.enable(False)
            shutil.rmtree(store, ignore_errors=True)
        emit({"phase": f"ooc {key}", "launches": ooc[key][1]})
        for line in trace.report().splitlines():
            if "count" not in line and (
                    key == "d" or "stream." in line or "crebuild" in line):
                print("trace ooc", key, line, flush=True)
    # K3 and K4 at (d)'s widest launches: the CRebuild's MAC stages (2
    # planes x n/2 lanes) and the finalize pass's alignment commitments (a
    # stripe of blocks x 128 lanes)
    ooc_shapes = ooc["d"][2]
    k3["ooc"] = check_k3(dev, rng, ops, B=max(b for _, b in ooc_shapes["k3"]))
    emit(dict(check="point_butterfly ooc", **{
        k: v for k, v in k3["ooc"].items() if k != "name"}))
    ooc_commit = max(sh for sh in ooc_shapes["k4"] if sh[1])
    k4["ooc"] = check_k4(dev, rng, ops, (("ooc_commit", *ooc_commit),))[0]
    emit(dict(check="fixed_base ooc", **{
        k: v for k, v in k4["ooc"].items() if k != "name"}))
    # (f) ICC erasure recovery: a level of 2^15 blocks, its folds on K1
    t0 = time.perf_counter()
    icc_total, k1["icc"] = run_icc(dev)
    emit({"phase": "icc", "s": time.perf_counter() - t0,
          "launches": icc_total})

    # (g) the multi-device mesh: (g1) paths (a) and (b) on a logical (2, 2)
    # mesh of the card, (g2) the distributed NTT and (g3) the sharded MSM
    # on dp = 4, (g4) two processes over gloo; each driven with the counts
    # set to 0 just before it and read just after
    t0 = time.perf_counter()
    mesh_runs = run_mesh_protocol(dev, store, runs, card)
    # (g2)'s count is its sharded encodes' launches alone (the comparisons
    # with encode_crt and the plain version, and the timed runs, apart)
    k1["mesh_encode"] = run_mesh_encode(dev, rng, card)
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            k1["mesh_encode"]["max_abs_err"])
    mesh_encode_total = {k: 0 for k in native.launches()}
    mesh_encode_total["ntt_stage"] = k1["mesh_encode"]["launches"]
    mesh_msm_total = run_mesh_msm(dev, card)
    missing = [k for k in ("pip_bucket", "bucket_fold", "group_sum")
               if mesh_msm_total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the mesh MSM: "
                             f"{missing}")
    cluster = run_mesh_cluster(card)
    emit({"phase": "mesh", "s": time.perf_counter() - t0,
          "launches": {"encode": mesh_encode_total, "msm": mesh_msm_total,
                       **{f"cluster {r}": v for r, v in cluster.items()}}})

    # (h) the reference's self-test epoch in each scheme (path (a)'s cycle
    # with n + 1 updates, an audit after the n-th), each driven with the
    # counts set to 0 just before it and read just after, K3 held at the
    # widest butterfly its updates launched; then the bench tool as a user
    # runs it
    t0 = time.perf_counter()
    epochs = {}
    for scheme, cops, row in (("ipa", ops, k3),
                              ("kzg", bn254(), bn["point_butterfly"])):
        shutil.rmtree(store, ignore_errors=True)
        try:
            epochs[scheme] = run_protocol(
                dev, store, scheme, n_updates=N_BLOCKS + 1,
                audit_after=(N_BLOCKS,), path="h", quiet=("update",))
        finally:
            shutil.rmtree(store, ignore_errors=True)
        e_phases, e_total, e_shapes, _ = epochs[scheme]
        check_protocol_launches(f"(h) {scheme}", e_phases, e_total)
        epoch_summary(scheme, e_phases)
        widest = max(b for ph, b in e_shapes["k3"]
                     if ph in ("update", "epoch_close"))
        row["epoch"] = check_k3(dev, rng, cops, B=widest)
        emit(dict(check=f"point_butterfly epoch {scheme}", **{
            k: v for k, v in row["epoch"].items() if k != "name"}))
    bench = run_bench_tool()
    emit({"phase": "epoch", "s": time.perf_counter() - t0,
          "launches": {**{s: e[1] for s, e in epochs.items()},
                       "bench": bench["launches"]}})

    # (i) the reference's two-process deployment: (i1) IPA and (i2) KZG, a
    # server and a client process of tools/demo_e2e.py over
    # tcp://localhost:8888, each phase beside path (a)'s in-process seconds;
    # (i3) a checkpoint resumed across processes, and a corrupted one refused
    t0 = time.perf_counter()
    deploy = {}
    for scheme, inproc in (("ipa", phases), ("kzg", kzg_phases)):
        shutil.rmtree(store, ignore_errors=True)
        try:
            deploy.update(run_deploy(scheme, store, inproc, card))
        finally:
            shutil.rmtree(store, ignore_errors=True)
    try:
        deploy.update(run_resume_deploy(dev, store, card))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    emit({"path": "i", "phase": "deploy", "s": time.perf_counter() - t0,
          "launches": deploy})

    # (j) the out-of-core bench tool as a user runs it, both schemes with
    # --check, each in a fresh store
    t0 = time.perf_counter()
    ooc_tool = run_bench_ooc(store)
    emit({"path": "j", "phase": "bench_ooc", "s": time.perf_counter() - t0,
          "launches": ooc_tool})

    # K2, K4 and group_sum at every other shape the one-device protocol
    # paths ((a), (b), (d), (e), (h)) launched that the checks above did not
    # hold, on each path's curve: (d)'s audit MSM (its samples padded to
    # 2048 slots), its CRebuild's MAC-plane scaling (2^14 GLV lanes), (e)'s
    # alignment commits over stripes of 8 blocks and the epoch's complement
    # replays (up to 1022 lanes at level 9) are shapes of no phase-2 check
    k2_by = {r["name"]: r for r in k2}
    path_runs = {**{f"{key}": run[2] for key, run in ooc.items()},
                 **{f"a-b {s}": run[2] for s, run in runs.items()},
                 **{f"h {s}": run[2] for s, run in epochs.items()}}
    for scheme, cops, krows, fb_checked in (
            ("ipa", ops, {**k2_by, "fixed_base": k4, "group_sum": gs},
             FB_SHAPES), ("kzg", bn254(), bn, KZG_FB_SHAPES)):
        seen = {name: set() for name in ("k2", "k4", "group_sum")}
        for key, shapes in path_runs.items():
            if scheme == ("kzg" if "kzg" in key else "ipa"):
                for name in seen:
                    seen[name].update(shapes[name])
        new_k2 = sorted(seen["k2"] - set(K2_SHAPES))
        new_k4 = sorted(seen["k4"] - {sh[1:] for sh in fb_checked}
                        - {ooc_commit})
        new_gs = sorted(seen["group_sum"] - set(GS_SHAPES))
        emit({"check": f"path shapes {scheme}", "k2": new_k2, "k4": new_k4,
              "group_sum": new_gs})
        checked = []
        if new_k2:
            for row in check_k2(dev, rng, cops, new_k2):
                checked.append((row["name"], row, k2_shapes([row])))
        if new_k4:
            k4_rows = check_k4(
                dev, rng, cops, [(f"path_{B}x{nout}", B, nout, ng, nbits)
                                 for B, nout, ng, nbits in new_k4],
                rand_points(rng, cops.curve, max(sh[2] for sh in new_k4)))
            for row in k4_rows:
                emit(dict(check=f"fixed_base {scheme} path",
                          **{k: v for k, v in row.items() if k != "name"}))
                checked.append(("fixed_base", row, k4_shapes([row])))
        if new_gs:
            row = check_group_sum(dev, rng, cops, new_gs,
                                  krows["group_sum"]["add_ms"], max(new_gs))
            checked.append(("group_sum", row, row["shapes"]))
        for name, row, shapes in checked:
            into = krows[name]
            into["max_abs_err"] = max(into["max_abs_err"], row["max_abs_err"])
            into.setdefault("path_shapes", {}).update(shapes)

    # a row's ms, plain_ms and bound are at its secp256k1 shape (the IPA
    # path's); its BN254 numbers (the KZG path's) are under "bn254"
    rows = []
    for r in (k1, *k2, k3, k4, gs, k5, k6, k7, pa):
        name = r["name"]
        k = native.KERNELS[name]
        per_phase = {}
        for rec in phases + kzg_phases:
            key = rec["phase"] if rec["scheme"] == "ipa" else \
                "kzg " + rec["phase"]
            per_phase.setdefault(key, []).append(rec["launches"][name])
        per_phase["run_msm"] = [msm_total[name]]
        per_phase["icc"] = [icc_total[name]]
        for scheme, (m_phases, _) in mesh_runs.items():
            for rec in m_phases:
                per_phase.setdefault(f"mesh {scheme} {rec['phase']}",
                                     []).append(rec["launches"][name])
        per_phase["mesh encode"] = [mesh_encode_total[name]]
        per_phase["mesh msm"] = [mesh_msm_total[name]]
        per_phase["mesh cluster"] = [c[name] for c in cluster.values()]
        for scheme, (e_phases, *_) in epochs.items():
            for rec in e_phases:
                key = f"epoch {scheme} {rec['phase']}"
                per_phase[key] = [per_phase.get(key, [0])[0]
                                  + rec["launches"][name]]
        per_phase["bench"] = [bench["launches"][name]]
        for key, launched in deploy.items():
            per_phase[f"({key[:2]}) {key[3:]}"] = [launched[name]]
        for key, launched in ooc_tool.items():
            per_phase[f"(j) {key}"] = [launched[name]]
        for log, *_ in ooc.values():
            for rec in log.records:
                per_phase.setdefault(f"{rec['path']} {rec['scheme']} "
                                     f"{rec['phase']}", []).append(
                    rec["launches"][name])
        b = bn.get(name)
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": total[name] + kzg_total[name] + msm_total[name]
            + sum(run[1][name] for run in ooc.values()) + icc_total[name]
            + sum(sum(r["launches"][name] for r in m_phases)
                  for m_phases, _ in mesh_runs.values())
            + mesh_encode_total[name] + mesh_msm_total[name]
            + sum(c[name] for c in cluster.values())
            + sum(e[1][name] for e in epochs.values())
            + bench["launches"][name]
            + sum(launched[name] for launched in deploy.values())
            + sum(launched[name] for launched in ooc_tool.values()),
            "max_abs_err": max(r["max_abs_err"],
                               b["max_abs_err"] if b else 0),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "shape": r["shape"],
            "launches_per_phase": per_phase,
            **{k: r[k] for k in ("shapes", "update_fold", "ooc",
                                 "path_shapes", "icc", "mesh_encode",
                                 "epoch", "depth_ms", "add_ms", "nb")
               if k in r},
            **({"bn254": {k: b[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "shapes", "path_shapes", "lane", "depth_ms",
                "add_ms", "epoch")
                if k in b}} if b else {}),
        })
    emit({"script_s": time.perf_counter() - script_t0})
    emit({"kernels": rows})
    print(native.card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
