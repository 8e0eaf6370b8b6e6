#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`porla_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   `porla_tpu_torch/csrc/` and prints the build seconds.
2. Holds each kernel (K1 ntt_stage, K2 scalar_mul in its windowed and
   GLV modes, K3 point_butterfly, K4 fixed_base) at the shapes of the
   main path against its plain torch version on the card (tolerance:
   exact, bit-identical limbs, so points
   are the same affine points, infinity included) and against exact
   Python integers on a few lanes, including edge lanes. Times both with
   CUDA events (median after a warm-up).
3. Runs the IPA protocol at n = 1024 blocks on the card: initialize, an
   audit, 4 updates, another audit (both must verify), then a corrupted
   codeword that the next audit must reject. Every kernel's launch count
   must rise during this run.
4. Prints one JSON line of per-kernel results, the card line again, and
   as its last line {"ok": true, "device": {...}}.

Any failed phase raises, so the script exits nonzero and prints no result.
It exits nonzero when torch finds no CUDA device or the port's package is
not beside it.
"""

from __future__ import annotations

import json
import os
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
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the protocol run: "
                             f"{missing}")

    rows = []
    for r in (k1, *k2, k3, k4):
        name = r["name"]
        k = native.KERNELS[name]
        per_phase = {}
        for rec in phases:
            per_phase.setdefault(rec["phase"], []).append(
                rec["launches"][name])
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": total[name],
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
