"""Time K1, K2, K7 and group_sum (and K3 as a control) of one source tree
on the card, to compare trees on one machine, run after run.

    python3 porla_tpu_torch/tools/kernel_ab.py TREE LABEL OUTDIR

Run it as a file, once per tree, each in its own process (parent, tree,
tree, parent): it imports `porla_tpu_torch` from TREE (a checkout, or a
copy with one change), builds that tree's kernels, and at the main path's
shapes times, as the median of 20 calls after a warm-up, both on the card's
timeline (CUDA events behind a ~1 ms spin kernel: `ms`) and from an idle
card (the host's launch cost included: `call_ms`):
- K1 `encode_lane` per CRT lane at (1024, 128, 16), and at (2^14, 128, 16)
  in the p lane, each checked against the plain stage loop;
- K2 GLV at 1024 lanes and at 1 lane, K2 windowed at 2048 lanes and 32
  bits, K3 at 1024 lanes, each checked against exact golden points on its
  first 16 lanes;
- K7 at 1024 lanes and 64 bits, and K2 windowed at the same shape (the
  same chain without the two closing adds), checked against their plain
  versions;
- group_sum at the audit's 2048 lanes in 2 groups and at one group of
  4095 and of 4094 points (the widest `kernels.msm` sends below its
  crossover; the second's half, 2047, keeps its levels from splitting),
  checked against its plain version.
It writes OUTDIR/LABEL.json with the times, the launch counts and a digest
of each output (equal digests: the same words).
"""

import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import time


def main(tree: str, label: str, outdir: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from porla_tpu_torch import native
    from porla_tpu_torch.curves import cuda_curve as cc
    from porla_tpu_torch.curves.instances import secp256k1
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc
    from porla_tpu_torch.ntt import cuda_stage, engine

    if not native.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {native.__file__}, not {tree}'s")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    t0 = time.perf_counter()
    native.library()
    res = {"label": label, "card": card, "build_s": time.perf_counter() - t0,
           "ptxas": {k: [ln.strip() for ln in v.splitlines()
                         if "registers" in ln or "smem" in ln]
                     for k, v in native.BUILD_LOG.items()}}

    def timed(fn, reps=20, spin=True):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    rng = np.random.default_rng(5)
    for n, lanes in ((1024, ("p", "q")), (1 << 14, ("p",))):
        ctx = engine.NttContext(n, "ipa")
        for lane in lanes:
            mod = ctx.mod_p if lane == "p" else ctx.mod_q
            lim = rng.integers(0, 1 << 16, size=(n * 128, 16), dtype="int64")
            lim[:, 15] %= mod.n >> 240
            a = torch.from_numpy(lim).to(dev).reshape(n, 128, 16)
            key = f"k1_{n}_{lane}"
            try:
                before = native.launches()["ntt_stage"]
                got = cuda_stage.encode_lane(ctx, a, mod, lane)
                torch.cuda.synchronize()
                launches = native.launches()["ntt_stage"] - before
                plain = a
                for s in range(1, ctx.height):
                    m2 = 1 << (s - 1)
                    tw = L.to_torch(getattr(ctx.twiddles(m2), "mont_" + lane),
                                    dev)
                    plain = engine.stage(plain, tw, m2, mod)
                fn = lambda: cuda_stage.encode_lane(ctx, a, mod, lane)
                res[key] = {"ms": timed(fn), "call_ms": timed(fn, spin=False),
                            "launches": launches,
                            "equal_plain": bool(torch.equal(got, plain)),
                            "digest": digest(got)}
            except Exception as e:                   # report, go on
                res[key] = {"error": repr(e)[:400]}
            print(label, key, res[key], flush=True)
            del a

    ops = secp256k1()
    cv = ops.curve
    r = random.Random(9)

    def pts(B):
        base = [ecc.mul(cv, cv.g, r.randrange(1, cv.n)) for _ in range(8)]
        return [base[i % 8] for i in range(B)]

    for name, B, nbits in (("glv_1024", 1024, 256), ("glv_1", 1, 256),
                           ("window_2048", 2048, 32), ("k3_1024", 1024, 256)):
        p = pts(B)
        k = [r.randrange(cv.n) if nbits == 256 else r.getrandbits(nbits)
             for _ in range(B)]
        if B > 4:
            p[0] = ecc.INF
            k[1], k[2] = 0, 1
            k[3] = cv.n - 1 if nbits == 256 else (1 << nbits) - 1
        P = ops.from_affine(p, dev)
        S = L.ints_to_tensor(k, dev)
        idx = list(range(min(16, B)))
        want = [ecc.mul(cv, p[i], k[i]) for i in idx]
        try:
            if name.startswith("k3"):
                m0 = ops.from_affine(pts(B), dev)
                g = cc.GlvScalars(ops, S)
                fn = lambda: cc.launch_point_butterfly(ops, m0, P, g)
                out = fn()[0]
                m0a = ops.to_affine(type(m0)(*(c[:len(idx)] for c in m0)))
                want = [ecc.add(cv, m0a[i], w) for i, w in zip(idx, want)]
            elif nbits == 256:
                g = cc.GlvScalars(ops, S)
                fn = lambda: cc.launch_scalar_mul_glv(ops, P, g)
                out = fn()
            else:
                fn = lambda: cc.launch_scalar_mul_window(ops, P, S, nbits)
                out = fn()
            torch.cuda.synchronize()
            got = ops.to_affine(type(out)(*(c[:len(idx)] for c in out)))
            res[name] = {"ms": timed(fn), "call_ms": timed(fn, spin=False),
                         "golden": got == want, "digest": digest(*out)}
        except Exception as e:
            res[name] = {"error": repr(e)[:400]}
        print(label, name, res[name], flush=True)

    def equal(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    for name, B, nbits in (("k7_1024_64", 1024, 64),
                           ("window_1024_64", 1024, 64)):
        p = pts(B)
        p[0] = ecc.INF
        P = ops.from_affine(p, dev)
        S = L.ints_to_tensor([r.getrandbits(nbits) for _ in range(B)], dev)
        try:
            if name.startswith("k7"):
                m0 = ops.from_affine(pts(B), dev)
                fn = lambda: cc.launch_window_butterfly(ops, m0, P, S, nbits)
                hi, lo = fn()
                phi, plo = cc.window_butterfly_plain(ops, m0, P, S, nbits)
                ok = equal(hi, phi) and equal(lo, plo)
                out = (*hi, *lo)
            else:
                fn = lambda: cc.launch_scalar_mul_window(ops, P, S, nbits)
                out = fn()
                ok = equal(out, ops.scalar_mul(P, S, nbits))
            res[name] = {"ms": timed(fn), "call_ms": timed(fn, spin=False),
                         "equal_plain": ok, "digest": digest(*out)}
        except Exception as e:
            res[name] = {"error": repr(e)[:400]}
        print(label, name, res[name], flush=True)

    def distinct(B):
        """B distinct multiples of a random point, shuffled."""
        step = ecc.mul(cv, cv.g, r.randrange(1, cv.n))
        out = [step]
        while len(out) < B:
            out.append(ecc.add(cv, out[-1], step))
        r.shuffle(out)
        return out

    for B, nout in ((2048, 2), (4095, 1), (4094, 1)):
        key = f"group_sum_{B}_{nout}"
        try:
            P = ops.from_affine(distinct(B), dev)
            fn = lambda: cc.group_sum(ops, P, nout)
            out = fn()
            res[key] = {"ms": timed(fn), "call_ms": timed(fn, spin=False),
                        "equal_plain": equal(out, cc.group_sum_plain(
                            ops, P, nout)),
                        "digest": digest(*out)}
        except Exception as e:
            res[key] = {"error": repr(e)[:400]}
        print(label, key, res[key], flush=True)

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{label}.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main(*sys.argv[1:4])
