"""Known-answer checks of the port's kernels on the card against the exact
golden models (never against the plain versions), recorded as a JSON file:
the counterpart of the reference package's `examples/kat_onchip.py`.

    python -m porla_tpu_torch.tools.kat_onchip --out kat.json

The checks (`CHECKS`, in order): K2 on both curves in its GLV mode (256-bit
scalars) and its windowed mode (32 bits), edge lanes included (infinity,
the scalars 0 and n - 1); K3, the MAC-mirror butterfly M0 +- s*M1; K4, the
fixed-base table; K5 + K6, the Pippenger MSM, against libsecp256k1's own
result (`tests/vectors/secp256k1_kat.json`, `ecmult_multi[1]`: 300 points,
64-bit scalars); K1, the CRebuild stages at (n, C) = (64, 8); the MSM entry
point (`kernels.msm`) at 2^20 distinct points (i+1)*G with random 256-bit
scalars, whose golden point is (sum_i k_i (i+1))*G; and the ICC encode
(`compute.encode_crt`, K1) at n = 2^16, C = 16, both CRT lanes, against an
exact model in Python ints (`exact_encode`: numpy object arrays, the
twiddles derived from the field's prime and generator as the reference's
client derives them, Client.hpp:141-144; it shares no code with K1, its
twiddle tables or the Montgomery limb arithmetic), with the sha256 of its
output.

The record is rewritten after each check, so a run cut short keeps the
checks that finished. A check that raises is recorded with `"pass": false`
and its error; after the last check the tool exits nonzero if any failed.
It raises without a card; `--device cpu` runs the plain versions, with
small `--msm-n` and `--icc-n`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import time
import traceback

import numpy as np
import torch

from porla_tpu_torch import native
from porla_tpu_torch.crypto import testrand
from porla_tpu_torch.curves import cuda_curve, cuda_msm, kernels
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.ntt import engine
from porla_tpu_torch.protocol import compute
from porla_tpu_torch.tools.bench import lane_limbs

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "tests", "vectors", "secp256k1_kat.json")
MSM_N = 1 << 20
ICC_N = 1 << 16
ICC_CHUNKS = 16      # the chunk axis is a batch: every column the same math


def rand_points(rng, cv, count: int) -> list:
    return [ecc.mul(cv, cv.g, rng.randrange(1, cv.n)) for _ in range(count)]


def multiples_of_g(cv, n: int) -> list:
    """(i + 1) * G for i < n, affine: a Jacobian chain of mixed adds and
    one batched inversion (Montgomery's trick)."""
    p = cv.p
    gx, gy = cv.g
    jac, (X, Y, Z) = [], (gx, gy, 1)
    for _ in range(n):
        jac.append((X, Y, Z))
        X, Y, Z = ecc._jac_madd(X, Y, Z, gx, gy, p)
    prefix, acc = [], 1
    for _, _, z in jac:
        prefix.append(acc)
        acc = acc * z % p
    inv = pow(acc, -1, p)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        x, y, z = jac[i]
        zi = inv * prefix[i] % p
        inv = inv * z % p
        zi2 = zi * zi % p
        out[i] = (x * zi2 % p, y * zi2 * zi % p)
    return out


def stage_twiddles(n: int, m2: int, modulus: int) -> list[int]:
    """The twiddles of the stage of half-width m2 at n blocks, v_j =
    w^(n*j/m2) for j < m2 with w = g^((p-1)/2n) (Client.hpp:141-144), in
    Python ints reduced mod `modulus`."""
    p = C.FFT_PRIME
    v = pow(C.FFT_GENERATOR, (p - 1) // (2 * n) * (n // m2), p)
    return [pow(v, j, p) % modulus for j in range(m2)]


def exact_encode(modulus: int, vals):
    """The CRebuild stages over an (n, C) object array of ints below
    `modulus`, in Python ints."""
    n, chunks = vals.shape
    a = vals
    for s in range(1, n.bit_length()):
        m2 = 1 << (s - 1)
        tw = np.array(stage_twiddles(n, m2, modulus), dtype=object)
        a = a.reshape(n // (2 * m2), 2 * m2, chunks)
        u, t = a[:, :m2], a[:, m2:] * tw[None, :, None] % modulus
        a = np.concatenate([(u + t) % modulus, (u - t) % modulus],
                           axis=1).reshape(n, chunks)
    return a


def _encode_check(k, n: int, chunks: int) -> dict:
    ctx = engine.NttContext(n, "ipa")
    want, lanes = [], []
    for mod in (ctx.mod_p, ctx.mod_q):
        lim = lane_limbs(k.np_rng, mod, (n, chunks), k.dev)
        vals = np.array(L.tensor_to_ints(lim),
                        dtype=object).reshape(n, chunks)
        want.append(exact_encode(mod.n, vals))
        lanes.append(lim)
    got = compute.encode_crt(ctx.mod_q, ctx, engine.CrtArray(*lanes))
    for lane, g, w in (("p", got.p, want[0]), ("q", got.q, want[1])):
        if L.tensor_to_ints(g) != list(w.ravel()):
            raise AssertionError(f"encode lane {lane} differs from the "
                                 f"exact model")
    raw = b"".join(L.to_numpy(t).astype("<u2").tobytes()
                   for t in (got.p, got.q))
    return {"n": n, "chunks": chunks,
            "sha256": hashlib.sha256(raw).hexdigest()}


class Kat:
    """What the checks share: the device, seeded host RNGs (Python's for
    ints, numpy's for limb arrays), the sizes."""

    def __init__(self, dev, msm_n: int, icc_n: int):
        self.dev, self.msm_n, self.icc_n = dev, msm_n, icc_n
        self.rng = random.Random(99)
        self.np_rng = np.random.default_rng(99)


def check_smul(k, ops) -> dict:
    cv = ops.curve
    pts = rand_points(k.rng, cv, 5) + [ecc.INF, cv.g, cv.g]
    P = ops.from_affine(pts, k.dev)
    for nbits, edge in ((256, [7, 0, cv.n - 1]), (32, [7, 0, (1 << 32) - 1])):
        sc = [k.rng.randrange(min(cv.n, 1 << nbits)) for _ in range(5)] + edge
        got = ops.to_affine(cuda_curve.scalar_mul(
            ops, P, L.ints_to_tensor(sc, k.dev), nbits))
        if got != [ecc.mul(cv, p, s) for p, s in zip(pts, sc)]:
            raise AssertionError(f"K2 at {nbits} bits differs from the "
                                 f"golden model")
    return {}


def check_butterfly(k) -> dict:
    ops = secp256k1()
    cv = ops.curve
    m0 = rand_points(k.rng, cv, 6) + [ecc.INF, cv.g]
    m1 = rand_points(k.rng, cv, 7) + [ecc.INF]
    sc = [k.rng.randrange(cv.n) for _ in range(8)]
    hi, lo = cuda_curve.point_butterfly(
        ops, ops.from_affine(m0, k.dev), ops.from_affine(m1, k.dev),
        L.ints_to_tensor(sc, k.dev))
    for a, b, s, h, l in zip(m0, m1, sc, ops.to_affine(hi),
                             ops.to_affine(lo)):
        t = ecc.mul(cv, b, s)
        if h != ecc.add(cv, a, t) or l != ecc.add(cv, a, ecc.neg(cv, t)):
            raise AssertionError("K3 differs from the golden model")
    return {}


def check_fixed_base(k) -> dict:
    ops = secp256k1()
    cv = ops.curve
    gens = rand_points(k.rng, cv, 4)
    tbl = cuda_curve.build_fb_table(ops, gens)
    sc = [k.rng.randrange(cv.n) for _ in range(3)] + [0]
    got = ops.to_affine(cuda_curve.fb_scalar_mul(
        tbl, L.ints_to_tensor(sc, k.dev)))
    if got != [ecc.mul(cv, g, s) for g, s in zip(gens, sc)]:
        raise AssertionError("K4 differs from the golden model")
    return {}


def check_pippenger_reference_c(k) -> dict:
    ops = secp256k1()
    with open(VECTORS) as f:
        case = json.load(f)["ecmult_multi"][1]
    gens = testrand.derive_ipa_generators(128)[0]
    n = case["n"]
    pts = ops.from_affine([gens[i % 128] for i in range(n)], k.dev)
    sc = L.ints_to_tensor([((i + 1) * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
                           for i in range(n)], k.dev)
    got = ops.to_affine(cuda_msm.pippenger_msm(ops, pts, sc, nbits=64))[0]
    if got != (int(case["result"][0], 16), int(case["result"][1], 16)):
        raise AssertionError("Pippenger differs from libsecp256k1's result")
    return {"n": n}


def check_ntt(k) -> dict:
    return _encode_check(k, 64, 8)


def check_msm_distinct(k) -> dict:
    ops = secp256k1()
    cv = ops.curve
    n = k.msm_n
    pts = ops.from_affine(multiples_of_g(cv, n), k.dev)
    sc = [k.rng.getrandbits(256) % cv.n for _ in range(n)]
    got = ops.to_affine(kernels.msm(ops, pts, L.ints_to_tensor(sc, k.dev)))[0]
    total = sum(s * (i + 1) for i, s in enumerate(sc)) % cv.n
    if got != ecc.mul(cv, cv.g, total):
        raise AssertionError("MSM over (i+1)*G differs from the golden point")
    return {"n": n}


def check_icc_encode(k) -> dict:
    return _encode_check(k, k.icc_n, ICC_CHUNKS)


CHECKS = {
    "smul_secp256k1": lambda k: check_smul(k, secp256k1()),
    "smul_bn254": lambda k: check_smul(k, bn254()),
    "point_butterfly": check_butterfly,
    "fixed_base": check_fixed_base,
    "pippenger_vs_reference_C": check_pippenger_reference_c,
    "ntt_encode": check_ntt,
    "msm_distinct_points": check_msm_distinct,
    "icc_encode": check_icc_encode,
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--msm-n", type=int, default=MSM_N)
    ap.add_argument("--icc-n", type=int, default=ICC_N)
    args = ap.parse_args(argv)

    dev = native.resolve_device(args.device)
    k = Kat(dev, args.msm_n, args.icc_n)
    rec = {"device": native.card_line(dev.index or 0)
           if dev.type == "cuda" else "cpu", "all_pass": True,
           "partial": True, "kats": {}}

    def write():
        rec["all_pass"] = all(r["pass"] for r in rec["kats"].values())
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f, indent=1)

    for name, fn in CHECKS.items():
        t0 = time.perf_counter()
        try:
            r = {"pass": True, **fn(k)}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except Exception as e:  # noqa: BLE001 - recorded, raised at the end
            r = {"pass": False, "err": repr(e)[:300],
                 "traceback": traceback.format_exc()[-2000:]}
        r["s"] = time.perf_counter() - t0
        rec["kats"][name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
        write()
    rec["partial"] = False
    write()
    print(json.dumps({k_: v for k_, v in rec.items() if k_ != "kats"}),
          flush=True)
    failed = [n for n, r in rec["kats"].items() if not r["pass"]]
    if failed:
        raise SystemExit(f"KAT failed: {', '.join(failed)}")
    return rec


if __name__ == "__main__":
    main()
