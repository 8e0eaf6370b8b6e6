"""Single-card benchmark of the port: ICC/NTT erasure encode and the
Pippenger MSM, the counterpart of the reference package's `bench.py`.

    python -m porla_tpu_torch.tools.bench [--out bench.json]

Prints the card's name and power limit, then one JSON line per metric,
{"metric", "value", "unit", "vs_baseline"}, with bench.py's names and
units; the last line is BASELINE.json's primary metric (MSM points per
second on BN254 at 2^20).

- icc_encode_coeffs_per_s: every radix-2 NTT stage over an (n, 128-chunk)
  block array in both CRT lanes (mod p and mod q), `compute.encode_crt` on
  K1, on operands on the card: one warm-up, then the mean of `ROUNDS`
  rounds, each ending in a synchronisation.
- msm_points_per_s_{secp256k1,bn254}: a 2^20-point MSM with scalars below
  the group order (nbits its bit length) through the blinded Pippenger
  kernels (`cuda_msm.pippenger_msm`: K5, K6), on bench.py's operands
  (`random.Random(7)`, 8 bases tiled over the points). Every run, the
  warm-up included, is checked against the golden point and raises on a
  mismatch; the best of `ROUNDS` runs is reported.

vs_baseline is against bench.py's estimates of the reference's 8-thread
CPU throughput (BENCH_NOTES.md). Without a card it raises; `--device cpu`
with small `--encode-n` / `--msm-n` runs the plain versions, and then
vs_baseline is null (a CPU number is no measurement of the card).
`--out` also writes the lines, the card line and the kernels' launches.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np
import torch

from porla_tpu_torch import native
from porla_tpu_torch.curves import cuda_msm
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.ntt import engine
from porla_tpu_torch.protocol import compute

# bench.py:90-94: estimates of the reference's 8-thread CPU throughput
REFERENCE_CPU_COEFFS_PER_S = 1.2e6
REFERENCE_CPU_MSM_PTS_PER_S = {"secp256k1": 1.0e6, "bn254": 2.0e6}
ENCODE_N = 1 << 14     # the baseline denominator's calibration point
CHUNKS = 128
MSM_N = 1 << 20
ROUNDS = 3


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _per_card(value: float, baseline: float, dev):
    return round(value / baseline, 3) if dev.type == "cuda" else None


def lane_limbs(rng, mod, shape, dev) -> torch.Tensor:
    """(*shape, 16) canonical values of one lane on `dev`: random 16-bit
    limbs from the numpy generator `rng`, the top limb below the modulus's
    (the encode's time does not depend on the values)."""
    lim = rng.integers(0, 1 << 16, (*shape, L.NLIMBS), dtype=np.int64)
    lim[..., -1] %= mod.n >> 240
    return torch.from_numpy(lim).to(dev)


def bench_encode(dev, n: int = ENCODE_N) -> dict:
    ctx = engine.NttContext(n, "ipa")
    rng = np.random.default_rng(0)
    arr = engine.CrtArray(lane_limbs(rng, ctx.mod_p, (n, CHUNKS), dev),
                          lane_limbs(rng, ctx.mod_q, (n, CHUNKS), dev))

    def one_round():
        compute.encode_crt(ctx.mod_q, ctx, arr)
        _sync(dev)

    one_round()
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        one_round()
    dt = (time.perf_counter() - t0) / ROUNDS
    value = n * CHUNKS / dt
    return {"metric": "icc_encode_coeffs_per_s", "value": round(value, 1),
            "unit": f"256-bit coeffs/s (n=2^{n.bit_length() - 1}, "
                    f"C={CHUNKS}, both CRT lanes, {dev.type})",
            "vs_baseline": _per_card(value, REFERENCE_CPU_COEFFS_PER_S, dev)}


def msm_inputs(ops, n: int, dev, nbases: int = 8):
    """bench.py's operands: `nbases` random bases tiled over n points (the
    golden sum stays O(n) host ints), scalars below the group order, from
    `random.Random(7)`, on `dev`. Returns (points, scalars, golden point)."""
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


def bench_msm(curve_name: str, dev, n: int = MSM_N) -> dict:
    ops = secp256k1() if curve_name == "secp256k1" else bn254()
    points, scalars, want = msm_inputs(ops, n, dev)
    nbits = ops.curve.n.bit_length()

    def run():
        out = cuda_msm.pippenger_msm(ops, points, scalars, nbits,
                                     affine=True)
        return ops.to_affine(out)[0]

    def check(got):
        if got != want:
            raise RuntimeError(f"MSM mismatch vs golden ({curve_name})")

    check(run())
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        got = run()
        times.append(time.perf_counter() - t0)
        check(got)
    value = n / min(times)
    c = cuda_msm.choose_c(n, nbits)
    return {"metric": f"msm_points_per_s_{curve_name}",
            "value": round(value, 1),
            "unit": f"pts/s (N=2^{n.bit_length() - 1}, {nbits}-bit order "
                    f"scalars, Pippenger c={c}, device-resident operands, "
                    f"{dev.type})",
            "vs_baseline": _per_card(
                value, REFERENCE_CPU_MSM_PTS_PER_S[curve_name], dev)}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--encode-n", type=int, default=ENCODE_N)
    ap.add_argument("--msm-n", type=int, default=MSM_N)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = native.resolve_device(args.device)
    card = native.card_line(dev.index or 0) if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    native.reset_launches()
    lines = []
    # BN254 last: BASELINE.json's primary metric
    for fn in (lambda: bench_encode(dev, args.encode_n),
               lambda: bench_msm("secp256k1", dev, args.msm_n),
               lambda: bench_msm("bn254", dev, args.msm_n)):
        lines.append(fn())
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "lines": lines,
                       "launches": native.launches()}, f, indent=1)
    return lines


if __name__ == "__main__":
    main()
