"""ICC erasure recovery of one level of a 2^16-block log, on the card.

    python -m porla_tpu_torch.tools.icc_recover --q-lane --out icc.json

A level of m = n/2 blocks of `--chunks` 256-bit chunks (a full block is
128) is encoded on K1 (X = F(B), Y = F(W * B), `icc_device`), `--erase`
random codeword columns of 2m are erased, and the level is recovered on the
card (`icc_device.recover_level_tensors`) and compared, whole, with the
blocks; two X columns are also held against the exact host fold
(`icc.fold_transform`). The mod-p lane, and with `--q-lane` the mod-q lane
(secp256k1's n). The data: 16 random 16-bit limbs a chunk from numpy seed
23, block i written at step 3 + i (an incremental build), the erasures
`random.Random(17).sample(range(2m), e)` per lane, and the hardened context
(a true primitive root, so the code is MDS and every pattern of at most m
erasures recovers). Each lane's blocks are first reduced into the lane (the
fold takes canonical residues). `--device cpu` runs the plain versions
(use a small `--n`). Prints and writes one JSON record: encode and recover
seconds and a bit-exact flag per lane, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np
import torch

from porla_tpu_torch import native
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont
from porla_tpu_torch.ntt import engine, icc, icc_device


def level_data(m: int, chunks: int, device) -> torch.Tensor:
    """(m, chunks, 16) limbs of 256-bit chunk values (numpy seed 23)."""
    blk = np.random.default_rng(23).integers(
        0, 1 << 32, (m, chunks, 8), dtype=np.uint32)
    blk16 = np.concatenate([blk & 0xFFFF, blk >> 16], axis=2)
    return L.to_torch(blk16, device)


def reduce_lane(raw: torch.Tensor, mod: mont.Modulus) -> torch.Tensor:
    """The chunk values mod the lane's modulus (canonical limbs)."""
    return icc_device.map_columns(lambda x: mont.mod_reduce(x, mod), raw)


def encode_level(ctx: engine.NttContext, B: torch.Tensor, write_times,
                 mod: mont.Modulus):
    """The level's codeword halves X = F(B) and Y = F(W * B): the folds on
    K1 (the plain stage loop on the CPU)."""
    wt = L.to_torch(icc_device._wt_mont(ctx, write_times, mod),
                    B.device).reshape(len(write_times), 1, L.NLIMBS)
    X = icc_device._fold_dev(ctx, B, mod)
    Y = icc_device._fold_dev(ctx, icc_device._twist(B, wt, mod), mod)
    return X, Y


def erase(X: torch.Tensor, Y: torch.Tensor, erased):
    """Copies of X and Y with the erased columns (global indices, the X
    half first) zeroed."""
    m = X.shape[0]
    X, Y = X.clone(), Y.clone()
    X[[j for j in erased if j < m]] = 0
    Y[[j - m for j in erased if j >= m]] = 0
    return X, Y


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 16,
                    help="log size (level recovered: m = n/2)")
    ap.add_argument("--erase", type=int, default=128)
    ap.add_argument("--chunks", type=int, default=128)
    ap.add_argument("--q-lane", action="store_true",
                    help="also recover the mod-q CRT lane")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = native.resolve_device(args.device)
    m = args.n // 2
    e = args.erase
    ctx = engine.NttContext(args.n, "ipa", hardened=True)
    rng = random.Random(17)
    write_times = [3 + i for i in range(m)]
    rec = {"n": args.n, "m": m, "erased": e, "chunks": args.chunks,
           "backend": "cpu" if dev.type == "cpu"
           else native.card_line(dev.index or 0)}
    raw = level_data(m, args.chunks, dev)

    lanes = [("p", ctx.mod_p)] + ([("q", ctx.mod_q)] if args.q_lane else [])
    for tag, mod in lanes:
        B = reduce_lane(raw, mod)
        _sync(dev)
        t0 = time.perf_counter()
        X, Y = encode_level(ctx, B, write_times, mod)
        _sync(dev)
        rec[f"encode_{tag}_s"] = time.perf_counter() - t0
        if mod is ctx.mod_p:
            for c in (0, args.chunks - 1):
                want = icc.fold_transform(ctx, L.tensor_to_ints(B[:, c]))
                if L.tensor_to_ints(X[:, c]) != want:
                    raise AssertionError("device fold != exact host fold")
        erased = set(rng.sample(range(2 * m), e))
        Xe, Ye = erase(X, Y, erased)
        del X, Y
        t0 = time.perf_counter()
        got = icc_device.recover_level_tensors(ctx, write_times, Xe, Ye,
                                               erased, mod)
        _sync(dev)
        rec[f"recover_{tag}_s"] = time.perf_counter() - t0
        if not torch.equal(got, B):
            raise AssertionError("recovered blocks differ")
        rec[f"recover_{tag}_bitexact"] = True
        print(f"[{tag}] encode {rec[f'encode_{tag}_s']:.3f}s, recover "
              f"{rec[f'recover_{tag}_s']:.3f}s, bit-exact", flush=True)

    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print("wrote", args.out)
    return rec


if __name__ == "__main__":
    main()
