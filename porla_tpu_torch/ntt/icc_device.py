"""ICC erasure recovery on the card: the level folds on K1, a structured
solve in torch field ops.

The port of `porla_tpu/ntt/icc_device.py`. The host path
(`icc.recover_level`) solves the full m x m system by Gaussian elimination
over Python ints, O(m^3) bigint work: a golden model, unusable at m = 2^15.
This module exploits the code's structure instead:

    X = F(B)            (the level fold: the CRebuild's first log2(m) stages)
    Y = F(W * B)        (W = diag(w^bitrev(t_i)), per-block write times;
                         reference Server.hpp:1391-1425, icc/main.m)

Let u = F(B). Surviving X columns give u at their positions. The e erased X
positions are unknowns delta = u[E], fixed by surviving Y rows of the
operator M = F . W . F^-1:

    A[Sy, E] @ delta = Y[Sy] - M(u~)[Sy],   u~ = u with zeros at E.

- The columns of A are M applied to one-hot vectors, and M(u~) is M on the
  known values: one operator pass over an (m, e + C, 16) array. F is K1
  (`cuda_stage.fold_lane`), F^-1 (`_unfold_dev`) and W are plain torch
  field ops, over column chunks of at most CHUNK_ELEMS elements (a plain
  Montgomery product builds (..., 16, 32) int64 columns, 4 KiB an element).
- The reduced (e + slack) x e system is solved by division-free
  Gauss-Jordan elimination on the card (`_gauss_jordan_df`; the pivot row
  comes to the host once a pivot), then e exact inverses on the host.
- B = F^-1(u) finishes the recovery.

Works in either CRT lane of the context (mod p, and mod q: secp256k1's n
or BN254's r), so full block values recover by CRT as they encode. Spans
`icc.host`, `icc.unfold`, `icc.twist`, `icc.fold` and `icc.solve`
(`utils/trace.py`) time the parts; with tracing on, each synchronises the
card at its end.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch

from porla_tpu_torch import native
from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont
from porla_tpu_torch.ntt import cuda_stage, engine
from porla_tpu_torch.utils import trace

# elements of one plain field op's operands at a time (2^19: 2 GiB of
# product columns)
CHUNK_ELEMS = 1 << 19

SINGULAR = ("surviving column set is singular — this erasure pattern is "
            "unrecoverable (e.g. paired X/Y columns of an epoch-CRebuild "
            "level, which are scalar multiples)")


@contextlib.contextmanager
def _span(name: str, device):
    with trace.span(name):
        yield
        if trace.enabled() and device.type == "cuda":
            torch.cuda.synchronize(device)


def _lane(ctx: engine.NttContext, mod: mont.Modulus) -> str:
    """The CRT lane of `ctx` whose modulus is `mod` (K1's twiddle table)."""
    if mod.n == ctx.mod_p.n:
        return "p"
    if mod.n == ctx.mod_q.n:
        return "q"
    raise ValueError(f"{mod} is neither CRT lane of this context "
                     f"({ctx.mod_p}, {ctx.mod_q})")


def _stage_twiddles(ctx: engine.NttContext, m: int, mod: mont.Modulus,
                    inverse: bool) -> list[np.ndarray]:
    """Per-stage (length, 16) uint32 Montgomery twiddle limbs of a size-m
    level fold (stage lengths 1..m/2, v = w^(n/length), as
    icc.fold_transform). inverse=True inverts each FORWARD value in this
    lane's field: the forward q-lane twiddle is (v^j mod p) mod q
    (`NttContext.twiddles`), which is not a power of (v mod q), so the
    inverse table cannot be built from powers of v^-1."""
    tabs = []
    length = 1
    while length < m:
        v = pow(ctx.w, ctx.n // length, C.FFT_PRIME)
        vals = [x % mod.n
                for x in engine._batch_powers(v, length, C.FFT_PRIME)]
        if inverse:
            if any(x == 0 for x in vals):
                raise ValueError(
                    "a forward twiddle reduces to 0 in this CRT lane — "
                    "the lane fold is not invertible for this (n, mod)")
            vals = [pow(x, -1, mod.n) for x in vals]
        tabs.append(L.ints_to_limbs([mod.to_mont_int(x) for x in vals]))
        length <<= 1
    return tabs


@lru_cache(maxsize=None)
def _inv2_mont(mod: mont.Modulus) -> np.ndarray:
    return L.ints_to_limbs([mod.to_mont_int(pow(2, -1, mod.n))])[0]


def _fold_dev(ctx: engine.NttContext, arr: torch.Tensor,
              mod: mont.Modulus) -> torch.Tensor:
    """Forward level fold over axis 0 of (m, ..., 16) standard-form values
    (butterflies exactly as icc.fold_transform): K1 on a CUDA tensor, the
    plain stage loop on a CPU tensor."""
    return cuda_stage.fold_lane(ctx, arr.contiguous(), mod, _lane(ctx, mod))


def map_columns(fn, arr: torch.Tensor,
                chunk: int = CHUNK_ELEMS) -> torch.Tensor:
    """fn over (m, ..., 16) as (m, B, 16), on column slices of at most
    `chunk` elements (at least one column each): for plain field ops along
    the rows or elementwise, whose product columns would not fit for the
    whole array at once."""
    m = arr.shape[0]
    flat = arr.reshape(m, -1, L.NLIMBS)
    out = torch.empty_like(flat)
    cols = max(1, chunk // m)
    for c in range(0, flat.shape[1], cols):
        out[:, c:c + cols] = fn(flat[:, c:c + cols].contiguous())
    return out.reshape(arr.shape)


def _unfold_dev(arr: torch.Tensor, itabs, mod: mont.Modulus,
                chunk: int = CHUNK_ELEMS) -> torch.Tensor:
    """Inverse level fold over axis 0 of (m, ..., 16): reverse stage order,
    butterflies inverted (u = (hi+lo)/2, t_in = (hi-lo)/2 * v^-j), plain
    torch field ops over column chunks of at most `chunk` elements."""
    m = arr.shape[0]
    inv2 = L.to_torch(_inv2_mont(mod), arr.device)
    tws = [L.to_torch(t, arr.device) for t in itabs]

    def unfold(x):
        length = m // 2
        for tw in reversed(tws):
            a = x.reshape(m // (2 * length), 2 * length, -1, L.NLIMBS)
            hi, lo = a[:, :length], a[:, length:]
            u = mont.mont_mul(mont.add_mod(hi, lo, mod), inv2, mod)
            t = mont.mont_mul(mont.sub_mod(hi, lo, mod), inv2, mod)
            t_in = mont.mont_mul(t, tw.reshape(1, length, 1, L.NLIMBS), mod)
            x = torch.cat([u, t_in], dim=1).reshape(x.shape)
            length //= 2
        return x
    return map_columns(unfold, arr, chunk)


def _wt_mont(ctx: engine.NttContext, write_times,
             mod: mont.Modulus) -> np.ndarray:
    """(m, 16) uint32 Montgomery limbs of each block's twist
    w^bitrev(t mod n) in this lane."""
    vals = [pow(ctx.w,
                engine.reverse_bits(t % ctx.n, ctx.height - 1),
                C.FFT_PRIME) % mod.n
            for t in write_times]
    return L.ints_to_limbs([mod.to_mont_int(v) for v in vals])


def _twist(arr: torch.Tensor, wt: torch.Tensor,
           mod: mont.Modulus) -> torch.Tensor:
    """W * arr: row i of (m, B, 16) times the Montgomery twist wt[i] ((m, 1,
    16)), over column chunks."""
    return map_columns(lambda x: mont.mont_mul(x, wt, mod), arr)


def _gauss_jordan_df(A: torch.Tensor, R: torch.Tensor, mod: mont.Modulus,
                     chunk: int = CHUNK_ELEMS):
    """Division-free Gauss-Jordan over the rows of A (nrows, e, 16) with
    batched right-hand sides R (nrows, B, 16), canonical standard-form
    residues.

    Per pivot column k: the first still-unused row with a nonzero entry is
    the pivot row p; every other row r becomes
        row_r <- a_pk * row_r - a_rk * row_p
    (cross-multiplication, no inverses; pivoted columns stay zero in every
    row but their pivot's). The rows update in chunks of at most `chunk`
    elements. Returns (A', R', pivot row per column); a column with no
    available nonzero entry gets -1 (singular)."""
    nrows, e = A.shape[0], A.shape[1]
    A, R = A.clone(), R.clone()
    dev = A.device
    idx = torch.arange(nrows, device=dev)
    used = torch.zeros(nrows, dtype=torch.bool, device=dev)
    step = max(1, chunk // (A.shape[1] + R.shape[1]))
    pivots = []
    for k in range(e):
        nz = ~mont.is_zero(A[:, k]) & ~used
        pr = int(torch.where(nz, idx, nrows).min())
        if pr == nrows:
            pivots.append(-1)
            continue
        a_pk = A[pr, k].clone()
        prow_A, prow_R = A[pr].clone(), R[pr].clone()
        a_rk = A[:, k].clone()
        for r0 in range(0, nrows, step):
            r1 = min(nrows, r0 + step)
            ak = a_rk[r0:r1, None]
            for X, prow in ((A, prow_A), (R, prow_R)):
                blk = X[r0:r1]
                new = mont.sub_mod(mont.mont_mul(blk, a_pk, mod),
                                   mont.mont_mul(prow, ak, mod), mod)
                if r0 <= pr < r1:
                    new[pr - r0] = blk[pr - r0]
                X[r0:r1] = new
        used[pr] = True
        pivots.append(pr)
    return A, R, pivots


def recover_level_tensors(ctx: engine.NttContext, write_times,
                          X: torch.Tensor, Y: torch.Tensor, erased,
                          mod: mont.Modulus | None = None,
                          slack: int = 64) -> torch.Tensor:
    """Recover a level's m blocks from its codeword halves X and Y ((m, C,
    16) canonical residues of `mod`, default mod p, on one device), where
    the global columns in `erased` (0..m-1 the X half, m..2m-1 the Y half)
    are lost: their values are never read. Returns the (m, C, 16) blocks.
    Raises ValueError on singular erasure patterns."""
    if mod is None:
        mod = ctx.mod_p
    m = len(write_times)
    dev = X.device
    erased = set(erased)
    E = sorted(j for j in erased if j < m)
    Sy = [j for j in range(m) if m + j not in erased]
    e = len(E)
    if e > len(Sy):
        raise ValueError(
            f"unrecoverable: {e} X columns erased but only {len(Sy)} "
            f"Y columns survive (need one Y constraint per X erasure)")
    with _span("icc.host", dev):
        itabs = _stage_twiddles(ctx, m, mod, inverse=True)
        wt = L.to_torch(_wt_mont(ctx, write_times, mod), dev).reshape(
            m, 1, L.NLIMBS)
    u = X.clone()
    u[E] = 0                                        # u~
    if e:
        # operator columns for the erased positions and M(u~): one pass
        ops = torch.zeros((m, e + X.shape[1], L.NLIMBS), dtype=L.DTYPE,
                          device=dev)
        ops[E, list(range(e)), 0] = 1
        ops[:, e:] = u
        with _span("icc.unfold", dev):
            ops = _unfold_dev(ops, itabs, mod)
        with _span("icc.twist", dev):
            ops = _twist(ops, wt, mod)
        with _span("icc.fold", dev):
            ops = _fold_dev(ctx, ops, mod)
        A_full, r_full = ops[:, :e], ops[:, e:]
        # reduced rows: the first e + slack surviving Y rows, then all of
        # them if those are singular
        for rows in dict.fromkeys((min(len(Sy), e + slack), len(Sy))):
            sel = torch.tensor(Sy[:rows], device=dev)
            with _span("icc.solve", dev):
                rhs = mont.sub_mod(Y[sel], r_full[sel], mod)
                A2, R2, piv = _gauss_jordan_df(A_full[sel], rhs, mod)
            if min(piv) >= 0:
                break
        if min(piv) < 0:
            raise ValueError(SINGULAR)
        del ops, A_full, r_full
        # delta_k = R2[piv_k] / A2[piv_k, k]: exact inverses on the host
        with _span("icc.host", dev):
            pv = torch.tensor(piv, device=dev)
            diag = L.tensor_to_ints(A2[pv, torch.arange(e, device=dev)])
            inv = L.ints_to_tensor(
                [mod.to_mont_int(pow(d, -1, mod.n)) for d in diag], dev)
        with _span("icc.solve", dev):
            u[E] = mont.mont_mul(R2[pv], inv[:, None], mod)
    with _span("icc.unfold", dev):
        return _unfold_dev(u, itabs, mod)


def recover_level_device(ctx: engine.NttContext, write_times,
                         surviving: dict[int, list[int]],
                         mod: mont.Modulus | None = None,
                         slack: int = 64, device="cuda"):
    """Recovery of a level's m blocks from surviving codeword columns, on
    `device` (the card by default; it raises without one). The contract of
    icc.recover_level: keys 0..m-1 are the X half, m..2m-1 the Y half;
    values are chunk residue lists. Returns m rows of chunk values (ints mod
    `mod.n`, default mod p). Raises ValueError on singular erasure patterns
    (the host path's diagnosis: e.g. paired X/Y columns of an epoch-CRebuild
    level under the reference's non-MDS generator)."""
    dev = native.resolve_device(device)
    if mod is None:
        mod = ctx.mod_p
    m = len(write_times)
    nchunks = len(next(iter(surviving.values())))
    halves = np.zeros((2, m, nchunks, L.NLIMBS), np.uint32)
    for j, vals in surviving.items():
        halves[j // m, j % m] = L.ints_to_limbs([v % mod.n for v in vals])
    X, Y = L.to_torch(halves, dev)
    erased = [j for j in range(2 * m) if j not in surviving]
    blocks = L.tensor_to_ints(recover_level_tensors(
        ctx, write_times, X, Y, erased, mod, slack))
    return [blocks[i * nchunks:(i + 1) * nchunks] for i in range(m)]
