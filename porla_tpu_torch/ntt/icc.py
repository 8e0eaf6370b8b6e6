"""ICC erasure-code recovery: rebuild data from surviving codeword columns.

The reference demonstrates decode only in its MATLAB golden model
(icc/main.m: encode with G = [F_l, D_lt*F_l], delete 2^l random columns,
recover the surviving system); the C++ server never decodes. Here
recovery is a first-class capability.

Structure note (faithful to the reference C++): a hierarchical-log level
l built incrementally holds X = T_l(B_0..B_{m-1}) and
Y = T_l(diag(w^bitrev(t_i)) * B), where t_i is block i's write step
(HAdd applies the per-write twist, Server.hpp:1391-1425, before the mix
folds) — the time-varying diagonal is what makes the 2m columns
redundant (the MATLAB D_lt with t+i-1). At an epoch CRebuild the twist
is the SAME scalar for every block (wt = w^bitrev(write_step), CRebuild
at Server.hpp:1494), so there Y = wt*X and protection relies on the X
half alone. Recovery therefore takes per-block write times.

Everything is exact: the level transform is a linear map over Z_p, so
any full-rank m-subset of surviving columns yields the data by Gaussian
elimination mod p. This module is the golden host solve in Python ints
(the same function as `porla_tpu/ntt/icc.py`); `icc_device` is the
structured solve on tensors that runs on the card.
"""

from __future__ import annotations


from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.ntt import engine

P = C.FFT_PRIME


def fold_transform(ctx: engine.NttContext, values: list[int]) -> list[int]:
    """The level fold of `m` values (the mix chain, reference
    Client.hpp:921-976): stage lengths 1..m/2 with twiddles
    v = w^(n/length), exactly the reference's butterfly order. Exact
    Python ints mod p."""
    m = len(values)
    x = [v % P for v in values]
    length = 1
    while length < m:
        v = pow(ctx.w, ctx.n // length, P)
        out = [0] * m
        for blk in range(0, m, 2 * length):
            for i in range(length):
                vi = pow(v, i, P)
                t = (vi * x[blk + length + i]) % P
                out[blk + i] = (x[blk + i] + t) % P
                out[blk + length + i] = (x[blk + i] - t) % P
        x = out
        length <<= 1
    return x


def level_generator_matrix(ctx: engine.NttContext,
                           write_times: list[int]) -> list[list[int]]:
    """(m, 2m) generator of a level built from blocks written at
    `write_times`: columns = [fold(basis_i) | fold(wt_i * basis_i)]."""
    m = len(write_times)
    G = []
    for i in range(m):
        basis = [0] * m
        basis[i] = 1
        x = fold_transform(ctx, basis)
        wt = pow(ctx.w,
                 engine.reverse_bits(write_times[i] % ctx.n, ctx.height - 1),
                 P)
        basis_y = [0] * m
        basis_y[i] = wt
        y = fold_transform(ctx, basis_y)
        G.append(x + y)
    return G


def _solve_mod_p(A_cols: list[list[int]], rhs: list[list[int]]):
    """Solve sum_i U[i]*A_cols[i][j] = rhs[k][j] for U, per rhs k."""
    n = len(A_cols)
    M = [[A_cols[i][j] for i in range(n)] for j in range(n)]
    B = [list(col) for col in rhs]
    nrhs = len(B)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if M[r][col] % P:
                piv = r
                break
        if piv is None:
            raise ValueError(
                "surviving column set is singular — this erasure pattern "
                "is unrecoverable (e.g. paired X/Y columns of an "
                "epoch-CRebuild level, which are scalar multiples)")
        if piv != col:
            M[col], M[piv] = M[piv], M[col]
            for k in range(nrhs):
                B[k][col], B[k][piv] = B[k][piv], B[k][col]
        inv = pow(M[col][col], -1, P)
        M[col] = [(v * inv) % P for v in M[col]]
        for k in range(nrhs):
            B[k][col] = (B[k][col] * inv) % P
        for r in range(n):
            if r != col and M[r][col]:
                f = M[r][col]
                M[r] = [(M[r][c] - f * M[col][c]) % P for c in range(n)]
                for k in range(nrhs):
                    B[k][r] = (B[k][r] - f * B[k][col]) % P
    return B


def recover_level(ctx: engine.NttContext, write_times: list[int],
                  surviving: dict[int, list[int]]) -> list[list[int]]:
    """Recover the m blocks of a level from >= m surviving columns.

    surviving: global column index (0..2m-1: X half then Y half) ->
    chunk values (mod p). Returns m rows of chunk values (the blocks as
    inserted, mod p)."""
    m = len(write_times)
    cols = sorted(surviving)[:m]
    assert len(cols) == m, f"need {m} surviving columns, have {len(cols)}"
    G = level_generator_matrix(ctx, write_times)
    A = [[G[i][j] for j in cols] for i in range(m)]
    nchunks = len(surviving[cols[0]])
    rhs = [[surviving[j][c] % P for j in cols] for c in range(nchunks)]
    solved = _solve_mod_p(A, rhs)
    return [[solved[c][i] for c in range(nchunks)] for i in range(m)]
