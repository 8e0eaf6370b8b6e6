"""ICC erasure recovery's host solve (`porla_tpu_torch.ntt.icc`) against
the reference package's (`porla_tpu.ntt.icc`), case for case as
tests/test_icc_recovery.py: encode a hierarchical-log level, erase columns,
recover exactly. Both packages run on the same seeds and must return the
same ints (tolerance: zero) and raise on the same singular patterns."""

import random

import pytest

from porla_tpu.ntt import engine as jeng
from porla_tpu.ntt import icc as jicc
from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.ntt import engine, icc

P = C.FFT_PRIME


def _contexts(n, hardened):
    return (engine.NttContext(n, "ipa", hardened=hardened),
            jeng.NttContext(n, "ipa", hardened=hardened))


def _level_codeword(ctx, data, write_times):
    """X = fold(B), Y = fold(wt_i * B_i) with the port's host fold."""
    x = icc.fold_transform(ctx, data)
    twisted = [
        (d * pow(ctx.w, engine.reverse_bits(t % ctx.n, ctx.height - 1), P))
        % P for d, t in zip(data, write_times)]
    return x + icc.fold_transform(ctx, twisted)


def _both(ctx, jctx, write_times, surviving):
    """Both packages' recover_level on one input: the port's result, after
    checking that the reference's is the same."""
    got = icc.recover_level(ctx, write_times, surviving)
    assert got == jicc.recover_level(jctx, write_times, surviving)
    return got


@pytest.mark.parametrize("m,hardened", [
    (1, True), (2, False), (8, True), (16, False), (32, True)])
def test_fold_transform_matches_reference(m, hardened):
    rng = random.Random(m)
    ctx, jctx = _contexts(64, hardened)
    vals = [rng.randrange(1 << 256) for _ in range(m)]
    assert icc.fold_transform(ctx, vals) == jicc.fold_transform(jctx, vals)


@pytest.mark.parametrize("hardened", [False, True])
def test_level_generator_matrix_matches_reference(hardened):
    rng = random.Random(3)
    ctx, jctx = _contexts(16, hardened)
    write_times = [rng.randrange(40) for _ in range(8)]
    G = icc.level_generator_matrix(ctx, write_times)
    assert G == jicc.level_generator_matrix(jctx, write_times)
    assert len(G) == 8 and all(len(row) == 16 for row in G)
    # row i is the level codeword of basis block i
    for i in range(8):
        basis = [int(k == i) for k in range(8)]
        assert G[i] == _level_codeword(ctx, basis, write_times)


def test_solve_mod_p_matches_reference():
    rng = random.Random(4)
    n = 6
    A = [[rng.randrange(P) for _ in range(n)] for _ in range(n)]
    rhs = [[rng.randrange(P) for _ in range(n)] for _ in range(3)]
    got = icc._solve_mod_p(A, rhs)
    assert got == jicc._solve_mod_p(A, rhs)
    for k in range(3):
        for j in range(n):
            assert sum(got[k][i] * A[i][j] for i in range(n)) % P == rhs[k][j]
    singular = [list(A[0]), list(A[0])] + A[2:]
    for solve in (icc._solve_mod_p, jicc._solve_mod_p):
        with pytest.raises(ValueError, match="singular"):
            solve(singular, rhs)


def test_recover_from_erasures():
    rng = random.Random(77)
    m = 8                       # level 3 of a 16-block database
    ctx, jctx = _contexts(16, True)
    write_times = list(range(8, 8 + m))
    data = [rng.randrange(P) for _ in range(m)]
    code = _level_codeword(ctx, data, write_times)
    for _ in range(5):
        erased = set(rng.sample(range(2 * m), m))
        surviving = {j: [code[j]] for j in range(2 * m) if j not in erased}
        assert [r[0] for r in _both(ctx, jctx, write_times, surviving)] \
            == data


def test_recover_multichunk():
    rng = random.Random(78)
    m, nchunks = 4, 3
    ctx, jctx = _contexts(8, True)
    write_times = [1, 2, 3, 4]
    data = [[rng.randrange(P) for _ in range(nchunks)] for _ in range(m)]
    codes = [_level_codeword(ctx, [data[i][c] for i in range(m)],
                             write_times) for c in range(nchunks)]
    keep = sorted(rng.sample(range(2 * m), m))
    surviving = {j: [codes[c][j] for c in range(nchunks)] for j in keep}
    assert _both(ctx, jctx, write_times, surviving) == data


def test_epoch_rebuild_pairs_are_singular():
    """At an epoch CRebuild every Y column is wt*X, so X_j/Y_j pairs cannot
    recover: both packages must say so; the X half alone recovers."""
    rng = random.Random(79)
    m = 8
    ctx, jctx = _contexts(8, False)
    write_times = [0] * m
    data = [rng.randrange(P) for _ in range(m)]
    code = _level_codeword(ctx, data, write_times)
    surviving = {j: [code[j]] for j in [0, 8, 1, 9, 2, 10, 3, 11]}
    for c, package in ((ctx, icc), (jctx, jicc)):
        with pytest.raises(ValueError, match="singular"):
            package.recover_level(c, write_times, surviving)
    surviving = {j: [code[j]] for j in range(m)}
    assert [r[0] for r in _both(ctx, jctx, write_times, surviving)] == data


def test_hardened_mode_is_mds():
    """Hardened (a true primitive root): every m-subset of the 2m columns
    recovers. The reference's generator: some subsets are singular, in
    both packages alike."""
    rng = random.Random(80)
    n, m = 16, 8
    write_times = list(range(8, 16))
    data = [rng.randrange(P) for _ in range(m)]

    ctx, jctx = _contexts(n, True)
    code = _level_codeword(ctx, data, write_times)
    for _ in range(20):
        keep = sorted(rng.sample(range(2 * m), m))
        rec = _both(ctx, jctx, write_times, {j: [code[j]] for j in keep})
        assert [r[0] for r in rec] == data, f"hardened not MDS at {keep}"

    ctx, jctx = _contexts(n, False)
    code = _level_codeword(ctx, data, write_times)
    failures = 0
    for _ in range(20):
        surviving = {j: [code[j]]
                     for j in sorted(rng.sample(range(2 * m), m))}
        try:
            rec = icc.recover_level(ctx, write_times, surviving)
        except ValueError:
            failures += 1
            with pytest.raises(ValueError, match="singular"):
                jicc.recover_level(jctx, write_times, surviving)
            continue
        assert rec == jicc.recover_level(jctx, write_times, surviving)
        assert [r[0] for r in rec] == data
    assert failures > 0, "expected singular subsets with the reference root"
