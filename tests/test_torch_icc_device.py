"""ICC recovery's tensor path (`porla_tpu_torch.ntt.icc_device`, its plain
versions on the CPU) against the reference package's
(`porla_tpu.ntt.icc_device`) on the same numpy inputs, case for case as
tests/test_icc_device.py, and against the exact host solve and the blocks
themselves: the fold / unfold, the stage twiddles, the division-free
Gauss-Jordan, recovery in the p lane, secp256k1's n lane and BN254's r lane,
hardened and reference modes, singular patterns, the slack retry, the dict
and tensor forms, K1's fold (`cuda_stage.fold_lane`) at m < n and its
twiddle rows, and the `icc_recover` tool. Tolerance: zero."""

import json
import random

import numpy as np
import pytest
import torch

from porla_tpu.fields import limbs as JL
from porla_tpu.ntt import engine as jeng
from porla_tpu.ntt import icc as jicc
from porla_tpu.ntt import icc_device as jdev
from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.ntt import cuda_stage, engine, icc, icc_device
from porla_tpu_torch.tools import icc_recover

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

P = C.FFT_PRIME


def _contexts(n, hardened=True, scheme="ipa"):
    return (engine.NttContext(n, scheme, hardened=hardened),
            jeng.NttContext(n, scheme, hardened=hardened))


def _jmod(jctx, mod):
    return jeng._MOD_P if mod.n == P else jctx.mod_q


def _exact_fold(ctx, values, modulus):
    """The level fold in exact ints mod `modulus`, with the lane's twiddles
    (v^i mod p) mod modulus."""
    m = len(values)
    x = [v % modulus for v in values]
    length = 1
    while length < m:
        v = pow(ctx.w, ctx.n // length, P)
        out = [0] * m
        for blk in range(0, m, 2 * length):
            for i in range(length):
                t = (pow(v, i, P) % modulus) * x[blk + length + i] % modulus
                out[blk + i] = (x[blk + i] + t) % modulus
                out[blk + length + i] = (x[blk + i] - t) % modulus
        x = out
        length <<= 1
    return x


def _codeword(ctx, write_times, blocks, modulus=P):
    """[X | Y] columns (global index -> chunk list) of a level holding
    `blocks` written at `write_times`, in exact ints."""
    m = len(write_times)
    nch = len(blocks[0])
    cols = {j: [] for j in range(2 * m)}
    for c in range(nch):
        col = [blocks[i][c] % modulus for i in range(m)]
        wt = [pow(ctx.w, engine.reverse_bits(write_times[i] % ctx.n,
                                             ctx.height - 1), P)
              % modulus * col[i] % modulus for i in range(m)]
        for j, v in enumerate(_exact_fold(ctx, col, modulus)
                              + _exact_fold(ctx, wt, modulus)):
            cols[j].append(v)
    return cols


def _random_case(rng, ctx, m, n_erase, nch=3, modulus=P):
    write_times = [rng.randrange(ctx.n) for _ in range(m)]
    blocks = [[rng.randrange(modulus) for _ in range(nch)] for _ in range(m)]
    cols = _codeword(ctx, write_times, blocks, modulus)
    erased = rng.sample(range(2 * m), n_erase)
    return write_times, blocks, {j: v for j, v in cols.items()
                                 if j not in erased}


def _recover_both(ctx, jctx, wt, surviving, mod=None, slack=64, xp=np):
    """The port's recover_level_device on the CPU, after checking that the
    reference's (on numpy, or with xp=None its default jnp) returns the
    same."""
    got = icc_device.recover_level_device(ctx, wt, surviving, mod=mod,
                                          slack=slack, device="cpu")
    want = jdev.recover_level_device(
        jctx, wt, surviving, mod=None if mod is None else _jmod(jctx, mod),
        slack=slack, **({} if xp is None else {"xp": xp}))
    assert got == want
    return got


def test_fold_unfold_roundtrip():
    """Both packages' fold and unfold on one input, the reference on its
    default jnp; the fold equals the exact host fold, the unfold inverts."""
    import jax.numpy as jnp
    rng = random.Random(1)
    ctx, jctx = _contexts(64)
    m = 16
    mod = ctx.mod_p
    vals = [[rng.randrange(P) for _ in range(2)] for _ in range(m)]
    arr = np.stack([JL.ints_to_limbs(v) for v in vals])
    tabs = jdev._stage_twiddles(jctx, m, jeng._MOD_P, inverse=False)
    itabs = jdev._stage_twiddles(jctx, m, jeng._MOD_P, inverse=True)
    jf = np.asarray(jdev._fold_dev(jnp, jnp.asarray(arr), tabs, jeng._MOD_P))
    f = icc_device._fold_dev(ctx, L.to_torch(arr), mod)
    assert np.array_equal(L.to_numpy(f), jf)
    for c in range(2):
        assert L.tensor_to_ints(f[:, c]) == icc.fold_transform(
            ctx, [vals[i][c] for i in range(m)])
    b = icc_device._unfold_dev(f, icc_device._stage_twiddles(
        ctx, m, mod, inverse=True), mod)
    jb = np.asarray(jdev._unfold_dev(jnp, jnp.asarray(jf), itabs,
                                     jeng._MOD_P))
    assert np.array_equal(L.to_numpy(b), jb)
    assert np.array_equal(jb, arr)


@pytest.mark.parametrize("scheme,hardened", [
    ("ipa", False), ("ipa", True), ("kzg", False), ("kzg", True)])
def test_tables_match_reference(scheme, hardened):
    """_stage_twiddles (forward and inverse), _inv2_mont and _wt_mont in
    both lanes: the same limbs as the reference's; the hardened flag
    carries into every table."""
    ctx, jctx = _contexts(128, hardened, scheme)
    wts = [0, 1, 5, 127, 128, 1000]
    for mod in (ctx.mod_p, ctx.mod_q):
        jmod = _jmod(jctx, mod)
        for inverse in (False, True):
            got = icc_device._stage_twiddles(ctx, 64, mod, inverse)
            want = jdev._stage_twiddles(jctx, 64, jmod, inverse)
            assert len(got) == len(want) == 6
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert np.array_equal(icc_device._inv2_mont(mod),
                              jdev._inv2_mont(jmod))
        assert np.array_equal(icc_device._wt_mont(ctx, wts, mod),
                              jdev._wt_mont(jctx, wts, jmod))
    other = engine.NttContext(128, scheme, hardened=not hardened)
    assert not np.array_equal(icc_device._wt_mont(other, wts, ctx.mod_p),
                              icc_device._wt_mont(ctx, wts, ctx.mod_p))


@pytest.mark.parametrize("m", [2, 16, 64])
def test_fold_lane_below_n_matches_reference(m):
    """K1's fold over m < n rows: its plain version (and the CPU dispatch
    of `fold_lane`) against the reference's `_fold_dev` in both lanes, and
    the rows m2 - 1 + j of the n-row packed table that K1 reads are the
    level fold's twiddles."""
    ctx, jctx = _contexts(256, hardened=False)
    rng = random.Random(m)
    for lane, mod in (("p", ctx.mod_p), ("q", ctx.mod_q)):
        jmod = _jmod(jctx, mod)
        vals = [rng.randrange(mod.n) for _ in range(m * 3)]
        arr = JL.ints_to_limbs(vals).reshape(m, 3, 16)
        want = jdev._fold_dev(np, arr, jdev._stage_twiddles(
            jctx, m, jmod, inverse=False), jmod)
        a = L.to_torch(arr)
        plain = cuda_stage.fold_lane_plain(ctx, a, mod, lane)
        assert np.array_equal(L.to_numpy(plain), want)
        assert torch.equal(cuda_stage.fold_lane(ctx, a, mod, lane), plain)
        table = ctx.stage_table(lane, "cpu").to(torch.int64) & 0xFFFFFFFF
        limbs = torch.stack([table & 0xFFFF, table >> 16], -1).reshape(-1, 16)
        for s, tw in enumerate(icc_device._stage_twiddles(ctx, m, mod,
                                                          False)):
            m2 = 1 << s
            assert np.array_equal(L.to_numpy(limbs[m2 - 1:2 * m2 - 1]), tw)
    for bad in (3, 512):
        with pytest.raises(ValueError):
            cuda_stage.fold_lane(ctx, L.zeros_t((bad, 1)), ctx.mod_p, "p")


@pytest.mark.parametrize("chunk", [icc_device.CHUNK_ELEMS, 7])
def test_gauss_jordan_matches_reference(chunk):
    """The division-free elimination, rows updated in chunks (7 elements:
    one row at a time), against the reference's on the same rows: the same
    A', R' and pivots, a singular column included."""
    rng = random.Random(5)
    mod = engine.MOD_P
    nrows, e, nb = 6, 4, 3
    a = [[rng.randrange(P) for _ in range(e)] for _ in range(nrows)]
    for r in a:
        r[2] = 0                     # column 2 has no pivot
    A = JL.ints_to_limbs(sum(a, [])).reshape(nrows, e, 16)
    R = JL.ints_to_limbs([rng.randrange(P) for _ in range(nrows * nb)]
                         ).reshape(nrows, nb, 16)
    A2, R2, piv = icc_device._gauss_jordan_df(L.to_torch(A), L.to_torch(R),
                                              mod, chunk)
    jA2, jR2, jpiv = jdev._gauss_jordan_df(np, A, R, jeng._MOD_P)
    assert piv == [int(p) for p in jpiv] and piv[2] == -1
    assert np.array_equal(L.to_numpy(A2), jA2)
    assert np.array_equal(L.to_numpy(R2), jR2)


def test_unfold_in_chunks():
    """The unfold and map_columns give the same limbs whatever the column
    chunk."""
    rng = np.random.default_rng(6)
    ctx = engine.NttContext(64, "ipa", hardened=True)
    m, mod = 32, ctx.mod_q
    vals = [int(v) % mod.n for v in rng.integers(0, 1 << 62, m * 5)]
    a = L.ints_to_tensor(vals).reshape(m, 5, 16)
    itabs = icc_device._stage_twiddles(ctx, m, mod, True)
    whole = icc_device._unfold_dev(a, itabs, mod)
    assert torch.equal(icc_device._unfold_dev(a, itabs, mod, chunk=m), whole)
    assert torch.equal(icc_device._unfold_dev(a, itabs, mod, chunk=3 * m),
                       whole)
    assert torch.equal(icc_device.map_columns(lambda x: x + 1, a, m), a + 1)


@pytest.mark.parametrize("m,n_erase", [(8, 4), (16, 9), (16, 16)])
def test_recover_matches_host(m, n_erase):
    rng = random.Random(m * 100 + n_erase)
    ctx, jctx = _contexts(64)
    wt, blocks, surviving = _random_case(rng, ctx, m, n_erase)
    # the reference on its default jnp in the first case
    got = _recover_both(ctx, jctx, wt, surviving,
                        xp=None if m == 8 else np)
    assert got == icc.recover_level(ctx, wt, surviving)
    assert got == [[v % P for v in b] for b in blocks]


def test_recover_mixed_xy_erasures():
    """X and Y of blocks 0..3 and X of 4..7 erased: 12 <= m columns."""
    rng = random.Random(7)
    ctx, jctx = _contexts(64)
    m = 16
    wt = [rng.randrange(ctx.n) for _ in range(m)]
    blocks = [[rng.randrange(P)] for _ in range(m)]
    cols = _codeword(ctx, wt, blocks)
    erased = set(range(4)) | {m + j for j in range(4)} | set(range(4, 8))
    surviving = {j: v for j, v in cols.items() if j not in erased}
    assert _recover_both(ctx, jctx, wt, surviving) == blocks


def test_unrecoverable_epoch_pairs():
    """An epoch-CRebuild level (all write times equal) has Y = wt*X:
    erasing the pair (j, m+j) is singular, in both packages; erasing more
    X columns than Y columns survive is refused before any work."""
    rng = random.Random(9)
    ctx, jctx = _contexts(64)
    m = 8
    wt = [5] * m
    blocks = [[rng.randrange(P)] for _ in range(m)]
    cols = _codeword(ctx, wt, blocks)
    surviving = {j: v for j, v in cols.items() if j not in (0, m)}
    with pytest.raises(ValueError, match="singular"):
        icc_device.recover_level_device(ctx, wt, surviving, device="cpu")
    with pytest.raises(ValueError, match="singular"):
        jdev.recover_level_device(jctx, wt, surviving, xp=np)
    surviving = {j: v for j, v in cols.items() if j in (0, 1, 2, m, m + 1)}
    with pytest.raises(ValueError, match="unrecoverable: 5 X columns"):
        icc_device.recover_level_device(ctx, wt, surviving, device="cpu")


def test_slack_retry():
    """An epoch level with X 5 and 6 erased and slack 0: the first e
    surviving Y rows (0 and 1) are singular, the retry on all rows
    recovers, as in the reference."""
    rng = random.Random(10)
    ctx, jctx = _contexts(64, hardened=False)
    m = 8
    wt = [3] * m
    blocks = [[rng.randrange(P) for _ in range(2)] for _ in range(m)]
    cols = _codeword(ctx, wt, blocks)
    surviving = {j: v for j, v in cols.items() if j not in (5, 6)}
    # the first subset alone: rows 0 and 1 of A = wt * I at columns 5, 6
    X = L.ints_to_tensor([v for j in range(m) for v in cols[j]]).reshape(
        m, 2, 16)
    first = icc_device._unfold_dev(
        torch.zeros(m, 2, 16, dtype=torch.int64).index_put_(
            (torch.tensor([5, 6]), torch.tensor([0, 1]), torch.tensor(0)),
            torch.tensor(1)),
        icc_device._stage_twiddles(ctx, m, ctx.mod_p, True), ctx.mod_p)
    A = icc_device._fold_dev(ctx, icc_device._twist(first, L.to_torch(
        icc_device._wt_mont(ctx, wt, ctx.mod_p)).reshape(m, 1, 16),
        ctx.mod_p), ctx.mod_p)
    assert min(icc_device._gauss_jordan_df(A[:2], X[:2], ctx.mod_p)[2]) < 0
    assert _recover_both(ctx, jctx, wt, surviving, slack=0) == blocks


def test_recover_q_lane_crt():
    """Both CRT lanes recover with the same code path; combined they give
    the full block values mod p * q."""
    rng = random.Random(11)
    ctx, jctx = _contexts(64)
    mod_q = ctx.mod_q
    m = 8
    wt = [rng.randrange(ctx.n) for _ in range(m)]
    full = [[rng.randrange(1 << 256)] for _ in range(m)]
    erased = {1, 3, m + 5}
    rec = {}
    for mod in (ctx.mod_p, mod_q):
        cols = _codeword(ctx, wt, full, mod.n)
        rec[mod.n] = _recover_both(
            ctx, jctx, wt, {j: v for j, v in cols.items() if j not in erased},
            mod=None if mod.n == P else mod)
    inv = pow(P, -1, mod_q.n)
    for i in range(m):
        a, b = rec[P][i][0], rec[mod_q.n][i][0]
        assert a + ((b - a) * inv % mod_q.n) * P == full[i][0]


def test_recover_bn254_r_lane():
    """BN254's r lane (the KZG scheme's q lane): recovery equals the
    reference's and the blocks."""
    rng = random.Random(12)
    ctx, jctx = _contexts(64, scheme="kzg")
    r = ctx.mod_q
    wt, blocks, surviving = _random_case(rng, ctx, 16, 12, nch=2,
                                         modulus=r.n)
    assert _recover_both(ctx, jctx, wt, surviving, mod=r) == blocks
    with pytest.raises(ValueError, match="neither CRT lane"):
        icc_device.recover_level_device(ctx, wt, surviving,
                                        mod=engine.MOD_SECP_N, device="cpu")


@pytest.mark.parametrize("hardened", [False, True])
def test_dict_and_tensor_forms_agree(hardened):
    """recover_level_device (ints) and recover_level_tensors (limb
    tensors, erased columns never read) give the same blocks in both modes,
    as the reference does, and both raise on an epoch level's erased pair."""
    ctx, jctx = _contexts(32, hardened)
    m = 16

    def halves(cols, erased):
        return [L.ints_to_tensor(
            [v if h * m + i not in erased else P - 1
             for i in range(m) for v in cols[h * m + i]]).reshape(m, 2, 16)
            for h in (0, 1)]
    for seed in range(3):
        rng = random.Random(100 + seed)
        wt = [rng.randrange(ctx.n) for _ in range(m)]
        blocks = [[rng.randrange(P) for _ in range(2)] for _ in range(m)]
        cols = _codeword(ctx, wt, blocks)
        erased = set(rng.sample(range(2 * m), 10))
        surviving = {j: v for j, v in cols.items() if j not in erased}
        got = _recover_both(ctx, jctx, wt, surviving)
        t = icc_device.recover_level_tensors(ctx, wt, *halves(cols, erased),
                                             erased)
        assert L.tensor_to_ints(t) == sum(got, []) and got == blocks
    cols = _codeword(ctx, [7] * m, blocks)
    with pytest.raises(ValueError, match="singular"):
        icc_device.recover_level_tensors(ctx, [7] * m, *halves(cols, {3, m + 3}),
                                         {3, m + 3})
    with pytest.raises(ValueError, match="singular"):
        icc_device.recover_level_device(
            ctx, [7] * m, {j: v for j, v in cols.items() if j not in
                           (3, m + 3)}, device="cpu")


def test_icc_recover_tool_on_cpu(tmp_path):
    out = tmp_path / "icc.json"
    rec = icc_recover.main(["--n", "64", "--erase", "16", "--chunks", "2",
                            "--q-lane", "--device", "cpu",
                            "--out", str(out)])
    assert json.loads(out.read_text()) == rec
    assert rec["m"] == 32 and rec["backend"] == "cpu"
    assert rec["recover_p_bitexact"] and rec["recover_q_bitexact"]
    assert all(k in rec for k in ("encode_p_s", "encode_q_s",
                                  "recover_p_s", "recover_q_s"))


def test_entry_points_take_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    ctx = engine.NttContext(16, "ipa", hardened=True)
    with pytest.raises(RuntimeError):
        icc_device.recover_level_device(ctx, [0] * 8, {0: [1]})
    with pytest.raises(RuntimeError):
        icc_recover.main(["--n", "16"])
