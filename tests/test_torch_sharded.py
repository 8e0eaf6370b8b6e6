"""The port's multi-device paths (porla_tpu_torch/parallel/sharded.py) on a
mesh of 4 CPU devices, against porla_tpu.parallel.sharded on the 4 virtual
CPU devices of conftest.py (tolerance: zero).

- the distributed NTT in both CRT lanes, limb for limb against the
  reference's `sharded_encode_fn` and its stage loop: n = 16 on a (2, 2)
  mesh (one exchange stage) and n = 64 on dp = 4 (two);
- the exchange stage's twiddles as K1 reads them from the packed table,
  row for row against the reference's `stage_twiddle_tables`;
- the point stage (local and exchange), the TP commitment, the DP MSM (32
  bits) and the sharded Pippenger MSM (16 bits, 64 points), as group
  elements against porla_tpu.golden.ecc: the reference's sharded curve
  functions take 50-160 s each to compile on the CPU, and its own tests
  hold them to the same golden model. The port's point butterflies give
  other Jacobian limbs than the reference's (ROADMAP Queue 3, item 2).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porla_tpu.fields import limbs as JL
from porla_tpu.golden import ecc as jecc
from porla_tpu.ntt import engine as jeng
from porla_tpu.parallel import sharded as jsharded
from porla_tpu_torch.crypto import testrand
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.instances import secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.ntt import cuda_stage
from porla_tpu_torch.ntt.engine import MOD_P, NttContext
from porla_tpu_torch.parallel import sharded

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

CPU = torch.device("cpu")
NBITS = 32
CV = jecc.SECP256K1


def jax_mesh(tp):
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices (see conftest.py)")
    return jsharded.make_mesh(devs[:4], tp=tp)


def lane_values(rng, mod, shape):
    vals = [rng.randrange(mod.n) for _ in range(int(np.prod(shape)))]
    return JL.ints_to_limbs(vals).reshape(shape + (16,))


@pytest.mark.parametrize("n,tp", [(16, 2), (64, 1)], ids=["n16-2x2",
                                                          "n64-4x1"])
@pytest.mark.parametrize("lane", ["p", "q"])
def test_encode_matches_reference(n, tp, lane):
    jctx, ctx = jeng.NttContext(n, "ipa"), NttContext(n, "ipa")
    jmod = jctx.mod_p if lane == "p" else jctx.mod_q
    mod = MOD_P if lane == "p" else ctx.mod_q
    arr = lane_values(random.Random(n), jmod, (n, 4))
    jm = jax_mesh(tp)
    tables = [jnp.asarray(t) for t in jsharded.stage_twiddle_tables(jctx,
                                                                  jmod)]
    want = np.asarray(jsharded.sharded_encode_fn(jctx, jm, jmod)(arr, *tables))
    golden = jeng.encode_stages(np, jctx, jeng.CrtArray(arr, arr))
    assert np.array_equal(want, golden.p if lane == "p" else golden.q)

    mesh = sharded.make_mesh([CPU] * 4, tp=tp)
    assert mesh.shape == dict(jm.shape)
    n_loc = n // mesh.dp
    assert ctx.height - n_loc.bit_length() == (1 if n == 16 else 2)
    got = sharded.gather(mesh, sharded.sharded_encode_fn(ctx, mesh, mod)(
        L.to_torch(arr)), CPU)
    assert np.array_equal(L.to_numpy(got), want)


@pytest.mark.parametrize("lane", ["p", "q"])
def test_twiddle_tables_match_reference(lane):
    """The rows each exchange pair of n = 64 on dp = 4 reads from the packed
    K1 table (`cuda_stage.exchange_rows`, at j0 = k * n_loc mod m2 for the
    pair's lower shard k) are the reference's per-stage table rows
    (`stage_twiddle_tables`) of both shards; the standard-form tables of
    the point stages are the reference's."""
    n, dp = 64, 4
    n_loc = n // dp
    jctx, ctx = jeng.NttContext(n, "ipa"), NttContext(n, "ipa")
    jmod = jctx.mod_p if lane == "p" else jctx.mod_q
    jt = jsharded.stage_twiddle_tables(jctx, jmod)
    for a, b in zip(sharded.stage_twiddle_tables_std(ctx),
                    jsharded.stage_twiddle_tables_std(jctx)):
        assert np.array_equal(L.to_numpy(a), b)
    pairs = 0
    for s in range(n_loc.bit_length(), jctx.height):
        m2 = 1 << (s - 1)
        shift = m2 // n_loc
        for k in range(dp):
            if k & shift:
                continue
            rows = L.to_numpy(cuda_stage.exchange_rows(
                ctx, lane, m2, k * n_loc % m2, n_loc))
            for shard in (k, k ^ shift):
                assert np.array_equal(
                    rows, jt[s - 1][shard * n_loc:(shard + 1) * n_loc])
            pairs += 1
    assert pairs == 4


def test_pair_stage_matches_stage_loop():
    """`pair_stage` on shards 1 and 3 of dp = 4 at n = 64, stage 6 (m2 = 32),
    is the stage loop's stage on those rows."""
    ctx = NttContext(64, "ipa")
    a = L.to_torch(lane_values(random.Random(5), MOD_P, (64, 2)))
    m2 = 32
    full = cuda_stage.stage_plain(
        a, L.to_torch(ctx.twiddles(m2).mont_p), m2, MOD_P)
    hi, lo = cuda_stage.pair_stage(ctx, a[16:32], a[48:64], MOD_P, "p", m2,
                                   16)
    assert torch.equal(hi, full[16:32]) and torch.equal(lo, full[48:64])
    with pytest.raises(ValueError):
        cuda_stage.pair_stage(ctx, a[16:32], a[48:64], MOD_P, "p", m2, 17)


def golden_points(rng, count):
    return [jecc.mul(CV, CV.g, rng.randrange(1, 1 << 20) + 2)
            for _ in range(count)]


@pytest.mark.parametrize("s", [1, 2, 3], ids=["local1", "local2",
                                              "exchange3"])
def test_point_stage_matches_golden(s):
    """n = 8 on the (2, 2) mesh: stages 1-2 local (m <= n_loc = 4), stage 3
    an exchange, each at 32-bit twiddles (the table's high limbs zeroed,
    as the reference's test does), through K7's plain version."""
    ops = secp256k1()
    n = 8
    ctx = NttContext(n, "ipa")
    rng = random.Random(5 + s)
    aff = golden_points(rng, n)
    pts = ops.from_affine(aff)
    mesh = sharded.make_mesh([CPU] * 4)
    tw = sharded.stage_twiddle_tables_std(ctx)[s - 1].clone()
    tw[:, NBITS // 16:] = 0
    fn = sharded.sharded_point_stage_fn(ctx, mesh, ops, nbits=NBITS)[s]
    planes = fn([sharded.stage(mesh, pts)], sharded.stage(mesh, tw))
    got = ops.to_affine(sharded.gather(mesh, planes[0], CPU))
    m, m2 = 1 << s, 1 << (s - 1)
    want = [None] * n
    for blk in range(n // m):
        for j in range(m2):
            iu, it = blk * m + j, blk * m + m2 + j
            t = jecc.mul(CV, aff[it], L.tensor_to_ints(tw[iu])[0])
            want[iu] = jecc.add(CV, aff[iu], t)
            want[it] = jecc.add(CV, aff[iu], jecc.neg(CV, t))
    assert got == want


def test_commit_matches_golden(monkeypatch):
    """TP commitments: 4 generators over tp = 2, 4 blocks over dp = 2, over
    the table of the generators that the caller owns; the per-shard tables
    are views of it made once, so neither call builds a table."""
    ops = secp256k1()
    nchunks, nblocks = 4, 4
    gens_aff, _ = testrand.derive_ipa_generators(nchunks)
    table = cuda_curve.build_fb_table(ops, gens_aff, nbits=NBITS)
    rng = np.random.default_rng(7)
    sc = rng.integers(0, 1 << 16, (nblocks, nchunks, 16), dtype=np.uint32)
    mesh = sharded.make_mesh([CPU] * 4)
    fn = sharded.sharded_commit_fn(mesh, table)
    builds = []
    monkeypatch.setattr(cuda_curve, "build_fb_table",
                        lambda *a, **k: builds.append(a))
    for _ in range(2):
        got = ops.to_affine(sharded.gather(mesh, fn(L.to_torch(sc)), CPU))
        for b in range(nblocks):
            ks = [JL.limbs_to_int(sc[b, c]) & ((1 << NBITS) - 1)
                  for c in range(nchunks)]
            assert got[b] == jecc.msm(CV, gens_aff, ks)
    assert builds == []


def test_msm_matches_golden():
    """DP MSM: 8 points over dp = 2, K2 per shard and the combine."""
    ops = secp256k1()
    rng = np.random.default_rng(9)
    aff = golden_points(random.Random(9), 8)
    sc = rng.integers(0, 1 << 16, (8, 16), dtype=np.uint32)
    mesh = sharded.make_mesh([CPU] * 4)
    fn = sharded.sharded_msm_fn(mesh, ops, nbits=NBITS)
    got = ops.to_affine(fn(ops.from_affine(aff), L.to_torch(sc)))[0]
    ks = [JL.limbs_to_int(sc[i]) & ((1 << NBITS) - 1) for i in range(8)]
    assert got == jecc.msm(CV, aff, ks)


@pytest.mark.parametrize("tp", [2, 1], ids=["dp2", "dp4"])
def test_pippenger_msm_matches_golden(tp):
    """The per-shard Pippenger (K5, K6 plain versions) at 16 bits and 64
    points, as the reference's fast test, on dp = 2 and dp = 4."""
    ops = secp256k1()
    rng = random.Random(12)
    base = golden_points(rng, 8)
    aff = [base[i % 8] for i in range(64)]
    ks = [rng.randrange(1 << 16) for _ in range(64)]
    mesh = sharded.make_mesh([CPU] * 4, tp=tp)
    fn, finish = sharded.sharded_pippenger_msm_fn(
        mesh, ops, nbits=16, n_local=64 // mesh.dp)
    totals = fn(ops.from_affine(aff), L.ints_to_tensor(ks))
    assert totals.x.shape == (5, 16)            # c = 4 at 16 bits: 5 windows
    assert ops.to_affine(finish(totals))[0] == jecc.msm(CV, aff, ks)


def test_mesh_layout():
    """make_mesh's default rule is the reference's (tp = 2 for an even
    count above 1); stage / gather round-trip rows and points; a mesh
    without devices needs a card."""
    for count, shape in ((4, (2, 2)), (2, (1, 2)), (3, (3, 1)), (1, (1, 1))):
        mesh = sharded.make_mesh([CPU] * count)
        assert (mesh.dp, mesh.tp) == shape
        assert dict(jsharded.make_mesh(jax.devices()[:count]).shape) == \
            mesh.shape
    mesh = sharded.make_mesh([CPU] * 4)
    a = torch.arange(8 * 16).reshape(8, 16)
    shards = sharded.stage(mesh, a)
    assert [s.shape[0] for s in shards] == [4, 4]
    assert sharded.stage(mesh, shards) is shards
    assert torch.equal(sharded.gather(mesh, shards, CPU), a)
    p = JacPoint(a, a + 1, a + 2)
    back = sharded.gather(mesh, sharded.stage(mesh, p), CPU)
    assert all(torch.equal(x, y) for x, y in zip(back, p))
    with pytest.raises(ValueError):
        sharded.stage(mesh, a[:7])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sharded.make_mesh()
