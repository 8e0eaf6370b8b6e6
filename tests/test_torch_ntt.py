"""K1's plain version and the port's NTT engine vs the reference package:
porla_tpu.ntt.engine.encode_stages (numpy) in both CRT lanes with
`hardened` off and on (the q lane mod secp256k1's n, and in the cases
whose id starts with `kzg` mod BN254's r), and one fused Pallas stage
(pallas_stage.butterfly_stage, interpret mode); K1's host side: its pass
plan and its packed twiddle table. Tolerance: zero."""

import os
import re

import random

import numpy as np
import pytest
import torch

from porla_tpu.fields import limbs as JL
from porla_tpu.ntt import engine as jeng
from porla_tpu.ntt import mxu, pallas_stage
from porla_tpu_torch import native
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.ntt import cuda_stage, engine
from porla_tpu_torch.protocol import compute

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.mark.parametrize("n,hardened,scheme", [
    pytest.param(n, h, "ipa", id=f"{n}-{h}")
    for n in (2, 16, 256) for h in (False, True)] + [
    pytest.param(n, False, "kzg", id=f"kzg-{n}-False") for n in (16, 256)])
def test_encode_matches_reference(n, hardened, scheme):
    rng = random.Random(n + hardened)
    C = 3
    jctx = jeng.NttContext(n, scheme, hardened=hardened)
    ctx = engine.NttContext(n, scheme, hardened=hardened)
    assert ctx.mod_q.n == jctx.mod_q.n
    vp = [rng.randrange(jctx.mod_p.n) for _ in range(n * C)]
    vq = [rng.randrange(jctx.mod_q.n) for _ in range(n * C)]
    ap = JL.ints_to_limbs(vp).reshape(n, C, 16)
    aq = JL.ints_to_limbs(vq).reshape(n, C, 16)
    want = jeng.encode_stages(np, jctx, jeng.CrtArray(ap, aq))
    arr = engine.CrtArray(L.to_torch(ap), L.to_torch(aq))
    # the K1 path on the CPU (the wrapper's plain version, the stage loop)
    got = compute.encode_crt(ctx.mod_q, ctx, arr)
    assert np.array_equal(L.to_numpy(got.p), want.p)
    assert np.array_equal(L.to_numpy(got.q), want.q)
    # and the plain full encode
    plain = engine.encode_stages(ctx, arr)
    assert torch.equal(plain.p, got.p) and torch.equal(plain.q, got.q)


def test_twiddles_match_reference():
    for hardened in (False, True):
        j = jeng.NttContext(64, "ipa", hardened=hardened)
        t = engine.NttContext(64, "ipa", hardened=hardened)
        for m2 in (1, 8, 32):
            for a, b in zip(j.twiddles(m2), t.twiddles(m2)):
                assert np.array_equal(a, b)
        for ws in (0, 5, 63):
            for a, b in zip(j.wt_scalar(ws), t.wt_scalar(ws)):
                assert np.array_equal(a, b)


def test_stage_matches_pallas_interpret():
    """One fused TPU stage kernel (interpret mode) vs K1's plain version,
    on the layout each expects: (m2, 32, B) byte digits vs (n, C, 16)
    limbs with the same pairs."""
    rng = random.Random(77)
    ctx = engine.NttContext(16, "ipa")
    m2, B = 2, 128
    for mod in (ctx.mod_p, ctx.mod_q):
        u_vals = [rng.randrange(mod.n) for _ in range(m2 * B)]
        t_vals = [rng.randrange(mod.n) for _ in range(m2 * B)]
        tw = [rng.randrange(mod.n) for _ in range(m2)]
        tw_m = [mod.to_mont_int(v) for v in tw]

        def digits(vals):
            a = mxu.digits_from_limbs(np, JL.ints_to_limbs(vals))
            return np.ascontiguousarray(np.moveaxis(a.reshape(m2, B, 32), -1, 1))

        mats = mxu.toeplitz8_mats(tw_m, 64)
        jmod = jeng.NttContext(16, "ipa").mod_p if mod is ctx.mod_p \
            else jeng.NttContext(16, "ipa").mod_q
        hi, lo = map(np.asarray, pallas_stage.butterfly_stage(
            digits(u_vals), digits(t_vals), mats, jmod, bt=128,
            interpret=True))

        def ints(d):  # (m2, 32, B) digits -> ints in (g, b) order
            lim = mxu.limbs_from_digits(np, np.moveaxis(d, 1, -1))
            return JL.limbs_to_ints(lim)

        # the same pairs as one K1 stage over (2*m2, B, 16): rows g are
        # the u halves, rows m2+g the t halves of group 0
        a = L.ints_to_tensor(u_vals + t_vals).reshape(2 * m2, B, 16)
        out = cuda_stage.ntt_stage(a, L.ints_to_tensor(tw_m), m2, mod)
        got = L.tensor_to_ints(out)
        assert got[:m2 * B] == ints(hi)
        assert got[m2 * B:] == ints(lo)


def test_wrapper_checks_and_cpu_route(monkeypatch):
    ctx = engine.NttContext(8, "ipa")
    a = torch.zeros((8, 2, 16), dtype=torch.int64)
    tw = L.to_torch(ctx.twiddles(2).mont_p)

    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)
    before = native.launches()["ntt_stage"]
    cuda_stage.ntt_stage(a, tw, 2, ctx.mod_p)
    assert native.launches()["ntt_stage"] == before     # no launch counted
    with pytest.raises(ValueError):
        cuda_stage.ntt_stage(a, tw, 4, ctx.mod_p)        # tw rows != m2
    with pytest.raises(ValueError):
        cuda_stage.ntt_stage(a[:6], L.to_torch(ctx.twiddles(4).mont_p), 4,
                             ctx.mod_p)                  # 2*m2 must tile n
    with pytest.raises(ValueError):
        cuda_stage.ntt_stage(a.to("meta"), tw.to("meta"), 2, ctx.mod_p)


def test_pass_plan_covers_every_stage_once():
    """The passes cover the stages 1 .. height-1 once each, in order, for
    n = 2 .. 2^16, and every pass's groups (2^(s1-s0+1) rows) fit a
    block's shared memory, whose size is the kernel's own constant."""
    src = open(os.path.join(os.path.dirname(native.__file__), "csrc",
                            "ntt_stage.cu")).read()
    lg = int(re.search(r"#define NTT_BLOCK_LG (\d+)", src).group(1))
    assert cuda_stage.BLOCK_LG == lg
    for e in range(1, 17):
        n = 1 << e
        plan = cuda_stage.pass_plan(n)
        stages = [s for s0, s1 in plan for s in range(s0, s1 + 1)]
        assert stages == list(range(1, engine.NttContext(n).height))
        assert all(1 <= s1 - s0 + 1 <= lg for s0, s1 in plan)
        assert len(plan) == 1 if n <= 1 << lg else len(plan) > 1
    assert cuda_stage.pass_plan(1 << 14) == [(1, 10), (11, 14)]


@pytest.mark.parametrize("hardened", [False, True])
def test_stage_table_unpacks_to_twiddles(hardened):
    """K1's packed table (one per lane, every stage's twiddles, stage s's
    twiddle j at row 2^(s-1) - 1 + j) unpacks to `ctx.twiddles(m2)`'s
    Montgomery forms and to the reference's."""
    n = 64
    ctx = engine.NttContext(n, "ipa", hardened=hardened)
    jctx = jeng.NttContext(n, "ipa", hardened=hardened)
    for lane in ("p", "q"):
        words = ctx.stage_table(lane, "cpu")
        assert words.dtype == torch.int32 and words.shape == (n - 1, 8)
        assert words.is_contiguous()
        w = words.to(torch.int64) & 0xFFFFFFFF
        lim = torch.stack([w & 0xFFFF, w >> 16], -1).reshape(n - 1, 16)
        assert ctx.stage_table(lane, "cpu") is words        # kept
        for s in range(ctx.height - 1):
            m2 = 1 << s
            rows = L.to_numpy(lim[m2 - 1:2 * m2 - 1])
            assert np.array_equal(rows, getattr(ctx.twiddles(m2),
                                                "mont_" + lane))
            assert np.array_equal(rows, getattr(jctx.twiddles(m2),
                                                "mont_" + lane))


def test_encode_lane_checks_and_cpu_route(monkeypatch):
    """encode_lane on CPU tensors is the plain stage loop (no kernel), and
    refuses arrays that are not n rows of 16 limbs."""
    ctx = engine.NttContext(8, "ipa")
    rng = random.Random(3)
    a = L.ints_to_tensor([rng.randrange(ctx.mod_q.n) for _ in range(16)]
                         ).reshape(8, 2, 16)

    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)
    before = native.launches()["ntt_stage"]
    got = cuda_stage.encode_lane(ctx, a, ctx.mod_q, "q")
    assert torch.equal(got, engine.encode_stages(
        ctx, engine.CrtArray(a, a)).q)
    assert native.launches()["ntt_stage"] == before
    with pytest.raises(ValueError):
        cuda_stage.encode_lane(ctx, a[:4], ctx.mod_q, "q")
    with pytest.raises(ValueError):
        cuda_stage.encode_lane(ctx, a[..., :8], ctx.mod_q, "q")
    with pytest.raises(ValueError):
        cuda_stage.encode_lane(ctx, a.to("meta"), ctx.mod_q, "q")
