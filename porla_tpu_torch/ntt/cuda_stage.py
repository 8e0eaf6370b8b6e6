"""K1 `ntt_stage`: radix-2 NTT stages of one CRT lane on the card.

Counterpart of `porla_tpu/ntt/pallas_stage.py` (the `_stage_kernel`
behind `butterfly_stage` / `encode_stages_pallas`). The kernel source is
`csrc/ntt_stage.cu`: one launch runs a pass of consecutive stages on
shared memory. `encode_lane` runs a lane's CRebuild stages in the passes of
`pass_plan` (one launch at n <= 1024); `ntt_stage` is the one-stage call of
the same kernel; `fold_lane` runs the first log2(m) stages over m <= n
rows (ICC recovery's level fold, `icc_device`). Their plain versions are
the plain stage loop (`engine.stage`). A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from porla_tpu_torch import native
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont
from porla_tpu_torch.ntt import engine

# A block's shared memory holds 2^BLOCK_LG elements (csrc/ntt_stage.cu), so a
# pass runs at most BLOCK_LG stages: its groups are 2^(stages) rows.
BLOCK_LG = 10


def pass_plan(n: int) -> list[tuple[int, int]]:
    """K1's passes (s0, s1) over the stages 1 .. log2(n) of an n-row lane,
    in order, each at most BLOCK_LG stages: one pass up to n = 2^BLOCK_LG,
    then a pass over rows 2^(s0-1) apart for each further BLOCK_LG
    stages."""
    stages = n.bit_length() - 1
    return [(s0, min(s0 + BLOCK_LG - 1, stages))
            for s0 in range(1, stages + 1, BLOCK_LG)]


def stage_plain(a, tw_mont, m2: int, mod: mont.Modulus):
    """Plain torch version of one K1 stage (engine.stage)."""
    return engine.stage(a, tw_mont, m2, mod)


def _check_lane(a: torch.Tensor):
    if a.dim() < 2 or a.shape[-1] != L.NLIMBS:
        raise ValueError(f"bad lane shape {tuple(a.shape)}")


def _require(a: torch.Tensor, *others: torch.Tensor):
    """Kernel operands: CUDA, int64, contiguous (`native.require`), and the
    array 16-byte aligned (the kernel reads and writes an element's limbs
    16 bytes at a time)."""
    native.require(a.device, a, *others)
    if a.data_ptr() % 16:
        raise ValueError("the limb array must be 16-byte aligned")


def ntt_stage(a: torch.Tensor, tw_mont: torch.Tensor, m2: int,
              mod: mont.Modulus) -> torch.Tensor:
    """One stage over (n, C…, 16) limbs: pairs (k, k+m2) for k mod 2*m2 <
    m2 become (a[k] + tw[j]*a[k+m2], a[k] - tw[j]*a[k+m2]), j = k mod m2.
    tw_mont: (m2, 16) Montgomery-form twiddles of this lane."""
    n = a.shape[0]
    _check_lane(a)
    if tw_mont.shape != (m2, L.NLIMBS):
        raise ValueError(f"bad shapes {tuple(a.shape)}, {tuple(tw_mont.shape)}")
    if m2 < 1 or n % (2 * m2):
        raise ValueError(f"stage half-width {m2} does not tile n={n}")
    if a.device.type == "cpu":
        return stage_plain(a, tw_mont, m2, mod)
    _require(a, tw_mont)
    out = torch.empty_like(a)
    tw = L.words32(tw_mont).contiguous()
    _launch(a, out, tw, m2 - 1, m2, 1, mod)
    return out


def encode_lane_plain(ctx: engine.NttContext, a, mod: mont.Modulus,
                      lane: str):
    """The plain version of `encode_lane`: the stage loop."""
    return fold_lane_plain(ctx, a, mod, lane)


def encode_lane(ctx: engine.NttContext, a: torch.Tensor,
                mod: mont.Modulus, lane: str) -> torch.Tensor:
    """All CRebuild stages s = 1..height-1 over one (n, C, 16) lane: one K1
    launch per pass of `pass_plan(n)`, reading the lane's packed twiddle
    table (`ctx.stage_table`)."""
    _check_lane(a)
    if a.shape[0] != ctx.n:
        raise ValueError(f"{a.shape[0]} rows, expected n = {ctx.n}")
    return fold_lane(ctx, a, mod, lane)


def fold_lane_plain(ctx: engine.NttContext, a, mod: mont.Modulus,
                    lane: str):
    """The plain version of `fold_lane`: the stage loop over m rows."""
    m = a.shape[0]
    for s in range(1, m.bit_length()):
        m2 = 1 << (s - 1)
        tw = getattr(ctx.twiddles(m2), "mont_" + lane)
        a = stage_plain(a, L.to_torch(tw, a.device), m2, mod)
    return a


def fold_lane(ctx: engine.NttContext, a: torch.Tensor, mod: mont.Modulus,
              lane: str) -> torch.Tensor:
    """The level fold of ICC recovery: stages s = 1..log2(m) over one (m,
    C…, 16) lane, m a power of two <= ctx.n (the CRebuild's first log2(m)
    stages, which `icc.fold_transform` computes). One K1 launch per pass of
    `pass_plan(m)` on the lane's n-row table (`ctx.stage_table`), whose
    rows m2 - 1 + j for m2 < m are the same twiddles."""
    _check_lane(a)
    m = a.shape[0]
    if m & (m - 1) or not 1 <= m <= ctx.n:
        raise ValueError(f"{m} rows: need a power of two <= n = {ctx.n}")
    if a.device.type == "cpu":
        return fold_lane_plain(ctx, a, mod, lane)
    _require(a)
    out = torch.empty_like(a)
    src = a
    tw = ctx.stage_table(lane, a.device)
    for s0, s1 in pass_plan(m):
        _launch(src, out, tw, 0, 1 << (s0 - 1), s1 - s0 + 1, mod)
        src = out
    return src


def _launch(a, out, tw, tw_off: int, stride: int, lg: int, mod):
    """One K1 pass: stages with half-widths stride .. stride * 2^(lg-1),
    twiddle (m2, j) at row m2 - 1 + j - tw_off of the word table tw."""
    lib = native.library()
    C = a[0].numel() // L.NLIMBS
    rc = lib.porla_ntt_pass(native.ptr(a), native.ptr(out), native.ptr(tw),
                            tw_off, a.shape[0], C, stride, lg,
                            native.mod_words(mod), native.stream(a.device))
    native.KERNELS["ntt_stage"].launches += 1
    native.check(rc, "ntt_stage")
