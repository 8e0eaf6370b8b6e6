"""K1 `ntt_stage`: one radix-2 NTT stage of one CRT lane on the card.

Counterpart of `porla_tpu/ntt/pallas_stage.py` (the `_stage_kernel`
behind `butterfly_stage` / `encode_stages_pallas`). The kernel source is
`csrc/ntt_stage.cu`; `stage_plain` is the same function in plain torch.
A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from porla_tpu_torch import native
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields import mont
from porla_tpu_torch.ntt import engine


def stage_plain(a, tw_mont, m2: int, mod: mont.Modulus):
    """Plain torch version of K1 (engine.stage)."""
    return engine.stage(a, tw_mont, m2, mod)


def ntt_stage(a: torch.Tensor, tw_mont: torch.Tensor, m2: int,
              mod: mont.Modulus) -> torch.Tensor:
    """One stage over (n, C…, 16) limbs: pairs (k, k+m2) for k mod 2*m2 <
    m2 become (a[k] + tw[j]*a[k+m2], a[k] - tw[j]*a[k+m2]), j = k mod m2.
    tw_mont: (m2, 16) Montgomery-form twiddles of this lane."""
    n = a.shape[0]
    if a.shape[-1] != L.NLIMBS or tw_mont.shape != (m2, L.NLIMBS):
        raise ValueError(f"bad shapes {tuple(a.shape)}, {tuple(tw_mont.shape)}")
    if m2 < 1 or n % (2 * m2):
        raise ValueError(f"stage half-width {m2} does not tile n={n}")
    if a.device.type == "cpu":
        return stage_plain(a, tw_mont, m2, mod)
    native.require(a.device, a, tw_mont)
    return _launch_ntt_stage(a, tw_mont, m2, mod)


def _launch_ntt_stage(a, tw_mont, m2, mod):
    n = a.shape[0]
    lib = native.library()
    out = torch.empty_like(a)
    C = a[0].numel() // L.NLIMBS
    rc = lib.porla_ntt_stage(native.ptr(a), native.ptr(tw_mont),
                             native.ptr(out), n, C, m2,
                             native.mod_words(mod), native.stream(a.device))
    native.KERNELS["ntt_stage"].launches += 1
    native.check(rc, "ntt_stage")
    return out


def encode_lane(ctx: engine.NttContext, a: torch.Tensor,
                mod: mont.Modulus, lane: str) -> torch.Tensor:
    """All CRebuild stages s = 1..height-1 over one (n, C, 16) lane."""
    for s in range(1, ctx.height):
        m2 = 1 << (s - 1)
        tw = getattr(ctx.twiddles(m2), "mont_" + lane)
        a = ntt_stage(a, L.to_torch(tw, a.device), m2, mod)
    return a
