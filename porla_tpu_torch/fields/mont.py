"""Batched 256-bit modular arithmetic on (…, 16) limb tensors (plain torch).

A field element is 16 little-endian 16-bit limbs in an int64 tensor. The
arithmetic is the same function as the reference package's
`porla_tpu/fields/mont.py` (Montgomery form with R = 2^256, canonical
outputs), written with int64 carriers: every limb product is < 2^32 and a
column of 16 of them < 2^36, so whole product columns accumulate without
splitting, and a Montgomery value is the same integer whatever limb width a
CUDA kernel uses inside (the kernels in `csrc/` use 8 x 32-bit words).

Carry normalization is data-parallel: a few "shift the carries up one
column" passes bring every column below 2^17 - 1, after which the
remaining ripple is resolved exactly by the adder identity
cin = ((g|p) + g) ^ p on bit-packed generate/propagate flags.

These functions run on any device; they are the plain versions the CUDA
kernels are held against and the arithmetic of the port's non-kernel
tensor code.
"""

from __future__ import annotations

import torch

from porla_tpu_torch.fields.limbs import DTYPE, LIMB_BITS, LIMB_MASK, NLIMBS, int_to_limbs

_B = LIMB_BITS
_M = LIMB_MASK
_ROWS_FROM = 512      # CPU batch size from which _cols sums shifted rows


class Modulus:
    """Host-precomputed per-modulus constants."""

    def __init__(self, n: int, name: str = ""):
        assert n % 2 == 1 and n < (1 << 256)
        self.n = n
        self.name = name or hex(n)[:18]
        self.limbs = int_to_limbs(n)                      # (16,) u32 numpy
        self.nprime_int = (-pow(n, -1, 1 << 256)) % (1 << 256)
        self.nprime = int_to_limbs(self.nprime_int)
        self.r = (1 << 256) % n                           # R mod n
        self.r2 = (self.r * self.r) % n                   # R^2 mod n
        self.r2_limbs = int_to_limbs(self.r2)
        self.one_limbs = int_to_limbs(1)
        self.r_limbs = int_to_limbs(self.r)               # mont form of 1
        self._dev: dict = {}

    def to_mont_int(self, v: int) -> int:
        return (v * self.r) % self.n

    def words32(self) -> list[int]:
        """n as 8 little-endian 32-bit words plus -n^-1 mod 2^32 (the
        CIOS constant of the CUDA kernels)."""
        return ([(self.n >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                + [self.nprime_int & 0xFFFFFFFF])

    def const(self, name: str, device) -> torch.Tensor:
        """(16,) int64 tensor of a limb constant, cached per device."""
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            import numpy as np
            t = torch.from_numpy(np.asarray(getattr(self, name), np.int64)).to(device)
            self._dev[key] = t
        return t

    def __repr__(self):
        return f"Modulus({self.name})"


# --- column helpers ----------------------------------------------------------

def _cols(a, b):
    """Product columns of a*b: (…, 16) x (…, 16) -> (…, 31), entries
    < 16 * 2^32 (= a skew sum of the 16x16 partial products).

    One outer product and a skewed sum: few ops, which is what counts on
    the card (launches) and for small CPU batches. Large CPU batches
    accumulate 16 shifted rows instead, which touches half the memory."""
    if not a.is_cuda and a.numel() >= _ROWS_FROM * NLIMBS:
        out = torch.zeros(a.shape[:-1] + (31,), dtype=a.dtype,
                          device=a.device)
        for i in range(NLIMBS):
            out[..., i:i + NLIMBS] += a[..., i:i + 1] * b
        return out
    p = a.unsqueeze(-1) * b.unsqueeze(-2)                 # (…, 16, 16)
    lead = p.shape[:-2]
    p = torch.nn.functional.pad(p, (0, NLIMBS))           # (…, 16, 32)
    p = p.reshape(lead + (32 * NLIMBS,))[..., :31 * NLIMBS]
    return p.reshape(lead + (NLIMBS, 31)).sum(-2)


def _shift_cols(c, width: int):
    """Pad/truncate the column axis to `width`."""
    w = c.shape[-1]
    if w >= width:
        return c[..., :width]
    return torch.nn.functional.pad(c, (0, width - w))


def _normalize(c, width: int, passes: int):
    """Exact base-2^16 digits of sum_k c[k] 2^(16k) mod 2^(16*width).

    c: (…, W) nonnegative columns. `passes` shift-carry passes must bring
    every column to <= 2^17 - 2 (each pass shrinks a bound B to
    2^16 + B/2^16); the rest is resolved with packed carry flags: a
    column's digit is v & M, it generates a carry when v >= 2^16 and
    propagates one when v == M."""
    v = _shift_cols(c, width)
    for _ in range(passes):
        hi = v >> _B
        v = (v & _M) + torch.nn.functional.pad(hi, (1, 0))[..., :width]
    g = v >> _B                                            # 0/1
    p = (v == _M).to(DTYPE)
    sh = _arange(width, v.device)
    gw = (g << sh).sum(-1, keepdim=True)
    pw = (p << sh).sum(-1, keepdim=True)
    cin = (((gw | pw) + gw) ^ pw) >> sh & 1
    return (v + cin) & _M


_ARANGE: dict = {}


def _arange(width: int, device):
    key = (width, str(device))
    t = _ARANGE.get(key)
    if t is None:
        t = _ARANGE[key] = torch.arange(width, device=device, dtype=DTYPE)
    return t


def _cond_sub(res, top, mod: Modulus):
    """value = top*2^256 + res (< 2n) -> value mod n (canonical)."""
    ncomp = _ncomp(mod, res.device)                       # 2^256 - n
    d = _normalize(res + ncomp, NLIMBS + 1, 0)            # res - n + 2^256
    ge = (d[..., NLIMBS] | top) != 0
    return torch.where(ge.unsqueeze(-1), d[..., :NLIMBS], res)


def _ncomp(mod: Modulus, device):
    key = ("ncomp", str(device))
    t = mod._dev.get(key)
    if t is None:
        from porla_tpu_torch.fields.limbs import ints_to_tensor
        t = ints_to_tensor([(1 << 256) - mod.n], device)[0]
        mod._dev[key] = t
    return t


_ONE_LIMBS = Modulus(1, "unit")       # only its constant 1 is used


# --- public API ----------------------------------------------------------------

def mont_mul(a, b, mod: Modulus):
    """Montgomery product a*b*R^-1 mod n -> canonical (< n).

    One operand may be any 256-bit value; at least one must be canonical,
    which keeps the result < 2n before the final subtract. With one
    operand in Montgomery form (v*R mod n) the result is the plain modular
    product of the other operand with v."""
    a, b = torch.broadcast_tensors(a, b)
    t = _cols(a, b)                                        # (…, 31) < 2^36
    # m = (T mod R) * N' mod R straight from T's raw low columns: column
    # products < 2^36 * 2^16, 16 of them < 2^56 — exact in int64
    npr = mod.const("nprime", a.device)
    m = _normalize(_cols(t[..., :NLIMBS], npr.expand_as(a))[..., :NLIMBS],
                   NLIMBS, 3)                              # 2^56 -> <= 2^17-2
    # S = T + m*N (== 0 mod R); result = S / R < 2n
    s = _cols(m, mod.const("limbs", a.device).expand_as(a)) + t
    s = _normalize(s, 2 * NLIMBS + 1, 2)                  # 2^37 -> <= 2^17-2
    return _cond_sub(s[..., NLIMBS:2 * NLIMBS], s[..., 2 * NLIMBS], mod)


def add_mod(a, b, mod: Modulus):
    a, b = torch.broadcast_tensors(a, b)
    d = _normalize(a + b, NLIMBS + 1, 0)
    return _cond_sub(d[..., :NLIMBS], d[..., NLIMBS], mod)


def sub_mod(a, b, mod: Modulus):
    """(a - b) mod n for canonical a, b."""
    a, b = torch.broadcast_tensors(a, b)
    # a + (2^256 - b) = a + ~b + 1; carry out set <=> a >= b
    d = _normalize(a + (_M - b) + _one_col(a), NLIMBS + 1, 0)
    diff = d[..., :NLIMBS]
    borrowed = d[..., NLIMBS] == 0
    fixed = _normalize(diff + mod.const("limbs", a.device), NLIMBS, 0)
    return torch.where(borrowed.unsqueeze(-1), fixed, diff)


def _one_col(like):
    return _ONE_LIMBS.const("one_limbs", like.device)


def neg_mod(a, mod: Modulus):
    """(-a) mod n; maps 0 -> 0."""
    return sub_mod(torch.zeros_like(a), a, mod)


def is_zero(a):
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def to_mont(a, mod: Modulus):
    return mont_mul(a, mod.const("r2_limbs", a.device).expand_as(a), mod)


def from_mont(a, mod: Modulus):
    return mont_mul(a, mod.const("one_limbs", a.device).expand_as(a), mod)


def mod_reduce(a, mod: Modulus):
    """Reduce an arbitrary (< 2^256) limb value into [0, n)."""
    return from_mont(to_mont(a, mod), mod)
