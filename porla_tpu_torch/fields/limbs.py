"""Limb-tensor codecs: 256-bit integers <-> (…, 16) limb arrays.

A field element is 16 little-endian limbs of 16 bits each. The numpy
helpers below hold them in uint32 (the reference package's layout and
wire-compatible byte order); the torch helpers at the end hold them in
int64, the port's carrier: CPU torch has no usable uint32 arithmetic, and
int64 keeps every partial product and column sum of fields/mont.py exact.

The byte serialization below matches the reference's file/wire formats,
which are little-endian u32 words (reference porla/Utils/utils.h:353-374,
473-517: convert_ZZ_to_arr / serialize_error_code_256b).
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(value: int) -> np.ndarray:
    """One 256-bit integer -> (16,) uint32 limb vector."""
    assert 0 <= value < (1 << 256), hex(value)
    return np.frombuffer(value.to_bytes(32, "little"), dtype="<u2").astype(np.uint32)


def ints_to_limbs(values) -> np.ndarray:
    """Sequence of ints -> (N, 16) uint32."""
    values = [int(v) for v in values]
    assert all(0 <= v < (1 << 256) for v in values), "values must be 256-bit"
    buf = b"".join(v.to_bytes(32, "little") for v in values)
    out = np.frombuffer(buf, dtype="<u2").astype(np.uint32)
    return out.reshape(len(values), NLIMBS)


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs, dtype=np.uint64).reshape(-1)
    assert limbs.shape == (NLIMBS,)
    return sum(int(l) << (LIMB_BITS * i) for i, l in enumerate(limbs))


def limbs_to_ints(arr) -> list:
    """(…, 16) -> flat list of ints over the leading dims."""
    arr = np.asarray(arr, dtype=np.uint32).reshape(-1, NLIMBS)
    b = arr.astype("<u2").tobytes()
    return [int.from_bytes(b[i * 32:(i + 1) * 32], "little")
            for i in range(arr.shape[0])]


def bytes_to_limbs(data: bytes) -> np.ndarray:
    """Little-endian 32-byte records -> (N, 16) uint32 (zero-copy-ish)."""
    assert len(data) % 32 == 0
    out = np.frombuffer(data, dtype="<u2").astype(np.uint32)
    return out.reshape(-1, NLIMBS)


def limbs_to_bytes(arr) -> bytes:
    arr = np.asarray(arr, dtype=np.uint32)
    assert arr.shape[-1] == NLIMBS
    return arr.astype("<u2").tobytes()


def zeros(shape=(), xp=np) -> "np.ndarray":
    return xp.zeros(tuple(shape) + (NLIMBS,), dtype=xp.uint32)


# --- torch (int64 carrier) -------------------------------------------------

DTYPE = torch.int64


def to_torch(arr, device="cpu") -> torch.Tensor:
    """(…, 16) uint32 numpy limbs -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(arr, np.uint32).astype(np.int64)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 limb tensor -> uint32 numpy limbs (host copy)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def ints_to_tensor(values, device="cpu") -> torch.Tensor:
    """Sequence of 256-bit ints -> (N, 16) int64 tensor."""
    return to_torch(ints_to_limbs(values), device)


def tensor_to_ints(t: torch.Tensor) -> list:
    """(…, 16) int64 limb tensor -> flat list of ints."""
    return limbs_to_ints(to_numpy(t))


def zeros_t(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (NLIMBS,), dtype=DTYPE, device=device)


def words32(lim: torch.Tensor) -> torch.Tensor:
    """(…, 16) limbs -> (…, 8) int32 words: word k is limbs 2k, 2k+1,
    little-endian, the unsigned value kept in the signed type's bits (the
    kernels' packed form)."""
    w = lim[..., 0::2] | (lim[..., 1::2] << 16)          # in [0, 2^32)
    w = w - ((w >> 31) << 32)                            # as signed 32-bit
    return w.to(torch.int32)
