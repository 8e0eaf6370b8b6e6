"""Build, load and account for the port's CUDA kernels.

The kernels are CUDA C++ sources in `csrc/` with a plain C interface. The
first call that needs one compiles every source with `nvcc` for sm_90a (one
process per source, all started together), links them into one shared
library under `csrc/build/` (keyed by a hash of the sources, so an
unchanged tree reuses it) and loads it with ctypes. Nothing is built or
loaded at import time: the CPU tests import every module.

Each wrapper passes `tensor.data_ptr()` pointers and PyTorch's current
stream, raises if the C function returns a nonzero `cudaGetLastError()`,
and adds one to its kernel's `launches` count where it launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("ntt_stage.cu", "scalar_mul.cu", "point_butterfly.cu",
           "fixed_base.cu", "group_sum.cu", "pip_bucket.cu",
           "bucket_fold.cu", "point_add.cu")
HEADERS = ("porla_field.cuh", "porla_coop.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times it was launched since the last `reset_launches()`."""
    name: str
    source: str
    replaces: str
    launches: int = 0


KERNELS = {
    "ntt_stage": Kernel(
        "ntt_stage", "porla_tpu_torch/csrc/ntt_stage.cu",
        "porla_tpu/ntt/pallas_stage.py:165"),
    # K2's two modes: two kernels in one source, counted apart
    "scalar_mul_window": Kernel(
        "scalar_mul_window", "porla_tpu_torch/csrc/scalar_mul.cu",
        "porla_tpu/curves/pallas_curve.py:637"),
    "scalar_mul_glv": Kernel(
        "scalar_mul_glv", "porla_tpu_torch/csrc/scalar_mul.cu",
        "porla_tpu/curves/pallas_curve.py:656"),
    "point_butterfly": Kernel(
        "point_butterfly", "porla_tpu_torch/csrc/point_butterfly.cu",
        "porla_tpu/curves/pallas_curve.py:666"),
    "fixed_base": Kernel(
        "fixed_base", "porla_tpu_torch/csrc/fixed_base.cu",
        "porla_tpu/curves/pallas_curve.py:602"),
    "pip_bucket": Kernel(
        "pip_bucket", "porla_tpu_torch/csrc/pip_bucket.cu",
        "porla_tpu/curves/pallas_msm.py:85"),
    "bucket_fold": Kernel(
        "bucket_fold", "porla_tpu_torch/csrc/bucket_fold.cu",
        "porla_tpu/curves/pallas_msm.py:215"),
    # K3's windowed mode: one source with K3, counted apart
    "point_butterfly_window": Kernel(
        "point_butterfly_window", "porla_tpu_torch/csrc/point_butterfly.cu",
        "porla_tpu/curves/pallas_curve.py:645"),
    # the point sums that followed K2 and K4 in plain torch (the reference
    # leaves them to its compiler: CurveOps.tree_sum)
    "group_sum": Kernel(
        "group_sum", "porla_tpu_torch/csrc/group_sum.cu",
        "porla_tpu/curves/weierstrass.py:257"),
    # the protocol's general point add (MAC sums, deltas, align_MAC), which
    # ran as plain torch limb arithmetic (the reference: CurveOps.add, left
    # to its compiler)
    "point_add": Kernel(
        "point_add", "porla_tpu_torch/csrc/point_add.cu",
        "porla_tpu/curves/weierstrass.py:127"),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_SIGNATURES = {
    "porla_ntt_pass": [_P, _P, _P, _I64, _I64, _I32, _I64, _I32, _P, _P],
    "porla_scalar_mul_window": [_P, _P, _P, _P, _I32, _P, _P, _P, _I64, _P, _P],
    "porla_scalar_mul_glv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I64, _P, _P],
    "porla_point_butterfly": [_P] * 17 + [_I64, _P, _P],
    "porla_point_butterfly_window": [_P] * 7 + [_I32] + [_P] * 6
                                    + [_I64, _P, _P],
    "porla_fixed_base": [_P] * 6 + [_I64] + [_I32] * 4 + [_P, _P],
    "porla_group_sum": [_P] * 9 + [_I64] + [_I32] * 2 + [_P, _P],
    "porla_pip_bucket": [_P] * 5 + [_I32] * 6 + [_P, _P],
    "porla_bucket_fold": [_P] * 5 + [_I32] * 4 + [_P, _P],
    "porla_point_add": [_P] * 9 + [_I64, _I32, _P, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return h.hexdigest()[:16]


# ptxas's register / stack report of the last build, per source
BUILD_LOG: dict[str, str] = {}


def build() -> str:
    """Compile every source in parallel and link the shared library;
    returns its path (an existing build of the same sources is reused)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _digest()
    so = os.path.join(BUILD_DIR, f"libporla_kernels_{tag}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    objs, procs = [], []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{src[:-3]}_{tag}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
             os.path.join(CSRC, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[src] = out.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{src}:\n{BUILD_LOG[src]}")
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    tmp = so + ".tmp"
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                   check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def words(values) -> ctypes.Array:
    arr = (ctypes.c_uint32 * len(values))()
    for i, v in enumerate(values):
        arr[i] = v
    return arr


_MOD_WORDS: dict = {}


def mod_words(mod) -> ctypes.Array:
    """Modulus constants for the kernels: n (8 words), -n^-1 mod 2^32 and
    R mod n (8 words)."""
    key = mod.n
    w = _MOD_WORDS.get(key)
    if w is None:
        one = [(mod.r >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        w = _MOD_WORDS[key] = words(mod.words32() + one)
    return w


def fe_words(value: int) -> ctypes.Array:
    return words([(value >> (32 * i)) & 0xFFFFFFFF for i in range(8)])


def require(device: torch.device, *tensors: torch.Tensor) -> None:
    """Validate kernel operands: one CUDA device, int64, contiguous,
    16-limb last axis."""
    if device.type != "cuda":
        raise ValueError(f"kernel operands must be CUDA tensors, got {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"operand on {t.device}, expected {device}")
        if t.dtype != torch.int64:
            raise ValueError(f"operand dtype {t.dtype}, expected int64")
        if not t.is_contiguous():
            raise ValueError("operand must be contiguous")


def card_line(index: int = 0) -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (a card
    below its maximum power runs slower under load: keep this beside every
    time measured on it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[index]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. "cuda" is the default of the
    protocol classes; it raises when no card is present instead of falling
    back to the CPU (pass device="cpu" for the plain torch versions)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)
