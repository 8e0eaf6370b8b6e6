"""ctypes binding of the port's native host runtime (`native/porla_rt.cc`).

AES-128 ECB (AES-NI on x86-64; the MAC PRF is ECB over packed records),
the emp-style PRG expansion and batched file reads, writes and deletes on
a pool of threads (the reference's audit reads on 8 threads,
Server.hpp:742-776). The first call builds the library with g++ into
`runtime/build/`, keyed by a hash of the source and the flags so that an
unchanged tree reuses it. The compiler writes a file
of its own process's name and `os.replace` moves it into place, so
processes that build at once never load a half-written library. A failed
build or load raises: nothing falls back to the numpy AES or to a Python
file loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "native", "porla_rt.cc")
BUILD_DIR = os.path.join(_HERE, "build")
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread") + (
    ("-maes", "-mssse3") if platform.machine() in ("x86_64", "AMD64")
    else ())
# workers a batched read or write starts (never more than its files): the
# work waits on the file system, so more than the host's cores pay (PERF.md
# section 3, chip_smoke.py's `store_io` lines)
THREADS = 32

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "porla_aes128_ecb": ([_P, _P, _P, _I64], None),
    "porla_prg_expand": ([_P, ctypes.c_uint64, _P, _I64], None),
    "porla_read_files": ([_P, _I64, _I64, _P, ctypes.c_int32], _I64),
    "porla_write_files": ([_P, _I64, _I64, _P, ctypes.c_int32], _I64),
    "porla_delete_files": ([_P, _I64, ctypes.c_int32], _I64),
}

_lock = threading.Lock()
_lib = None


def build(cxx: str = CXX, build_dir: str = BUILD_DIR) -> str:
    """Compile `porla_rt.cc` (unless a build of the same source and flags
    is there) and return the shared library's path; raises RuntimeError
    when the compiler is missing or fails."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = " ".join(FLAGS + (platform.machine(),)).encode() + src
    so = os.path.join(build_dir,
                      f"libporla_rt_{hashlib.sha256(key).hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([cxx, *FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"porla_rt: running {cxx!r} failed: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"porla_rt: {cxx} failed\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded runtime (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def _buf(data) -> np.ndarray:
    """A C-contiguous uint8 view of bytes or a numpy array (no copy)."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return arr


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(arr.ctypes.data)


def aes128_ecb(key: bytes, plaintext: bytes) -> bytes:
    """AES-128-ECB over a whole number of 16-byte blocks."""
    if len(key) != 16 or len(plaintext) % 16:
        raise ValueError("AES-128 takes a 16-byte key and whole blocks")
    src = _buf(plaintext)
    out = np.empty(len(plaintext), np.uint8)
    library().porla_aes128_ecb(_ptr(_buf(key)), _ptr(src), _ptr(out),
                               len(plaintext) // 16)
    return out.tobytes()


def prg_expand(key: bytes, counter: int, nblocks: int) -> bytes:
    """AES_key(counter + i as the low 8 bytes LE, high 8 bytes 0) for
    i < nblocks: the emp PRG's blocks from `counter` on."""
    if len(key) != 16:
        raise ValueError("AES-128 takes a 16-byte key")
    out = np.empty(16 * nblocks, np.uint8)
    library().porla_prg_expand(_ptr(_buf(key)), counter, _ptr(out), nblocks)
    return out.tobytes()


def _paths(paths) -> bytes:
    return b"".join(os.fsencode(p) + b"\0" for p in paths)


def read_files(paths, record_size: int, out: np.ndarray | None = None,
               threads: int = THREADS) -> np.ndarray:
    """Read `record_size` bytes from each file into consecutive records of
    `out` (a C-contiguous uint8 array, allocated when None); returns the
    filled uint8 view. Raises IOError unless every file gave a record."""
    paths = list(paths)
    nbytes = len(paths) * record_size
    if out is None:
        out = np.empty(nbytes, np.uint8)
    if out.dtype != np.uint8 or not out.flags.c_contiguous or \
            not out.flags.writeable or out.size < nbytes:
        raise ValueError("read_files needs a writable contiguous uint8 "
                         f"buffer of {nbytes} bytes")
    out = out.reshape(-1)[:nbytes]
    if paths:
        ok = library().porla_read_files(_paths(paths), len(paths),
                                        record_size, _ptr(out), threads)
        if ok != len(paths):
            raise IOError(f"read_files: {ok}/{len(paths)} files read")
    return out


def write_files(paths, record_size: int, data,
                threads: int = THREADS) -> None:
    """Write consecutive `record_size`-byte records of `data` (bytes or a
    contiguous array) to the files; raises IOError unless every file was
    written whole."""
    paths = list(paths)
    src = _buf(data)
    if src.size != len(paths) * record_size:
        raise ValueError(f"write_files: {src.size} bytes for {len(paths)} "
                         f"records of {record_size}")
    if paths:
        ok = library().porla_write_files(_paths(paths), len(paths),
                                         record_size, _ptr(src), threads)
        if ok != len(paths):
            raise IOError(f"write_files: {ok}/{len(paths)} files written")


def delete_files(paths, threads: int = THREADS) -> None:
    """Delete the files (a missing one counts as deleted); raises IOError
    unless every one is gone."""
    paths = list(paths)
    if paths:
        ok = library().porla_delete_files(_paths(paths), len(paths), threads)
        if ok != len(paths):
            raise IOError(f"delete_files: {ok}/{len(paths)} files deleted")
