"""Server-side block storage: U/, H_X/, H_Y/, STG/ with the reference's layouts.

File formats (reference porla/Utils/utils.h):
- U/<i>: the raw 4096-byte data block (write_data_block_to_file, :585-590);
  chunks are 32-byte little-endian values.
- H_X/<level>_<i>, H_Y/<level>_<i>: codeword blocks; 256-bit form is 128 x
  32-byte LE values (serialize_error_code_256b, :496-507), 512-bit form is
  128 x 64-byte LE values mod LCM (serialize_error_code_512b, :473-484).
- STG/<tag>_<i>: the out-of-core tier's staging records, 128 x 64 bytes:
  a mod-LCM value as its CRT residue pair [p lane 32 B LE | q lane 32 B LE].

Every multi-file read, write and delete goes through the native runtime's
pool of threads (`runtime/lib.py`), inside a `store.read`, `store.write` or
`store.delete` span that carries the batch's `files` (and `bytes` and
`what`: "codes256", "codes512", "staged" or "blocks"); the read span holds
the file reads alone, not the copy to the device or the widening. Limb
arrays are int64 tensors on any device;
a file's LE 16-bit limbs travel as raw bytes (through a pinned host buffer
when the device is a card) and are widened to int64 on the device, as
int16 values masked to 16 bits (torch does no uint16 arithmetic).
"""

from __future__ import annotations

import os

import torch

from porla_tpu_torch.config import BLOCK_SIZE, NUM_CHUNKS
from porla_tpu_torch.fields import limbs, mont
from porla_tpu_torch.ntt.engine import MOD_P, CrtArray
from porla_tpu_torch.runtime import lib as rt
from porla_tpu_torch.utils import trace

_REC_256 = NUM_CHUNKS * 32
_REC_512 = NUM_CHUNKS * 64


def limb_bytes(t: torch.Tensor) -> torch.Tensor:
    """(…, 16k) int64 limbs (each < 2^16) -> (…, 32k) uint8, little-endian,
    on the same device."""
    signed = t - ((t & 0x8000) << 1)          # the int16 of the same bits
    return signed.to(torch.int16).contiguous().view(torch.uint8)


def bytes_limbs(b: torch.Tensor) -> torch.Tensor:
    """(…, 32k) uint8 little-endian -> (…, 16k) int64 limbs."""
    return b.contiguous().view(torch.int16).to(torch.int64) & limbs.LIMB_MASK


class BlockStore:
    """Directory-backed store mirroring the reference's U/H_X/H_Y trees."""

    def __init__(self, root: str):
        self.root = root
        for sub in ("U", "H_X", "H_Y", "STG"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        self._host = torch.empty(0, dtype=torch.uint8)
        self._pinned = False

    # --- batched file IO core ----------------------------------------------

    def _buffer(self, nbytes: int, pinned: bool) -> torch.Tensor:
        """A reusable host byte buffer (page-locked for a card's copies)."""
        if self._host.numel() < nbytes or self._pinned != pinned:
            self._host = torch.empty(max(nbytes, self._host.numel()),
                                     dtype=torch.uint8, pin_memory=pinned)
            self._pinned = pinned
        return self._host[:nbytes]

    @property
    def pinned_bytes(self) -> int:
        """The bytes of the page-locked host buffer (0 until a card's copy
        made one): it grows to the largest batch of files moved at once."""
        return self._host.numel() if self._pinned else 0

    def _read_limbs(self, paths: list[str], record_size: int, device,
                    what: str) -> torch.Tensor:
        """The files' records as (len(paths), NUM_CHUNKS, record_size / 64
        * 16) int64 limbs on `device`: the bytes go to the device as they
        are and are widened there."""
        device = torch.device(device)
        nbytes = len(paths) * record_size
        buf = self._buffer(nbytes, device.type == "cuda")
        if trace.enabled() and device.type == "cuda":
            # the span's closing wait for the card then holds no work
            # launched before the read
            torch.cuda.synchronize(device)
        with trace.span("store.read", files=len(paths), bytes=nbytes,
                        what=what):
            rt.read_files(paths, record_size, buf.numpy())
            trace.count("store.files_read", len(paths))
            trace.count("store.bytes_read", nbytes)
        raw = buf.to(device) if device.type == "cuda" else buf
        return bytes_limbs(raw).view(len(paths), NUM_CHUNKS, -1)

    def _write_files(self, paths: list[str], record_size: int, data,
                     what: str) -> None:
        """Write the records of a contiguous host buffer to the files."""
        nbytes = len(paths) * record_size
        with trace.span("store.write", files=len(paths), bytes=nbytes,
                        what=what):
            rt.write_files(paths, record_size, data)
            trace.count("store.files_written", len(paths))
            trace.count("store.bytes_written", nbytes)

    def _write_many(self, paths: list[str], record_size: int,
                    data: torch.Tensor, what: str) -> None:
        """Write the rows of a uint8 tensor (any device) to the files."""
        flat = data.reshape(-1)
        if flat.is_cuda:
            flat = self._buffer(flat.numel(), True).copy_(flat)
        self._write_files(paths, record_size, flat.numpy(), what)

    # --- raw data blocks (U/) ---------------------------------------------

    def _u_path(self, index: int) -> str:
        return os.path.join(self.root, "U", str(index))

    def write_block(self, index: int, data: bytes) -> None:
        assert len(data) == BLOCK_SIZE
        with open(self._u_path(index), "wb") as f:
            f.write(data)

    def write_blocks(self, indices, datas: bytes) -> None:
        """Batch-write raw 4096-byte blocks from one contiguous buffer."""
        self._write_files([self._u_path(i) for i in indices], BLOCK_SIZE,
                          datas, "blocks")

    def read_block(self, index: int) -> bytes:
        with open(self._u_path(index), "rb") as f:
            return f.read(BLOCK_SIZE)

    def read_block_chunks(self, index: int) -> list[int]:
        """Block -> 128 chunk integers (read_data_block_from_file
        semantics: 8 LE u32 words per chunk)."""
        raw = self.read_block(index)
        return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
                for i in range(NUM_CHUNKS)]

    def read_blocks_crt(self, indices, mod_q, device="cpu") -> CrtArray:
        """Batch-load raw blocks into a (N, NUM_CHUNKS, 16) CRT array on
        `device`; raw chunks are arbitrary 256-bit values, reduced
        canonically in each lane there."""
        arr = self._read_limbs([self._u_path(i) for i in indices],
                               BLOCK_SIZE, device, "blocks")
        return CrtArray(mont.mod_reduce(arr, MOD_P),
                        mont.mod_reduce(arr, mod_q))

    # --- codeword files (H_X/, H_Y/) --------------------------------------

    def _code_path(self, is_x: bool, level: int, index: int) -> str:
        sub = "H_X" if is_x else "H_Y"
        return os.path.join(self.root, sub, f"{level}_{index}")

    def write_code_256(self, is_x: bool, level: int, index: int,
                       chunks: list[int]) -> None:
        assert len(chunks) == NUM_CHUNKS
        buf = b"".join(c.to_bytes(32, "little") for c in chunks)
        with open(self._code_path(is_x, level, index), "wb") as f:
            f.write(buf)

    def read_code_256(self, is_x: bool, level: int, index: int) -> list[int]:
        with open(self._code_path(is_x, level, index), "rb") as f:
            raw = f.read(_REC_256)
        return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
                for i in range(NUM_CHUNKS)]

    def write_codes_256(self, is_x: bool, level: int, indices,
                        arr: torch.Tensor) -> None:
        """Batch-write (N, NUM_CHUNKS, 16) canonical limb values as 256-bit
        codeword files (serialize_error_code_256b layout, utils.h:496-507)."""
        self._write_many([self._code_path(is_x, level, i) for i in indices],
                         _REC_256, limb_bytes(arr), "codes256")

    def read_codes_256(self, is_x: bool, level: int, indices,
                       device="cpu") -> torch.Tensor:
        """Batch-read 256-bit codeword files -> (N, NUM_CHUNKS, 16) limbs
        on `device`."""
        return self._read_limbs(
            [self._code_path(is_x, level, i) for i in indices], _REC_256,
            device, "codes256")

    def write_code_512(self, is_x: bool, level: int, index: int,
                       chunks: list[int]) -> None:
        assert len(chunks) == NUM_CHUNKS
        buf = b"".join(c.to_bytes(64, "little") for c in chunks)
        with open(self._code_path(is_x, level, index), "wb") as f:
            f.write(buf)

    def read_code_512(self, is_x: bool, level: int, index: int) -> list[int]:
        with open(self._code_path(is_x, level, index), "rb") as f:
            raw = f.read(_REC_512)
        return [int.from_bytes(raw[i * 64:(i + 1) * 64], "little")
                for i in range(NUM_CHUNKS)]

    def write_codes_512(self, is_x: bool, level: int, indices,
                        lo: torch.Tensor, hi: torch.Tensor) -> None:
        """Batch-write 512-bit files (serialize_error_code_512b,
        utils.h:473-484): values mod LCM as (low 256b limbs, high 256b
        limbs) pairs, little-endian."""
        self._write_many([self._code_path(is_x, level, i) for i in indices],
                         _REC_512, torch.cat([limb_bytes(lo),
                                              limb_bytes(hi)], -1),
                         "codes512")

    def read_codes_512(self, is_x: bool, level: int, indices,
                       device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
        """Batch-read 512-bit files -> (lo, hi) (N, C, 16) limbs."""
        arr = self._read_limbs(
            [self._code_path(is_x, level, i) for i in indices], _REC_512,
            device, "codes512")
        return (arr[..., :limbs.NLIMBS].contiguous(),
                arr[..., limbs.NLIMBS:].contiguous())

    # --- out-of-core staging files (STG/) -----------------------------------
    # 64-byte-per-chunk staging records for not-yet-reduced mod-LCM values
    # during the streamed CRebuild and mix (the role of the reference's
    # 512b files, serialize_error_code_512b utils.h:473-484).

    def _stg_path(self, tag: str, index: int) -> str:
        return os.path.join(self.root, "STG", f"{tag}_{index}")

    def write_staged(self, tag: str, indices, data: CrtArray) -> None:
        """Batch-write (N, NUM_CHUNKS, 16)-limb CRT lane pairs."""
        self._write_many([self._stg_path(tag, i) for i in indices], _REC_512,
                         torch.cat([limb_bytes(data.p),
                                    limb_bytes(data.q)], -1), "staged")

    def read_staged(self, tag: str, indices, device="cpu") -> CrtArray:
        arr = self._read_limbs([self._stg_path(tag, i) for i in indices],
                               _REC_512, device, "staged")
        return CrtArray(arr[..., :limbs.NLIMBS].contiguous(),
                        arr[..., limbs.NLIMBS:].contiguous())

    def delete_staged(self, tag: str, n: int) -> None:
        with trace.span("store.delete", files=n):
            rt.delete_files([self._stg_path(tag, i) for i in range(n)])
