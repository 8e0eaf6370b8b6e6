"""Server-side block storage: U/, H_X/, H_Y/ with the reference's layouts.

File formats (reference porla/Utils/utils.h):
- U/<i>: the raw 4096-byte data block (write_data_block_to_file, :585-590);
  chunks are 32-byte little-endian values.
- H_X/<level>_<i>, H_Y/<level>_<i>: codeword blocks; 256-bit form is 128 x
  32-byte LE values (serialize_error_code_256b, :496-507), 512-bit form is
  128 x 64-byte LE values mod LCM (serialize_error_code_512b, :473-484).

File IO is plain Python; the reference package's native batched-IO
runtime is not ported yet, nor are the codeword and staging files of the
out-of-core tier (H_X/, H_Y/ contents, STG/), which this slice never
writes.
"""

from __future__ import annotations

import os

from porla_tpu_torch.config import BLOCK_SIZE, NUM_CHUNKS
from porla_tpu_torch.fields import limbs, mont
from porla_tpu_torch.ntt.engine import MOD_P, CrtArray


class BlockStore:
    """Directory-backed store mirroring the reference's U/H_X/H_Y trees."""

    def __init__(self, root: str):
        self.root = root
        for sub in ("U", "H_X", "H_Y", "STG"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)

    # --- batched file IO core ----------------------------------------------

    @staticmethod
    def _read_many(paths: list[str], record_size: int) -> bytes:
        bufs = []
        for p in paths:
            with open(p, "rb") as f:
                bufs.append(f.read(record_size))
        return b"".join(bufs)

    @staticmethod
    def _write_many(paths: list[str], record_size: int, data: bytes) -> None:
        for i, p in enumerate(paths):
            with open(p, "wb") as f:
                f.write(data[i * record_size:(i + 1) * record_size])

    # --- raw data blocks (U/) ---------------------------------------------

    def _u_path(self, index: int) -> str:
        return os.path.join(self.root, "U", str(index))

    def write_block(self, index: int, data: bytes) -> None:
        assert len(data) == BLOCK_SIZE
        with open(self._u_path(index), "wb") as f:
            f.write(data)

    def write_blocks(self, indices, datas: bytes) -> None:
        """Batch-write raw 4096-byte blocks from one contiguous buffer."""
        self._write_many([self._u_path(i) for i in indices], BLOCK_SIZE,
                         datas)

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
        indices = list(indices)
        raw = self._read_many([self._u_path(i) for i in indices],
                              BLOCK_SIZE)
        arr = limbs.to_torch(limbs.bytes_to_limbs(raw).reshape(
            len(indices), NUM_CHUNKS, limbs.NLIMBS), device)
        return CrtArray(mont.mod_reduce(arr, MOD_P),
                        mont.mod_reduce(arr, mod_q))
