"""Protocol constants.

Mirrors the reference's compile-time configuration (reference:
porla/config.hpp) as a runtime dataclass so a single build supports both
schemes and arbitrary cache levels.
"""

from __future__ import annotations

import dataclasses

# reference porla/config.hpp:20-22
ID_SIZE = 4
BLOCK_SIZE = 4092 + ID_SIZE  # bytes per data block
NUM_CHUNKS = BLOCK_SIZE >> 5  # 128 chunks of 256 bits
NUM_GENERATORS = NUM_CHUNKS

# reference porla/config.hpp:29-32
MAX_BLOCKS_SENT = 1024
NUM_CHECK_AUDIT = 128

# reference porla/config.hpp:13
TOP_CACHING_LEVEL = 10

# reference porla/config.hpp:19
SERVER_PORT = 8888

# reference porla/config.hpp:38-40 (fixed demo keys; protocol is
# deterministic given these)
SECRET_KEY = bytes(
    [0x00, 0x11, 0x22, 0x33, 0x44, 0x55, 0x66, 0x77,
     0x88, 0x99, 0xAA, 0xBB, 0xCC, 0xDD, 0xEE, 0xFF])
TAU_KEY = bytes(
    [0xFF, 0xEE, 0xDD, 0xCC, 0xBB, 0xAA, 0x99, 0x88,
     0x77, 0x66, 0x55, 0x44, 0x33, 0x22, 0x11, 0x00])
IV = bytes(range(16))


@dataclasses.dataclass(frozen=True)
class PorlaConfig:
    """Runtime configuration for one client/server pair."""

    scheme: str = "ipa"  # "ipa" (secp256k1/Bulletproof) or "kzg" (BN254)
    num_chunks: int = NUM_CHUNKS
    num_check_audit: int = NUM_CHECK_AUDIT
    top_caching_level: int = TOP_CACHING_LEVEL
    max_blocks_sent: int = MAX_BLOCKS_SENT
    secret_key: bytes = SECRET_KEY
    tau_key: bytes = TAU_KEY
    server_port: int = SERVER_PORT
    storage_dir: str = "porla_store"
    # out-of-core tier (protocol/stream.py): blocks a streamed pass holds on
    # the device at once, 8 KiB of staging bytes each: a stripe in the
    # staging, mix and final passes, two in a pass of butterfly stages (a
    # stage's pairs). The reference streams each butterfly through 512-byte
    # file read-modify-writes instead (CRebuild_No_Cached and the disk mix,
    # Server.hpp:1835-2255, 954-1207).
    stream_stripe_blocks: int = 4096
    # multi-device: route ALL sharded audit MSMs through the per-shard
    # Pippenger kernels (parallel/sharded.py) even below their size cutoff,
    # so the Pippenger path is exercised at small sizes (it otherwise only
    # triggers at n_local >= 4096 or nbits > 32)
    force_sharded_pippenger: bool = False
    # multi-device layout: a parallel.sharded.Mesh (sharded.make_mesh, or
    # parallel.multihost.make_mesh across processes), or None for one
    # device. The server shards the CRebuild, the commitments and the
    # audit MSMs over it.
    mesh: object = None

    def __post_init__(self):
        if self.scheme not in ("ipa", "kzg"):
            raise ValueError(f"unknown scheme {self.scheme!r}")
