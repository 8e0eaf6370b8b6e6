"""Out-of-core streaming for the data plane of levels beyond
`top_caching_level`.

The reference's cold-storage tier streams every butterfly through
512-byte file read-modify-writes (`CRebuild_No_Cached`,
reference porla/Server/Server.hpp:1835-2255; disk `mix`,
Server.hpp:954-1207; file formats porla/Utils/utils.h:473-584). Here the
same out-of-core structure (data lives in per-block staging files, memory
never holds more than a stripe) runs stage by stage in batches: read a
stripe of paired blocks (the native runtime's threaded IO), run the
stripe's butterflies as one batch of plain torch field arithmetic on the
server's device, write the stripe back. A stage reads and writes the level
once, as the reference's does.

Staging records are the CRT residue pair (mod p, mod q) of the mod-LCM
value, 64 bytes a chunk like the reference's 512b format. The final pass
reduces mod p, commits the alignment correction (align_MAC,
Server.hpp:478-562) and writes the reference's 256b codeword files.

MAC (point) planes are not streamed: like the reference, which keeps
MAC_commitments_H in memory for every level (Server.hpp:221-241), point
planes stay on the device; only block data goes out of core.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from porla_tpu_torch.curves.weierstrass import cat
from porla_tpu_torch.ntt import engine
from porla_tpu_torch.ntt.engine import CrtArray, NttContext, Twiddles
from porla_tpu_torch.protocol import compute
from porla_tpu_torch.protocol.hlog import concat_crt
from porla_tpu_torch.utils import trace

# a reader yields the (off, cnt) stripe of an (n, C, 16) CRT data plane
StripeReader = Callable[[int, int], CrtArray]


def _tw_rows(tw: Twiddles, rows) -> Twiddles:
    return Twiddles(*(t[rows] for t in tw))


def _rows(a: CrtArray, lo: int, hi: int) -> CrtArray:
    return CrtArray(a.p[lo:hi], a.q[lo:hi])


def ram_reader(data: CrtArray) -> StripeReader:
    return lambda off, cnt: _rows(data, off, off + cnt)


def level_reader(store, mod_q, is_x: bool, level: int,
                 device) -> StripeReader:
    """Stripe reader over a file-backed level's 256b (mod-p-reduced)
    codeword files; the q lane is re-canonicalized on load (BN254's r is
    below p)."""
    def read(off: int, cnt: int) -> CrtArray:
        arr = store.read_codes_256(is_x, level, range(off, off + cnt), device)
        return CrtArray(arr, engine.q_lane_from_p(arr, mod_q))
    return read


def staged_reader(store, tag: str, device) -> StripeReader:
    return lambda off, cnt: store.read_staged(tag, range(off, off + cnt),
                                              device)


def stage_u_to_staging(store, ctx: NttContext, wt: Twiddles, n: int,
                       tag_x: str, tag_y: str, stripe: int, device) -> None:
    """CRebuild pass 0: U blocks -> staging X (copy) and Y (scaled by
    w^bitrev(t)), a stripe at a time (Server.hpp:1865-1897)."""
    with trace.span("stream.staging", n=n):
        for i0 in range(0, n, stripe):
            idx = range(i0, min(i0 + stripe, n))
            data = store.read_blocks_crt(idx, ctx.mod_q, device)
            store.write_staged(tag_x, idx, data)
            store.write_staged(tag_y, idx, compute.scale_crt(ctx.mod_q, data,
                                                             wt))


def stage_passes(n: int, stripe: int) -> list[tuple[int, int]]:
    """The CRebuild's stages 1..log2(n) grouped into passes over the files:
    a pass of w stages pairs the elements of sets of 2^w blocks among
    themselves, and a set must fit a stripe's 2 * stripe blocks (a stage's
    working set in pairs)."""
    w = max(1, (2 * stripe).bit_length() - 1)
    top = n.bit_length() - 1
    return [(s, min(s + w - 1, top)) for s in range(1, top + 1, w)]


def stream_stages(store, ctx: NttContext, tag: str, n: int, first: int,
                  last: int, stripe: int, device) -> None:
    """Radix-2 butterfly stages first..last over a staged (n, C, 16) plane
    in one pass over its files. Stage s pairs (k, k + 2^(s-1)) for k with
    bit s-1 clear, twiddle v^(k mod 2^(s-1)): the stage loop of
    CRebuild_No_Cached (Server.hpp:1899-2253). The blocks whose indices
    differ only in bits first-1..last-1 form a set that these stages pair
    among themselves; a pass reads as many whole sets as fit 2 * stripe
    blocks, runs the stages on them in order and writes them back."""
    p, w = first - 1, last - first + 1
    size = 1 << w
    assert size <= max(2 * stripe, 2), "a set must fit a stripe"
    nsets = n // size
    b = np.arange(nsets)
    base = ((b >> p) << (p + w)) | (b & ((1 << p) - 1))
    offs = np.arange(size) << p
    per_read = max(1, 2 * stripe // size)
    with trace.span("stream.stage", s=first, last=last, n=n):
        for c0 in range(0, nsets, per_read):
            k = base[c0:c0 + per_read, None] + offs          # (c, size)
            c = k.shape[0]
            a = store.read_staged(tag, k.reshape(-1), device)
            lanes = [x.view((c, size) + tuple(x.shape[1:])) for x in a]
            for s in range(first, last + 1):
                h = 1 << (s - 1 - p)                 # the pair's stride
                j = (k.reshape(c, size // (2 * h), 2, h)[:, :, 0]
                     & (h << p) - 1).reshape(-1)
                halves = [x.view((c, size // (2 * h), 2, h)
                                 + tuple(x.shape[2:])) for x in lanes]
                u = CrtArray(*(x[:, :, 0].reshape((-1,) + x.shape[-2:])
                               for x in halves))
                t = CrtArray(*(x[:, :, 1].reshape((-1,) + x.shape[-2:])
                               for x in halves))
                hi, lo = compute.data_butterfly(
                    ctx.mod_q, u, t, _tw_rows(ctx.twiddles(h << p), j))
                for x, vh, vl in zip(halves, hi, lo):
                    x[:, :, 0] = vh.view(x[:, :, 0].shape)
                    x[:, :, 1] = vl.view(x[:, :, 1].shape)
            store.write_staged(tag, k.reshape(-1), a)


def stream_mix(store, ctx: NttContext, lower: StripeReader,
               upper: StripeReader, out_tag: str, length: int,
               stripe: int) -> None:
    """One streamed fold/mix step (disk `mix`, Server.hpp:954-1207):
        out[i]        = lower[i] + v^i * upper[i]
        out[i+length] = lower[i] - v^i * upper[i]
    writing the 2*length-block result to staging files."""
    tw = ctx.twiddles(length)
    with trace.span("stream.mix", length=length):
        for off in range(0, length, stripe):
            cnt = min(stripe, length - off)
            hi, lo = compute.data_butterfly(
                ctx.mod_q, lower(off, cnt), upper(off, cnt),
                _tw_rows(tw, slice(off, off + cnt)))
            store.write_staged(
                out_tag, np.concatenate([np.arange(off, off + cnt),
                                         np.arange(length + off,
                                                   length + off + cnt)]),
                concat_crt(hi, lo))


def finalize_staged_level(server, tag: str, is_x: bool, level: int,
                          n: int, stripe: int):
    """Final streamed pass of a staged plane: commit the alignment
    correction of each block (align_MAC), reduce mod p, write the level's
    256b codeword files, delete the staging files. Returns the (n,)
    alignment commitments (on the server's device) that go into the
    level's "a" plane (CRebuild_No_Cached final stage,
    Server.hpp:1977-2253)."""
    store = server.store
    parts = []
    with trace.span("stream.finalize", level=level, n=n):
        for i0 in range(0, n, stripe):
            idx = range(i0, min(i0 + stripe, n))
            data = store.read_staged(tag, idx, server.device)
            parts.append(server._commit_batch(
                engine.align_scalars(data, server.mod_q)))
            store.write_codes_256(is_x, level, idx, data.p)
        store.delete_staged(tag, n)
    return cat(parts)
