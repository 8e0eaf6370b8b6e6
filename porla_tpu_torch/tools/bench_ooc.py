"""The out-of-core tier at scale: the server's streamed CRebuild of n
blocks, timed per phase, with the host memory and the disk broken down and
an optional bit-exact check (the counterpart of examples/bench_ooc.py).

    python -m porla_tpu_torch.tools.bench_ooc --n 262144 --scheme ipa \\
        --check --out ooc_ipa.json

Seeds U/ with n random 4 KB blocks made from `--seed` (writes of 4096
blocks through the store) and the server's MAC plane with k_j * G for
random scalars k_j (one K2 launch on the card), then runs the server's own
CRebuild (`PorlaServer._crebuild`), which streams the top level (log2(n) >
`--top`) through staging files into the H_X/H_Y codeword files, with the
spans of utils/trace.py on and the card synchronised at each span's end.

Phases (`phases_s`, from the spans): stage_u (`stream.staging`),
data_stages (the `stream.stage` passes of both sides), mac_stages (the Y
plane's K2 scale and the K3 stages of both planes: `point_scale` and
`server.crebuild.mac_stage`), finalize_align_256b (`stream.finalize`: the
alignment commitments on K4, the codeword files, the staging files'
deletion). The JAX example's `mac_stages_one_plane` timed one plane over
placeholder points at infinity; here both planes run over real points.

Memory (`memory`): the host RSS after `import torch`, the CUDA context,
the kernels' build and load, the server, the seeding and each phase, and
its peak (sampled every 10 ms from /proc/self/statm, which the card's
machine has where it reports no VmHWM); `torch.cuda.max_memory_allocated`;
the store's pinned buffer. Disk (`disk`): the files and bytes of U/, STG/,
H_X/ and H_Y/ at the peak (just before the first side's staging files are
deleted) and after, from the store's fixed layout (`layout`); the file
system's used bytes over the run's start, sampled every 100 ms by the same
thread (their peak, and after); the store's file system from /proc/mounts:
on a tmpfs the "out-of-core" files sit in RAM.

Before it writes anything the tool refuses (`StoreTooSmall`) when the
store's file system has less free space than n blocks need: U/ n * 4096
bytes, two staging planes 2 * n * 128 * 64, two codeword planes 2 * n *
4096 (7 GiB at 2^18). It never goes on with a smaller n.

`--check` holds the result bit-exact, independently of the plain
butterflies that produced it: (data) U read back onto the device, both CRT
lanes encoded with K1 (`compute.encode_crt`), the Y copy scaled as the
CRebuild scales it, the p lane (the value mod p) compared with every block
of the top level's H_X/H_Y files; (align) the "a" plane of the first and
the last stripe of each side against the plain version of K4
(`fb_lanes_plain`, at the server's split, so the same limbs) on those
stripes' alignment scalars; (mac) 64 sampled codewords of each "c" plane
against t_i * G (the golden model), t the CRebuild's stages over the seed
scalars k_j mod q in Python ints (`kat_onchip.exact_encode`). Any
difference raises `CheckFailed`.

The record (one JSON line, printed last and written to `--out`) has the
JAX record's keys, `device` (the card's name and power limit, as
nvidia-smi prints them) in place of its `backend`, and the above. The
entry points run on the card and raise without one; `--device cpu` runs
the plain versions (use a small `--n`). A store the tool made
(`tempfile.mkdtemp`, which follows TMPDIR) is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from porla_tpu_torch import native
from porla_tpu_torch.commit import kzg
from porla_tpu_torch.config import BLOCK_SIZE, NUM_CHUNKS, PorlaConfig
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves.weierstrass import JacPoint, index
from porla_tpu_torch.fields import constants as C
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.ntt import engine
from porla_tpu_torch.ntt.engine import CrtArray
from porla_tpu_torch.protocol import compute
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.tools.kat_onchip import exact_encode
from porla_tpu_torch.utils import trace

SEED_BATCH = 4096            # blocks a write while seeding U/
MAC_SAMPLES = 64             # codewords of each "c" plane checked
_REC_STAGED = NUM_CHUNKS * 64
_REC_CODE = NUM_CHUNKS * 32
PHASES = ("stage_u", "data_stages", "mac_stages", "finalize_align_256b")
# phase -> the spans under server.crebuild that make it up
PHASE_SPANS = {"stage_u": ("stream.staging",),
               "data_stages": ("stream.stage",),
               "mac_stages": ("point_scale", "server.crebuild.mac_stage"),
               "finalize_align_256b": ("stream.finalize",)}


class StoreTooSmall(RuntimeError):
    """The store's file system cannot hold the files n blocks need."""


class CheckFailed(AssertionError):
    """The streamed top level differs from the independent computation."""


def bytes_needed(n: int) -> dict:
    """The bytes the streamed CRebuild of n blocks puts on disk, by kind."""
    return {"U": n * BLOCK_SIZE, "STG": 2 * n * _REC_STAGED,
            "H_X_H_Y": 2 * n * _REC_CODE}


def refuse_if_small(root: str, n: int) -> dict:
    """Raise StoreTooSmall, naming the bytes needed and free, when the
    file system of `root` has less free space than n blocks need."""
    need = bytes_needed(n)
    st = os.statvfs(root)
    free = st.f_bavail * st.f_frsize
    total = sum(need.values())
    if free < total:
        raise StoreTooSmall(
            f"the store {root} has {free} bytes free; n = {n} blocks need "
            f"{total} ({', '.join(f'{k} {v}' for k, v in need.items())})")
    return {"needed_bytes": total, "free_bytes": free, **need}


def store_filesystem(root: str) -> dict:
    """The mount that holds `root` (the longest /proc/mounts entry that
    prefixes its real path), its type, size and free bytes."""
    real = os.path.realpath(root)
    best = ("?", "/", "?")
    with open("/proc/mounts") as f:
        for line in f:
            src, mnt, fstype = line.split()[:3]
            mnt = mnt.replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[1]):
                best = (src, mnt, fstype)
    st = os.statvfs(root)
    return {"source": best[0], "mount": best[1], "fstype": best[2],
            "in_ram": best[2] in ("tmpfs", "ramfs"),
            "size_bytes": st.f_blocks * st.f_frsize,
            "free_bytes": st.f_bavail * st.f_frsize}


def layout(n: int, peak: bool) -> dict:
    """The files and bytes of U/, STG/, H_X/, H_Y/ that the streamed
    CRebuild of n blocks leaves: at its peak (U/, both staging planes and
    H_X/, before the X side's staging files are deleted) or after it."""
    files = {"U": (n, BLOCK_SIZE), "STG": (2 * n if peak else 0, _REC_STAGED),
             "H_X": (n, _REC_CODE), "H_Y": (0 if peak else n, _REC_CODE)}
    out = {sub: {"files": f, "bytes": f * size}
           for sub, (f, size) in files.items()}
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def fs_used(root: str) -> int:
    st = os.statvfs(root)
    return (st.f_blocks - st.f_bfree) * st.f_frsize


class RssSampler:
    """The process's resident set every 10 ms from /proc/self/statm, on a
    thread; `mark(name)` records it now. Given a store's `root`, the file
    system's used bytes every 100 ms (`disk`). While spans are on it also
    logs each finished phase span, so a run that is cut shows where it
    was."""

    def __init__(self, log=None, root=None):
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.samples: list[tuple[float, int]] = []
        self.disk: list[tuple[float, int]] = []
        self.marks: dict[str, int] = {}
        self.log, self.root = log, root
        self._seen = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def mark(self, name: str) -> int:
        self.marks[name] = v = self.rss()
        self.samples.append((time.perf_counter(), v))
        return v

    def _run(self):
        tick = 0
        while not self._stop.wait(0.01):
            self.samples.append((time.perf_counter(), self.rss()))
            if self.root is not None and tick % 10 == 0:
                self.disk.append((time.perf_counter(), fs_used(self.root)))
            tick += 1
            if self.log is not None and tick % 100 == 0:
                self._log_spans()

    def _log_spans(self):
        done = trace.spans()
        for s in done[self._seen:]:
            if s["name"] in ("stream.staging", "stream.stage",
                             "stream.finalize", "point_scale") or \
                    s["name"] == "server.crebuild.mac_stage" and \
                    s.get("attrs", {}).get("s", 0) % 6 == 0:
                self.log(f"  {s['name']} {s.get('attrs', {})}: "
                         f"{s['elapsed_s']:.3f}s rss="
                         f"{self.samples[-1][1] / 2 ** 30:.2f}GiB")
        self._seen = len(done)

    def __enter__(self):
        self.samples.append((time.perf_counter(), self.rss()))
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.samples.append((time.perf_counter(), self.rss()))

    @property
    def peak_mib(self) -> float:
        return max(v for _, v in self.samples) / 2 ** 20

    def window(self, t0: float, t1: float) -> dict:
        """The peak within [t0, t1] and the RSS just after t1, in MiB."""
        inside = [v for t, v in self.samples if t0 <= t <= t1]
        after = next((v for t, v in self.samples if t >= t1),
                     self.samples[-1][1])
        return {"peak_mib": max(inside or [after]) / 2 ** 20,
                "after_mib": after / 2 ** 20}


def open_server(scheme: str, n: int, top: int, stripe: int, root: str,
                device) -> PorlaServer:
    """A server at n blocks over the store `root`, set up as the
    initialize message leaves it (`_setup`); a KZG server gets the SRS a
    client of the default tau would send."""
    cfg = PorlaConfig(scheme=scheme, top_caching_level=top,
                      stream_stripe_blocks=stripe, storage_dir=root)
    server = PorlaServer(cfg, device=device)
    if scheme == "kzg":
        tau = int.from_bytes(cfg.tau_key, "big") % C.BN254_R
        server.srs = kzg.KzgSrs.from_tau(tau, NUM_CHUNKS)
    server._setup(n)
    return server


def seed_blocks(store, n: int, seed: int) -> None:
    """U/ <- n random blocks from `seed`, in writes of SEED_BATCH blocks
    (either package's store: `write_blocks(indices, bytes)`)."""
    rng = np.random.default_rng([seed, 0])
    for i0 in range(0, n, SEED_BATCH):
        cnt = min(SEED_BATCH, n - i0)
        store.write_blocks(range(i0, i0 + cnt), rng.integers(
            0, 256, cnt * BLOCK_SIZE, dtype=np.uint8).tobytes())


def seed_scalars(n: int, seed: int) -> torch.Tensor:
    """n random scalars below 2^252 (below either curve's order) from
    `seed`, as (n, 16) limbs."""
    rng = np.random.default_rng([seed, 1])
    k = rng.integers(0, 1 << L.LIMB_BITS, (n, L.NLIMBS), dtype=np.int64)
    k[:, -1] &= (1 << (252 - 240)) - 1
    return torch.from_numpy(k)


def seed_macs(server, k: torch.Tensor) -> None:
    """The server's MAC plane <- k_j * G, K2 on the server's device."""
    ops, n = server.ops, k.shape[0]
    g = ops.from_affine([ops.curve.g], server.device)
    gs = JacPoint(*(c.expand(n, L.NLIMBS).contiguous() for c in g))
    server.mac_u = cuda_curve.scalar_mul(ops, gs, k.to(server.device), 256)


def streamed_crebuild(server, sampler: RssSampler) -> dict:
    """The server's CRebuild with the spans on (the card synchronised at
    each span's end): the phases' seconds, RSS and launches. Raises unless
    it took the streamed branch."""
    dev = server.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    native.reset_launches()
    trace.reset()
    trace.enable(True, sync=sync)
    try:
        server._crebuild()
    finally:
        trace.enable(False)
    launches = native.launches()
    spans = trace.spans()
    top = server.height - 1
    if not server.levels[top].file_backed or \
            not any(s["name"] == "stream.staging" for s in spans):
        raise AssertionError(f"the CRebuild of level {top} did not stream "
                             f"(top_caching_level "
                             f"{server.config.top_caching_level})")
    total = next(s for s in spans if s["name"] == "server.crebuild")
    phases, memory = {}, {}
    for ph, names in PHASE_SPANS.items():
        mine = [s for s in spans if s["depth"] == 1 and s["name"] in names]
        phases[ph] = sum(s["elapsed_s"] for s in mine)
        memory[ph] = sampler.window(
            min(s["ts"] for s in mine),
            max(s["ts"] + s["elapsed_s"] for s in mine))
    return {"phases_s": phases, "total_s": total["elapsed_s"], "rss": memory,
            "window": (total["ts"], total["ts"] + total["elapsed_s"]),
            "launches": launches,
            "cuda_max_allocated_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None}


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _stripes(n: int, stripe: int):
    return [range(i0, min(i0 + stripe, n)) for i0 in range(0, n, stripe)]


def commit_plain(server, scalars: torch.Tensor) -> JacPoint:
    """The plain version of the server's commitment of a (B, 128, 16)
    scalar batch (`pedersen.commit_blocks`: K4 in groups of 128 lanes), at
    K4's split for that shape, over the server's own table."""
    B, ng = scalars.shape[0], scalars.shape[1]
    flat = scalars.reshape(B * ng, L.NLIMBS).contiguous()
    return cuda_curve.group_sum_plain(
        server.ops, cuda_curve.fb_lanes_plain(
            server.commit_table, flat, cuda_curve.fb_split(B * ng, ng)), B)


def check_data_and_align(server) -> dict:
    """(data) every block of the top level's H_X/H_Y files against K1's
    codeword of U; (align) the "a" plane of the first and last stripe of
    each side against the plain K4 on K1's alignment scalars."""
    n, ctx, dev = server.num_blocks, server.ctx, server.device
    store, top = server.store, server.height - 1
    stripes = _stripes(n, server.config.stream_stripe_blocks)
    ends = [stripes[0]] + ([stripes[-1]] if len(stripes) > 1 else [])
    wt = ctx.wt_scalar(server.write_step)
    out = {"k1_encode_crt_s": [], "k4_stripe_s": [], "k4_plain_stripe_s": []}
    for is_x, side in ((True, "x"), (False, "y")):
        lanes = [torch.empty((n, NUM_CHUNKS, L.NLIMBS), dtype=torch.int64,
                             device=dev) for _ in range(2)]
        for idx in stripes:
            d = store.read_blocks_crt(idx, ctx.mod_q, dev)
            if not is_x:
                d = compute.scale_crt(ctx.mod_q, d, wt)
            for dst, src in zip(lanes, d):
                dst[idx.start:idx.stop] = src
        t0 = _sync(dev)
        enc = compute.encode_crt(ctx.mod_q, ctx, CrtArray(*lanes))
        out["k1_encode_crt_s"].append(_sync(dev) - t0)
        del lanes
        # limbs below 2^16 are the files' bytes one to one, so equal limbs
        # are equal bytes
        for idx in stripes:
            got = store.read_codes_256(is_x, top, idx, dev)
            bad = (got != enc.p[idx.start:idx.stop]).flatten(1).any(1)
            if bad.any():
                i = idx.start + int(bad.nonzero()[0])
                raise CheckFailed(f"H_{side.upper()} block {i} of level "
                                  f"{top} differs from K1's codeword")
        plane = getattr(server.levels[top], side).points["a"]
        for idx in ends:
            sc = engine.align_scalars(
                CrtArray(enc.p[idx.start:idx.stop],
                         enc.q[idx.start:idx.stop]), ctx.mod_q)
            t0 = _sync(dev)
            server._commit_batch(sc)
            t1 = _sync(dev)
            want = commit_plain(server, sc)
            out["k4_stripe_s"].append(t1 - t0)
            out["k4_plain_stripe_s"].append(_sync(dev) - t1)
            got = index(plane, slice(idx.start, idx.stop))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise CheckFailed(f"the {side} alignment plane's blocks "
                                  f"{idx.start}..{idx.stop - 1} differ from "
                                  f"the plain K4")
        del enc
    out["data"] = "exact"
    out["data_blocks"] = 2 * n
    out["align"] = "exact"
    out["align_stripes"] = [[r.start, r.stop] for r in ends]
    return out


def check_mac(server, k: torch.Tensor, seed: int,
              samples: int = MAC_SAMPLES) -> dict:
    """Sampled codewords of each "c" plane against t_i * G, t the
    CRebuild's stages over k mod q (the Y copy's k scaled by w^bitrev(ws))
    in Python ints."""
    n, ops = server.num_blocks, server.ops
    cv, q, p = ops.curve, ops.order.n, C.FFT_PRIME
    w = pow(C.FFT_GENERATOR, (p - 1) // (2 * n), p)
    wt = pow(w, engine.reverse_bits(server.write_step % n, server.height - 1),
             p) % q
    kx = np.array(L.tensor_to_ints(k), dtype=object).reshape(n, 1) % q
    rng = np.random.default_rng([seed, 2])
    idx = sorted(int(i) for i in rng.choice(n, min(samples, n),
                                            replace=False))
    lv = server.levels[server.height - 1]
    for side, vals in (("x", kx), ("y", kx * wt % q)):
        t = exact_encode(q, vals)
        plane = getattr(lv, side).points["c"]
        got = ops.to_affine(index(plane, torch.tensor(idx,
                                                      device=plane.x.device)))
        for i, pt in zip(idx, got):
            if pt != ecc.mul(cv, cv.g, int(t[i, 0])):
                raise CheckFailed(f"the {side} MAC plane's codeword {i} is "
                                  f"not t_{i} * G")
    return {"mac": "exact", "mac_samples": len(idx)}


def run(n: int = 1 << 18, top: int = 10, stripe: int = 4096,
        scheme: str = "ipa", device="cuda", store: str | None = None,
        check: bool = False, seed: int = 0, log=print) -> dict:
    """Seed, stream and (with `check`) verify in `store`, or in a new
    temporary directory that is removed at the end; returns the record."""
    dev = native.resolve_device(device)
    made = store is None
    root = tempfile.mkdtemp(prefix="porla_ooc_") if made else store
    try:
        return measure(n, top, stripe, scheme, dev, root, check, seed,
                       log)[0]
    finally:
        if made:
            shutil.rmtree(root, ignore_errors=True)


def measure(n, top, stripe, scheme, dev, root, check, seed, log):
    """The tool's work on `dev` in the store `root`: returns (record, the
    server after its CRebuild, the seed scalars k)."""
    os.makedirs(root, exist_ok=True)
    sampler = RssSampler(log, root)
    sampler.mark("python_torch")
    card = "cpu"
    if dev.type == "cuda":
        torch.empty(1, device=dev)
        sampler.mark("cuda_context")
        native.library()
        sampler.mark("kernels_loaded")
        card = native.card_line()
    space = refuse_if_small(root, n)
    fs = store_filesystem(root)
    log(f"n={n} scheme={scheme} store={root} ({fs['fstype']} on "
        f"{fs['mount']}, {space['free_bytes']} bytes free, "
        f"{space['needed_bytes']} needed) device={card}")
    used0 = fs_used(root)
    with sampler:
        server = open_server(scheme, n, top, stripe, root, dev)
        sampler.mark("server")
        t0 = time.perf_counter()
        seed_blocks(server.store, n, seed)
        k = seed_scalars(n, seed)
        seed_macs(server, k)
        seed_s = _sync(dev) - t0
        sampler.mark("seeded")
        log(f"seeded {n} blocks and MACs in {seed_s:.3f}s")
        run_ = streamed_crebuild(server, sampler)
        used_after = fs_used(root) - used0
        sampler.mark("crebuild")
        crebuild_peak = max(v for t, v in sampler.samples
                            if t <= run_["window"][1])
        used_peak = max([used_after] + [v - used0 for t, v in sampler.disk
                                        if t <= run_["window"][1]])
        log(f"streamed CRebuild {run_['total_s']:.3f}s: "
            + ", ".join(f"{p} {run_['phases_s'][p]:.3f}s" for p in PHASES))
        result = {}
        if check:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            native.reset_launches()
            t0 = time.perf_counter()
            result = check_data_and_align(server)
            result.update(check_mac(server, k, seed))
            result["check_s"] = time.perf_counter() - t0
            result["launches"] = native.launches()
            if dev.type == "cuda":
                result["cuda_max_allocated_bytes"] = \
                    torch.cuda.max_memory_allocated(dev)
            sampler.mark("check")
            log(f"check exact in {result['check_s']:.3f}s")
    data_s = run_["phases_s"]["data_stages"]
    rec = {
        "metric": "streamed_crebuild", "n": n, "top_caching_level": top,
        "stripe_blocks": stripe, "scheme": scheme, "seed": seed,
        "data_plane_bytes_per_side": n * NUM_CHUNKS * 32,
        "phases_s": run_["phases_s"], "total_s": run_["total_s"],
        "coeffs_per_s_data_stages": n * NUM_CHUNKS * 2 / data_s,
        "peak_rss_gb": crebuild_peak / 1e9,
        "device": card, "seed_s": seed_s,
        "launches": run_["launches"],
        "memory": {
            "rss_mib": {k: v / 2 ** 20 for k, v in sampler.marks.items()},
            "rss_by_phase": run_["rss"],
            "rss_peak_mib": crebuild_peak / 2 ** 20,
            "cuda_max_allocated_bytes": run_["cuda_max_allocated_bytes"],
            "pinned_buffer_bytes": server.store.pinned_bytes},
        "disk": {"filesystem": fs, "space": space,
                 "at_peak": layout(n, True), "after": layout(n, False),
                 "fs_used_delta_peak_bytes": used_peak,
                 "fs_used_delta_after_bytes": used_after},
    }
    if check:
        rec["check"] = {part: result.pop(part)
                        for part in ("data", "align", "mac")}
        rec["check_detail"] = result
    return rec, server, k


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--stripe", type=int, default=4096)
    ap.add_argument("--scheme", choices=["ipa", "kzg"], default="ipa")
    ap.add_argument("--out", default="ooc_torch.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--store", default=None,
                    help="the store's directory (default: a new temporary "
                         "one, removed at the end)")
    ap.add_argument("--check", action="store_true",
                    help="hold the streamed top level bit-exact")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    log = lambda msg: print(msg, flush=True)
    rec = run(args.n, args.top, args.stripe, args.scheme, args.device,
              args.store, args.check, args.seed, log)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
