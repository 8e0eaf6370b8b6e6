"""Porla server: stores the database, maintains the hierarchical log with
homomorphic MACs, answers updates and audits.

Reimplements the reference server's semantics (porla/Server/Server.hpp)
on PyTorch: data plane = CRT limb tensors, MAC plane = batched Jacobian
points, both resident on `device` (the card unless the caller asks for
the CPU). Message framing mirrors the reference's REQ/REP flow (opcodes
'U'/'A', Server.hpp:933-952); the MAC wire format is the 96-byte Jacobian
triple (protocol/points_io.py), and audit replies keep the reference's
33-byte compressed points + 556-byte IPA proof (Server.hpp:880-894), or
for KZG the 192-byte opening and two 96-byte points (Server.hpp:898-916).
The bytes are those of the reference package's server, so either package's
client can talk to either server.

Both schemes run on one device, or with `config.mesh` (a
`parallel.sharded.Mesh`) over a mesh of devices, as the reference's server
routes it: the cached CRebuild's data encode (the distributed NTT), the MAC
stages of both CRebuilds, every commitment batch (tensor parallel over the
generators, `_commit_batch`) and the audit's MAC and alignment MSMs (data
parallel, `_msm_sharded`); updates' folds stay on `device`. Levels up to
`config.top_caching_level` are held in memory; the data planes of the
levels above it live in the reference's H_X/H_Y files, written by the
streamed CRebuild and fold of protocol/stream.py (CRebuild_No_Cached and
the disk `mix`), and audits read their samples back from those files. A
ready server checkpoints to the reference package's `checkpoint.npz` +
`checkpoint.json` layout (a file-backed level's data stays in its files),
so either package resumes the other's checkpoint, and a mesh server's
checkpoint resumes on one device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from porla_tpu_torch import native
from porla_tpu_torch.config import BLOCK_SIZE, NUM_CHUNKS, PorlaConfig
from porla_tpu_torch.commit import ipa, kzg, pedersen
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves import kernels as ck
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint, cat, index
from porla_tpu_torch.fields import limbs
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.ntt import engine
from porla_tpu_torch.ntt.engine import MOD_P, CrtArray, NttContext
from porla_tpu_torch.parallel import sharded
from porla_tpu_torch.protocol import auditing, compute, hlog, points_io, stream
from porla_tpu_torch.protocol.hlog import Level, Planes
from porla_tpu_torch.storage.store import BlockStore
from porla_tpu_torch.utils import trace


class PorlaServer:
    def __init__(self, config: PorlaConfig, device="cuda"):
        if config.mesh is not None and not isinstance(config.mesh,
                                                      sharded.Mesh):
            raise TypeError(f"config.mesh is a {type(config.mesh).__name__}"
                            f", not a parallel.sharded.Mesh")
        self.config = config
        self.device = native.resolve_device(device)
        self.store = BlockStore(config.storage_dir)
        # commit_table: the K4 table every commitment batch reads, the IPA
        # generators' or, once the client sends it, the SRS's
        self._srs = None
        if config.scheme == "ipa":
            self.ipa_key = ipa.IpaKey(*pedersen.ipa_generators(), self.device)
            self.commit_table = self.ipa_key.table
            self.ops = secp256k1()
        else:  # kzg: the SRS arrives from the client (Server.hpp:179-194)
            self.commit_table = None
            self.ops = bn254()
        self.num_blocks = 0
        self.write_step = 0
        self._mesh = config.mesh
        self._state = "generators"

    @property
    def srs(self):
        """The KZG SRS, None until the client sends it. Setting it makes
        its G1 table the commit table."""
        return self._srs

    @srs.setter
    def srs(self, srs) -> None:
        self._srs = srs
        self.commit_table = srs.table

    # ------------------------------------------------------------------ wire

    @torch.inference_mode()
    def handle(self, msg: bytes) -> bytes:
        if self._state == "generators":
            self._state = "num_blocks"
            if self.config.scheme == "ipa":
                assert msg == b"GET GENERATORS"
                pts = self.ipa_key.gens_affine + [self.ipa_key.u]
                return points_io.points_to_bytes(self.ops.from_affine(pts),
                                                 self.ops)
            # kzg: the first message is the SRS (init_SRS_from_data,
            # Server.hpp:179-194)
            self.srs = kzg.KzgSrs.from_bytes(msg)
            return b"RECEIVED SRS FROM CLIENT."
        if self._state == "num_blocks":
            self._setup(int.from_bytes(msg[:4], "little"))
            self._state = "blocks"
            return b"OK: awaiting blocks"
        if self._state == "blocks":
            self._recv_blocks(msg)
            if self._blocks_received == self.num_blocks:
                self._state = "deltas"
            return f"RECEIVED {len(msg)} BYTES FROM CLIENT.".encode()
        if self._state == "deltas":
            reply = f"RECEIVED {len(msg)} BYTES FROM CLIENT.".encode()
            self._crebuild()
            self._absorb_deltas(self.height - 1, msg)
            self._state = "ready"
            return reply
        op = msg[:1]
        if op == b"U":
            return self.update(msg[1:])
        if op == b"A":
            return self.audit(msg[1:17])
        raise ValueError(f"unknown opcode {op!r}")

    # ----------------------------------------------------------------- setup

    def _setup(self, num_blocks: int) -> None:
        self.num_blocks = num_blocks
        self.ctx = NttContext(num_blocks, self.config.scheme)
        self.height = self.ctx.height
        self.mod_q = self.ctx.mod_q
        self.write_step = 0
        self.levels = [Level(Planes(), Planes()) for _ in range(self.height)]
        self.mac_u = hlog.infinity_points(num_blocks, self.ops, self.device)
        self._blocks_received = 0
        if self._mesh is not None:
            self._setup_sharded()

    def _setup_sharded(self) -> None:
        """Multi-device mode: the sharded functions over the configured
        mesh (parallel/sharded.py). The data encode shards blocks over
        "blocks" with shard exchanges at the wide stages; the MAC mirror is
        a sharded point stage per stage; commitments are tensor parallel
        over "chunks"; the audit's combination MSMs data parallel."""
        ctx, mesh = self.ctx, self._mesh
        self._sh_enc = {lane: sharded.sharded_encode_fn(ctx, mesh, mod)
                        for lane, mod in (("p", MOD_P), ("q", ctx.mod_q))}
        self._sh_tab_std = [sharded.stage(mesh, t.to(self.device)) for t in
                            sharded.stage_twiddle_tables_std(ctx)]
        self._sh_pt = sharded.sharded_point_stage_fn(ctx, mesh, self.ops)
        self._sh_commit = sharded.sharded_commit_fn(mesh, self.commit_table)
        self._sh_msm32 = sharded.sharded_msm_fn(mesh, self.ops, nbits=32)
        self._sh_pip: dict = {}

    def _recv_blocks(self, msg: bytes) -> None:
        with trace.span("server.recv_blocks"):
            self._recv_blocks_impl(msg)

    def _recv_blocks_impl(self, msg: bytes) -> None:
        """Absorb one init batch: batch block write + one MAC parse + row
        assignment into the device-resident MAC plane."""
        rec = BLOCK_SIZE + points_io.MAC_WIRE_SIZE
        assert len(msg) % rec == 0
        count = len(msg) // rec
        view = memoryview(msg)
        datas = b"".join(view[k * rec:k * rec + BLOCK_SIZE]
                         for k in range(count))
        macs = b"".join(view[k * rec + BLOCK_SIZE:(k + 1) * rec]
                        for k in range(count))
        i0 = self._blocks_received
        self.store.write_blocks(range(i0, i0 + count), datas)
        pts = points_io.points_from_bytes(macs, self.ops, self.device)
        for dst, src in zip(self.mac_u, pts):
            dst[i0:i0 + count] = src
        self._blocks_received += count

    def _absorb_deltas(self, level: int, msg: bytes) -> None:
        """Add complement deltas into MAC_commitments_H[level]
        (Server.hpp:289-307, 449-469)."""
        with trace.span("server.parse", bytes=len(msg)):
            deltas = points_io.points_from_bytes(msg, self.ops, self.device)
        l = 1 << level
        assert deltas.x.shape[0] == 2 * l
        lv = self.levels[level]
        with trace.span("server.absorb", points=2 * l, level=level):
            lv.x.points["c"] = cuda_curve.point_add(
                self.ops, lv.x.points["c"], index(deltas, slice(0, l)))
            lv.y.points["c"] = cuda_curve.point_add(
                self.ops, lv.y.points["c"], index(deltas, slice(l, 2 * l)))

    # ------------------------------------------------------------- rebuild

    def _crebuild(self) -> None:
        """CRebuild (Server.hpp:1479-1485): rebuild level C from U, cached
        (all in memory) while the level fits the caching budget, streamed
        through files otherwise (CRebuild_No_Cached)."""
        with trace.span("server.crebuild", n=self.num_blocks):
            if self.height - 1 > self.config.top_caching_level:
                self._crebuild_streaming()
            else:
                self._crebuild_impl()

    def _crebuild_impl(self) -> None:
        n = self.num_blocks
        ctx = self.ctx
        wt = ctx.wt_scalar(self.write_step)

        data_x = self.store.read_blocks_crt(range(n), self.mod_q, self.device)
        data_y = compute.scale_crt(self.mod_q, data_x, wt)
        mc_y = compute.point_scale(self.mac_u, wt.std, ops=self.ops)

        # data planes: all butterfly stages (K1); MAC-commitment planes:
        # per-stage point butterflies (K3). Alignments reset to infinity
        # (no align_MAC in the cached path).
        with trace.span("server.crebuild.data"):
            dx, dy = self._encode(data_x), self._encode(data_y)
        cx, cy = self._mac_stages([self.mac_u, mc_y])

        top = self.levels[self.height - 1]
        top.x = Planes(data=dx, points={
            "c": cx, "a": hlog.infinity_points(n, self.ops, self.device)})
        top.y = Planes(data=dy, points={
            "c": cy, "a": hlog.infinity_points(n, self.ops, self.device)})
        top.empty = False
        top.file_backed = False
        hlog.clear_below(self.levels, self.height - 1)

    def _crebuild_streaming(self) -> None:
        """CRebuild_No_Cached (Server.hpp:1835-2255): rebuild level C from
        U with the data planes streamed through staging files, at most a
        stripe in memory, into the top level's H_X/H_Y files. The MAC planes
        stay on the device, as the reference's stay in memory
        (Server.hpp:221-241): the same K2 scale and K3 stages as the cached
        path."""
        n, ctx, dev = self.num_blocks, self.ctx, self.device
        top = self.height - 1
        S = self.config.stream_stripe_blocks
        wt = ctx.wt_scalar(self.write_step)
        tag_x, tag_y = "crx", "cry"

        stream.stage_u_to_staging(self.store, ctx, wt, n, tag_x, tag_y, S, dev)
        for first, last in stream.stage_passes(n, S):
            for tag in (tag_x, tag_y):
                stream.stream_stages(self.store, ctx, tag, n, first, last, S,
                                     dev)

        cy = compute.point_scale(self.mac_u, wt.std, ops=self.ops)
        cx, cy = self._mac_stages([self.mac_u, cy])

        ax = stream.finalize_staged_level(self, tag_x, True, top, n, S)
        ay = stream.finalize_staged_level(self, tag_y, False, top, n, S)
        lv = self.levels[top]
        lv.x = Planes(points={"c": cx, "a": ax})
        lv.y = Planes(points={"c": cy, "a": ay})
        lv.empty = False
        lv.file_backed = True
        hlog.clear_below(self.levels, top)

    def _encode(self, a: CrtArray) -> CrtArray:
        """All CRebuild stages over an (n, C, 16) CRT array: K1 per lane, or
        the distributed NTT over the mesh, gathered back to `device`."""
        if self._mesh is None:
            return compute.encode_crt(self.mod_q, self.ctx, a)
        return CrtArray(*(sharded.gather(self._mesh, self._sh_enc[lane](x),
                                         self.device)
                          for lane, x in (("p", a.p), ("q", a.q))))

    def _mac_stages(self, planes: list[JacPoint]) -> list[JacPoint]:
        """The CRebuild stages s = 1..height-1 over the (n,) MAC planes,
        all planes in one K3 launch a stage (a shard or shard pair with a
        mesh, the planes sharded from the first stage to the last)."""
        mesh = self._mesh
        if mesh is not None:
            planes = [sharded.stage(mesh, p) for p in planes]
        for s in range(1, self.height):
            with trace.span("server.crebuild.mac_stage", s=s):
                if mesh is None:
                    planes = compute.point_stage(self.ctx, s, planes,
                                                 ops=self.ops)
                else:
                    planes = self._sh_pt[s](planes, self._sh_tab_std[s - 1])
        if mesh is not None:
            planes = [sharded.gather(mesh, p, self.device) for p in planes]
        return planes

    # --------------------------------------------------------------- update

    def update(self, payload: bytes) -> bytes:
        with trace.span("server.update", write_step=self.write_step + 1):
            return self._update_impl(payload)

    def _update_impl(self, payload: bytes) -> bytes:
        index_ = int.from_bytes(payload[:8], "little")
        data = payload[:BLOCK_SIZE]
        with trace.span("server.block_write", bytes=BLOCK_SIZE):
            self.store.write_block(index_ - 1, data)
        with trace.span("server.parse", points=1):
            chunks = [int.from_bytes(data[i * 32:(i + 1) * 32], "little")
                      for i in range(NUM_CHUNKS)]
            mac = points_io.points_from_bytes(
                payload[BLOCK_SIZE:BLOCK_SIZE + points_io.MAC_WIRE_SIZE],
                self.ops, self.device)
            for dst, src in zip(self.mac_u, mac):
                dst[index_ - 1] = src[0]

        self.write_step += 1
        if self.write_step % self.num_blocks == 0:
            self._crebuild()
            updated_level = self.height - 1
        else:
            updated_level = self._hadd(chunks, mac)

        self._absorb_deltas(
            updated_level, payload[BLOCK_SIZE + points_io.MAC_WIRE_SIZE:])
        return f"BLOCK {index_} IS UPDATED.".encode()

    def _hadd(self, chunks: list[int], mac: JacPoint) -> int:
        """HAdd (Server.hpp:1388-1477). Returns the folded level."""
        with trace.span("server.hadd"):
            ctx = self.ctx
            wt = ctx.wt_scalar(self.write_step)
            with trace.span("server.hadd.scale", chunks=len(chunks)):
                data = engine.crt_from_ints(chunks, self.mod_q, self.device)
                data = CrtArray(data.p[None], data.q[None])  # (1, C, 16)

                data_b2 = compute.scale_crt(self.mod_q, data, wt)
                mac_b2 = compute.point_scale(mac, wt.std, ops=self.ops)
                align_b2 = hlog.infinity_points(1, self.ops, self.device)
                align_x = hlog.infinity_points(1, self.ops, self.device)

            # align_MAC(data_B2): commit the mod-p correction, reduce data
            align_b2, data_b2 = self._align(data_b2, align_b2)

            slot_x = Planes(data=data, points={"c": mac, "a": align_x})
            slot_y = Planes(data=data_b2, points={"c": mac_b2, "a": align_b2})

            if self.levels[0].empty:
                self.levels[0].x = slot_x
                self.levels[0].y = slot_y
                self.levels[0].empty = False
                return 0
            level = 1
            while not self.levels[level].empty:
                level += 1
            if level > self.config.top_caching_level:
                self._fold_streamed(level, slot_x, slot_y)
            else:
                hlog.fold_to_level(ctx, self.levels, level, slot_x, slot_y)
            return level

    def _fold_streamed(self, target: int, slot_x: Planes,
                       slot_y: Planes) -> None:
        """Fold levels 0..target-1 and the incoming slot into the
        file-backed level `target` (the reference's disk `mix`,
        Server.hpp:954-1207). The point planes fold on the device as in
        `hlog.fold_to_level`; the data planes stay in memory while a mix's
        output fits the caching budget, then go through staging files, a
        stripe at a time, the two tags fx0/fx1 in turn (a consumed upper's
        files are deleted). A mix's lower is a level in memory or a
        file-backed level's codeword files; its upper is the slot, or the
        previous mix's output in memory or in staging."""
        ctx, store, dev = self.ctx, self.store, self.device
        S = self.config.stream_stripe_blocks
        ram_limit = 1 << self.config.top_caching_level

        def points(p: Planes) -> Planes:
            return Planes(points=p.points)

        lv0 = self.levels[0]
        st_px, st_py = hlog.mix_planes(ctx, points(lv0.x), points(lv0.y),
                                       points(slot_x), points(slot_y), 1)
        # a data plane: CrtArray (memory) or a staging tag
        dx, dy = slot_x.data, slot_y.data
        cycle = 0
        for i in range(1, target + 1):
            length = 1 << (i - 1)            # this mix's lower/upper size
            lv = self.levels[i - 1]
            if i < target:
                nxt = self.levels[i]
                st_px, st_py = hlog.mix_planes(ctx, points(nxt.x),
                                               points(nxt.y), st_px, st_py,
                                               1 << i)
            # the point mix above took level i as its lower; the data mix
            # below takes level i-1 as the lower of the length-sized step
            if 2 * length <= ram_limit:
                tw = ctx.twiddles(length)
                hix, lox = compute.data_butterfly(ctx.mod_q, lv.x.data, dx, tw)
                hiy, loy = compute.data_butterfly(ctx.mod_q, lv.y.data, dy, tw)
                dx, dy = hlog.concat_crt(hix, lox), hlog.concat_crt(hiy, loy)
                continue
            cycle ^= 1
            outs = (f"fx{cycle}", f"fy{cycle}")
            for is_x, d, planes, out in ((True, dx, lv.x, outs[0]),
                                         (False, dy, lv.y, outs[1])):
                if planes.data is not None:
                    lower = stream.ram_reader(planes.data)
                else:
                    lower = stream.level_reader(store, self.mod_q, is_x,
                                                i - 1, dev)
                upper = stream.ram_reader(d) if isinstance(d, CrtArray) \
                    else stream.staged_reader(store, d, dev)
                stream.stream_mix(store, ctx, lower, upper, out, length, S)
                if not isinstance(d, CrtArray):
                    store.delete_staged(d, length)
            dx, dy = outs

        n_out = 1 << target
        ax = stream.finalize_staged_level(self, dx, True, target, n_out, S)
        ay = stream.finalize_staged_level(self, dy, False, target, n_out, S)
        lvt = self.levels[target]
        add = cuda_curve.point_add
        st_px.points["a"] = add(self.ops, st_px.points["a"], ax)
        st_py.points["a"] = add(self.ops, st_py.points["a"], ay)
        lvt.x, lvt.y = st_px, st_py
        lvt.empty = False
        lvt.file_backed = True
        hlog.clear_below(self.levels, target)

    def _align(self, data: CrtArray, acc: JacPoint):
        """align_MAC (Server.hpp:478-562): acc += commit((A mod p) - A);
        A := A mod p. Returns (new acc (batch,), reduced data)."""
        with trace.span("server.align", lanes=data.p.shape[0]):
            c = engine.align_scalars(data, self.mod_q)
            acc = cuda_curve.point_add(self.ops, acc, self._commit_batch(c))
            return acc, engine.crt_reduce_mod_p(data, self.mod_q)

    def _commit_batch(self, scalars: torch.Tensor) -> JacPoint:
        """Commit a (B, NUM_CHUNKS, 16) scalar batch over `commit_table`:
        the Pedersen MSM over the IPA generators, or the SRS MSM for KZG
        (compute_digest_from_srs, main.go:103-116); one K4 launch either
        way, or with a mesh K4 on every grid cell and `group_sum` over each
        block's tp partials (the multi-device form of the 8-thread
        commitment splits, Server.hpp:330-361), B padded to a multiple of dp
        with zero scalars."""
        if self._mesh is None:
            return pedersen.commit_blocks(self.commit_table, scalars)
        B, dp = scalars.shape[0], self._mesh.dp
        pad = -B % dp
        if pad:
            scalars = torch.cat([scalars, scalars.new_zeros(
                (pad,) + tuple(scalars.shape[1:]))])
        out = sharded.gather(self._mesh, self._sh_commit(scalars),
                             self.device)
        return index(out, slice(0, B))

    def _msm_sharded(self, pts: JacPoint, coeffs: list[int]) -> JacPoint:
        """A data-parallel audit-combination MSM (32-bit coefficients) over
        the mesh (Server.hpp:831-848), the point axis padded to a multiple
        of dp with zero-scalar lanes (identity contributions). From
        `PIPPENGER_CROSSOVER` points a shard, or with
        `config.force_sharded_pippenger`, the per-shard Pippenger kernels
        (K5 + K6, the window from `choose_c`), else K2 per shard."""
        mesh, dev = self._mesh, self.device
        n = pts.x.shape[0]
        pad = -n % mesh.dp
        sc = limbs.ints_to_tensor(list(coeffs) + [0] * pad, dev)
        if pad:
            pts = cat([pts, index(pts, [0] * pad)])
        n_loc = (n + pad) // mesh.dp
        if (n_loc >= ck.PIPPENGER_CROSSOVER
                or self.config.force_sharded_pippenger):
            if n_loc not in self._sh_pip:
                self._sh_pip[n_loc] = sharded.sharded_pippenger_msm_fn(
                    mesh, self.ops, nbits=32, n_local=n_loc)
            fn, finish = self._sh_pip[n_loc]
            return finish(fn(pts, sc)).to(dev)
        return self._sh_msm32(pts, sc).to(dev)

    # ---------------------------------------------------------------- audit

    def audit(self, seed: bytes) -> bytes:
        with trace.span("server.audit", write_step=self.write_step):
            return self._audit_impl(seed)

    def _gather(self, plan):
        """Audited rows in sample order: data lanes (S, C, 16) and the
        MAC / alignment points (S,), one index_select per (level, side);
        a file-backed level's rows come from one batched read of its
        codeword files (the reference's threaded audit reads,
        Server.hpp:742-776), the q lane recomputed from the p lane."""
        groups: dict = {}
        for si, s in enumerate(plan.samples):
            groups.setdefault((s.level, s.is_x), []).append((si, s.index))
        order, dp, dq, pc, pa = [], [], [], [], []
        for (level, is_x), items in groups.items():
            lv = self.levels[level]
            planes = lv.x if is_x else lv.y
            if lv.empty or (planes.data is None and not lv.file_backed):
                raise RuntimeError(f"audited level {level} is empty "
                                   f"(write_step {self.write_step})")
            ixs = [ix for _, ix in items]
            rows = torch.tensor(ixs, device=self.device)
            order += [si for si, _ in items]
            if planes.data is None:
                p = self.store.read_codes_256(is_x, level, ixs, self.device)
                dp.append(p)
                dq.append(engine.q_lane_from_p(p, self.mod_q))
            else:
                dp.append(planes.data.p.index_select(0, rows))
                dq.append(planes.data.q.index_select(0, rows))
            pc.append(JacPoint(*(c.index_select(0, rows)
                                 for c in planes.points["c"])))
            pa.append(JacPoint(*(c.index_select(0, rows)
                                 for c in planes.points["a"])))
        inv = torch.empty(len(order), dtype=torch.int64)
        inv[torch.tensor(order)] = torch.arange(len(order))
        inv = inv.to(self.device)
        return (CrtArray(torch.cat(dp)[inv], torch.cat(dq)[inv]),
                index(cat(pc), inv), index(cat(pa), inv))

    def _audit_impl(self, seed: bytes) -> bytes:
        with trace.span("audit.plan"):
            plan = auditing.build_audit_plan(
                seed, self.write_step, self.num_blocks, self.height)
            # pad every audit batch to the occupancy-independent worst case
            # (auditing.audit_pad_slots): zero blocks with coefficient 0
            # and points at infinity are exact identity contributions
            S = auditing.audit_pad_slots(self.num_blocks, self.height)
            auditing.check_pad_slots(plan, S)
        ops, dev = self.ops, self.device
        with trace.span("server.audit.gather", samples=len(plan.samples)):
            blocks, ptc, pta = self._gather(plan)
        coeffs = [s.coeff for s in plan.samples]

        npad = S - len(coeffs)
        if npad:
            with trace.span("server.audit.pad", slots=npad):
                zb = torch.zeros((npad,) + tuple(blocks.p.shape[1:]),
                                 dtype=blocks.p.dtype, device=dev)
                blocks = CrtArray(torch.cat([blocks.p, zb]),
                                  torch.cat([blocks.q, zb]))
                inf = hlog.infinity_points(npad, ops, dev)
                ptc, pta = cat([ptc, inf]), cat([pta, inf])
                coeffs += [0] * npad

        with trace.span("server.audit.combine"):
            B = compute.linear_combine_crt(self.mod_q, blocks, coeffs)

        with trace.span("server.audit.msm", n=len(coeffs)):
            if self._mesh is not None:
                combined_mac_j = self._msm_sharded(ptc, coeffs)
                combined_align_j = self._msm_sharded(pta, coeffs)
            else:
                # MAC + alignment MSMs share coefficients: one K2 launch
                # over the stacked point set, reduced per half
                combined_mac_j, combined_align_j = ck.msm_parts(
                    ops, cat([ptc, pta]),
                    limbs.ints_to_tensor(coeffs + coeffs, dev), 2, nbits=32)

        # align_MAC(B, combined_align); commitment over the reduced B
        B1 = CrtArray(B.p[None], B.q[None])
        combined_align_b, B1 = self._align(B1, combined_align_j)
        with trace.span("server.audit.commit", chunks=NUM_CHUNKS):
            b_chunks = limbs.tensor_to_ints(B1.p[0])
            if self.config.scheme == "ipa":
                combined_mac = ops.to_affine(combined_mac_j)[0]
                combined_align = ops.to_affine(combined_align_b)[0]
                commitment = ops.to_affine(self._commit_batch(
                    limbs.ints_to_tensor(b_chunks, dev)[None]))[0]
        if self.config.scheme == "kzg":
            return self._kzg_reply(plan, b_chunks, combined_mac_j,
                                   combined_align_b)

        # IPA proof over (B, challenge powers) (Server.hpp:856-877)
        a_vec = list(b_chunks)
        b_vec = []
        v = plan.ipa_challenge  # signed int32, may be negative
        for _ in range(NUM_CHUNKS):
            b_vec.append(v)
            v = (v * v) % self.mod_q.n
        with trace.span("server.audit.prove"):
            proof = ipa.prove(a_vec, b_vec, self.ipa_key)
        with trace.span("server.audit.serialize"):
            return (ecc.secp_serialize_compressed(commitment)
                    + ecc.secp_serialize_compressed(combined_mac)
                    + ecc.secp_serialize_compressed(combined_align)
                    + proof)

    def _kzg_reply(self, plan, b_chunks: list[int], combined_mac: JacPoint,
                   combined_align: JacPoint) -> bytes:
        """[C(64) | H(64) | z(32) | claimed(32)] then the combined MAC and
        alignment points as 96-byte triples (create_kzg_proof,
        Server.hpp:898-916 / main.go:153-175)."""
        with trace.span("server.audit.prove"):
            commitment = kzg.commit_msm(self.srs, b_chunks, self.device)
            # the reference passes the next unconsumed signed int through a
            # C int -> Go uint64 conversion (a negative one wraps mod 2^64)
            z = plan.kzg_challenge & 0xFFFFFFFFFFFFFFFF
            H, claimed = kzg.open_at(self.srs, b_chunks, z, self.device)
        with trace.span("server.audit.serialize"):
            proof = (ecc.bn254_marshal(commitment) + ecc.bn254_marshal(H)
                     + (z % kzg.FR).to_bytes(32, "big")
                     + claimed.to_bytes(32, "big"))
            return (proof + points_io.points_to_bytes(combined_mac, self.ops)
                    + points_io.points_to_bytes(combined_align, self.ops))

    # ---------------------------------------------------- checkpoint/resume

    def save_checkpoint(self) -> str:
        """Persist the server state (write counter, MAC plane, the levels'
        planes and, for KZG, the SRS; a file-backed level's data stays in
        its H_X/H_Y files) beside the block files as
        `checkpoint.npz` + `checkpoint.json`, the reference package's layout
        key for key (porla_tpu/protocol/server.py:164-206): host uint32
        (…, 16) limbs, so either package resumes the other's checkpoint.
        Returns the checkpoint path."""
        if self._state != "ready":
            raise RuntimeError("a checkpoint is taken from the ready state")
        arrays: dict = {}
        meta = {"scheme": self.config.scheme,
                "num_blocks": self.num_blocks,
                "write_step": self.write_step,
                "levels": []}
        for li, lv in enumerate(self.levels):
            lm = {"empty": lv.empty, "file_backed": lv.file_backed,
                  "sides": {}}
            for side, planes in (("x", lv.x), ("y", lv.y)):
                lm["sides"][side] = {"has_data": planes.data is not None,
                                     "points": planes.point_names()}
                if planes.data is not None:
                    arrays[f"L{li}{side}_dp"] = limbs.to_numpy(planes.data.p)
                    arrays[f"L{li}{side}_dq"] = limbs.to_numpy(planes.data.q)
                for nm in planes.point_names():
                    for c, a in zip("xyz", planes.points[nm]):
                        arrays[f"L{li}{side}_{nm}{c}"] = limbs.to_numpy(a)
            meta["levels"].append(lm)
        for c, a in zip("xyz", self.mac_u):
            arrays[f"mac_u_{c}"] = limbs.to_numpy(a)
        if self.config.scheme == "kzg":
            arrays["srs"] = np.frombuffer(self.srs.to_bytes(), np.uint8)
        path = os.path.join(self.store.root, "checkpoint.npz")
        np.savez(path, **arrays)
        with open(os.path.join(self.store.root, "checkpoint.json"), "w") as f:
            json.dump(meta, f)
        return path

    @classmethod
    def restore(cls, config: PorlaConfig, device="cuda") -> "PorlaServer":
        """A ready server on `device` from the checkpoint in
        config.storage_dir, written by either package's save_checkpoint
        (the block files are used in place)."""
        with open(os.path.join(config.storage_dir, "checkpoint.json")) as f:
            meta = json.load(f)
        if meta["scheme"] != config.scheme:
            raise ValueError(f"checkpoint of scheme {meta['scheme']!r}, "
                             f"config {config.scheme!r}")
        with np.load(os.path.join(config.storage_dir,
                                  "checkpoint.npz")) as data:
            def pt(prefix):
                return tuple(data[prefix + c] for c in "xyz")

            levels = []
            for li, lm in enumerate(meta["levels"]):
                sides = {}
                for side in ("x", "y"):
                    pm = lm["sides"][side]
                    key = f"L{li}{side}_"
                    sides[side] = {
                        "data": (data[key + "dp"], data[key + "dq"])
                        if pm["has_data"] else None,
                        "points": {nm: pt(key + nm) for nm in pm["points"]}}
                levels.append({"empty": lm["empty"],
                               "file_backed": lm["file_backed"], **sides})
            state = {"num_blocks": meta["num_blocks"],
                     "write_step": meta["write_step"],
                     "mac_u": pt("mac_u_"), "levels": levels}
            if config.scheme == "kzg":
                state["srs"] = data["srs"].tobytes()
        return load_state(state, config, device)


# --- state carry-over ---------------------------------------------------------

def from_jax_state(src, config: PorlaConfig, device="cuda") -> PorlaServer:
    """A port server in the ready state holding the log of `src`, a ready
    server of the reference package (porla_tpu.protocol.server.PorlaServer)
    or any object with the same attributes and numpy-convertible arrays:
    num_blocks, write_step, mac_u (x, y, z) and levels[i] with .empty and
    .x/.y planes (.data CrtArray or None, .points name -> JacPoint) and
    .file_backed. The block and codeword files are shared through
    config.storage_dir: a file-backed level's data is read from them. A KZG
    server's SRS (an object with `to_bytes()`) carries over too."""
    def pt(p):
        return tuple(np.asarray(c) for c in p)

    levels = []
    for lv in src.levels:
        sides = {}
        for side in ("x", "y"):
            planes = getattr(lv, side)
            sides[side] = {
                "data": None if planes.data is None else
                (np.asarray(planes.data.p), np.asarray(planes.data.q)),
                "points": {k: pt(v) for k, v in planes.points.items()}}
        levels.append({"empty": lv.empty,
                       "file_backed": getattr(lv, "file_backed", False),
                       **sides})
    state = {"num_blocks": src.num_blocks, "write_step": src.write_step,
             "mac_u": pt(src.mac_u), "levels": levels}
    if config.scheme == "kzg":
        state["srs"] = src.srs.to_bytes()
    return load_state(state, config, device)


def load_state(state: dict, config: PorlaConfig, device="cuda") -> PorlaServer:
    """A ready server on `device` from a log state of host numpy arrays in
    the reference package's layout: uint32 (…, 16) limbs; num_blocks,
    write_step, mac_u (x, y, z) and levels of {"empty", "file_backed", "x",
    "y"}, each side {"data": (p, q) limbs or None, "points": name -> (x, y,
    z)}; and for KZG "srs", the SRS wire bytes. A file-backed level has no
    data plane: its data is in config.storage_dir's H_X/H_Y files."""
    srv = PorlaServer(config, device)
    if config.scheme == "kzg":
        srv.srs = kzg.KzgSrs.from_bytes(state["srs"])
    srv._setup(state["num_blocks"])
    srv.write_step = state["write_step"]
    dev = srv.device

    def pt(xyz):
        return JacPoint(*(limbs.to_torch(c, dev) for c in xyz))

    srv.mac_u = pt(state["mac_u"])
    for lv, lm in zip(srv.levels, state["levels"]):
        lv.empty = lm["empty"]
        lv.file_backed = lm.get("file_backed", False)
        for side in ("x", "y"):
            sm = lm[side]
            data = None if sm["data"] is None else CrtArray(
                limbs.to_torch(sm["data"][0], dev),
                limbs.to_torch(sm["data"][1], dev))
            setattr(lv, side, Planes(data=data, points={
                k: pt(v) for k, v in sm["points"].items()}))
    srv._blocks_received = srv.num_blocks
    srv._state = "ready"
    return srv
