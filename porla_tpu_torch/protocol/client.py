"""Porla client: O(1) secret state, commitments, MAC complements, audits.

Reimplements the reference client (porla/Client/Client.hpp) on PyTorch,
with its point work on `device` (the card unless the caller asks for the
CPU). The client keeps only the secret scalar alpha and the AES PRF key;
every MAC complement h^PRF(level,index,write_step) is re-derived on demand
(Client.hpp:42-46, 423-455). Both schemes: IPA on secp256k1 (Pedersen
commitments on K4, the IPA transcript) and KZG on BN254 (the client's
trusted setup, commitments f(tau)*alpha*G1 on the host, a pairing check).

Deliberate deviation from the reference: during initialize the reference
computes its complement fold at write_step = 1 while the server rebuilds
at write_step = 0 (Client.hpp:180 vs Server.hpp:218), which leaves the
initial level-C complements inconsistent until the first full epoch
rebuild — their self-test only audits after a full epoch so it never
trips. We run the whole initialize at write_step = 0 on both sides, so
audits verify immediately.
"""

from __future__ import annotations

import hashlib
import os

import torch

from porla_tpu_torch import native
from porla_tpu_torch.config import NUM_CHUNKS, PorlaConfig
from porla_tpu_torch.commit import ipa, kzg, pedersen
from porla_tpu_torch.crypto.aes import MacPrf, Prg
from porla_tpu_torch.crypto import testrand
from porla_tpu_torch.curves import cuda_curve
from porla_tpu_torch.curves import kernels as ck
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint, cat, index
from porla_tpu_torch.fields import limbs
from porla_tpu_torch.fields.constants import BN254_R
from porla_tpu_torch.golden import bn254_pairing as bp
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.ntt.engine import NttContext
from porla_tpu_torch.protocol import auditing, compute, hlog, points_io
from porla_tpu_torch.protocol.hlog import Level, Planes
from porla_tpu_torch.utils import trace


class AuditError(AssertionError):
    pass


def alpha_products(ops, alpha: int, points: JacPoint) -> JacPoint:
    """alpha * points[i] in one K2 launch: its windowed mode over 128 bits
    where alpha fits in them (IPA's alpha, and KZG's from a 16-byte key),
    its GLV mode otherwise (a KZG alpha of up to 254 bits)."""
    nbits = 128 if alpha.bit_length() <= 128 else 256
    scalars = limbs.ints_to_tensor([alpha] * points.x.shape[0],
                                   points.x.device)
    return cuda_curve.scalar_mul(ops, points, scalars, nbits)


def mac_sides(ops, alpha: int, commitment: JacPoint, compl: JacPoint,
              mac_align: JacPoint) -> list:
    """The two sides of the audit's MAC equation, alpha C + sum(coeff
    complement) and MAC + alpha align, as affine points: alpha's two
    products in one K2 launch, the two adds in one `point_add` launch, one
    read-back. `commitment` and `compl` are (1,) JacPoints, `mac_align`
    the (2,) MAC and alignment points."""
    prod = alpha_products(ops, alpha,
                          cat([commitment, index(mac_align, slice(1, 2))]))
    sides = cuda_curve.point_add(
        ops, cat([index(prod, slice(0, 1)), index(mac_align, slice(0, 1))]),
        cat([compl, index(prod, slice(1, 2))]))
    return ops.to_affine(sides)


class UpdateOrderError(ValueError):
    """The protocol's complement scheme derives every PRF time input
    canonically from write_step alone (O(1) client state): the epoch
    CRebuild regenerates U complements assuming block i+1 was last
    written at step base+i (Client.hpp:483-499), and the replay folds
    assume the same discipline for the log levels. Updates must
    therefore arrive ROUND-ROBIN: block_id == (write_step % n) + 1.
    The reference SILENTLY corrupts future epochs on any other order
    (its self_test only ever updates in rotation); we turn that into a
    typed error at the call site instead of a failed audit an epoch
    later. (Found by the round-4 soak: a warm-up update(1) shifted the
    rotation and the post-CRebuild audit failed.)"""


class PorlaClient:
    def __init__(self, config: PorlaConfig, transport,
                 data_seed: bytes | None = None, device="cuda"):
        self.config = config
        self.transport = transport  # callable: bytes -> bytes (REQ/REP)
        self.device = native.resolve_device(device)
        self.prf = MacPrf(config.secret_key)
        if config.scheme == "ipa":
            # alpha = low 128 bits little-endian (memcpy into scalar limbs,
            # Client.hpp:150-151); h = first zero-state testrand draw
            self.alpha = int.from_bytes(config.secret_key, "little")
            self.h = testrand.derive_h_mac()
            self.ops = secp256k1()
        else:
            # kzg: alpha and tau are Fr elements from big-endian bytes
            # (gnark SetBytes, main.go:31-40). The reference derives h
            # nondeterministically (SetRandom, main.go:52-59); the reference
            # package derives it from TAU_KEY, and so does this one.
            self.alpha = int.from_bytes(config.secret_key, "big") % BN254_R
            self.tau = int.from_bytes(config.tau_key, "big") % BN254_R
            hr = int.from_bytes(
                hashlib.sha256(config.tau_key + b"porla-h").digest(),
                "big") % BN254_R
            self.h = ecc.mul(ecc.BN254, bp.G1, hr)
            self.ops = bn254()
        # h's table, for every complement: h^PRF is K4 over 128 bits
        self.h_table = cuda_curve.fixed_base_table(self.ops, [self.h],
                                                   nbits=128)
        self.data_rng = Prg(data_seed or os.urandom(16), 1)
        self.audit_seed_rng = Prg(os.urandom(16), 2)
        self.write_step = 0

    # ----------------------------------------------------------------- data

    def create_data_block(self, block_id: int) -> list[int]:
        """Chunk 0 is the block id; the rest are random 256-bit values
        (Client.hpp:367-372)."""
        chunks = [block_id]
        raw = self.data_rng.random_data(32 * (NUM_CHUNKS - 1))
        chunks += [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
                   for i in range(NUM_CHUNKS - 1)]
        return chunks

    @staticmethod
    def block_bytes(chunks: list[int]) -> bytes:
        return b"".join(c.to_bytes(32, "little") for c in chunks)

    def _commit_blocks(self, blocks: list[list[int]]) -> JacPoint:
        """Client-side block commitments: the alpha-scaled Pedersen MSM
        (IPA, Client.hpp:374-421) on K4, or f(tau)*alpha*G1 a block (KZG:
        the client knows tau, so a commitment is one scalar mult on the
        host, main.go:70-89; its points go on the wire with Z = 1, as the
        reference client's do)."""
        with trace.span("client.commit", n=len(blocks)):
            if self.config.scheme == "kzg":
                return self.ops.from_affine(
                    [kzg.commit_eval(self.tau, self.alpha, b)
                     for b in blocks], self.device)
            scalars = torch.stack([limbs.ints_to_tensor(b) for b in blocks])
            return pedersen.commit_blocks(self.alpha_table,
                                          scalars.to(self.device))

    # ----------------------------------------------------- MAC complements

    def complement_points(self, records) -> JacPoint:
        """Batched h^PRF(level,index,step) as JacPoint (N,): h is a fixed
        base, so this is K4 over 128-bit PRF scalars (a 16-byte AES block,
        little-endian for IPA, big-endian into Fr for KZG, which is below
        2^128 too)."""
        with trace.span("client.complements", n=len(records)):
            if self.config.scheme == "ipa":
                rs = self.prf.prf_scalars_ipa(records)
            else:
                rs = self.prf.prf_scalars_kzg(records, BN254_R)
            sc = limbs.ints_to_tensor(rs, self.device)
            return cuda_curve.fb_scalar_mul(self.h_table, sc)

    # ----------------------------------------------------------- initialize

    @torch.inference_mode()
    def initialize(self, num_blocks: int) -> None:
        with trace.span("client.initialize", n=num_blocks):
            self._initialize_impl(num_blocks)

    def _initialize_impl(self, num_blocks: int) -> None:
        self.num_blocks = num_blocks
        self.ctx = NttContext(num_blocks, self.config.scheme)
        self.height = self.ctx.height
        self.mod_q = self.ctx.mod_q
        self.write_step = 0

        if self.config.scheme == "ipa":
            reply = self.transport(b"GET GENERATORS")
            ops = self.ops
            affine = ops.to_affine(points_io.points_from_bytes(reply, ops))
            self.ipa_key = ipa.IpaKey(affine[:NUM_CHUNKS], affine[NUM_CHUNKS],
                                      self.device)
            with trace.span("client.alpha_generators"):
                self.alpha_table = cuda_curve.fixed_base_table(
                    ops, pedersen.alpha_generators(self.alpha))
        else:
            # kzg: the client runs the trusted setup and ships the SRS
            # (init_SRS + send, Client.hpp:347-364)
            self.srs = kzg.KzgSrs.from_tau(self.tau, NUM_CHUNKS)
            self.transport(self.srs.to_bytes())

        self.transport(num_blocks.to_bytes(4, "little"))

        compl_pts_all = []
        i = 0
        while i < num_blocks:
            count = min(self.config.max_blocks_sent, num_blocks - i)
            with trace.span("client.create_blocks", n=count):
                blocks = [self.create_data_block(i + k + 1)
                          for k in range(count)]
            commits = self._commit_blocks(blocks)
            compl = self.complement_points(
                [(0, i + k + 1, self.write_step) for k in range(count)])
            compl_pts_all.append(compl)
            with trace.span("client.macs", n=count):
                macs = cuda_curve.point_add(self.ops, commits, compl)
                macs_b = points_io.points_to_bytes(macs, self.ops)
            msg = b"".join(
                self.block_bytes(b) + macs_b[k * 96:(k + 1) * 96]
                for k, b in enumerate(blocks))
            self.transport(msg)
            i += count

        complements_u = cat(compl_pts_all)

        folded_x, folded_y = self._complement_crebuild(complements_u)
        deltas = self._fresh_minus_folded(self.height - 1, folded_x, folded_y)
        self.transport(deltas)

    def _complement_crebuild(self, complements_u: JacPoint):
        """Client-side CRebuild over complements (Client.hpp:1040-1453)."""
        with trace.span("client.crebuild", n=self.num_blocks):
            return self._complement_crebuild_impl(complements_u)

    def _complement_crebuild_impl(self, complements_u: JacPoint):
        ctx = self.ctx
        wt = ctx.wt_scalar(self.write_step)
        cx = complements_u
        cy = compute.point_scale(complements_u, wt.std, ops=self.ops)
        for s in range(1, self.height):
            cx, cy = compute.point_stage(ctx, s, [cx, cy], ops=self.ops)
        return cx, cy

    def _fresh_minus_folded(self, level: int, folded_x: JacPoint,
                            folded_y: JacPoint) -> bytes:
        """delta_i = h^PRF(level, i, ws) - folded_i for i in [0, 2^(l+1))
        (Client.hpp:256-306 / :584-614)."""
        l = 1 << level
        with trace.span("client.deltas", points=2 * l, level=level):
            fresh = self.complement_points(
                [(level, i, self.write_step) for i in range(2 * l)])
            folded = cat([folded_x, folded_y])
            with trace.span("point_add", points=2 * l):
                delta = cuda_curve.point_add(self.ops, fresh, folded,
                                              negate=True)
        with trace.span("client.serialize", points=2 * l):
            return points_io.points_to_bytes(delta, self.ops)

    # --------------------------------------------------------------- update

    @torch.inference_mode()
    def update(self, block_id: int) -> None:
        with trace.span("client.update", write_step=self.write_step + 1):
            self._update_impl(block_id)

    def _update_impl(self, block_id: int) -> None:
        expected = (self.write_step % self.num_blocks) + 1
        if block_id != expected:
            raise UpdateOrderError(
                f"update(block_id={block_id}) at write_step="
                f"{self.write_step}: the complement scheme requires "
                f"round-robin updates; expected block {expected} "
                f"(see UpdateOrderError)")
        with trace.span("client.prg"):
            chunks = self.create_data_block(block_id)
        compl = self.complement_points([(0, block_id, self.write_step)])
        commit = self._commit_blocks([chunks])
        with trace.span("client.mac"):
            mac = cuda_curve.point_add(self.ops, commit, compl)
        with trace.span("client.serialize", points=1):
            mac_b = points_io.points_to_bytes(mac, self.ops)

        self.write_step += 1
        if self.write_step % self.num_blocks == 0:
            base = self.write_step - self.num_blocks
            recs = [(0, i + 1, base + i) for i in range(self.num_blocks)]
            complements_u = self.complement_points(recs)
            folded_x, folded_y = self._complement_crebuild(complements_u)
            updated_level = self.height - 1
        else:
            updated_level = 0
            while ((self.write_step >> updated_level) & 1) == 0:
                updated_level += 1
            with trace.span("client.replay_fold", level=updated_level):
                folded_x, folded_y = self._replay_fold(updated_level, compl)

        deltas = self._fresh_minus_folded(updated_level, folded_x, folded_y)
        msg = (b"U" + self.block_bytes(chunks) + mac_b + deltas)
        self.transport(msg)

    def _replay_fold(self, level: int, new_compl: JacPoint):
        """Recompute the folded complements for the level being formed by
        replaying formation write-steps of levels 0..level-1
        (Client.hpp:505-536) and folding (HAdd on complements)."""
        ws = self.write_step
        wt = self.ctx.wt_scalar(ws)
        b2 = compute.point_scale(new_compl, wt.std, ops=self.ops)
        if level == 0:
            return new_compl, b2

        levels = [Level(Planes(), Planes()) for _ in range(level + 1)]
        time_step_value = ws & ~(1 << level)
        for i in range(level - 1, -1, -1):
            time_step_value |= (1 << i)
            sz = 1 << i
            x = self.complement_points(
                [(i, j, time_step_value) for j in range(sz)])
            y = self.complement_points(
                [(i, j + sz, time_step_value) for j in range(sz)])
            levels[i].x = Planes(points={"c": x})
            levels[i].y = Planes(points={"c": y})
            levels[i].empty = False

        slot_x = Planes(points={"c": new_compl})
        slot_y = Planes(points={"c": b2})
        hlog.fold_to_level(self.ctx, levels, level, slot_x, slot_y)
        return (levels[level].x.points["c"], levels[level].y.points["c"])

    # ---------------------------------------------------------------- audit

    @torch.inference_mode()
    def audit(self, seed: bytes | None = None) -> None:
        with trace.span("client.audit", write_step=self.write_step):
            self._audit_impl(seed)

    def _audit_impl(self, seed: bytes | None = None) -> None:
        ws = self.write_step
        n = self.num_blocks
        if seed is None:
            seed = self.audit_seed_rng.random_block(1)

        with trace.span("audit.plan"):
            plan = auditing.build_audit_plan(seed, ws, n, self.height)
            # pad to the occupancy-independent worst-case slot count, as
            # the server does (padding: coeff 0, an identity contribution)
            S = auditing.audit_pad_slots(n, self.height)
            auditing.check_pad_slots(plan, S)
            # complements for the sampled positions, at each level's
            # masked step
            by_level: dict[int, list[int]] = {}
            for k, s in enumerate(plan.samples):
                by_level.setdefault(s.level, []).append(k)
            records = [None] * len(plan.samples)
            for level, idxs in by_level.items():
                mws = auditing.masked_write_step(ws, level)
                sz = 1 << level
                for k in idxs:
                    s = plan.samples[k]
                    index = s.index if s.is_x else s.index + sz
                    records[k] = (level, index, mws)
            records += [(0, 0, 0)] * (S - len(records))
        reply = self.transport(b"A" + seed)
        compl = self.complement_points(records)
        ops = self.ops
        with trace.span("client.audit.msm", points=S):
            coeffs = ([s.coeff for s in plan.samples]
                      + [0] * (S - len(plan.samples)))
            combined_compl = ck.msm(
                ops, compl, limbs.ints_to_tensor(coeffs, self.device),
                nbits=32)

        with trace.span("client.audit.mac_check", bytes=len(reply)):
            if self.config.scheme == "ipa":
                commitment = ecc.secp_parse_compressed(reply[0:33])
                mac_align = ops.from_affine(
                    [ecc.secp_parse_compressed(reply[33:66]),
                     ecc.secp_parse_compressed(reply[66:99])], self.device)
            else:
                # kzg (Client.hpp:846-876): reply = [proof(192) | MAC(96) |
                # align(96)]; proof = [C(64) | H(64) | z(32) | claimed(32)]
                commitment = ecc.bn254_unmarshal(reply[0:64])
                mac_align = points_io.points_from_bytes(
                    reply[192:384], ops, self.device)
            with trace.span("ecc.host"):
                commitment_pt = ops.from_affine([commitment], self.device)
                lhs, rhs = mac_sides(ops, self.alpha, commitment_pt,
                                     combined_compl, mac_align)
        if lhs != rhs:
            raise AuditError("MAC equation failed: data loss detected")

        if self.config.scheme == "ipa":
            ipa.verify(commitment, reply[99:], self.ipa_key)
            return
        H = ecc.bn254_unmarshal(reply[64:128])
        z = int.from_bytes(reply[128:160], "big")
        claimed = int.from_bytes(reply[160:192], "big")
        if not kzg.verify(self.srs, commitment, H, z, claimed):
            raise AuditError("KZG opening proof failed")

    # ------------------------------------------------------------ self test

    def self_test(self, epochs: int = 1, audits_per_epoch: int = 1) -> dict:
        """The reference's self-test loop with its amortized-cost meter
        (Client.hpp:894-919: epochs of n round-robin updates, audits after
        the last write of each epoch, amortized seconds per request)."""
        import time

        total = 0.0
        requests = 0
        audit_time = 0.0
        audits = 0
        for _ in range(epochs):
            for i in range(self.num_blocks):
                t0 = time.perf_counter()
                # continue the rotation from wherever write_step stands
                # (warm-up updates may have advanced it): the protocol
                # requires block_id == (ws % n) + 1 — see UpdateOrderError
                self.update((self.write_step % self.num_blocks) + 1)
                total += time.perf_counter() - t0
                requests += 1
                if i == self.num_blocks - 1:
                    for _ in range(audits_per_epoch):
                        t0 = time.perf_counter()
                        self.audit()
                        audit_time += time.perf_counter() - t0
                        audits += 1
        stats = {
            "requests": requests,
            "amortized_update_s": total / max(requests, 1),
            "audits": audits,
            "mean_audit_s": audit_time / max(audits, 1),
        }
        print(f"Total number of requests: {requests}")
        print(f"Amortized cost for each request: "
              f"{stats['amortized_update_s']:.3f}s")
        print(f"Mean audit time: {stats['mean_audit_s']:.3f}s")
        if trace.enabled():
            print(trace.report())
            trace.dump_jsonl()
        return stats
