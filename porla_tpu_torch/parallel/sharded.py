"""Multi-device sharding: the distributed NTT, the sharded MAC stages,
tensor-parallel commitments and data-parallel audit MSMs.

Counterpart of `porla_tpu/parallel/sharded.py`. The reference's only
parallelism is an 8-thread pool with static index splits
(Server.hpp:1564-1686); here the work is split over a mesh of devices:

- A `Mesh` is a (dp, tp) grid of torch devices with the reference
  package's axes: "blocks" (data parallel: the rows of the NTT, of the MAC
  planes and of an MSM's points) and "chunks" (tensor parallel: a
  commitment's generators). A logical mesh repeats one device (`[cuda:0] *
  4`, or `[cpu] * 4` in the tests): every shard-local kernel and the whole
  exchange schedule then run on one card, with no interconnect.
- A sharded tensor is a list of dp per-shard tensors (row blocks, as the
  reference's `P("blocks")`), shard b on the device of grid row b, or None
  where row b belongs to another process (`parallel.multihost`).
- **Distributed NTT** (`sharded_encode_fn`): the stages whose pairs lie
  within a shard run on the shard (K1 passes, `cuda_stage.fold_lane`); a
  wider stage pairs shard k with shard k ^ (m2 / n_loc) and runs as one K1
  launch over the stacked pair (`cuda_stage.pair_stage`). In one process
  both outputs go back to their shards; across processes each side sends
  its shard and keeps its own half.
- **Sharded MAC stages** (`sharded_point_stage_fn`): the same pairing over
  the point planes, K3 (K7 below 256 bits) per shard or per pair.
- **TP commitments** (`sharded_commit_fn`): grid cell (b, c) commits its
  blocks' scalars of generator slice c (K4); each block's tp partials are
  summed by `group_sum`.
- **DP audit MSMs** (`sharded_msm_fn`: K2 + `group_sum` per shard;
  `sharded_pippenger_msm_fn`: K5 + K6 per shard), the dp partials summed by
  one `group_sum` (the reference's `_halving_sum`).

Every kernel is one of the port's (`curves/cuda_curve.py`,
`curves/cuda_msm.py`, `ntt/cuda_stage.py`): a shard on the CPU takes its
plain version, a shard on the card launches it or raises.
"""

from __future__ import annotations

import torch

from porla_tpu_torch.curves import cuda_curve, cuda_msm
from porla_tpu_torch.curves import kernels as ck
from porla_tpu_torch.curves.weierstrass import JacPoint, cat, index
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.ntt import cuda_stage
from porla_tpu_torch.ntt.engine import MOD_P, NttContext
from porla_tpu_torch.protocol import compute


class Mesh:
    """A (dp, tp) grid of torch devices, axes "blocks" and "chunks". Grid
    row b belongs to process `ranks[b]` (rows ordered by process); this
    process, `rank`, runs the shards of its own rows only."""

    def __init__(self, devices, dp: int, tp: int, ranks=None,
                 rank: int = 0):
        devices = [torch.device(d) for d in devices]
        if dp < 1 or tp < 1 or len(devices) != dp * tp:
            raise ValueError(f"{len(devices)} devices do not form a "
                             f"({dp}, {tp}) grid")
        self.grid = tuple(tuple(devices[b * tp:(b + 1) * tp])
                          for b in range(dp))
        self.dp, self.tp = dp, tp
        self.ranks = tuple(ranks) if ranks is not None else (rank,) * dp
        if len(self.ranks) != dp or list(self.ranks) != sorted(self.ranks):
            raise ValueError(f"row owners {self.ranks} must be dp = {dp} "
                             f"ranks in order")
        self.rank = rank
        self.shape = {"blocks": dp, "chunks": tp}
        self.rows = [b for b in range(dp) if self.ranks[b] == rank]
        if not self.rows:
            raise ValueError(f"process {rank} owns no row of the mesh")

    @property
    def nproc(self) -> int:
        return len(set(self.ranks))

    def local(self, b: int) -> bool:
        return self.ranks[b] == self.rank

    def device(self, b: int, c: int = 0) -> torch.device:
        return self.grid[b][c]

    @property
    def primary(self) -> torch.device:
        """Where this process combines partials: its first shard's device."""
        return self.grid[self.rows[0]][0]


def make_mesh(devices=None, tp: int | None = None) -> Mesh:
    """A one-process mesh over `devices` (default: every card torch finds;
    raises without one). tp = 2 when the count is even and above 1, as in
    the reference; dp = count / tp."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError("torch finds no CUDA device; pass the mesh's "
                               "devices, e.g. [torch.device('cpu')] * 4")
        devices = [torch.device("cuda", i) for i in range(count)]
    n = len(devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if n % tp:
        raise ValueError(f"tp = {tp} does not divide {n} devices")
    return Mesh(devices, n // tp, tp)


# --- sharded values ----------------------------------------------------------

def _rows(a, lo: int, hi: int):
    if isinstance(a, JacPoint):
        return JacPoint(*(c[lo:hi] for c in a))
    return a[lo:hi]


def _to(a, device):
    if a is None:
        return None
    if isinstance(a, JacPoint):
        return a.to(device)
    if isinstance(a, list):
        return [_to(x, device) for x in a]
    return a.to(device)


def stage(mesh: Mesh, a) -> list:
    """A tensor or JacPoint (rows on any device) -> its dp row blocks, block
    b on grid row b's device, None for the rows of other processes (each
    process stages from its own copy of the value). A list is taken as
    already sharded and passes through."""
    if isinstance(a, list):
        if len(a) != mesh.dp:
            raise ValueError(f"{len(a)} shards on a mesh of dp = {mesh.dp}")
        return a
    n = a.x.shape[0] if isinstance(a, JacPoint) else a.shape[0]
    if n % mesh.dp:
        raise ValueError(f"{n} rows do not split over dp = {mesh.dp}")
    k = n // mesh.dp
    return [_to(_rows(a, b * k, (b + 1) * k), mesh.device(b))
            if mesh.local(b) else None for b in range(mesh.dp)]


def gather(mesh: Mesh, shards: list, device):
    """Sharded rows -> the whole tensor (or JacPoint) on `device`, in every
    process (the rows of other processes through `multihost.all_gather`,
    the counterpart of the reference's `fetch_many`)."""
    mine = [_to(shards[b], device) for b in mesh.rows]
    if isinstance(mine[0], JacPoint):
        whole = torch.stack([torch.cat([p[i] for p in mine])
                             for i in range(3)])
    else:
        whole = torch.cat(mine)
    if mesh.nproc > 1:
        from porla_tpu_torch.parallel import multihost
        whole = torch.cat(multihost.all_gather(whole), dim=int(
            isinstance(mine[0], JacPoint))).to(device)
    return JacPoint(*whole) if isinstance(mine[0], JacPoint) else whole


def _pack(value) -> torch.Tensor:
    """A shard's payload (a tensor or a list of JacPoints) as one tensor."""
    if isinstance(value, list):
        return torch.stack([c for p in value for c in p])
    return value


def _unpack(t: torch.Tensor, like):
    if isinstance(like, list):
        return [JacPoint(*t[3 * i:3 * i + 3]) for i in range(len(like))]
    return t


def exchange_stage(mesh: Mesh, shards: list, shift: int, combine) -> list:
    """One stage whose pairs lie in shards k and k ^ shift: `combine(u, t,
    k)` of the pair's lower shard u and upper shard t, on the device of
    local shard k, returns (hi, lo), the new values of the lower and the
    upper shard. A pair within this process is combined once and its
    outputs go to their shards; a pair with another process's shard
    exchanges the two shards (`multihost.exchange`) and each side keeps
    its own half."""
    out = list(shards)
    remote = {}
    for k in mesh.rows:
        p = k ^ shift
        if not mesh.local(p):
            remote[k] = p
        elif not k & shift:
            hi, lo = combine(shards[k], _to(shards[p], mesh.device(k)), k)
            out[k], out[p] = hi, _to(lo, mesh.device(p))
    if remote:
        from porla_tpu_torch.parallel import multihost
        got = multihost.exchange(
            {k: _pack(shards[k]) for k in remote},
            {k: (mesh.ranks[p], min(k, p)) for k, p in remote.items()})
        for k in remote:
            theirs = _unpack(got[k].to(mesh.device(k)), shards[k])
            if k & shift:
                out[k] = combine(theirs, shards[k], k)[1]
            else:
                out[k] = combine(shards[k], theirs, k)[0]
    return out


# --- the distributed NTT -----------------------------------------------------

def stage_twiddle_tables_std(ctx: NttContext) -> list[torch.Tensor]:
    """Per-stage (n, 16) standard-form twiddles, row g = v_s^(g mod m2):
    the factors of the MAC-mirror point butterflies (Server.hpp:1592), the
    tables `sharded_point_stage_fn`'s stages take."""
    return [L.to_torch(ctx.twiddles(1 << (s - 1)).std)
            .repeat(ctx.n >> (s - 1), 1) for s in range(1, ctx.height)]


def sharded_encode_fn(ctx: NttContext, mesh: Mesh, mod):
    """f(a) -> all CRebuild stages of one lane (mod p or the context's q)
    over an (n, C, 16) lane, sharded on "blocks" (a is staged unless it is
    already sharded). Each shard runs stages 1..log2(n_loc) as K1 passes
    (`fold_lane`); each wider stage is one `pair_stage` K1 launch a pair,
    its twiddles rows m2 - 1 + j0 + r of the lane's table with j0 = k *
    n_loc mod m2 for the pair's lower shard k."""
    n, dp = ctx.n, mesh.dp
    if n % dp or dp & (dp - 1):
        raise ValueError(f"n = {n} does not split into dp = {dp} shards")
    n_loc = n // dp
    lane = "p" if mod is MOD_P else "q"

    def fn(a) -> list:
        shards = [None if s is None else
                  cuda_stage.fold_lane(ctx, s, mod, lane)
                  for s in stage(mesh, a)]
        for s in range(n_loc.bit_length(), ctx.height):
            m2 = 1 << (s - 1)
            shards = exchange_stage(
                mesh, shards, m2 // n_loc,
                lambda u, t, k, m2=m2: cuda_stage.pair_stage(
                    ctx, u, t, mod, lane, m2, k * n_loc % m2))
        return shards
    return fn


# --- the sharded MAC stages --------------------------------------------------

def sharded_point_stage_fn(ctx: NttContext, mesh: Mesh, ops,
                           nbits: int = 256) -> dict:
    """{s: f(planes, tw)} for the stages s = 1..height-1 of the MAC mirror
    over (n,) point planes sharded on "blocks": planes is a list of sharded
    JacPoints (all planes share one launch a shard or pair), tw the
    stage's `stage_twiddle_tables_std` table, sharded. A stage whose pairs
    fit in a shard is `compute.point_stage` on each shard; a wider one is
    one `cuda_curve.point_butterfly` a pair on the shards' rows of tw (both
    shards' rows hold the same factors). K3 at nbits = 256, K7 otherwise."""
    n_loc = ctx.n // mesh.dp

    def make(s: int):
        m2 = 1 << (s - 1)

        def local(planes, tw):
            out = [[None] * mesh.dp for _ in planes]
            for b in mesh.rows:
                res = compute.point_stage(ctx, s, [p[b] for p in planes],
                                          ops=ops, tw=tw[b], nbits=nbits)
                for o, r in zip(out, res):
                    o[b] = r
            return out

        def exchanged(planes, tw):
            def combine(u, t, k):
                hi, lo = cuda_curve.point_butterfly(
                    ops, cat(u), cat(t), tw[k].repeat(len(u), 1), nbits)
                return ([index(hi, slice(i * n_loc, (i + 1) * n_loc))
                         for i in range(len(u))],
                        [index(lo, slice(i * n_loc, (i + 1) * n_loc))
                         for i in range(len(u))])
            per_shard = [None if planes[0][b] is None else
                         [p[b] for p in planes] for b in range(mesh.dp)]
            res = exchange_stage(mesh, per_shard, m2 // n_loc, combine)
            return [[None if r is None else r[i] for r in res]
                    for i in range(len(planes))]

        return local if 2 * m2 <= n_loc else exchanged

    return {s: make(s) for s in range(1, ctx.height)}


# --- MSMs and commitments ----------------------------------------------------

def _combine(mesh: Mesh, partials: list, ops, nout: int) -> JacPoint:
    """This process's (nout,) partial sums of its shards -> the sum over
    all dp shards of each of the nout columns, (nout,) on the primary
    device of every process: one `group_sum` over nout groups of dp."""
    dev = mesh.primary
    mine = torch.stack([torch.stack(list(partials[b])).to(dev)
                        for b in mesh.rows])          # (rows, 3, nout, 16)
    if mesh.nproc > 1:
        from porla_tpu_torch.parallel import multihost
        mine = torch.cat(multihost.all_gather(mine)).to(dev)
    pts = mine.permute(1, 2, 0, 3).reshape(3, nout * mesh.dp, L.NLIMBS)
    return cuda_curve.group_sum(ops, JacPoint(*pts.contiguous()), nout)


def sharded_msm_fn(mesh: Mesh, ops, nbits: int = 256):
    """f(points, scalars) -> (1,) MSM total on the primary device, the point
    axis sharded over "blocks" (data parallel): one `kernels.msm_parts`
    call a shard (K2 + `group_sum`), then one `group_sum` over the dp
    partials. The multi-device form of the audit combination MSMs
    (Server.hpp:831-848)."""
    def fn(points, scalars) -> JacPoint:
        pts, sc = stage(mesh, points), stage(mesh, scalars)
        parts = [None if pts[b] is None else
                 ck.msm_parts(ops, pts[b], sc[b], 1, nbits)[0]
                 for b in range(mesh.dp)]
        return _combine(mesh, parts, ops, 1)
    return fn


def sharded_pippenger_msm_fn(mesh: Mesh, ops, nbits: int = 256,
                             n_local: int | None = None,
                             c: int | None = None, bt: int | None = None):
    """The data-parallel MSM on the Pippenger kernels: per shard
    `signed_digits` -> K5 `pip_bucket` -> K6 `fold_windows` (nwin window
    totals), the dp x nwin totals summed by one `group_sum` (nwin groups of
    dp). Returns (fn, finish): fn(points, scalars) -> (nwin,) window
    totals on the primary device; finish(totals) -> the (1,) MSM point on
    the host: the Horner over windows less the blinding, which every shard
    started from (the same points in every process: the fleet seed,
    `multihost.share_fleet_seed`), so kappa = dp * bt * wsum * tsum.
    N = dp * n_local; c is `cuda_msm.choose_c(n_local, nbits)` unless
    given."""
    if n_local is None:
        raise ValueError("pass n_local = N // mesh blocks")
    if bt is None:
        bt = min(cuda_msm.DEFAULT_BT,
                 max(128, 1 << (n_local - 1).bit_length()))
    if bt & (bt - 1):
        raise ValueError(f"lane width must be a power of two: {bt}")
    if c is None:
        c = cuda_msm.choose_c(n_local, nbits)
    nb = 1 << (c - 1)
    npad = -(-n_local // bt) * bt
    nwin, tight = cuda_msm._nwin_for(nbits, c)

    def pad(t):
        return cuda_msm._pad_rows(t, npad)

    def shard_windows(pts: JacPoint, sc: torch.Tensor) -> JacPoint:
        if pts.x.shape[0] != n_local:
            raise ValueError(f"{pts.x.shape[0]} points a shard, expected "
                             f"n_local = {n_local}")
        dev = pts.x.device
        p = JacPoint(*(pad(t) for t in pts))
        digits = cuda_msm.signed_digits(pad(sc), p.z, c, nwin, tight)
        state = cuda_msm.pip_bucket(ops, p, digits,
                                    cuda_msm.blinding(ops, nb, device=dev),
                                    bt, cuda_msm._is_affine(ops, p.z))
        return cuda_msm.fold_windows(ops, state)

    def fn(points, scalars) -> JacPoint:
        pts, sc = stage(mesh, points), stage(mesh, scalars)
        wins = [None if pts[b] is None else shard_windows(pts[b], sc[b])
                for b in range(mesh.dp)]
        return _combine(mesh, wins, ops, nwin)

    def finish(totals: JacPoint) -> JacPoint:
        tsum = cuda_msm.blinding(ops, nb).tsum
        total = cuda_msm.horner(ops, ops.to_affine(totals), c,
                                mesh.dp * bt, tsum)
        return ops.from_affine([total])

    return fn, finish


def sharded_commit_fn(mesh: Mesh, table: cuda_curve.FbTable):
    """f(scalars) -> sharded (B / dp,) commitments over the NG bases of
    `table` (its owner's): scalars (B, NG, 16) with B over "blocks" and NG
    over "chunks"; grid cell (b, c) runs K4 over the table's columns
    c k .. (c + 1) k - 1 (k = NG / tp; a `cuda_curve.FbColumns` view, made
    here once, which computes no table point) and its blocks' scalars of
    that slice (`cuda_curve.fb_msm_groups`), and each block's tp partials
    are summed by `group_sum` on grid row b's first device."""
    tp, ng, ops = mesh.tp, table.ng, table.ops
    if ng % tp:
        raise ValueError(f"{ng} generators do not split over tp = {tp}")
    k = ng // tp
    tbls = [cuda_curve.FbColumns(table, list(range(c * k, (c + 1) * k)))
            for c in range(tp)]

    def fn(scalars: torch.Tensor) -> list:
        B = scalars.shape[0]
        if B % mesh.dp or scalars.shape[1] != ng:
            raise ValueError(f"{tuple(scalars.shape[:2])} scalars do not "
                             f"split over dp = {mesh.dp} and {ng} bases")
        bl = B // mesh.dp
        out = [None] * mesh.dp
        for b in mesh.rows:
            parts = []
            for c in range(tp):
                sc = scalars[b * bl:(b + 1) * bl, c * k:(c + 1) * k]
                sc = sc.to(mesh.device(b, c)).reshape(bl * k, L.NLIMBS)
                parts.append(cuda_curve.fb_msm_groups(
                    tbls[c], sc.contiguous(), nout=bl).to(mesh.device(b)))
            pts = torch.stack([torch.stack(list(p)) for p in parts], 2)
            out[b] = cuda_curve.group_sum(
                ops, JacPoint(*pts.reshape(3, bl * tp, L.NLIMBS)), bl)
        return out
    return fn
