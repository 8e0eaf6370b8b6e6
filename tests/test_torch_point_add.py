"""`cuda_curve.point_add`, the protocol's general point add, on the CPU: its
plain route held limb for limb (tolerance: zero) against `CurveOps.add` and
`CurveOps.add(a, CurveOps.neg(b))`, and against the golden model's affine
sums, on secp256k1 and BN254 G1 at B = 1, 17 and 33 (lanes at infinity on
either side, P + P and P + (-P) in other Jacobian forms, generic pairs);
then the protocol's routing of its adds through it: on the CPU an update
makes five calls and an audit two, and the bytes the client sends are those
of a run whose adds call `CurveOps.add` directly. A CPU tensor never loads
the kernel library."""

import random

import pytest
import torch

from porla_tpu_torch import native
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.curves import cuda_curve as cc
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

CURVES = {"secp256k1": (ecc.SECP256K1, secp256k1),
          "bn254": (ecc.BN254, bn254)}


@pytest.fixture(autouse=True)
def _cpu_only(monkeypatch):
    """CPU tensors must take the plain versions, never the kernels."""
    def no_kernel():
        raise AssertionError("a CPU tensor must not load the CUDA kernels")
    monkeypatch.setattr(native, "library", no_kernel)


def _jacobian(ops, pts, zs):
    """Affine points (or INF) with the given Z's: X = x Z^2, Y = y Z^3."""
    p = ops.curve.p
    m = ops.fp.to_mont_int
    xs, ys, zz = [], [], []
    for pt, z in zip(pts, zs):
        if pt is ecc.INF:
            xs.append(m(1)), ys.append(m(1)), zz.append(0)
        else:
            xs.append(m(pt[0] * z * z % p))
            ys.append(m(pt[1] * z * z * z % p))
            zz.append(m(z))
    return JacPoint(*(L.ints_to_tensor(c) for c in (xs, ys, zz)))


def _pairs(cv, B, seed):
    """B pairs (a, c) to add, by lane: a at infinity, c at infinity, both,
    c = a (the doubling), c = -a (infinity), then generic pairs."""
    rng = random.Random(seed)
    mul = lambda: ecc.mul(cv, cv.g, rng.randrange(1, cv.n))
    a, c = [], []
    for i in range(B):
        case = i % 6
        p = ecc.INF if case in (0, 2) else mul()
        if case in (1, 2):
            q = ecc.INF
        elif case == 3:
            q = p
        elif case == 4:
            q = ecc.neg(cv, p)
        else:
            q = mul()
        a.append(p)
        c.append(q)
    return a, c, rng


@pytest.mark.parametrize("negate", [False, True], ids=["add", "sub"])
@pytest.mark.parametrize("B", [1, 17, 33])
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_plain_route_is_curve_ops_add(curve, B, negate):
    cv, make = CURVES[curve]
    ops = make()
    a_aff, c_aff, rng = _pairs(cv, B, seed=B + 100 * negate)
    # b is what the caller passes: -c where the wrapper negates it
    b_aff = [ecc.neg(cv, q) for q in c_aff] if negate else c_aff
    zs = lambda: [rng.randrange(1, cv.p) for _ in range(B)]
    a = _jacobian(ops, a_aff, zs())
    b = _jacobian(ops, b_aff, zs())
    before = native.launches()
    got = cc.point_add(ops, a, b, negate=negate)
    assert native.launches() == before          # the CPU launches nothing
    want = ops.add(a, ops.neg(b)) if negate else ops.add(a, b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.to_affine(got) == [ecc.add(cv, p, q)
                                  for p, q in zip(a_aff, c_aff)]


def test_batches_must_match():
    ops = secp256k1()
    a = ops.from_affine([ecc.SECP256K1.g] * 3)
    b = ops.from_affine([ecc.SECP256K1.g] * 2)
    with pytest.raises(ValueError):
        cc.point_add(ops, a, b)
    with pytest.raises(ValueError):
        cc.point_add(ops, JacPoint(*(c[None] for c in a)),
                     JacPoint(*(c[None] for c in a)))


class _Sent:
    """The in-process transport, keeping every request the client sends."""

    def __init__(self, server):
        self.inner = InProcTransport(server)
        self.msgs = []

    def __call__(self, msg: bytes) -> bytes:
        self.msgs.append(msg)
        return self.inner(msg)


def _run(store, scheme, n=8, updates=2):
    """initialize(n), `updates` round-robin updates, an audit; returns the
    client's requests and the calls of `cuda_curve.point_add` per op."""
    cfg = PorlaConfig(scheme=scheme, storage_dir=str(store))
    server = PorlaServer(cfg, device="cpu")
    sent = _Sent(server)
    client = PorlaClient(cfg, sent, data_seed=bytes(range(16)), device="cpu")
    calls = []
    real = cc.point_add

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(cc, "point_add", counted)
    try:
        client.initialize(n)
        per_op = []
        for _ in range(updates):
            calls.clear()
            client.update(client.write_step % n + 1)
            per_op.append(("update", len(calls)))
        calls.clear()
        client.audit(seed=bytes(16))
        per_op.append(("audit", len(calls)))
    finally:
        mp.undo()
    return sent.msgs, per_op


def test_protocol_adds_go_through_point_add(tmp_path, monkeypatch):
    """Five adds an update (the client's MAC and deltas, the server's two
    absorbs and its align), at fold levels 0 and 1, and two an audit (the
    server's align, the client's MAC check); the requests are byte for
    byte those of a run whose adds are `CurveOps.add` itself."""
    msgs, per_op = _run(tmp_path / "wrapper", "ipa")
    assert per_op == [("update", 5), ("update", 5), ("audit", 2)]

    def direct(ops, a, b, negate=False):
        return ops.add(a, ops.neg(b) if negate else b)

    monkeypatch.setattr(cc, "point_add", direct)
    msgs_direct, _ = _run(tmp_path / "direct", "ipa")
    assert len(msgs) == len(msgs_direct)
    for i, (m, d) in enumerate(zip(msgs, msgs_direct)):
        assert m == d, f"request {i} differs"
