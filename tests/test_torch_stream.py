"""The out-of-core streaming passes (porla_tpu_torch.protocol.stream)
against the reference package's (porla_tpu.protocol.stream, on the CPU) on
the same store contents, in both schemes: the CRebuild's staging pass and
butterfly stages (a pass of several stages over the files against the
reference's stage-by-stage passes), the streamed mix with its lower read
from memory, from a file-backed level's codeword files and from staging,
and the final pass.
n = 8 blocks with stripes of 3 (which divide neither a stage's 4 pairs nor
a mix's length of 4). The STG/ and H_X/ files must be byte-identical and
the alignment commitments the same affine points. The reference's final
pass is given the port server's commitment function (the commitments
themselves are held against the reference in test_torch_fixed_base.py and
test_torch_kzg.py), so the points agree exactly when both packages commit
the same alignment scalars in the same order. Tolerance: zero."""

import os
import types

import numpy as np
import pytest
import torch

from porla_tpu.curves.instances import bn254 as jbn254
from porla_tpu.curves.instances import secp256k1 as jsecp
from porla_tpu.curves.weierstrass import JacPoint as JJacPoint
from porla_tpu.ntt import engine as jengine
from porla_tpu.protocol import stream as jstream
from porla_tpu.storage.store import BlockStore as JStore
from porla_tpu_torch.commit import kzg
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.fields.constants import FFT_PRIME
from porla_tpu_torch.ntt import engine
from porla_tpu_torch.protocol import compute, stream
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.storage.store import BlockStore

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

N = 8
STRIPE = 3
SCHEMES = ["ipa", "kzg"]
CPU = torch.device("cpu")


def _files(root, sub):
    d = os.path.join(root, sub)
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _same(port, ref, sub):
    a, b = _files(port.root, sub), _files(ref.root, sub)
    assert a == b
    return a


def _crt(seed, n, mod_q):
    """n blocks of canonical CRT lanes: (port CrtArray, reference one)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") for _ in range(n * 128)]
    p = L.ints_to_limbs([v % FFT_PRIME for v in vals]).reshape(n, 128, 16)
    q = L.ints_to_limbs([v % mod_q.n for v in vals]).reshape(n, 128, 16)
    return (engine.CrtArray(L.to_torch(p), L.to_torch(q)),
            jengine.CrtArray(p, q))


@pytest.fixture(params=SCHEMES)
def setup(request, tmp_path):
    scheme = request.param
    return (scheme, engine.NttContext(N, scheme),
            jengine.NttContext(N, scheme), BlockStore(str(tmp_path / "port")),
            JStore(str(tmp_path / "ref")))


def test_staging_pass_and_stages_match_reference(setup):
    scheme, ctx, jctx, port, ref = setup
    raw = np.random.default_rng(1).integers(0, 256, N * 4096,
                                            dtype=np.uint8).tobytes()
    for st in (port, ref):
        st.write_blocks(range(N), raw)
    wt, jwt = ctx.wt_scalar(3), jctx.wt_scalar(3)
    stream.stage_u_to_staging(port, ctx, wt, N, "crx", "cry", STRIPE, CPU)
    jstream.stage_u_to_staging(ref, jctx, jwt, N, "crx", "cry", STRIPE)
    assert len(_same(port, ref, "STG")) == 2 * N
    # a pass of several stages (1-2), then one (3), against the
    # reference's stage-by-stage loop
    assert stream.stage_passes(N, STRIPE) == [(1, 2), (3, 3)]
    for first, last in stream.stage_passes(N, STRIPE):
        stream.stream_stages(port, ctx, "cry", N, first, last, STRIPE, CPU)
        for s in range(first, last + 1):
            jstream.stream_stage(ref, jctx, "cry", N, s, STRIPE)
        _same(port, ref, "STG")
    # the staged stages are the cached encode of the same plane
    y = port.read_staged("cry", range(N))
    data = port.read_blocks_crt(range(N), ctx.mod_q)
    want = engine.encode_stages(ctx, compute.scale_crt(ctx.mod_q, data, wt))
    assert torch.equal(y.p, want.p) and torch.equal(y.q, want.q)


def test_stage_passes():
    # a pass's sets fit two stripes of blocks (a stage's pairs)
    assert stream.stage_passes(1 << 14, 4096) == [(1, 13), (14, 14)]
    assert stream.stage_passes(1 << 18, 4096) == [(1, 13), (14, 18)]
    assert stream.stage_passes(1024, 8) == [(1, 4), (5, 8), (9, 10)]
    assert stream.stage_passes(8, 1) == [(1, 1), (2, 2), (3, 3)]


@pytest.mark.parametrize("lower_from", ["ram", "level", "staged"])
def test_stream_mix_matches_reference(setup, lower_from):
    scheme, ctx, jctx, port, ref = setup
    length = 4
    lo, jlo = _crt(2, length, ctx.mod_q)
    up, jup = _crt(3, length, ctx.mod_q)
    if lower_from == "ram":
        lower, jlower = stream.ram_reader(lo), jstream.ram_reader(jlo)
    elif lower_from == "level":
        # a file-backed level holds values reduced mod p; the q lane is
        # recomputed from the p lane on load
        port.write_codes_256(True, 2, range(length), lo.p)
        ref.write_codes_256(True, 2, range(length), jlo.p)
        _same(port, ref, "H_X")
        lower = stream.level_reader(port, ctx.mod_q, True, 2, CPU)
        jlower = jstream.level_reader(ref, jctx.mod_q, True, 2)
    else:
        port.write_staged("fx0", range(length), lo)
        ref.write_staged("fx0", range(length), jlo.p, jlo.q)
        lower = stream.staged_reader(port, "fx0", CPU)
        jlower = jstream.staged_reader(ref, "fx0")
    if lower_from == "staged":
        upper, jupper = stream.ram_reader(up), jstream.ram_reader(jup)
    else:
        port.write_staged("fy0", range(length), up)
        ref.write_staged("fy0", range(length), jup.p, jup.q)
        upper = stream.staged_reader(port, "fy0", CPU)
        jupper = jstream.staged_reader(ref, "fy0")
    stream.stream_mix(port, ctx, lower, upper, "fx1", length, STRIPE)
    jstream.stream_mix(ref, jctx, jlower, jupper, "fx1", length, STRIPE)
    files = _same(port, ref, "STG")
    assert sum(f.startswith("fx1_") for f in files) == 2 * length


def _port_server(scheme, root):
    srv = PorlaServer(PorlaConfig(scheme=scheme, storage_dir=root),
                      device="cpu")
    if scheme == "kzg":
        srv.srs = kzg.KzgSrs.from_tau(123456789, 128)
    srv._setup(N)
    return srv


def test_finalize_matches_reference(setup, tmp_path):
    scheme, ctx, jctx, port, ref = setup
    srv = _port_server(scheme, port.root)
    jops = jsecp() if scheme == "ipa" else jbn254()

    def commit(c):           # the port server's commitments, as reference
        pt = srv._commit_batch(L.to_torch(c))      # limbs
        return JJacPoint(*(L.to_numpy(a) for a in pt))

    jsrv = types.SimpleNamespace(store=ref, ops=jops, mod_q=jctx.mod_q,
                                 _commit_batch=commit)
    data, jdata = _crt(4, N, ctx.mod_q)
    srv.store.write_staged("crx", range(N), data)
    ref.write_staged("crx", range(N), jdata.p, jdata.q)
    got = stream.finalize_staged_level(srv, "crx", True, 3, N, STRIPE)
    want = jstream.finalize_staged_level(jsrv, "crx", True, 3, N, STRIPE)
    assert srv.ops.to_affine(got) == jops.to_affine(want)
    assert len(_same(srv.store, ref, "H_X")) == N
    assert os.listdir(os.path.join(port.root, "STG")) == []
    # the codeword files hold the p lane, the values reduced mod p
    assert torch.equal(port.read_codes_256(True, 3, range(N)), data.p)
