"""The port's BlockStore (porla_tpu_torch.storage.store) against the
reference package's (porla_tpu.storage.store): for the same limb arrays the
H_X/, H_Y/ and STG/ files are byte-identical, each package reads the
other's files back to the same limbs, and raw U/ blocks load to the same
CRT lanes. Limbs are random 16-bit values with the edges 0, 0x7FFF, 0x8000
and 0xFFFF in every chunk (the port widens a file's limbs through int16).
Tolerance: zero.

Then the spans of the store's file IO: every batched read, write and
delete records a `store.read`, `store.write` or `store.delete` span with
its `files`, `bytes` and `what` while tracing is on, and nothing while it
is off; an audit of a server with levels in files records one read per
file-backed (level, side) under `server.audit.gather`."""

import os

import numpy as np
import pytest
import torch

from porla_tpu.ntt import engine as jengine
from porla_tpu.storage.store import BlockStore as JStore
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.ntt import engine
from porla_tpu_torch.protocol import auditing
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport
from porla_tpu_torch.storage.store import BlockStore
from porla_tpu_torch.utils import trace

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

N = 7
IDX = [3, 0, 11, 5, 6, 2, 9]   # not in order, not contiguous


def _limbs(seed, n=N):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(n, 128, 16), dtype=np.int64)
    a[:, :, :4] = [0, 0x7FFF, 0x8000, 0xFFFF]
    return a.astype(np.uint32)


@pytest.fixture
def stores(tmp_path):
    return BlockStore(str(tmp_path / "port")), JStore(str(tmp_path / "ref"))


def _files(root, sub):
    d = os.path.join(root, sub)
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _same_tree(port, ref, sub):
    a, b = _files(port.root, sub), _files(ref.root, sub)
    assert a and a == b


@pytest.mark.parametrize("is_x", [True, False])
def test_codes_256_match_reference(stores, is_x):
    port, ref = stores
    arr = _limbs(1)
    port.write_codes_256(is_x, 5, IDX, L.to_torch(arr))
    ref.write_codes_256(is_x, 5, IDX, arr)
    sub = "H_X" if is_x else "H_Y"
    _same_tree(port, ref, sub)
    assert os.path.getsize(os.path.join(port.root, sub, "5_3")) == 4096
    # each reads the other's files
    back = port.read_codes_256(is_x, 5, IDX[::-1])
    assert (L.to_numpy(back) == arr[::-1]).all()
    ref_back = JStore(port.root).read_codes_256(is_x, 5, IDX)
    assert (ref_back == arr).all()
    assert (L.to_numpy(BlockStore(ref.root).read_codes_256(is_x, 5, IDX))
            == arr).all()


def test_codes_512_match_reference(stores):
    port, ref = stores
    lo, hi = _limbs(2), _limbs(3)
    port.write_codes_512(False, 9, IDX, L.to_torch(lo), L.to_torch(hi))
    ref.write_codes_512(False, 9, IDX, lo, hi)
    _same_tree(port, ref, "H_Y")
    plo, phi = port.read_codes_512(False, 9, IDX)
    assert (L.to_numpy(plo) == lo).all() and (L.to_numpy(phi) == hi).all()
    rlo, rhi = JStore(port.root).read_codes_512(False, 9, IDX)
    assert (rlo == lo).all() and (rhi == hi).all()


def test_staged_match_reference(stores):
    port, ref = stores
    p, q = _limbs(4), _limbs(5)
    port.write_staged("crx", IDX, engine.CrtArray(L.to_torch(p),
                                                  L.to_torch(q)))
    ref.write_staged("crx", IDX, p, q)
    _same_tree(port, ref, "STG")
    back = BlockStore(ref.root).read_staged("crx", IDX)
    assert (L.to_numpy(back.p) == p).all() and (L.to_numpy(back.q) == q).all()
    rb = JStore(port.root).read_staged("crx", IDX)
    assert (rb.p == p).all() and (rb.q == q).all()
    port.delete_staged("crx", 12)
    assert os.listdir(os.path.join(port.root, "STG")) == []


def test_single_file_forms_match_reference(stores):
    port, ref = stores
    rng = np.random.default_rng(6)
    c256 = [int(v) for v in rng.integers(0, 1 << 62, 128)]
    c256 = [(v << 192) | v for v in c256[:-1]] + [(1 << 256) - 1]
    c512 = [(v << 256) | v for v in c256]
    for st in (port, ref):
        st.write_code_256(True, 2, 1, c256)
        st.write_code_512(True, 3, 1, c512)
    _same_tree(port, ref, "H_X")
    assert port.read_code_256(True, 2, 1) == c256
    assert port.read_code_512(True, 3, 1) == c512
    # the batch reader sees the single-file writer's bytes
    assert L.tensor_to_ints(port.read_codes_256(True, 2, [1])[0]) == c256


@pytest.mark.parametrize("scheme", ["ipa", "kzg"])
def test_read_blocks_crt_matches_reference(stores, scheme):
    port, ref = stores
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, size=N * 4096, dtype=np.uint8).tobytes()
    raw = b"\xff" * 4096 + raw[4096:]          # a block of 2^256 - 1 chunks
    for st in (port, ref):
        st.write_blocks(range(N), raw)
    _same_tree(port, ref, "U")
    ctx = engine.NttContext(8, scheme)
    jctx = jengine.NttContext(8, scheme)
    idx = [i for i in IDX if i < N]
    got = port.read_blocks_crt(idx, ctx.mod_q)
    want = ref.read_blocks_crt(idx, jctx.mod_q)
    assert (L.to_numpy(got.p) == np.asarray(want.p)).all()
    assert (L.to_numpy(got.q) == np.asarray(want.q)).all()


def _store_spans(fn) -> tuple[list, dict]:
    """The `store.*` spans and the counters that `fn()` records."""
    trace.reset()
    trace.enable(True)
    try:
        fn()
        return ([sp for sp in trace.spans() if sp["name"].startswith("store.")],
                {k.rsplit("/", 1)[-1]: v["count"]
                 for k, v in trace.summary().items()
                 if "count" in v and "/store." in "/" + k})
    finally:
        trace.enable(False)
        trace.reset()


def _io_cases(st: BlockStore):
    """(what it does, the span it records: name, files, bytes, what)."""
    crt = engine.CrtArray(L.to_torch(_limbs(4)), L.to_torch(_limbs(5)))
    lo, hi = L.to_torch(_limbs(2)), L.to_torch(_limbs(3))
    raw = np.random.default_rng(8).integers(0, 256, N * 4096,
                                            dtype=np.uint8).tobytes()
    mod_q = engine.NttContext(8, "ipa").mod_q
    return {
        "write_codes_256": (lambda: st.write_codes_256(True, 5, IDX, lo),
                            ("store.write", N, N * 4096, "codes256")),
        "read_codes_256": (lambda: st.read_codes_256(True, 5, IDX),
                           ("store.read", N, N * 4096, "codes256")),
        "write_codes_512": (lambda: st.write_codes_512(False, 9, IDX, lo, hi),
                            ("store.write", N, N * 8192, "codes512")),
        "read_codes_512": (lambda: st.read_codes_512(False, 9, IDX[:3]),
                           ("store.read", 3, 3 * 8192, "codes512")),
        "write_staged": (lambda: st.write_staged("crx", IDX, crt),
                         ("store.write", N, N * 8192, "staged")),
        "read_staged": (lambda: st.read_staged("crx", IDX[::-1]),
                        ("store.read", N, N * 8192, "staged")),
        "write_blocks": (lambda: st.write_blocks(range(N), raw),
                         ("store.write", N, N * 4096, "blocks")),
        "read_blocks_crt": (lambda: st.read_blocks_crt(range(2), mod_q),
                            ("store.read", 2, 2 * 4096, "blocks")),
        "delete_staged": (lambda: st.delete_staged("crx", 12),
                          ("store.delete", 12, None, None)),
    }


@pytest.mark.parametrize("op", [
    "write_codes_256", "read_codes_256", "write_codes_512", "read_codes_512",
    "write_staged", "read_staged", "write_blocks", "read_blocks_crt",
    "delete_staged"])
def test_file_io_records_its_span(tmp_path, op):
    st = BlockStore(str(tmp_path))
    cases = _io_cases(st)
    # the files each case reads or deletes, written with tracing off
    for name in ("write_codes_256", "write_codes_512", "write_staged",
                 "write_blocks"):
        cases[name][0]()
    fn, (name, files, nbytes, what) = cases[op]
    spans, counters = _store_spans(fn)
    assert [sp["name"] for sp in spans] == [name]
    want = {"files": files} if name == "store.delete" else \
        {"files": files, "bytes": nbytes, "what": what}
    assert spans[0]["attrs"] == want
    kind = {"store.read": "read", "store.write": "written"}.get(name)
    if kind is None:
        assert counters == {}
    else:
        assert counters == {f"store.files_{kind}": files,
                            f"store.bytes_{kind}": nbytes}
    # tracing off: the same call records nothing
    trace.reset()
    fn()
    assert trace.spans() == [] and trace.summary() == {}


def test_audit_reads_each_file_backed_side_once(tmp_path):
    # n = 16 with caching level 2: at write step 7 levels 0-2 are in
    # memory and the top, level 4, is in its codeword files
    n = 16
    cfg = PorlaConfig(scheme="ipa", top_caching_level=2,
                      storage_dir=str(tmp_path))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server),
                         data_seed=bytes([3] * 16), device="cpu")
    client.initialize(n)
    for i in range(7):
        client.update(i + 1)
    assert server.write_step == 7
    seed = bytes([5] * 16)
    spans, counters = _store_spans(lambda: client.audit(seed=seed))
    gather = "client.audit/server.audit/server.audit.gather/store.read"
    reads = [sp for sp in spans if sp["path"] == gather]
    assert reads == spans        # nothing else of the store ran
    plan = auditing.build_audit_plan(seed, 7, n, server.height)
    sides: dict = {}
    for smp in plan.samples:
        if server.levels[smp.level].file_backed:
            key = (smp.level, smp.is_x)
            sides[key] = sides.get(key, 0) + 1
    assert set(sides) == {(4, True), (4, False)}
    assert sorted(sp["attrs"]["files"] for sp in reads) == \
        sorted(sides.values())
    assert sum(sides.values()) == 32
    assert all(sp["attrs"] == {"files": sp["attrs"]["files"],
                               "bytes": 4096 * sp["attrs"]["files"],
                               "what": "codes256"} for sp in reads)
    assert counters == {"store.files_read": 32, "store.bytes_read": 32 * 4096}
