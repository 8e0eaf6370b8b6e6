"""The port's BlockStore (porla_tpu_torch.storage.store) against the
reference package's (porla_tpu.storage.store): for the same limb arrays the
H_X/, H_Y/ and STG/ files are byte-identical, each package reads the
other's files back to the same limbs, and raw U/ blocks load to the same
CRT lanes. Limbs are random 16-bit values with the edges 0, 0x7FFF, 0x8000
and 0xFFFF in every chunk (the port widens a file's limbs through int16).
Tolerance: zero."""

import os

import numpy as np
import pytest
import torch

from porla_tpu.ntt import engine as jengine
from porla_tpu.storage.store import BlockStore as JStore
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.ntt import engine
from porla_tpu_torch.storage.store import BlockStore

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
