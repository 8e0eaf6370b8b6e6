"""The port's native host runtime (porla_tpu_torch/runtime, its own copy of
porla_rt.cc built with g++ at first use) against its numpy plain version
(`crypto.aes.ecb_encrypt_plain`) and the reference package
(`porla_tpu.crypto.aes`), byte for byte, mirroring
tests/test_runtime_native.py: AES-128 ECB, the PRG expansion (mid-stream
counter included), the MAC PRF, batched file reads, writes and deletes
(in one directory and across several, from concurrent callers and a
forked child), and a build that fails raises."""

import os
import random
import struct
import threading

import numpy as np
import pytest

from porla_tpu.crypto import aes as ref
from porla_tpu_torch.crypto import aes
from porla_tpu_torch.runtime import lib as rt


@pytest.mark.parametrize("nblocks", [1, 33, 1024])
def test_aes_matches_plain_and_reference(nblocks):
    rng = random.Random(nblocks)
    key = rng.randbytes(16)
    pt = rng.randbytes(16 * nblocks)
    got = rt.aes128_ecb(key, pt)
    assert got == aes.ecb_encrypt_plain(key, pt)
    assert got == ref._ecb_encrypt(key, pt)


def test_fips197_vector():
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert rt.aes128_ecb(key, pt).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_prg_expand_matches_python():
    seed = bytes(range(16))
    n = 100
    assert rt.prg_expand(seed, 0, n) == ref.Prg(seed, 0).random_block(n)
    # mid-stream counter
    prg = ref.Prg(seed, 0)
    prg.random_block(7)
    assert rt.prg_expand(seed, 7, 5) == prg.random_block(5)
    # the counter blocks as the plain version encrypts them
    pts = b"".join(c.to_bytes(8, "little") + bytes(8) for c in range(7, 12))
    assert rt.prg_expand(seed, 7, 5) == aes.ecb_encrypt_plain(seed, pts)


@pytest.mark.parametrize("stream_id", [0, 1, 2])
def test_prg_stream_matches_reference(stream_id):
    seed = bytes(range(3, 19))
    a, b = aes.Prg(seed, stream_id), ref.Prg(seed, stream_id)
    assert a.random_data(4064 * 3) == b.random_data(4064 * 3)
    assert a.random_data(13) == b.random_data(13)
    assert a.random_block(2) == b.random_block(2)


def test_mac_prf_matches_plain():
    key = os.urandom(16)
    records = [(lv, i, 7 * i + lv) for lv in range(3) for i in range(22)]
    pt = b"".join(struct.pack("<iiq", *r) for r in records)
    ct = aes.ecb_encrypt_plain(key, pt)
    prf = aes.MacPrf(key)
    assert prf.prf_scalars_ipa(records) == [
        int.from_bytes(ct[k:k + 16], "little") for k in range(0, len(ct), 16)]
    assert prf.prf_block(*records[5]) == ct[80:96]


def test_batched_file_io_roundtrip(tmp_path):
    paths = [str(tmp_path / f"f{i}") for i in range(20)]
    rec = 4096
    data = os.urandom(rec * len(paths))
    rt.write_files(paths, rec, data, threads=4)
    back = rt.read_files(paths, rec, threads=4)
    assert back.tobytes() == data
    # the files themselves are the records
    with open(paths[3], "rb") as f:
        assert f.read() == data[3 * rec:4 * rec]
    # into a caller's buffer, from an array
    buf = np.zeros(rec * 25, np.uint8)
    out = rt.read_files(paths[5:10], rec, buf)
    assert out.tobytes() == data[5 * rec:10 * rec]
    rt.write_files(paths[:2], rec, np.frombuffer(data[-2 * rec:], np.uint8))
    assert rt.read_files(paths[:2], rec).tobytes() == data[-2 * rec:]


@pytest.mark.parametrize("layout", ["one_dir", "two_dirs", "relative"])
@pytest.mark.parametrize("threads", [1, 4, 32])
def test_batched_io_in_and_across_directories(tmp_path, monkeypatch, layout,
                                              threads):
    """A batch in one directory opens its files under that directory; one
    that spans directories, or relative paths, opens each path whole. The
    workers are the process's pool, reused from batch to batch."""
    for d in ("H_X", "H_Y"):
        os.mkdir(tmp_path / d)
    names = [f"{'H_X' if i % 2 or layout == 'one_dir' else 'H_Y'}/14_{i}"
             for i in range(40)]
    if layout == "relative":
        monkeypatch.chdir(tmp_path)
        paths = names
    else:
        paths = [str(tmp_path / n) for n in names]
    rec = 64
    data = os.urandom(rec * len(paths))
    rt.write_files(paths, rec, data, threads=threads)
    for k in range(5):
        part = slice(k, 40, 5)
        want = b"".join(data[i * rec:(i + 1) * rec]
                        for i in range(40)[part])
        assert rt.read_files(paths[part], rec,
                             threads=threads).tobytes() == want
    with open(tmp_path / names[7], "rb") as f:
        assert f.read() == data[7 * rec:8 * rec]
    rt.delete_files(paths, threads=threads)
    assert os.listdir(tmp_path / "H_X") == os.listdir(tmp_path / "H_Y") == []


def test_short_file_fails_its_read(tmp_path):
    paths = [str(tmp_path / f"s{i}") for i in range(3)]
    rt.write_files(paths, 32, bytes(96))
    rt.write_files(paths[1:2], 16, bytes(16))
    with pytest.raises(IOError, match="2/3"):
        rt.read_files(paths, 32)


def test_concurrent_batches_read_their_own_records(tmp_path):
    paths = [str(tmp_path / f"c{i}") for i in range(64)]
    rec = 256
    data = os.urandom(rec * 64)
    rt.write_files(paths, rec, data)
    bad = []

    def reader(seed):
        rng = random.Random(seed)
        for _ in range(50):
            ix = rng.sample(range(64), 16)
            got = rt.read_files([paths[i] for i in ix], rec).tobytes()
            if got != b"".join(data[i * rec:(i + 1) * rec] for i in ix):
                bad.append(seed)

    threads = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert bad == []


def test_a_forked_child_makes_its_own_workers(tmp_path):
    paths = [str(tmp_path / f"k{i}") for i in range(16)]
    data = os.urandom(16 * 128)
    rt.write_files(paths, 128, data, threads=8)   # the parent's pool exists
    pid = os.fork()
    if pid == 0:
        ok = rt.read_files(paths, 128, threads=8).tobytes() == data
        os._exit(0 if ok else 1)
    _, status = os.waitpid(pid, 0)
    assert os.waitstatus_to_exitcode(status) == 0
    assert rt.read_files(paths, 128, threads=8).tobytes() == data


def test_batched_delete(tmp_path):
    paths = [str(tmp_path / f"d{i}") for i in range(10)]
    rt.write_files(paths[:7], 16, bytes(16 * 7))
    rt.delete_files(paths)            # three never existed
    assert os.listdir(tmp_path) == []
    os.mkdir(tmp_path / "d0")         # a directory is not removed as a file
    (tmp_path / "d0" / "x").write_bytes(b"x")
    with pytest.raises(IOError):
        rt.delete_files(paths[:1])


def test_read_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        rt.read_files([str(tmp_path / "nope")], 16)
    with pytest.raises(IOError):
        rt.write_files([str(tmp_path / "no_dir" / "f")], 16, bytes(16))


def test_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError):
        rt.build(cxx=str(tmp_path / "missing" / "g++"),
                 build_dir=str(tmp_path / "build"))
    assert not os.listdir(tmp_path / "build")


def test_build_is_reused_and_atomic(tmp_path):
    so = rt.build(build_dir=str(tmp_path))
    mtime = os.path.getmtime(so)
    assert rt.build(build_dir=str(tmp_path)) == so
    assert os.path.getmtime(so) == mtime
    # nothing but the library is left beside it
    assert os.listdir(tmp_path) == [os.path.basename(so)]


def test_concurrent_builds_give_one_whole_library(tmp_path):
    import ctypes
    import threading
    results, errors = [], []

    def run():
        try:
            results.append(rt.build(build_dir=str(tmp_path)))
        except Exception as e:      # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(results)) == 1 and len(results) == 4
    assert os.listdir(tmp_path) == [os.path.basename(results[0])]
    ctypes.CDLL(results[0]).porla_aes128_ecb
