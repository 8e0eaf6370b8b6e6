"""The out-of-core bench tool (porla_tpu_torch.tools.bench_ooc) on the CPU.

Fast cases, port only, each scheme at n = 8 with top_caching_level 1 and
stripes of 2 (level 3 streamed in two passes of stages, 1-2 and 3): the
tool's `measure` with --check passes in all three parts (about 25 s a scheme
on one thread, the module's one run); a flipped byte of a codeword file
makes the data check raise (about 1 s); a store whose file system is too
small is refused before anything is written, by name and with the bytes
needed and free (monkeypatched statvfs, under 1 s); the CLI's record,
printed last and written to --out, has the JAX example's keys and the
memory and disk breakdown, and the disk layout it states is the files
the run left at its peak and after it (about 15 s). Without a card the tool raises
(tests/test_torch_tools.py).

Slow case, across the packages (the reference's CRebuild compiles its XLA
programs for about two minutes on the CPU, as tests/test_disk_tier.py
does, so it is in the slow tier): at n = 16, --top 2, --stripe 4 (two
passes) in both schemes, U/ and the MAC plane seeded identically from one
numpy seed, the reference server's own `_setup(16)` and `_crebuild()`
(its streamed branch) against the tool's `measure`: the top level's H_X/H_Y
files byte-equal, the "a" and "c" planes equal as affine points (their
Jacobian limbs differ by design: K2/K3 add the GLV halves as two chains).
Tolerance: zero."""

import json
import os
import types

import numpy as np
import pytest
import torch

from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.tools import bench_ooc

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

SEED = 13
CPU = torch.device("cpu")
N, TOP, STRIPE = 8, 1, 2


def quiet(msg):
    pass


@pytest.fixture(scope="module", params=["ipa", "kzg"])
def ran(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"ooc_{request.param}"))
    rec, server, k = bench_ooc.measure(N, TOP, STRIPE, request.param, CPU,
                                       root, True, SEED, quiet)
    return rec, server, k


def test_check_passes(ran):
    rec, server, _ = ran
    assert rec["check"] == {"data": "exact", "align": "exact",
                            "mac": "exact"}
    assert rec["check_detail"]["data_blocks"] == 2 * N
    assert rec["check_detail"]["align_stripes"] == [[0, 2], [6, 8]]
    assert rec["check_detail"]["mac_samples"] == N
    assert server.levels[server.height - 1].file_backed
    # two passes of stages over the files a side
    assert rec["phases_s"]["data_stages"] > 0


def test_flipped_codeword_byte_raises(ran):
    _, server, _ = ran
    top = server.height - 1
    path = os.path.join(server.store.root, "H_Y", f"{top}_5")
    with open(path, "rb") as f:
        orig = f.read()
    bad = bytearray(orig)
    bad[100] ^= 0x10
    with open(path, "wb") as f:
        f.write(bytes(bad))
    try:
        with pytest.raises(bench_ooc.CheckFailed, match="H_Y block 5 "):
            bench_ooc.check_data_and_align(server)
    finally:
        with open(path, "wb") as f:
            f.write(orig)


def test_small_store_is_refused(tmp_path, monkeypatch):
    real = os.statvfs

    def statvfs(path):
        st = real(path)
        return types.SimpleNamespace(f_bavail=1000, f_frsize=4096,
                                     f_blocks=st.f_blocks, f_bfree=1000)

    monkeypatch.setattr(bench_ooc.os, "statvfs", statvfs)
    need = sum(bench_ooc.bytes_needed(1 << 18).values())
    assert need == 7 * 2 ** 30
    with pytest.raises(bench_ooc.StoreTooSmall,
                       match=f"has 4096000 bytes free; n = 262144 blocks "
                             f"need {need} "):
        bench_ooc.run(device="cpu", store=str(tmp_path / "s"), log=quiet)
    assert os.listdir(tmp_path / "s") == []


def count_files(root):
    """Files and bytes under the store's U/, STG/, H_X/, H_Y/."""
    out = {}
    for sub in ("U", "STG", "H_X", "H_Y"):
        with os.scandir(os.path.join(root, sub)) as it:
            sizes = [e.stat().st_size for e in it]
        out[sub] = {"files": len(sizes), "bytes": sum(sizes)}
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def test_record_keys(tmp_path, capsys, monkeypatch):
    from porla_tpu_torch.storage.store import BlockStore

    store = tmp_path / "store"
    # the files on disk at the peak: just before the first side's staging
    # files are deleted
    peak, delete = [], BlockStore.delete_staged

    def delete_staged(self, tag, n):
        if not peak:
            peak.append(count_files(str(store)))
        delete(self, tag, n)

    monkeypatch.setattr(BlockStore, "delete_staged", delete_staged)
    out = tmp_path / "ooc.json"
    rec = bench_ooc.main(["--n", str(N), "--top", str(TOP), "--stripe",
                          str(STRIPE), "--device", "cpu", "--store",
                          str(store), "--out", str(out),
                          "--seed", str(SEED)])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert json.loads(out.read_text()) == rec
    # the JAX example's keys, `device` in place of `backend`
    for key in ("metric", "n", "top_caching_level", "stripe_blocks",
                "data_plane_bytes_per_side", "phases_s", "total_s",
                "coeffs_per_s_data_stages", "peak_rss_gb", "device"):
        assert key in rec
    assert rec["metric"] == "streamed_crebuild" and rec["device"] == "cpu"
    assert (rec["n"], rec["top_caching_level"], rec["stripe_blocks"]) == \
        (N, TOP, STRIPE)
    assert rec["data_plane_bytes_per_side"] == N * 128 * 32
    assert list(rec["phases_s"]) == list(bench_ooc.PHASES)
    assert sum(rec["phases_s"].values()) <= rec["total_s"]
    assert "check" not in rec
    mem = rec["memory"]
    assert set(mem["rss_by_phase"]) == set(bench_ooc.PHASES)
    assert {"python_torch", "server", "seeded", "crebuild"} <= \
        set(mem["rss_mib"])
    assert mem["rss_peak_mib"] >= max(mem["rss_mib"]["seeded"],
                                      *(v["peak_mib"] for v in
                                        mem["rss_by_phase"].values()))
    assert mem["pinned_buffer_bytes"] == 0          # no card: no pinning
    disk = rec["disk"]
    assert disk["filesystem"]["fstype"] and "in_ram" in disk["filesystem"]
    # the layout the record states is the files the run left: at the peak
    # U/, both staging planes and H_X/; after it U/, H_X/, H_Y/
    files = lambda d: {s: (d[s]["files"], d[s]["bytes"])
                       for s in ("U", "STG", "H_X", "H_Y")}
    assert files(disk["at_peak"]) == {"U": (N, N * 4096),
                                      "STG": (2 * N, 2 * N * 8192),
                                      "H_X": (N, N * 4096), "H_Y": (0, 0)}
    assert files(disk["after"]) == {"U": (N, N * 4096), "STG": (0, 0),
                                    "H_X": (N, N * 4096),
                                    "H_Y": (N, N * 4096)}
    assert peak == [disk["at_peak"]]
    assert count_files(str(store)) == disk["after"]
    assert disk["fs_used_delta_peak_bytes"] >= \
        disk["fs_used_delta_after_bytes"]
    assert disk["space"]["needed_bytes"] == N * (4096 + 2 * 8192 + 2 * 4096)


@pytest.mark.slow
@pytest.mark.parametrize("scheme", ["ipa", "kzg"])
def test_streamed_top_level_matches_porla_tpu(tmp_path, scheme):
    from porla_tpu.commit import kzg as jkzg
    from porla_tpu.config import PorlaConfig as RefConfig
    from porla_tpu.curves.weierstrass import JacPoint as JJacPoint
    from porla_tpu.protocol.server import PorlaServer as RefServer
    from porla_tpu_torch.curves.weierstrass import JacPoint

    n, top, stripe = 16, 2, 4
    rec, port, k = bench_ooc.measure(n, top, stripe, scheme, CPU,
                                     str(tmp_path / "port"), True, SEED,
                                     quiet)
    assert rec["check"] == {"data": "exact", "align": "exact",
                            "mac": "exact"}
    ref = RefServer(RefConfig(scheme=scheme, top_caching_level=top,
                              stream_stripe_blocks=stripe,
                              storage_dir=str(tmp_path / "ref")))
    if scheme == "kzg":
        ref.srs = jkzg.KzgSrs.from_bytes(port.srs.to_bytes())
    ref._setup(n)
    bench_ooc.seed_blocks(ref.store, n, SEED)
    ref.mac_u = JJacPoint(*(L.to_numpy(c) for c in port.mac_u))
    ref._crebuild()

    lvl = port.height - 1
    assert ref.levels[lvl].file_backed and port.levels[lvl].file_backed
    for sub in ("H_X", "H_Y"):
        names = [f"{lvl}_{i}" for i in range(n)]
        for side in ("port", "ref"):
            assert sorted(os.listdir(tmp_path / side / sub)) == sorted(names)
        for name in names:
            assert (tmp_path / "port" / sub / name).read_bytes() == \
                (tmp_path / "ref" / sub / name).read_bytes(), f"{sub}/{name}"
    for side in ("x", "y"):
        for plane in ("a", "c"):
            want = JacPoint(*(L.to_torch(np.asarray(c)) for c in
                              getattr(ref.levels[lvl], side).points[plane]))
            got = getattr(port.levels[lvl], side).points[plane]
            assert port.ops.to_affine(got) == port.ops.to_affine(want), \
                f"{side} {plane}"
