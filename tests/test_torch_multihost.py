"""The port's multi-process path (porla_tpu_torch/parallel/multihost.py):
two real processes of this file joined over torch.distributed with gloo on
the CPU, each with two CPU shards.

- The distributed NTT at n = 16 on dp = 4 (stage 3 exchanges within a
  process, stage 4 between the processes), both lanes, gathered in each
  process and held limb for limb against porla_tpu.ntt.engine.encode_stages.
- share_fleet_seed: both processes derive the same MSM blinding, and a
  sharded Pippenger MSM over both processes' shards (16 bits, 64 points)
  equals the golden sum.
- init_distributed with NCCL and two processes naming one card raises
  before any NCCL call.
- Slow tier: the whole epoch of porla_tpu_torch/tools/run_multihost.py
  (initialize, update, audit) in two processes at n = 8; the plain versions
  take about a minute a process.

Run as `python tests/test_torch_multihost.py MODE RANK WORLD PORT OUT`, this
file is one process of such a run.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N, CHUNKS, NPTS = 16, 4, 64


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"       # two processes side by side
    env.pop("JAX_PLATFORMS", None)
    return env


def _run(argvs, timeout):
    procs = [subprocess.Popen([sys.executable, *a], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=_env(), cwd=ROOT)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _workers(mode, tmp_path, timeout=300):
    port = _free_port()
    res = _run([[__file__, mode, str(r), "2", str(port), str(tmp_path)]
                for r in range(2)], timeout)
    for r, (rc, out) in enumerate(res):
        assert rc == 0, f"process {r} rc={rc}\n{out[-3000:]}"
    return [out for _, out in res]


def test_distributed_ntt_and_fleet_seed(tmp_path):
    from porla_tpu.golden import ecc as jecc
    from porla_tpu.ntt import engine as jeng

    _workers("ntt", tmp_path)
    jctx = jeng.NttContext(N, "ipa")
    ap, aq = _lanes(jctx.mod_p.n, jctx.mod_q.n)
    want = jeng.encode_stages(np, jctx, jeng.CrtArray(ap, aq))
    recs = []
    for r in range(2):
        got = np.load(tmp_path / f"ntt{r}.npz")
        assert np.array_equal(got["p"], want.p), f"process {r}, p lane"
        assert np.array_equal(got["q"], want.q), f"process {r}, q lane"
        recs.append(json.loads((tmp_path / f"rec{r}.json").read_text()))
    assert recs[0]["blinding"] == recs[1]["blinding"]
    aff, ks = _msm_inputs(jecc)
    want_msm = jecc.msm(jecc.SECP256K1, aff, ks)
    for r, rec in enumerate(recs):
        assert tuple(rec["msm"]) == want_msm, f"process {r}"
        assert rec["mesh"] == {"blocks": 4, "chunks": 1}
        assert rec["rows"] == [2 * r, 2 * r + 1]
        assert rec["traffic"]["sent"] > 0 and rec["traffic"]["gathered"] > 0


def test_nccl_on_a_shared_card_raises(tmp_path):
    outs = _workers("nccl", tmp_path)
    for out in outs:
        assert "raised: processes 0 and 1 share cuda:0" in out, out


@pytest.mark.slow
def test_two_process_protocol_epoch(tmp_path):
    port = _free_port()
    res = _run([["-m", "porla_tpu_torch.tools.run_multihost",
                 "--coordinator", f"localhost:{port}", "--nprocs", "2",
                 "--proc-id", str(r), "--backend", "gloo",
                 "--device", "cpu,cpu", "--n", "8"] for r in range(2)],
               timeout=1800)
    for r, (rc, out) in enumerate(res):
        assert rc == 0, f"process {r} rc={rc}\n{out[-3000:]}"
        assert "audit PASSED" in out
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["mesh"] == {"blocks": 2, "chunks": 2}
        assert rec["traffic"]["sent"] > 0


# --- one process of a run ----------------------------------------------------

def _lanes(p: int, q: int):
    """The run's data: (N, CHUNKS) values below each lane's modulus, the
    same in every process (numpy seed 3)."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, (2, N * CHUNKS, 8), dtype=np.uint64)
    vals = [[sum(int(w) << (32 * i) for i, w in enumerate(row)) % m
             for row in words[k]] for k, m in enumerate((p, q))]

    def limbs(v):
        return np.array([[(x >> (16 * i)) & 0xFFFF for i in range(16)]
                         for x in v], np.uint32).reshape(N, CHUNKS, 16)
    return limbs(vals[0]), limbs(vals[1])


def _msm_inputs(ecc):
    rng = np.random.default_rng(12)
    cv = ecc.SECP256K1
    base = [ecc.mul(cv, cv.g, int(k) + 2) for k in
            rng.integers(1, 1 << 20, 8)]
    return ([base[i % 8] for i in range(NPTS)],
            [int(k) for k in rng.integers(0, 1 << 16, NPTS)])


def _worker(mode, rank, world, port, out) -> int:
    import torch

    from porla_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    coord = f"localhost:{port}"
    if mode == "nccl":
        try:
            multihost.init_distributed(coord, world, rank, "nccl",
                                       devices=["cuda:0"])
        except ValueError as e:
            print(f"raised: {e}", flush=True)
            return 0
        return 1

    from porla_tpu_torch.curves import cuda_msm
    from porla_tpu_torch.curves.instances import secp256k1
    from porla_tpu_torch.fields import limbs as L
    from porla_tpu_torch.golden import ecc
    from porla_tpu_torch.ntt.engine import MOD_P, NttContext
    from porla_tpu_torch.parallel import sharded

    multihost.init_distributed(coord, world, rank, "gloo",
                               devices=["cpu", "cpu"])
    mesh = multihost.make_mesh(tp=1)
    assert mesh.rows == list(range(mesh.dp))[
        multihost.process_local_slice(mesh.dp)]
    cpu = torch.device("cpu")
    ctx = NttContext(N, "ipa")
    multihost.reset_traffic()
    lanes = {}
    for lane, mod, arr in zip("pq", (MOD_P, ctx.mod_q),
                              _lanes(MOD_P.n, ctx.mod_q.n)):
        shards = sharded.sharded_encode_fn(ctx, mesh, mod)(L.to_torch(arr))
        lanes[lane] = L.to_numpy(sharded.gather(mesh, shards, cpu))
    np.savez(os.path.join(out, f"ntt{rank}.npz"), **lanes)

    ops = secp256k1()
    blind = cuda_msm.blinding(ops, 8)
    aff, ks = _msm_inputs(ecc)
    fn, finish = sharded.sharded_pippenger_msm_fn(mesh, ops, nbits=16,
                                                  n_local=NPTS // mesh.dp)
    total = ops.to_affine(finish(fn(ops.from_affine(aff),
                                    L.ints_to_tensor(ks))))[0]
    rec = {"mesh": mesh.shape, "rows": mesh.rows,
           "blinding": [L.tensor_to_ints(blind.x), blind.tsum],
           "msm": list(total), "traffic": dict(multihost.TRAFFIC)}
    with open(os.path.join(out, f"rec{rank}.json"), "w") as f:
        json.dump(rec, f)
    multihost.close()
    return 0


if __name__ == "__main__":
    mode, rank, world, port, out = sys.argv[1:]
    sys.exit(_worker(mode, int(rank), int(world), port, out))
