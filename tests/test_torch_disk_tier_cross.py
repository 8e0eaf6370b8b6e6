"""The disk tier across the packages at n = 8 on the CPU, stripes of 3.
First, a port server and a porla_tpu server, each driven by a port client
of the same data seed, must hold byte-identical H_X/ and H_Y/ trees and the
same alignment points (affine) in every file-backed level after initialize
(the streamed CRebuild) and after each of updates 1-4 (the streamed folds:
with top_caching_level = 1 the fold into level 2 has a lower level in
memory; with 0 update 2 streams level 1 into files and update 4 folds
through two streamed mixes, the second with level 1's files as its lower
and the first one's staging files as its upper). Second, a porla_tpu server
whose top level (and, after four updates, level 2) lives in H_X/H_Y files,
driven by the port's client, is carried into a port server by
from_jax_state on the same storage_dir; the port server reads the
reference's codeword files, and the next update and audit verify. The
reference side compiles its XLA programs for minutes on the CPU, so this
file is in the slow tier, like tests/test_disk_tier.py."""

import os

import numpy as np
import pytest
import torch

from porla_tpu.config import PorlaConfig as RefConfig
from porla_tpu.protocol.server import PorlaServer as RefServer
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.curves.weierstrass import JacPoint
from porla_tpu_torch.fields import limbs as L
from porla_tpu_torch.protocol import server as srv_mod
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

pytestmark = pytest.mark.slow

torch.set_num_threads(1)     # small tensors; xdist runs files side by side

SEED = bytes(range(16))


def _tree(root):
    """name -> bytes of every file under H_X/ and H_Y/."""
    out = {}
    for sub in ("H_X", "H_Y"):
        for f in sorted(os.listdir(os.path.join(root, sub))):
            with open(os.path.join(root, sub, f), "rb") as fh:
                out[f"{sub}/{f}"] = fh.read()
    return out


def _same_disk_state(port, ref):
    assert [lv.file_backed for lv in port.levels] == \
        [lv.file_backed for lv in ref.levels]
    tree = _tree(port.config.storage_dir)
    assert tree and tree == _tree(ref.config.storage_dir)
    for lvl, (lv, rlv) in enumerate(zip(port.levels, ref.levels)):
        if not lv.file_backed:
            continue
        for side, rside in ((lv.x, rlv.x), (lv.y, rlv.y)):
            want = JacPoint(*(L.to_torch(np.asarray(c))
                              for c in rside.points["a"]))
            assert port.ops.to_affine(side.points["a"]) == \
                port.ops.to_affine(want), f"level {lvl}"
    for root in (port.config.storage_dir, ref.config.storage_dir):
        assert os.listdir(os.path.join(root, "STG")) == []


@pytest.mark.parametrize("scheme,top_caching_level",
                         [("ipa", 1), ("kzg", 0)])
def test_streamed_files_match_the_reference(tmp_path, scheme,
                                            top_caching_level):
    kw = dict(scheme=scheme, top_caching_level=top_caching_level,
              stream_stripe_blocks=3)
    port = PorlaServer(PorlaConfig(**kw, storage_dir=str(tmp_path / "port")),
                       device="cpu")
    ref = RefServer(RefConfig(**kw, storage_dir=str(tmp_path / "ref")))
    clients = [PorlaClient(PorlaConfig(**kw,
                                       storage_dir=srv.config.storage_dir),
                           InProcTransport(srv), data_seed=SEED, device="cpu")
               for srv in (port, ref)]
    for client in clients:
        client.initialize(8)
    _same_disk_state(port, ref)
    for step in range(1, 5):
        for client in clients:
            client.update(step)
        _same_disk_state(port, ref)
    assert port.levels[2].file_backed


@pytest.mark.parametrize("scheme", ["ipa", "kzg"])
def test_reference_file_backed_levels_carry_into_the_port(tmp_path, scheme):
    kw = dict(scheme=scheme, top_caching_level=1, stream_stripe_blocks=3,
              storage_dir=str(tmp_path))
    ref_server = RefServer(RefConfig(**kw))
    cfg = PorlaConfig(**kw)
    client = PorlaClient(cfg, InProcTransport(ref_server),
                         data_seed=SEED, device="cpu")
    client.initialize(8)
    for i in range(4):
        client.update(i + 1)
    assert ref_server.levels[2].file_backed
    assert ref_server.levels[3].file_backed

    carried = srv_mod.from_jax_state(ref_server, cfg, device="cpu")
    assert [lv.file_backed for lv in carried.levels] == \
        [lv.file_backed for lv in ref_server.levels]
    client.transport = InProcTransport(carried)
    client.audit(seed=bytes(range(2, 18)))
    client.update(5)
    client.audit(seed=bytes(range(3, 19)))
