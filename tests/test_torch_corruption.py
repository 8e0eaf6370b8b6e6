"""Corruption detection and state carry-over on the port at n = 8 on the
CPU. Flipping one bit of a stored codeword's q-lane residue makes the next
audit fail with AuditError (mirrors
tests/test_protocol_e2e.py::test_corruption_is_detected), and restoring it
makes audits verify again. A server's log state survives load_state and
from_jax_state (the reference package's server layout:
porla_tpu Level / Planes / CrtArray / JacPoint holding numpy arrays)
bit for bit, and the client's audits verify against the carried-over
server."""

import numpy as np
import pytest
import torch

from porla_tpu.curves.weierstrass import JacPoint as JJacPoint
from porla_tpu.ntt.engine import CrtArray as JCrtArray
from porla_tpu.protocol import hlog as jhlog
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.fields import limbs
from porla_tpu_torch.protocol import server as srv_mod
from porla_tpu_torch.protocol.client import AuditError, PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = PorlaConfig(scheme="ipa",
                      storage_dir=str(tmp_path_factory.mktemp("store")))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server),
                         data_seed=bytes(range(1, 17)), device="cpu")
    client.initialize(8)
    client.update(1)                  # level 0 occupied beside the top
    return client, server


def test_corruption_is_detected(pair):
    client, server = pair
    top = server.levels[server.height - 1]
    orig = top.x.data
    bad = orig.q.clone()
    bad[0, 0, 0] ^= 1           # changes the value mod q (see the JAX test)
    top.x.data = type(orig)(orig.p, bad)
    with pytest.raises(AuditError):
        client.audit(seed=bytes(range(16)))
    top.x.data = orig


def _export_state(server):
    """A port server's log state as host numpy arrays, in load_state's
    layout."""
    def np_pt(p):
        return tuple(limbs.to_numpy(c) for c in p)

    levels = []
    for lv in server.levels:
        sides = {}
        for side, planes in (("x", lv.x), ("y", lv.y)):
            sides[side] = {
                "data": None if planes.data is None else
                (limbs.to_numpy(planes.data.p), limbs.to_numpy(planes.data.q)),
                "points": {k: np_pt(v) for k, v in planes.points.items()}}
        levels.append({"empty": lv.empty, **sides})
    return {"num_blocks": server.num_blocks, "write_step": server.write_step,
            "mac_u": np_pt(server.mac_u), "levels": levels}


def _same_state(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_state(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_state(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _as_reference_server(state):
    """The exported state in the reference package's server layout."""
    def pt(xyz):
        return JJacPoint(*xyz)

    levels = []
    for lm in state["levels"]:
        sides = []
        for side in ("x", "y"):
            sm = lm[side]
            data = None if sm["data"] is None else JCrtArray(*sm["data"])
            sides.append(jhlog.Planes(data=data, points={
                k: pt(v) for k, v in sm["points"].items()}))
        levels.append(jhlog.Level(*sides, empty=lm["empty"]))

    class RefServer:
        num_blocks = state["num_blocks"]
        write_step = state["write_step"]
        mac_u = pt(state["mac_u"])
    RefServer.levels = levels
    return RefServer


def test_state_carries_over(pair):
    client, server = pair
    state = _export_state(server)
    assert state["write_step"] == 1 and not state["levels"][0]["empty"]
    restored = srv_mod.load_state(state, server.config, device="cpu")
    _same_state(_export_state(restored), state)

    carried = srv_mod.from_jax_state(_as_reference_server(state),
                                     server.config, device="cpu")
    _same_state(_export_state(carried), state)
    client.transport = InProcTransport(carried)
    try:
        client.audit(seed=bytes(range(16)))
    finally:
        client.transport = InProcTransport(server)
