"""The KZG scheme across the two packages at n = 8 on the CPU, over the
in-process transport: a porla_tpu_torch client against a porla_tpu server
and the reverse, with initialize, updates and audits that verify on both
sides (the SRS bytes, 96-byte MAC triples, the 192-byte opening and the
two 96-byte points of an audit reply). The reference server's log carries
over into a port server (from_jax_state), and a checkpoint written by
either package's server is resumed by the other's.

The reference side compiles its XLA programs for minutes on the CPU, so
this file is in the slow tier, like tests/test_protocol_kzg.py."""

import pytest
import torch

from porla_tpu.config import PorlaConfig as RefConfig
from porla_tpu.protocol.client import PorlaClient as RefClient
from porla_tpu.protocol.server import PorlaServer as RefServer
from porla_tpu.protocol.transport import InProcTransport as RefTransport
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.protocol import server as srv_mod
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

pytestmark = pytest.mark.slow

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


def test_port_client_with_reference_server(tmp_path):
    ref_server = RefServer(RefConfig(scheme="kzg", storage_dir=str(tmp_path)))
    cfg = PorlaConfig(scheme="kzg", storage_dir=str(tmp_path))
    client = PorlaClient(cfg, InProcTransport(ref_server),
                         data_seed=bytes(range(16)), device="cpu")
    client.initialize(8)
    assert ref_server.srs.to_bytes() == client.srs.to_bytes()
    client.audit(seed=bytes(range(16)))
    client.update(1)
    client.update(2)
    client.audit(seed=bytes(range(1, 17)))

    carried = srv_mod.from_jax_state(ref_server, cfg, device="cpu")
    client.transport = InProcTransport(carried)
    client.audit(seed=bytes(range(2, 18)))

    # the reference server's checkpoint, resumed by the port
    ref_server.save_checkpoint()
    client.transport = InProcTransport(PorlaServer.restore(cfg, device="cpu"))
    client.update(3)
    client.audit(seed=bytes(range(3, 19)))


def test_reference_client_with_port_server(tmp_path):
    cfg = PorlaConfig(scheme="kzg", storage_dir=str(tmp_path))
    server = PorlaServer(cfg, device="cpu")
    ref_cfg = RefConfig(scheme="kzg", storage_dir=str(tmp_path))
    transport = RefTransport(server)
    client = RefClient(ref_cfg, transport, data_seed=bytes(range(16)))
    client.initialize(8)
    client.audit(seed=bytes(range(16)))
    client.update(1)
    client.update(2)
    client.audit(seed=bytes(range(1, 17)))

    # the port server's checkpoint, resumed by the reference
    server.save_checkpoint()
    transport.server = RefServer.restore(ref_cfg)
    client.audit(seed=bytes(range(2, 18)))
    client.update(3)
    client.audit(seed=bytes(range(3, 19)))
