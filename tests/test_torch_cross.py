"""Wire compatibility between the port and the reference package at n = 8
on the CPU: a porla_tpu_torch client against a porla_tpu server and a
porla_tpu client against a porla_tpu_torch server, over the in-process
transport, with initialize, updates and audits that verify on both sides
(96-byte MAC triples, 33-byte compressed points, the 556-byte IPA proof).
The reference server's log also carries over into a port server
(from_jax_state), against which the port client's audit verifies.

The reference side compiles its XLA programs for minutes on the CPU, so
this file is in the slow tier, like tests/test_protocol_e2e.py."""

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
    ref_server = RefServer(RefConfig(scheme="ipa", storage_dir=str(tmp_path)))
    cfg = PorlaConfig(scheme="ipa", storage_dir=str(tmp_path))
    client = PorlaClient(cfg, InProcTransport(ref_server),
                         data_seed=bytes(range(16)), device="cpu")
    client.initialize(8)
    client.audit(seed=bytes(range(16)))
    client.update(1)
    client.update(2)
    client.audit(seed=bytes(range(1, 17)))

    carried = srv_mod.from_jax_state(ref_server, cfg, device="cpu")
    client.transport = InProcTransport(carried)
    client.update(3)
    client.audit(seed=bytes(range(2, 18)))


def test_reference_client_with_port_server(tmp_path):
    server = PorlaServer(PorlaConfig(scheme="ipa", storage_dir=str(tmp_path)),
                         device="cpu")
    client = RefClient(RefConfig(scheme="ipa", storage_dir=str(tmp_path)),
                       RefTransport(server), data_seed=bytes(range(16)))
    client.initialize(8)
    client.audit(seed=bytes(range(16)))
    client.update(1)
    client.update(2)
    client.audit(seed=bytes(range(1, 17)))
