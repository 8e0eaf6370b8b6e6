"""The port's mirror of tests/test_protocol_n128.py: the protocol at n = 128
on the CPU plain path, the first size where the audit's NUM_CHECK_AUDIT
sampling branch runs (a level of 128 blocks has 2l = 256 > 128 candidates,
so the audit samples 128 random indices instead of taking every block;
reference Server.hpp:604-666, protocol/auditing.py), with 8 updates that
fold through levels 0..3.

Beyond the reference's test: every message the port client sends is
replayed into a porla_tpu server, whose replies must be the port server's
byte for byte; in particular each audit's reply (the compressed points and
the IPA proof) for the same seed, after initialize and after the updates.
One port initialize takes over 110 s on one CPU thread and the reference
server compiles its XLA programs, so this file is in the slow tier, like
the reference's."""

import pytest
import torch

from porla_tpu.config import PorlaConfig as RefConfig
from porla_tpu.protocol.server import PorlaServer as RefServer
from porla_tpu_torch.config import NUM_CHECK_AUDIT, PorlaConfig
from porla_tpu_torch.protocol.auditing import build_audit_plan
from porla_tpu_torch.protocol.client import PorlaClient
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport

pytestmark = pytest.mark.slow

torch.set_num_threads(1)     # xdist runs files side by side


class Replayed(InProcTransport):
    """The port server's transport that also sends every message to a
    porla_tpu server and keeps both replies."""

    def __init__(self, server, ref):
        super().__init__(server)
        self.ref = ref
        self.replies = []

    def __call__(self, msg: bytes) -> bytes:
        reply = super().__call__(msg)
        self.replies.append((reply, self.ref.handle(bytes(msg))))
        return reply

    def same_since(self, start: int) -> int:
        """Asserts that the replies since `start` are byte-equal; returns
        how many there were."""
        for k, (reply, ref_reply) in enumerate(self.replies[start:]):
            assert reply == ref_reply, f"reply {start + k} differs"
        return len(self.replies) - start


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = PorlaConfig(scheme="ipa",
                      storage_dir=str(tmp_path_factory.mktemp("store")))
    server = PorlaServer(cfg, device="cpu")
    ref = RefServer(RefConfig(scheme="ipa", storage_dir=str(
        tmp_path_factory.mktemp("ref"))))
    transport = Replayed(server, ref)
    client = PorlaClient(cfg, transport, data_seed=bytes([3] * 16),
                         device="cpu")
    client.initialize(128)
    return client, server, transport


def test_sampling_branch_is_exercised(pair):
    client, server, transport = pair
    plan = build_audit_plan(bytes(16), server.write_step, 128,
                            server.height)
    top = [s for s in plan.samples if s.level == server.height - 1]
    # the top level contributes exactly NUM_CHECK_AUDIT sampled blocks,
    # not all 256
    assert len(top) == NUM_CHECK_AUDIT
    assert any(s.index != i for i, s in enumerate(top))
    # initialize: the generators, the count, one batch, the deltas
    assert transport.same_since(0) == 4


def test_audit_after_initialize(pair):
    client, server, transport = pair
    start = len(transport.replies)
    client.audit(seed=bytes([9] * 16))
    assert transport.same_since(start) == 1


def test_updates_fold_deep_and_audit(pair):
    client, server, transport = pair
    start = len(transport.replies)
    # 8 writes fold through levels 0..3
    for i in range(8):
        client.update(i + 1)
    assert not server.levels[3].empty
    assert transport.same_since(start) == 8
    start = len(transport.replies)
    client.audit()
    assert transport.same_since(start) == 1
