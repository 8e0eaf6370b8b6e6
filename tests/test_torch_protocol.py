"""The port's protocol slice on the CPU: a porla_tpu_torch client against a
porla_tpu_torch server at n = 8 over the in-process transport — initialize,
an audit that verifies (the MAC equation and the IPA transcript) and runs
no scalar multiplication of the golden model (`golden/ecc.py`'s `mul`), an
audit that compresses no SHA-256 block in Python (its 28 blocks, 14 a side
of the IPA transcript, on the native runtime), an
audit whose reply carries a MAC off by one generator refused, the MAC
check's alpha products lane by lane against that golden model (alpha of
128 bits on secp256k1, of 254 bits on BN254), the typed update-order
error, the audit's padding guard, and entry points that take an explicit
device; and, in both schemes, that after initialize neither updates that
form every level nor an audit build or look up a fixed-base table (every
table is held by its owner), and that an in-process IPA client and server
hold one generators' table. Every kernel-backed call takes its plain
torch version here;
chip_smoke.py runs the same cycle through the kernels. Updates are in
test_torch_updates.py, corruption detection in test_torch_corruption.py."""

import pytest
import torch

from porla_tpu_torch import native
from porla_tpu_torch.config import PorlaConfig
from porla_tpu_torch.crypto import shas
from porla_tpu_torch.curves import cuda_curve, glv
from porla_tpu_torch.curves.instances import bn254, secp256k1
from porla_tpu_torch.golden import ecc
from porla_tpu_torch.protocol import auditing
from porla_tpu_torch.protocol.client import (AuditError, PorlaClient,
                                             UpdateOrderError,
                                             alpha_products)
from porla_tpu_torch.protocol.server import PorlaServer
from porla_tpu_torch.protocol.transport import InProcTransport
from porla_tpu_torch.utils import trace

torch.set_num_threads(1)     # small tensors; xdist runs files side by side


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = PorlaConfig(scheme="ipa",
                      storage_dir=str(tmp_path_factory.mktemp("store")))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server),
                         data_seed=bytes(range(16)), device="cpu")
    client.initialize(8)
    return client, server


@pytest.fixture(scope="module")
def kzg_pair(tmp_path_factory):
    cfg = PorlaConfig(scheme="kzg",
                      storage_dir=str(tmp_path_factory.mktemp("kzg_store")))
    server = PorlaServer(cfg, device="cpu")
    client = PorlaClient(cfg, InProcTransport(server),
                         data_seed=bytes([5] * 16), device="cpu")
    client.initialize(8)
    return client, server


def test_audit_after_initialize(pair):
    client, server = pair
    assert server.levels[server.height - 1].x.data.p.device.type == "cpu"
    client.audit(seed=bytes(range(16)))


def test_audit_runs_no_host_scalar_mul(pair, monkeypatch):
    client, _ = pair
    glv.params_for(client.ops.curve)      # the GLV constants: set-up, cached

    def refuse(*args):
        raise AssertionError("the golden model's mul on an audit's path")
    monkeypatch.setattr(ecc, "mul", refuse)
    client.audit(seed=bytes(range(3, 19)))


def test_audit_compresses_no_block_in_python(pair, monkeypatch):
    client, _ = pair

    def refuse(*args):
        raise AssertionError("a Python SHA-256 compression on an audit")
    monkeypatch.setattr(shas, "_compress", refuse)
    trace.reset()
    trace.enable(True)
    try:
        client.audit(seed=bytes(range(5, 21)))
        counts = {k: v["count"] for k, v in trace.summary().items()
                  if k.endswith("sha256.blocks")}
    finally:
        trace.enable(False)
        trace.reset()
    assert sum(counts.values()) == 28
    # 14 a side: the prover's under the server's audit, the verifier's
    # under the client's ipa.verify
    assert sum(v for k, v in counts.items() if "server.audit.prove" in k) == 14
    assert sum(v for k, v in counts.items() if "ipa.verify" in k) == 14


def test_mac_off_by_a_generator_refused(pair, monkeypatch):
    client, _ = pair
    cv = ecc.SECP256K1
    send = client.transport

    def off_by_g(msg):
        reply = send(msg)
        mac = ecc.add(cv, ecc.secp_parse_compressed(reply[33:66]), cv.g)
        return reply[:33] + ecc.secp_serialize_compressed(mac) + reply[66:]
    monkeypatch.setattr(client, "transport", off_by_g)
    with pytest.raises(AuditError):
        client.audit(seed=bytes(range(4, 20)))


@pytest.mark.parametrize("scheme", ["ipa", "kzg"])
def test_alpha_products_match_golden_model(scheme):
    """K2's windowed mode over 128 bits for IPA's alpha, its GLV mode for a
    KZG alpha of 254 bits; a lane at infinity stays there."""
    if scheme == "ipa":
        ops = secp256k1()
        alpha = PorlaClient(PorlaConfig(scheme="ipa"), None,
                            device="cpu").alpha
        assert 124 < alpha.bit_length() <= 128
    else:
        ops = bn254()
        alpha = ops.curve.n - 0x1234567
        assert alpha.bit_length() == 254
    cv = ops.curve
    pts = [ecc.mul(cv, cv.g, 3), ecc.mul(cv, cv.g, 1 << 200), ecc.INF]
    got = ops.to_affine(alpha_products(ops, alpha, ops.from_affine(pts)))
    assert got == [ecc.mul(cv, p, alpha) for p in pts]


def test_misaligned_update_rejected(pair):
    client, _ = pair
    expected = (client.write_step % client.num_blocks) + 1
    with pytest.raises(UpdateOrderError):
        client.update(expected % client.num_blocks + 1)


def test_entry_points_take_an_explicit_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    for scheme in ("ipa", "kzg"):
        cfg = PorlaConfig(scheme=scheme, storage_dir=str(tmp_path))
        with pytest.raises(RuntimeError):
            PorlaServer(cfg)              # device="cuda" by default
        with pytest.raises(RuntimeError):
            PorlaClient(cfg, None)
    with pytest.raises(TypeError):     # a mesh is a parallel.sharded.Mesh
        PorlaServer(PorlaConfig(scheme="ipa", storage_dir=str(tmp_path),
                                mesh=object()), device="cpu")
    assert native.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("party", ["client", "server"])
def test_audit_plan_larger_than_its_padding_refused(pair, monkeypatch, party):
    """Both parties pad an audit to `audit_pad_slots`; a plan with more
    samples than that is refused before any work (the client before it
    contacts the server)."""
    client, server = pair
    monkeypatch.setattr(auditing, "audit_pad_slots", lambda n, height: 4)
    sent = []
    monkeypatch.setattr(client, "transport", lambda msg: sent.append(msg))
    with pytest.raises(ValueError, match="padded slots"):
        if party == "client":
            client.audit(seed=bytes(range(16)))
        else:
            server.audit(bytes(range(16)))
    assert not sent


@pytest.mark.parametrize("scheme", ["ipa", "kzg"])
def test_ops_build_no_fixed_base_table(request, monkeypatch, scheme):
    """Every K4 table is built by its owner at construction or initialize:
    n updates, which form every level (the folds into levels 0 to
    height - 2 and the epoch's CRebuild of the top level), and an audit
    then build no table and look none up. In one process the IPA client's
    key and the server's hold one generators' table, the server's commit
    table."""
    client, server = request.getfixturevalue(
        "pair" if scheme == "ipa" else "kzg_pair")
    if scheme == "ipa":
        assert client.ipa_key.table is server.ipa_key.table
        assert server.commit_table is server.ipa_key.table
    else:
        assert server.commit_table is server.srs.table
    calls = []
    monkeypatch.setattr(cuda_curve, "build_fb_table",
                        lambda *a, **k: calls.append("build"))
    monkeypatch.setattr(cuda_curve, "fixed_base_table",
                        lambda *a, **k: calls.append("lookup"))
    n, formed = client.num_blocks, set()
    for _ in range(n):
        ws = client.write_step + 1
        formed.add((ws & -ws).bit_length() - 1 if ws % n
                   else server.height - 1)
        client.update(client.write_step % n + 1)
    assert formed == set(range(server.height))
    client.audit(seed=bytes(range(5, 21)))
    assert calls == []
