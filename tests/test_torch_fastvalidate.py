"""fabric_tpu_torch's block fast path against the JAX package's.

Blocks are built as tests/test_fastvalidate.py builds them (cryptogen,
two org peers and a gateway), plus txs edited to reach the lane
assembly's corners (an undeserializable endorser, a repeated endorser,
an Ed25519 endorser, more than MAX_E endorsements, an unknown field), and
the chip smoke's envelope block written by fabric_tpu_torch/protoutil.py
with its self-signed identities. Held, exactly:

  (a) the port's `native.block_prep` (csrc/blockprep.cpp) to
      fabric_tpu.native.block_prep, every array;
  (b) protoutil.py's bytes to protobuf's SerializeToString;
  (c) the lanes `core.fastvalidate.signature_phase` hands to
      `verify_prepared_start` to those fabric_tpu's `validate_fast` hands
      to a recording wrapper around its provider;
  (d) the flags from the port's CPU provider (plain versions, q8) to the
      reference's creator and endorsement bits and to the port's sw
      provider, lane by lane;
  (e) `msp.identity`'s three outcomes to the JAX MSP's.

The JAX provider runs with MinBatch 1 << 20, so it verifies on its sw
path and nothing is jitted; the port's provider finds its key set's 8-bit
Q table cached (Python ints, as tests/test_torch_provider.py does).
"""

import copy
import functools
import os
import random

import numpy as np
import pytest
import torch
from cryptography import x509
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ed25519
from cryptography.x509.oid import NameOID

from fabric_tpu import native as jnative
from fabric_tpu.bccsp import factory as jfactory
from fabric_tpu.bccsp.sw import SWProvider as JSWProvider
from fabric_tpu.core import fastvalidate as jfast, statebased
from fabric_tpu.core.chaincode import Chaincode, ChaincodeDefinition, shim
from fabric_tpu.core.txvalidator import TxValidator
from fabric_tpu.internal import cryptogen
from fabric_tpu.internal.configtxgen import genesis_block, new_channel_group
from fabric_tpu.msp import msp_config_from_dir
from fabric_tpu.msp.mspimpl import X509MSP
from fabric_tpu.peer import Peer
from fabric_tpu.peer.gateway import Gateway
from fabric_tpu.protos import common as cpb, msp as msppb
from fabric_tpu.protos import proposal as pb, rwset as rwpb
from fabric_tpu.protos import transaction as txpb
from fabric_tpu.protoutil import protoutil as pu

import chip_smoke
from fabric_tpu_torch import native, protoutil
from fabric_tpu_torch.bccsp import factory, sw
from fabric_tpu_torch.core import fastvalidate
from fabric_tpu_torch.msp import identity
from tests.test_torch_comb import _q8_ints

CHANNEL = "fastchannel"
MSPIDS = ("Org1MSP", "Org2MSP")
LANES = ("digests", "r", "rpn", "w", "der_ok", "key_idx")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class KV(Chaincode):
    def init(self, stub):
        return shim.success()

    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        stub.put_state(params[0], params[1].encode())
        return shim.success()


def _ed25519_identity(mspid: str) -> bytes:
    """A SerializedIdentity on a self-signed Ed25519 certificate."""
    key = ed25519.Ed25519PrivateKey.generate()
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "ed.org1.example.com")])
    import datetime
    now = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key()).serial_number(7)
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=3650))
            .sign(key, None))
    return msppb.SerializedIdentity(
        mspid=mspid, id_bytes=cert.public_bytes(serialization.Encoding.PEM)
    ).SerializeToString()


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """Two orgs' peers on one channel, a gateway over Org1's user, and
    make_block(ntxs, num)."""
    root = tmp_path_factory.mktemp("torchfast")
    cdir = str(root / "crypto")
    org1 = cryptogen.generate_org(cdir, "org1.example.com", n_peers=1,
                                  n_users=1)
    org2 = cryptogen.generate_org(cdir, "org2.example.com", n_peers=1,
                                  n_users=1)
    jsw = JSWProvider()
    profile = {
        "Consortium": "SampleConsortium",
        "Capabilities": {"V2_0": True},
        "Application": {
            "Organizations": [
                {"Name": "Org1", "ID": "Org1MSP",
                 "MSPDir": os.path.join(org1, "msp")},
                {"Name": "Org2", "ID": "Org2MSP",
                 "MSPDir": os.path.join(org2, "msp")},
            ],
            "Capabilities": {"V2_0": True},
        },
        "Orderer": {
            "OrdererType": "solo", "Addresses": ["orderer0:7050"],
            "BatchTimeout": "1s",
            "BatchSize": {"MaxMessageCount": 512,
                          "PreferredMaxBytes": 1 << 30,
                          "AbsoluteMaxBytes": 1 << 30},
            "Organizations": [], "Capabilities": {"V2_0": True},
        },
    }
    genesis = genesis_block(CHANNEL, new_channel_group(profile))

    def local_msp(msp_dir, mspid):
        m = X509MSP(jsw)
        m.setup(msp_config_from_dir(msp_dir, mspid, csp=jsw))
        return m

    peers = {}
    for org_name, org_dir, mspid in (("org1", org1, "Org1MSP"),
                                     ("org2", org2, "Org2MSP")):
        msp = local_msp(os.path.join(
            org_dir, "peers", f"peer0.{org_name}.example.com", "msp"), mspid)
        p = Peer(str(root / f"peer_{org_name}"), msp, jsw)
        p.join_channel(genesis)
        p.chaincode_support.register("fastcc", KV())
        p.channel(CHANNEL).define_chaincode(
            ChaincodeDefinition(name="fastcc"))
        peers[org_name] = p
    user = local_msp(os.path.join(
        org1, "users", "User1@org1.example.com", "msp"), "Org1MSP")
    gw = Gateway(peers["org1"], None, user.get_default_signing_identity())

    def make_block(ntxs: int, num: int) -> cpb.Block:
        block = pu.new_block(num, b"\x00" * 32)
        for i in range(ntxs):
            env = gw.endorse(CHANNEL, "fastcc", [
                b"put", f"k{num}_{i}".encode(), f"v{i}".encode()],
                endorsing_peers=list(peers.values()))[0]
            block.data.data.append(pu.marshal(env))
        block.header.data_hash = pu.block_data_hash(block.data)
        while len(block.metadata.metadata) <= \
                cpb.BlockMetadataIndex.TRANSACTIONS_FILTER:
            block.metadata.metadata.append(b"")
        return block

    return peers, make_block


def _edit_endorsements(env_bytes: bytes, edit) -> bytes:
    """The envelope with its endorsements list passed through `edit`
    (the creator's signature no longer covers the payload)."""
    env = pu.unmarshal_envelope(env_bytes)
    pay = pu.get_payload(env)
    tx = txpb.Transaction()
    tx.ParseFromString(pay.data)
    cap = txpb.ChaincodeActionPayload()
    cap.ParseFromString(tx.actions[0].payload)
    ends = [copy.deepcopy(e) for e in cap.action.endorsements]
    del cap.action.endorsements[:]
    cap.action.endorsements.extend(edit(ends))
    tx.actions[0].payload = cap.SerializeToString()
    pay.data = tx.SerializeToString()
    env.payload = pu.marshal(pay)
    return pu.marshal(env)


@pytest.fixture(scope="module")
def blocks(net):
    """{name: (envs, channel)}: the cases of (a), (c) and (d)."""
    _, make_block = net
    ed_ident = _ed25519_identity("Org1MSP")
    valid = make_block(16, 1)

    special = make_block(12, 2)
    d = special.data.data

    def with_endorser(j, ident):
        def edit(ends):
            ends[j].endorser = ident
            return ends
        return edit

    d[1] = _edit_endorsements(d[1], with_endorser(0, b"\x0a\x03bad"))
    d[2] = _edit_endorsements(d[2], lambda ends: ends + [ends[0]])
    d[3] = _edit_endorsements(d[3], with_endorser(1, ed_ident))
    d[4] = _edit_endorsements(d[4], lambda ends: ends * 5)      # > MAX_E
    d[5] = d[5] + b"\x38\x01"                     # unknown field 7
    d[6] = _edit_endorsements(d[6], with_endorser(
        0, msppb.SerializedIdentity(mspid="NoSuchMSP",
                                    id_bytes=b"x").SerializeToString()))
    env = pu.unmarshal_envelope(d[7])             # a bad creator signature
    d[7] = cpb.Envelope(payload=env.payload,
                        signature=b"\x30\x06\x02\x01\x01\x02\x01\x01"
                        ).SerializeToString()
    d[8] = _edit_endorsements(d[8], lambda ends: [ends[1], ends[0]])

    tampered = make_block(10, 3)
    d = tampered.data.data
    d[4] = d[2]                                   # duplicate txid
    d[6] = b"\xff\xff\xff"
    d[7] = d[7][:40]
    d[9] = b""

    base = make_block(8, 4)
    rng = random.Random(42)
    sweep = []
    for _ in range(24):
        envs = list(base.data.data)
        for _ in range(3):
            ti = rng.randrange(len(envs))
            raw = bytearray(envs[ti])
            op = rng.random()
            if op < 0.4:
                raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
            elif op < 0.7:
                del raw[rng.randrange(len(raw))]
            else:
                raw.insert(rng.randrange(len(raw)), rng.randrange(256))
            envs[ti] = bytes(raw)
        sweep.extend(envs)
    env_blk = chip_smoke.make_envelope_block(7, 40, None, 1)
    return {"valid": (list(valid.data.data), CHANNEL),
            "special": (list(special.data.data), CHANNEL),
            "tampered": (list(tampered.data.data), CHANNEL),
            "mutation_sweep": (sweep, CHANNEL),
            "wrong_channel": (list(valid.data.data), "otherchannel"),
            "envelope_block": (env_blk["envs"], chip_smoke.ENV_CHANNEL),
            "ed_ident": ed_ident}


# -- (a) the native block prep --

@pytest.mark.parametrize("case", ["valid", "special", "tampered",
                                  "mutation_sweep", "wrong_channel",
                                  "envelope_block"])
def test_block_prep_matches_jax(blocks, case):
    envs, channel = blocks[case]
    mine = native.block_prep(envs, channel, fastvalidate.MAX_E)
    ref = jnative.block_prep(envs, channel, fastvalidate.MAX_E)
    assert mine.n_unique == ref.n_unique
    for name in jnative.BlockPrep.__slots__:
        if name in ("envs", "n_unique"):
            continue
        a, b = getattr(mine, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case == "special":
        assert mine.status[4] == native.BP_NEEDS_PYTHON       # > MAX_E
        assert mine.status[5] == native.BP_NEEDS_PYTHON       # unknown
    if case == "wrong_channel":
        assert (mine.status == native.BP_FAIL_BASE
                + chip_smoke.BAD_CHANNEL_HEADER).all()
    for name in ("BP_OK_ENDORSER", "BP_OK_CONFIG", "BP_NEEDS_PYTHON",
                 "BP_FAIL_BASE", "RW_PLAIN", "RW_RICH", "RW_UNPARSED",
                 "MAX_K"):
        assert getattr(native, name) == getattr(jnative, name), name


def test_block_prep_refuses_bad_arguments():
    with pytest.raises(RuntimeError, match="refused"):
        native.block_prep([b""], CHANNEL, max_e=0)


# -- (b) the wire writer --

def _chain_both():
    """(protoutil's bytes, protobuf's bytes) for one endorser tx's
    envelope chain, built both ways from the same fields."""
    nonce, creator = b"\x01" * 24, protoutil.serialized_identity(
        "Org1MSP", b"-----BEGIN CERTIFICATE-----\nAA==\n")
    args = [b"transfer", b"a", b"", b"7"]
    results = protoutil.tx_rwset([protoutil.ns_rwset("cc", protoutil.kv_rwset(
        reads=[protoutil.kv_read("a", protoutil.version(3, 0)),
               protoutil.kv_read("b")],
        writes=[protoutil.kv_write("a", b"1"),
                protoutil.kv_write("b", b"", is_delete=True)]))])
    action = protoutil.chaincode_action(
        results, b"ev", protoutil.response(200, "ok", b"p"),
        protoutil.chaincode_id("cc", "1.0", "path"))
    prp = protoutil.proposal_response_payload(b"\x02" * 32, action)
    ends = [protoutil.endorsement(b"e1", b"s1"),
            protoutil.endorsement(b"e2", b"")]
    mine = protoutil.envelope(protoutil.endorser_tx_payload(
        CHANNEL, creator, nonce, protoutil.chaincode_invocation_spec(
            "cc", args), prp, ends, timestamp=123456789,
        extension=protoutil.chaincode_header_extension("cc")), b"sig")

    sid = msppb.SerializedIdentity(
        mspid="Org1MSP", id_bytes=b"-----BEGIN CERTIFICATE-----\nAA==\n")
    assert sid.SerializeToString() == creator
    kv = rwpb.KVRWSet()
    kv.reads.add(key="a").version.CopyFrom(rwpb.Version(block_num=3))
    kv.reads.add(key="b")
    kv.writes.add(key="a", value=b"1")
    kv.writes.add(key="b", is_delete=True)
    txrw = rwpb.TxReadWriteSet()
    txrw.ns_rwset.add(namespace="cc", rwset=kv.SerializeToString())
    act = pb.ChaincodeAction(results=txrw.SerializeToString(), events=b"ev")
    act.response.CopyFrom(pb.Response(status=200, message="ok", payload=b"p"))
    act.chaincode_id.CopyFrom(pb.ChaincodeID(name="cc", version="1.0",
                                             path="path"))
    prp_pb = pb.ProposalResponsePayload(proposal_hash=b"\x02" * 32,
                                        extension=act.SerializeToString())
    spec = pb.ChaincodeInvocationSpec()
    spec.chaincode_spec.type = pb.ChaincodeSpec.PYTHON
    spec.chaincode_spec.chaincode_id.name = "cc"
    spec.chaincode_spec.input.args.extend(args)
    ext = pb.ChaincodeHeaderExtension()
    ext.chaincode_id.name = "cc"
    ch = pu.make_channel_header(cpb.HeaderType.ENDORSER_TRANSACTION, CHANNEL,
                                tx_id=pu.compute_tx_id(nonce, creator),
                                extension=ext.SerializeToString())
    ch.timestamp = 123456789
    sh = pu.create_signature_header(creator, nonce)
    hdr = cpb.Header(channel_header=ch.SerializeToString(),
                     signature_header=sh.SerializeToString())
    cap = txpb.ChaincodeActionPayload(
        chaincode_proposal_payload=pb.ChaincodeProposalPayload(
            input=spec.SerializeToString()).SerializeToString())
    cap.action.proposal_response_payload = prp_pb.SerializeToString()
    cap.action.endorsements.add(endorser=b"e1", signature=b"s1")
    cap.action.endorsements.add(endorser=b"e2")
    tx = txpb.Transaction()
    tx.actions.add(header=hdr.signature_header,
                   payload=cap.SerializeToString())
    payload = cpb.Payload(data=tx.SerializeToString())
    payload.header.CopyFrom(hdr)
    ref = cpb.Envelope(payload=payload.SerializeToString(), signature=b"sig")
    return mine, ref.SerializeToString()


@pytest.mark.parametrize("case", ["envelope_chain", "negative_ints",
                                  "empty_messages"])
def test_protoutil_matches_protobuf(case):
    if case == "envelope_chain":
        mine, ref = _chain_both()
    elif case == "negative_ints":
        mine = protoutil.channel_header(-3, "c", version=-1,
                                        timestamp=-(1 << 40), epoch=1 << 63)
        ref = cpb.ChannelHeader(type=-3, version=-1, timestamp=-(1 << 40),
                                channel_id="c", epoch=1 << 63
                                ).SerializeToString()
    else:
        mine = (protoutil.payload(b"")
                + protoutil.chaincode_action_payload(b"", b"")
                + protoutil.transaction([b"", b""])
                + protoutil.chaincode_endorsed_action(b"", [b""]))
        p = cpb.Payload()
        p.header.SetInParent()
        c = txpb.ChaincodeActionPayload()
        c.action.SetInParent()
        t = txpb.Transaction()
        t.actions.add()
        t.actions.add()
        e = txpb.ChaincodeEndorsedAction()
        e.endorsements.add()
        ref = b"".join(m.SerializeToString() for m in (p, c, t, e))
    assert mine == ref


# -- (c) and (d) the lanes and the flags --

class _Recording:
    """The JAX provider with `verify_prepared_start`'s arguments and its
    resolver's flags recorded."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def verify_prepared_start(self, digests, r, rpn, w, der_ok, key_idx,
                              keys, get_sig):
        call = dict(digests=np.array(digests), r=np.array(r),
                    rpn=np.array(rpn), w=np.array(w),
                    der_ok=np.array(der_ok), key_idx=np.array(key_idx),
                    keys=list(keys), get_sig=get_sig)
        self.calls.append(call)
        resolve = self._inner.verify_prepared_start(
            digests, r, rpn, w, der_ok, key_idx, keys, get_sig)

        def recorded():
            call["flags"] = list(resolve())
            return call["flags"]
        return recorded


def _reference_call(net, envs):
    """fabric_tpu's validate_fast over `envs` on the channel's ledger
    (called directly: TxValidator.validate would hide a failure behind
    its reference path): its recorded dispatch."""
    peers, _ = net
    ch = peers["org1"].channel(CHANNEL)
    rec = _Recording(jfactory.new_bccsp(jfactory.FactoryOpts.from_config(
        {"Default": "TPU", "TPU": {"MinBatch": 1 << 20}})))
    v = TxValidator(
        CHANNEL, ch.ledger, ch.validator._bundle_source, rec,
        cc_definition=ch.validator._cc_definition,
        configtx_validator_source=ch.validator._configtx_validator_source)
    block = pu.new_block(99, b"\x00" * 32)
    block.data.data.extend(envs)
    v._overlay = statebased.BlockOverlay()
    v._known_txids = frozenset()
    assert jfast.validate_fast(v, block, v._bundle_source()) is not None
    assert len(rec.calls) == 1, "validate_fast made no dispatch"
    return rec.calls[0]


class _NoCard:
    """A provider stand-in that records the lanes and verifies nothing."""

    def verify_prepared_start(self, **lanes):
        self.lanes = lanes
        return lambda: [False] * len(lanes["der_ok"])


# the channel's MSPs, as the reference's MSP manager knows them
_RESOLVE = functools.partial(identity.resolve, mspids=MSPIDS)


@pytest.mark.parametrize("case", ["valid", "special"])
def test_lanes_match_validate_fast(net, blocks, case):
    envs, channel = blocks[case]
    ref = _reference_call(net, envs)
    csp = _NoCard()
    ph = fastvalidate.signature_phase(envs, channel, csp, _RESOLVE)
    for name in LANES:
        np.testing.assert_array_equal(
            np.asarray(csp.lanes[name]), np.asarray(ref[name]), err_msg=name)
        assert np.asarray(csp.lanes[name]).dtype == \
            np.asarray(ref[name]).dtype, name
    assert len(csp.lanes["keys"]) == len(ref["keys"])
    for mine, theirs in zip(csp.lanes["keys"], ref["keys"]):
        assert (mine is None) == (theirs is None)
        if isinstance(mine, sw.ECDSAPublicKey):
            pn = theirs.raw.public_numbers()
            assert (mine.x, mine.y) == (pn.x, pn.y)
        elif mine is not None:
            assert mine.bytes() == theirs.bytes()
    for lane in range(len(csp.lanes["der_ok"])):
        assert csp.lanes["get_sig"](lane) == ref["get_sig"](lane)
    if case == "special":
        # tx 3's Ed25519 endorser reroutes it, as do the two txs the
        # native parse hands to the per-tx path
        assert np.nonzero(ph.reroute)[0].tolist() == [3, 4, 5]
        assert ph.ej[ph.ei == 2].tolist() == [0, 1]     # the repeat dropped
        assert ph.ej[ph.ei == 1].tolist() == [1]        # bad identity
        assert ph.ej[ph.ei == 6].tolist() == [1]        # unknown MSP


@pytest.fixture(scope="module")
def cpu_provider(blocks):
    """The port's CUDA provider on the CPU with the fixture's key set's
    8-bit Q table cached."""
    envs, channel = blocks["special"]
    bp = native.block_prep(envs, channel, fastvalidate.MAX_E)
    pubs = []
    for uid in range(bp.n_unique):
        try:
            key = identity.resolve(bp.unique_identity(uid), MSPIDS).key
        except ValueError:
            continue
        if isinstance(key, sw.ECDSAPublicKey):
            pubs.append(key)
    order = sorted({p.x_bytes().tobytes() + p.y_bytes().tobytes()
                    for p in pubs})
    keys = [(int.from_bytes(kb[:32], "big"), int.from_bytes(kb[32:], "big"))
            for kb in order]
    keys += keys[:1] * (4 - len(keys))
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, "UseG16": False}})
    prov._q8_cache[tuple(order)] = torch.as_tensor(_q8_ints(keys))
    return prov


def test_flags_match_reference_and_sw(net, blocks, cpu_provider):
    envs, channel = blocks["special"]
    ref = _reference_call(net, envs)
    ph = fastvalidate.signature_phase(envs, channel, cpu_provider, _RESOLVE)
    creator, e_flag = ph.resolve()
    assert cpu_provider.stats["comb_batches"] >= 1
    flags = np.concatenate([creator[ph.ci], e_flag[ph.ei, ph.ej]])
    assert len(flags) <= 256
    np.testing.assert_array_equal(flags, np.asarray(ref["flags"], bool))
    # every flag, by tx and slot, is the reference's bit at its lane
    nc = len(ph.ci)
    want_c = np.zeros(len(envs), bool)
    want_c[ph.ci] = np.asarray(ref["flags"][:nc], bool)
    want_e = np.zeros_like(e_flag)
    want_e[ph.ei, ph.ej] = np.asarray(ref["flags"][nc:], bool)
    np.testing.assert_array_equal(creator, want_c)
    np.testing.assert_array_equal(e_flag, want_e)
    # and sw's verdict on each lane
    swp = sw.SWProvider()
    sigs = chip_smoke.envelope_lane_sigs(ph, envs)
    for lane, got in enumerate(flags.tolist()):
        key = ph.idents[int(ph.lanes["key_idx"][lane])].key
        sig, digest = sigs[lane], bytes(ph.lanes["digests"][lane])
        try:
            want = swp.verify(key, sig, digest)
        except TypeError:
            want = False
        assert got == want, lane
    # the bad creator signature and the repeated endorser's first slot
    assert not creator[7] and e_flag[2, 0] and e_flag[0].sum() == 2


# -- (e) identities --

@pytest.mark.parametrize("case", ["org1_user", "org1_peer", "org2_peer",
                                  "ed25519", "garbage", "unknown_msp",
                                  "no_pem", "smoke_identity"])
def test_identity_outcomes_match_msp(net, blocks, case):
    envs, _ = blocks["valid"]
    bp = jnative.block_prep(envs, CHANNEL, fastvalidate.MAX_E)
    by_cn = {}
    for uid in range(bp.n_unique):
        raw = bp.unique_identity(uid)
        sid = msppb.SerializedIdentity()
        sid.ParseFromString(raw)
        subject = x509.load_pem_x509_certificate(sid.id_bytes).subject
        cn = subject.get_attributes_for_oid(NameOID.COMMON_NAME)[0].value
        by_cn[cn] = raw
    pem_of = next(iter(by_cn.values()))
    raw = {
        "org1_user": by_cn.get("User1@org1.example.com"),
        "org1_peer": by_cn.get("peer0.org1.example.com"),
        "org2_peer": by_cn.get("peer0.org2.example.com"),
        "ed25519": blocks["ed_ident"],
        "garbage": b"\xff\xff\x01",
        "unknown_msp": pem_of.replace(b"Org", b"Orx", 1),
        "no_pem": msppb.SerializedIdentity(
            mspid="Org1MSP", id_bytes=b"not a certificate"
        ).SerializeToString(),
        "smoke_identity": protoutil.serialized_identity(
            "Org2MSP", chip_smoke.pem_cert(chip_smoke.x509_der(
                12345, "peer9.org2.example.com", 4242))),
    }[case]
    assert raw is not None, case
    peers, _ = net
    mgr = peers["org1"].channel(CHANNEL).validator._bundle_source(
        ).msp_manager
    try:
        ref = mgr.deserialize_identity(raw)
    except Exception:               # noqa: BLE001
        ref_outcome = "undeserializable"
    else:
        key = getattr(ref, "key", None)
        ref_outcome = ("unstageable" if key is None
                       or getattr(key, "sign_message", False)
                       else "stageable")
    try:
        mine = identity.resolve(raw, MSPIDS)
    except ValueError:
        outcome = "undeserializable"
    else:
        outcome = "stageable" if identity.stageable(mine) else "unstageable"
    assert outcome == ref_outcome
    assert outcome == {"ed25519": "unstageable", "garbage": "undeserializable",
                       "unknown_msp": "undeserializable",
                       "no_pem": "undeserializable"}.get(case, "stageable")
    if outcome == "stageable":
        pn = ref.key.raw.public_numbers()
        assert (mine.key.x, mine.key.y) == (pn.x, pn.y)
    if case == "ed25519":
        assert mine.key.bytes() == ref.key.bytes()


def test_default_resolver_takes_any_msp(blocks):
    """No resolver takes any MSP id: `resolve` and `signature_phase` have
    no default that would, and the channel's resolver takes the block's
    three org MSP ids and refuses another's."""
    envs, _ = blocks["envelope_block"]
    bp = native.block_prep(envs, chip_smoke.ENV_CHANNEL, fastvalidate.MAX_E)
    with pytest.raises(TypeError):
        identity.resolve(bp.unique_identity(0))
    with pytest.raises(TypeError):
        fastvalidate.signature_phase(envs, chip_smoke.ENV_CHANNEL, _NoCard())
    channel = functools.partial(identity.resolve,
                                mspids=chip_smoke.ENV_MSPIDS)
    mspids = {channel(bp.unique_identity(uid)).mspid
              for uid in range(bp.n_unique)}
    assert mspids == set(chip_smoke.ENV_MSPIDS)
    with pytest.raises(ValueError, match="no MSP"):
        identity.resolve(bp.unique_identity(0), mspids=("OtherMSP",))
