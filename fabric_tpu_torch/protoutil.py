"""A protobuf wire-format writer for a Fabric transaction's envelope chain.

The port's counterpart of the envelope assembly in
fabric_tpu/protoutil/txutils.py (`create_proposal`,
`create_proposal_response`, `create_signed_tx`), for hosts without the
`protobuf` package: each function returns the bytes that protobuf's
`SerializeToString` writes for the message of the same name in
fabric_tpu/protos/*.proto (proto3: known fields in field-number order,
fields at their default value left out, each element of a repeated field
under its own tag, a negative int32 as a ten-byte varint). Message-typed
arguments are the embedded message's own bytes. It writes and never
parses: parsing a block is csrc/blockprep.cpp's (`native.block_prep`).

`endorser_tx_payload` assembles an ENDORSER_TRANSACTION payload as
`create_signed_tx` does; the caller signs it and wraps it in `envelope`.
tests/test_torch_fastvalidate.py holds every function to protobuf.
"""

from __future__ import annotations

import hashlib
from typing import Iterable

# common.HeaderType
ENDORSER_TRANSACTION = 3
# peer.ChaincodeSpec.Type
PYTHON = 4
# common.Status
SUCCESS = 200

_VARINT, _LEN = 0, 2


def _varint(v: int) -> bytes:
    """Base-128 varint of an unsigned 64-bit value (negative values are
    taken mod 2^64, as protobuf writes int32 and int64)."""
    v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int(field: int, v: int) -> bytes:
    return _tag(field, _VARINT) + _varint(v) if v else b""


def _bytes(field: int, v) -> bytes:
    if isinstance(v, str):
        v = v.encode()
    return _tag(field, _LEN) + _varint(len(v)) + v if v else b""


def _repeated(field: int, values: Iterable[bytes]) -> bytes:
    # a repeated field writes every element, empty ones too
    return b"".join(_tag(field, _LEN) + _varint(len(v)) + v
                    for v in values)


def _message(field: int, v) -> bytes:
    # a set message field is written even when empty; None is unset
    return b"" if v is None else _tag(field, _LEN) + _varint(len(v)) + v


# -- common.proto --

def envelope(payload: bytes, signature: bytes = b"") -> bytes:
    return _bytes(1, payload) + _bytes(2, signature)


def payload(header: bytes | None, data: bytes = b"") -> bytes:
    """`header` is a Header message's bytes."""
    return _message(1, header) + _bytes(2, data)


def header(channel_header: bytes, signature_header: bytes) -> bytes:
    return _bytes(1, channel_header) + _bytes(2, signature_header)


def channel_header(type: int, channel_id: str, tx_id: str = "",
                   timestamp: int = 0, version: int = 0, epoch: int = 0,
                   extension: bytes = b"",
                   tls_cert_hash: bytes = b"") -> bytes:
    return (_int(1, type) + _int(2, version) + _int(3, timestamp)
            + _bytes(4, channel_id) + _bytes(5, tx_id) + _int(6, epoch)
            + _bytes(7, extension) + _bytes(8, tls_cert_hash))


def signature_header(creator: bytes, nonce: bytes) -> bytes:
    return _bytes(1, creator) + _bytes(2, nonce)


# -- msp.proto --

def serialized_identity(mspid: str, id_bytes: bytes) -> bytes:
    return _bytes(1, mspid) + _bytes(2, id_bytes)


# -- transaction.proto --

def transaction(actions: Iterable[bytes]) -> bytes:
    """`actions`: TransactionAction messages' bytes."""
    return _repeated(1, actions)


def transaction_action(header: bytes, payload: bytes) -> bytes:
    """`header`: the proposal's SignatureHeader bytes; `payload`: a
    ChaincodeActionPayload's bytes."""
    return _bytes(1, header) + _bytes(2, payload)


def chaincode_action_payload(chaincode_proposal_payload: bytes,
                             action: bytes | None) -> bytes:
    """`action`: a ChaincodeEndorsedAction message's bytes."""
    return _bytes(1, chaincode_proposal_payload) + _message(2, action)


def chaincode_endorsed_action(proposal_response_payload: bytes,
                              endorsements: Iterable[bytes]) -> bytes:
    """`endorsements`: Endorsement messages' bytes."""
    return _bytes(1, proposal_response_payload) + _repeated(2,
                                                            endorsements)


# -- proposal.proto --

def chaincode_id(name: str, version: str = "", path: str = "") -> bytes:
    return _bytes(1, name) + _bytes(2, version) + _bytes(3, path)


def chaincode_invocation_spec(name: str, args: Iterable[bytes],
                              type: int = PYTHON) -> bytes:
    """ChaincodeInvocationSpec{ChaincodeSpec{type, chaincode_id, input:
    ChaincodeInput{args}}}."""
    spec = (_int(1, type) + _message(2, chaincode_id(name))
            + _message(3, _repeated(1, args)))
    return _message(1, spec)


def chaincode_header_extension(name: str) -> bytes:
    return _message(1, chaincode_id(name))


def chaincode_proposal_payload(input: bytes) -> bytes:
    """`input`: a ChaincodeInvocationSpec's bytes (no transient map: the
    committed payload never carries one)."""
    return _bytes(1, input)


def response(status: int, message: str = "", payload: bytes = b"") -> bytes:
    return _int(1, status) + _bytes(2, message) + _bytes(3, payload)


def chaincode_action(results: bytes, events: bytes = b"",
                     response: bytes | None = None,
                     chaincode_id: bytes | None = None) -> bytes:
    """`response` and `chaincode_id`: the embedded messages' bytes."""
    return (_bytes(1, results) + _bytes(2, events) + _message(3, response)
            + _message(4, chaincode_id))


def proposal_response_payload(proposal_hash: bytes,
                              extension: bytes) -> bytes:
    """`extension`: a ChaincodeAction's bytes."""
    return _bytes(1, proposal_hash) + _bytes(2, extension)


def endorsement(endorser: bytes, signature: bytes) -> bytes:
    return _bytes(1, endorser) + _bytes(2, signature)


# -- rwset.proto (a ChaincodeAction's results) --

def version(block_num: int, tx_num: int) -> bytes:
    return _int(1, block_num) + _int(2, tx_num)


def kv_read(key: str, version: bytes | None = None) -> bytes:
    return _bytes(1, key) + _message(2, version)


def kv_write(key: str, value: bytes = b"", is_delete: bool = False) -> bytes:
    return _bytes(1, key) + _int(2, int(is_delete)) + _bytes(3, value)


def kv_rwset(reads: Iterable[bytes] = (),
             writes: Iterable[bytes] = ()) -> bytes:
    """KVRWSet with reads and writes (no range queries, no metadata
    writes)."""
    return _repeated(1, reads) + _repeated(3, writes)


def ns_rwset(namespace: str, rwset: bytes) -> bytes:
    return _bytes(1, namespace) + _bytes(2, rwset)


def tx_rwset(ns_rwsets: Iterable[bytes]) -> bytes:
    """TxReadWriteSet in the KV data model (0, left out)."""
    return _repeated(2, ns_rwsets)


# -- assembly --

def compute_tx_id(nonce: bytes, creator: bytes) -> str:
    """hex(sha256(nonce || creator)), the binding every validator checks
    (fabric_tpu/protoutil/protoutil.py `compute_tx_id`)."""
    return hashlib.sha256(nonce + creator).hexdigest()


def endorser_tx_payload(channel_id: str, creator: bytes, nonce: bytes,
                        cc_input: bytes, prp: bytes,
                        endorsements: Iterable[bytes],
                        timestamp: int = 0, extension: bytes = b"") -> bytes:
    """The Payload of an ENDORSER_TRANSACTION envelope, assembled as
    `create_signed_tx` assembles it: the proposal's channel and signature
    headers, and one TransactionAction whose ChaincodeActionPayload holds
    the committed proposal payload (`cc_input`, a
    ChaincodeInvocationSpec) and the endorsed action (`prp`, the
    ProposalResponsePayload every endorser signed, with `endorsements`);
    `extension` is the channel header's (a ChaincodeHeaderExtension's
    bytes). The creator signs the returned bytes."""
    sh = signature_header(creator, nonce)
    ch = channel_header(ENDORSER_TRANSACTION, channel_id,
                        tx_id=compute_tx_id(nonce, creator),
                        timestamp=timestamp, extension=extension)
    cap = chaincode_action_payload(
        chaincode_proposal_payload(cc_input),
        chaincode_endorsed_action(prp, endorsements))
    return payload(header(ch, sh),
                   transaction([transaction_action(sh, cap)]))
