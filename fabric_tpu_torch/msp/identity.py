"""A serialized identity's verify key, without an MSP and without
`cryptography`.

The port's counterpart of the part of fabric_tpu's X.509 MSP that the
peer's block fast path asks of an identity before it stages signature
lanes (fabric_tpu/core/fastvalidate.py 99-113 and 151-165,
`X509MSP.deserialize_identity`): the `SerializedIdentity` (field 1
`mspid`, field 2 `id_bytes`) is read, its first PEM certificate decoded
and the certificate's `subjectPublicKeyInfo` turned into a key. One of
the reference's three outcomes follows:

  * a stageable key: an ECDSA key on P-256 (`p256_host.decode_spki`) or
    on P-224, P-384 or P-521 (`ec_host.decode_spki`), whose signature
    lanes the provider takes as digest lanes;
  * a live identity without a stageable key: an Ed25519 certificate key
    (the scheme signs the message, not a digest), or an identity a
    caller's own resolver returns with `key` None or a message-signing
    key (an idemix pseudonym, say); its txs reroute to the per-tx path;
  * not deserializable: `resolve` raises ValueError, and the identity's
    lanes are dropped.

No chain, validity period, extension or certificate signature is
checked here: identity validation (`ident.validate()`) is the MSP's, and
waits with the rest of the policy phase. A certificate key the port's
hosts cannot decode (RSA, a compressed EC point, another curve) is not
deserializable here, where an MSP on `cryptography` would take some of
them. A caller holding an MSP passes its own `deserialize_identity` as
`signature_phase`'s resolver instead.
"""

from __future__ import annotations

import base64
import binascii
import re
from typing import Iterable

from fabric_tpu_torch.bccsp import ec_host, p256_host, sw

_PEM_RE = re.compile(
    rb"-----BEGIN CERTIFICATE-----\s*(.*?)\s*-----END CERTIFICATE-----",
    re.DOTALL)
# SubjectPublicKeyInfo of an Ed25519 key (RFC 8410): the algorithm
# 1.3.101.112 and a 32-byte BIT STRING
_ED25519_SPKI_PREFIX = bytes.fromhex("302a300506032b6570032100")


class Identity:
    """A deserialized identity: its MSP id, its certificate's DER and its
    verify key (sw.ECDSAPublicKey or sw.Ed25519PublicKey)."""

    __slots__ = ("mspid", "cert_der", "key")

    def __init__(self, mspid: str, cert_der: bytes, key):
        self.mspid, self.cert_der, self.key = mspid, cert_der, key


# -- minimal readers: protobuf wire format and DER --

def _varint(buf: bytes, off: int) -> tuple[int, int]:
    v, shift = 0, 0
    while True:
        if off >= len(buf) or shift > 63:
            raise ValueError("protobuf: truncated varint")
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7


def _serialized_identity(raw: bytes) -> tuple[str, bytes]:
    """(mspid, id_bytes) of a msp.SerializedIdentity, read as protobuf
    reads proto3: unknown fields skipped, the last occurrence of a field
    kept, a known field of another wire type kept as unknown; ValueError
    where protobuf's parse fails (a truncated field, a group, mspid not
    UTF-8)."""
    mspid, id_bytes = b"", b""
    off = 0
    while off < len(raw):
        tag, off = _varint(raw, off)
        field, wire = tag >> 3, tag & 7
        if field == 0:
            raise ValueError("protobuf: field number 0")
        if wire == 0:
            _, off = _varint(raw, off)
        elif wire == 1 or wire == 5:
            off += 8 if wire == 1 else 4
        elif wire == 2:
            n, off = _varint(raw, off)
            value, off = raw[off:off + n], off + n
            if field == 1:
                mspid = value
            elif field == 2:
                id_bytes = value
        else:
            raise ValueError(f"protobuf: wire type {wire}")
        if off > len(raw):
            raise ValueError("protobuf: truncated field")
    try:
        return mspid.decode("utf-8"), id_bytes
    except UnicodeDecodeError as e:
        raise ValueError("protobuf: mspid is not UTF-8") from e


def _tlv(der: bytes, off: int) -> tuple[int, int, int]:
    """(tag, start of the element, end of its content) of the DER element
    at der[off:]; ValueError on a bad or overrunning length (the TLV
    reader of fabric_tpu/msp/cert.py)."""
    if off + 2 > len(der):
        raise ValueError("DER: truncated TLV header")
    tag, length, body = der[off], der[off + 1], off + 2
    if length & 0x80:
        k = length & 0x7F
        if k == 0 or k > 4 or body + k > len(der):
            raise ValueError("DER: bad long-form length")
        length = int.from_bytes(der[body:body + k], "big")
        body += k
    if body + length > len(der):
        raise ValueError("DER: content overruns buffer")
    return tag, body, body + length


def certificate_spki(der: bytes) -> bytes:
    """The subjectPublicKeyInfo element (its whole TLV) of an X.509
    certificate: Certificate ::= SEQUENCE { tbsCertificate, signature
    algorithm, signature BIT STRING }, tbsCertificate ::= SEQUENCE {
    [0] version OPTIONAL, serialNumber, signature, issuer, validity,
    subject, subjectPublicKeyInfo, ... }."""
    tag, body, end = _tlv(der, 0)
    if tag != 0x30 or end != len(der):
        raise ValueError("not a DER certificate")
    tags, off = [], body
    tbs = None
    while off < end:
        t, b, e = _tlv(der, off)
        tags.append(t)
        if tbs is None:
            tbs = (b, e)
        off = e
    if tags != [0x30, 0x30, 0x03]:
        raise ValueError("not a DER certificate")
    off, tbs_end = tbs
    t, _, e = _tlv(der, off)
    if t == 0xA0:                        # [0] EXPLICIT version
        off = e
    for want in (0x02, 0x30, 0x30, 0x30, 0x30):  # serial .. subject
        t, _, e = _tlv(der, off)
        if t != want or e > tbs_end:
            raise ValueError("malformed tbsCertificate")
        off = e
    t, _, e = _tlv(der, off)
    if t != 0x30 or e > tbs_end:
        raise ValueError("malformed subjectPublicKeyInfo")
    return der[off:e]


def key_from_spki(spki: bytes):
    """The verify key of a subjectPublicKeyInfo: ECDSA on P-256 or on
    ec_host's other curves, or Ed25519; ValueError for anything else."""
    if spki.startswith(p256_host.SPKI_PREFIX):
        return sw.ECDSAPublicKey(*p256_host.decode_spki(spki))
    if spki.startswith(_ED25519_SPKI_PREFIX) and \
            len(spki) == len(_ED25519_SPKI_PREFIX) + 32:
        return sw.Ed25519PublicKey(spki[-32:])
    c, x, y = ec_host.decode_spki(spki)
    return sw.ECDSAPublicKey(x, y, curve=c.name)


def resolve(raw: bytes, mspids: Iterable[str]) -> Identity:
    """A serialized identity's Identity; ValueError when it is not
    deserializable. An identity of an MSP outside `mspids`, the channel's
    MSP ids, is not deserializable either: the channel's MSP manager
    knows no MSP for it."""
    mspid, id_bytes = _serialized_identity(bytes(raw))
    if mspid not in mspids:
        raise ValueError(f"no MSP {mspid!r}")
    m = _PEM_RE.search(id_bytes)
    if m is None:
        raise ValueError("no PEM certificate in the identity")
    try:
        der = base64.b64decode(b"".join(m.group(1).split()), validate=True)
    except binascii.Error as e:
        raise ValueError(f"bad PEM body: {e}") from e
    return Identity(mspid, der, key_from_spki(certificate_spki(der)))


def stageable(ident) -> bool:
    """Whether an identity's lanes can be staged as digest lanes: a key,
    and one that signs digests (the reference's `key is None or
    key.sign_message` test, negated)."""
    key = getattr(ident, "key", None)
    return key is not None and not getattr(key, "sign_message", False)
