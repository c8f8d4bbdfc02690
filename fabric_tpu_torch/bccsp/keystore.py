"""File-based keystore: PEM files named by the hex SKI.

The port's counterpart of fabric_tpu/bccsp/keystore.py (the reference's
`bccsp/sw/fileks.go`), in the same file format, so one directory serves
both packages: a private key is `<hex-ski>_sk` (PKCS#8 PEM), a public key
`<hex-ski>_pk` (SubjectPublicKeyInfo PEM). The DER comes from the port's
own encoders, with no `cryptography`: P-256 keys through
`p256_host.encode_pkcs8`/`decode_pkcs8`/`encode_spki`/`decode_spki`, the
other ECDSA curves (P-224, P-384, P-521) through `ec_host`. The
reference's third kind, `<hex-ski>_key` (an AES key), is recognised and
refused: the port holds no AES keys.
"""

from __future__ import annotations

import base64
import os

from fabric_tpu_torch.bccsp import ec_host, p256_host, sw

_SK, _PK, _AES = "_sk", "_pk", "_key"
# prime256v1's OID (1.2.840.10045.3.1.7) as it sits in a P-256 key's
# AlgorithmIdentifier
_P256_OID = bytes.fromhex("06082a8648ce3d030107")


def _pem(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der)
    lines = b"".join(b64[i:i + 64] + b"\n" for i in range(0, len(b64), 64))
    return (f"-----BEGIN {label}-----\n".encode() + lines
            + f"-----END {label}-----\n".encode())


def _der(pem: bytes, label: str) -> bytes:
    begin = f"-----BEGIN {label}-----".encode()
    end = f"-----END {label}-----".encode()
    i, j = pem.find(begin), pem.find(end)
    if i < 0 or j < i:
        raise ValueError(f"no {label} PEM block")
    return base64.b64decode(b"".join(pem[i + len(begin):j].split()))


def _private_der(key: sw.ECDSAPrivateKey) -> bytes:
    if key.public_key().is_p256():
        return p256_host.encode_pkcs8(key.d)
    return ec_host.encode_pkcs8(ec_host.CURVES[key.public_key().curve],
                                key.d)


def _public_der(key: sw.ECDSAPublicKey) -> bytes:
    if key.is_p256():
        return p256_host.encode_spki(key.x, key.y)
    return ec_host.encode_spki(ec_host.CURVES[key.curve], key.x, key.y)


def _private_key(der: bytes) -> sw.ECDSAPrivateKey:
    if _P256_OID in der[:48]:
        return sw.ECDSAPrivateKey(p256_host.decode_pkcs8(der))
    c, d = ec_host.decode_pkcs8(der)
    return sw.ECDSAPrivateKey(d, curve=c.name)


def _public_key(der: bytes) -> sw.ECDSAPublicKey:
    if der.startswith(p256_host.SPKI_PREFIX):
        return sw.ECDSAPublicKey(*p256_host.decode_spki(der))
    c, x, y = ec_host.decode_spki(der)
    return sw.ECDSAPublicKey(x, y, curve=c.name)


class FileKeyStore:
    """ECDSA keys under `path`, one PEM file each, named by the key's
    SKI (sha256 of its uncompressed point, the reference's)."""

    def __init__(self, path: str, read_only: bool = False):
        self._path = path
        self._read_only = read_only
        os.makedirs(path, exist_ok=True)

    def store_key(self, key) -> None:
        if self._read_only:
            raise PermissionError("read-only keystore")
        if isinstance(key, sw.ECDSAPrivateKey):
            pem, suffix = _pem("PRIVATE KEY", _private_der(key)), _SK
        elif isinstance(key, sw.ECDSAPublicKey):
            pem, suffix = _pem("PUBLIC KEY", _public_der(key)), _PK
        else:
            raise TypeError(f"unsupported key type {type(key)}")
        with open(os.path.join(self._path, key.ski().hex() + suffix),
                  "wb") as f:
            f.write(pem)

    def get_key(self, ski: bytes):
        """The private key when the store holds one, else the public
        key; KeyError when it holds neither."""
        hexski = ski.hex()
        for suffix in (_SK, _PK, _AES):
            p = os.path.join(self._path, hexski + suffix)
            if not os.path.exists(p):
                continue
            with open(p, "rb") as f:
                data = f.read()
            if suffix == _SK:
                return _private_key(_der(data, "PRIVATE KEY"))
            if suffix == _PK:
                return _public_key(_der(data, "PUBLIC KEY"))
            raise TypeError(f"key {hexski} is an AES key, which the port's "
                            "sw provider does not hold")
        raise KeyError(f"key {hexski} not found")
