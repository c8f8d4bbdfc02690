"""BCCSP interfaces and option types, cut to what the port's slice uses.

The port's copy of fabric_tpu/bccsp/bccsp.py (the reference contract,
`bccsp/bccsp.go:15-134`, plus the batch-first `verify_batch`): keys,
the verify item, the ECDSA, Ed25519 and BLS12-381 key options and the
provider ABC.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional, Sequence


class Key(abc.ABC):
    """A cryptographic key handle (reference: `bccsp/bccsp.go:15-45`)."""

    @abc.abstractmethod
    def bytes(self) -> bytes:
        """Serialized form, if allowed (public keys: DER SPKI)."""

    @abc.abstractmethod
    def ski(self) -> bytes:
        """Subject Key Identifier — SHA-256 of the uncompressed point."""

    @abc.abstractmethod
    def symmetric(self) -> bool: ...

    @abc.abstractmethod
    def private(self) -> bool: ...

    def public_key(self) -> "Key":
        """Corresponding public part of an asymmetric key pair."""
        raise TypeError("not an asymmetric key")


@dataclass(frozen=True)
class VerifyItem:
    """One signature verification request for the batch path: exactly
    one of `message` (the provider hashes it) and `digest` (a SHA-256
    digest, as `bccsp.Verify(k, signature, digest)` takes) is set."""

    key: Key
    signature: bytes
    message: Optional[bytes] = None
    digest: Optional[bytes] = None


@dataclass(frozen=True)
class ECDSAKeyGenOpts:
    ephemeral: bool = False
    curve: str = "P-256"


@dataclass(frozen=True)
class Ed25519KeyGenOpts:
    ephemeral: bool = False


@dataclass(frozen=True)
class Ed25519PublicKeyImportOpts:
    ephemeral: bool = False


@dataclass(frozen=True)
class BLSKeyGenOpts:
    """BLS12-381 min-sig keys (pk on the G2 twist, signatures in G1 —
    the aggregatable consensus-identity shape)."""

    ephemeral: bool = False


@dataclass(frozen=True)
class BLSPublicKeyImportOpts:
    ephemeral: bool = False


@dataclass(frozen=True)
class ECDSAPrivateKeyImportOpts:
    ephemeral: bool = False


@dataclass(frozen=True)
class ECDSAPublicKeyImportOpts:
    ephemeral: bool = False


class BCCSP(abc.ABC):
    """The provider contract (reference: `bccsp/bccsp.go:90-134`)."""

    @abc.abstractmethod
    def key_gen(self, opts) -> Key: ...

    @abc.abstractmethod
    def key_import(self, raw, opts) -> Key: ...

    @abc.abstractmethod
    def get_key(self, ski: bytes) -> Key: ...

    @abc.abstractmethod
    def hash(self, msg: bytes, opts=None) -> bytes: ...

    @abc.abstractmethod
    def sign(self, key: Key, digest: bytes, opts=None) -> bytes: ...

    @abc.abstractmethod
    def verify(self, key: Key, signature: bytes, digest: bytes,
               opts=None) -> bool: ...

    @abc.abstractmethod
    def verify_batch(self, items: Sequence[VerifyItem]) -> list[bool]:
        """Verify many independent signatures; element i is the
        accept/reject for items[i], bit-identical to `verify` per item
        (with provider-side hashing for `message` items)."""
