"""Software BCCSP provider, P-256, Ed25519, BLS12-381 and the BN254
pairings — the port's CPU oracle.

A cut of fabric_tpu/bccsp/sw.py to the ECDSA-P256, Ed25519, BLS12-381 and
BN254 pairing slices, on the port's pure-Python backends
(bccsp/p256_host.py, bccsp/ed25519_host.py, ops/bls12_381_ref.py,
ops/bn254_ref.py): the card's host has no `cryptography` wheel. ECDSA verification semantics
follow `bccsp/sw/ecdsa.go:41-57` in order: strict DER unmarshal, the low-S
policy against the key's curve order, then the curve equation. Ed25519's
policy (strict encodings, S < L, small-order rejection, the cofactorless
equation) lives in `ed25519_host`; Ed25519 keys sign and verify messages,
not digests (`sign_message`).

BLS12-381 keys (min-sig: pk on the G2 twist, signatures in G1) sign and
verify messages too; `verify_aggregate` checks a span's aggregated
signature against its keys and messages with one pairing product
(`bls12_381_ref.aggregate_verify`), the host reference the CUDA
provider's aggregate path is held to.

The pairing methods (`pairing_check_batch`, `bls_verify_batch`: the exact
Python-int pairing) are the idemix credential checks' host oracle; the
CUDA provider batches them on the card and serves batches under its host
cutoffs here.

ECDSA keys on other curves can be represented (so a provider can tell
them apart) but not verified here: that needs OpenSSL, and raises
NotImplementedError.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence

import numpy as np

from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import ed25519_host as edh
from fabric_tpu_torch.bccsp import p256_host, utils
from fabric_tpu_torch.ops import bls12_381_ref as bref

NOT_P256 = ("ECDSA over curves other than P-256 needs OpenSSL on the sw "
            "side; the port's non-P-256 sw-lane slice (ROADMAP) adds it")


class ECDSAPublicKey(api.Key):
    def __init__(self, x: int, y: int, curve: str = "P-256"):
        if curve not in utils.CURVE_ORDERS:
            raise ValueError(f"unsupported curve {curve!r}")
        if curve == "P-256" and (not p256_host.on_curve(x, y)
                                 or (x == 0 and y == 0)):
            raise ValueError("public point not on P-256")
        self.x, self.y, self.curve = x, y, curve
        self._xy = None

    def is_p256(self) -> bool:
        return self.curve == "P-256"

    @property
    def order(self) -> int:
        return utils.CURVE_ORDERS[self.curve]

    def x_bytes(self) -> np.ndarray:
        """Cached 32-byte big-endian coordinates (the same org keys recur
        thousands of times per block)."""
        if self._xy is None:
            self._xy = (np.frombuffer(self.x.to_bytes(32, "big"), np.uint8),
                        np.frombuffer(self.y.to_bytes(32, "big"), np.uint8))
        return self._xy[0]

    def y_bytes(self) -> np.ndarray:
        self.x_bytes()
        return self._xy[1]

    def bytes(self) -> bytes:
        if not self.is_p256():
            raise NotImplementedError(NOT_P256)
        return p256_host.encode_spki(self.x, self.y)

    def ski(self) -> bytes:
        size = (self.order.bit_length() + 7) // 8
        return hashlib.sha256(b"\x04" + self.x.to_bytes(size, "big")
                              + self.y.to_bytes(size, "big")).digest()

    def symmetric(self) -> bool:
        return False

    def private(self) -> bool:
        return False

    def public_key(self) -> "ECDSAPublicKey":
        return self


class ECDSAPrivateKey(api.Key):
    def __init__(self, d: int):
        if not 1 <= d < p256_host.N:
            raise ValueError("private scalar out of range")
        self.d = d
        self._pub = ECDSAPublicKey(*p256_host.derive_public(d))

    def bytes(self) -> bytes:
        raise TypeError("private key export not allowed")

    def ski(self) -> bytes:
        return self._pub.ski()

    def symmetric(self) -> bool:
        return False

    def private(self) -> bool:
        return True

    def public_key(self) -> ECDSAPublicKey:
        return self._pub


class Ed25519PublicKey(api.Key):
    """RFC 8032 public key (32-byte canonical encoding)."""

    scheme = "ed25519"
    sign_message = True

    def __init__(self, raw: bytes):
        if edh.decode_point(raw) is None:
            raise ValueError("not a canonical Ed25519 public key")
        self._raw = bytes(raw)

    def bytes(self) -> bytes:
        return self._raw

    def ski(self) -> bytes:
        return hashlib.sha256(self._raw).digest()

    def symmetric(self) -> bool:
        return False

    def private(self) -> bool:
        return False

    def public_key(self) -> "Ed25519PublicKey":
        return self


class Ed25519PrivateKey(api.Key):
    scheme = "ed25519"
    sign_message = True

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("Ed25519 seed must be 32 bytes")
        self._seed = bytes(seed)
        self._pub = Ed25519PublicKey(edh.public_from_seed(seed))

    def bytes(self) -> bytes:
        raise TypeError("private key export not allowed")

    def ski(self) -> bytes:
        return self._pub.ski()

    def symmetric(self) -> bool:
        return False

    def private(self) -> bool:
        return True

    def public_key(self) -> Ed25519PublicKey:
        return self._pub

    @property
    def seed(self) -> bytes:
        return self._seed


class BLSPublicKey(api.Key):
    """BLS12-381 min-sig public key: a G2 twist point (192-byte
    uncompressed encoding), subgroup-checked at construction —
    aggregation is unsound over points outside the order-r group."""

    scheme = "bls12381"
    sign_message = True

    def __init__(self, raw: bytes):
        self.point = bref.g2_from_bytes(raw)
        if self.point is None:
            raise ValueError("BLS public key is the identity")
        self._raw = bytes(raw)

    def bytes(self) -> bytes:
        return self._raw

    def ski(self) -> bytes:
        return hashlib.sha256(self._raw).digest()

    def symmetric(self) -> bool:
        return False

    def private(self) -> bool:
        return False

    def public_key(self) -> "BLSPublicKey":
        return self


class BLSPrivateKey(api.Key):
    scheme = "bls12381"
    sign_message = True

    def __init__(self, sk: int):
        if not 1 <= sk < bref.R:
            raise ValueError("BLS secret scalar out of range")
        self._sk = sk
        self._pub = BLSPublicKey(bref.g2_to_bytes(
            bref.g2_mul(sk, (bref.G2_X, bref.G2_Y))))

    def bytes(self) -> bytes:
        raise TypeError("private key export not allowed")

    def ski(self) -> bytes:
        return self._pub.ski()

    def symmetric(self) -> bool:
        return False

    def private(self) -> bool:
        return True

    def public_key(self) -> BLSPublicKey:
        return self._pub

    @property
    def sk(self) -> int:
        return self._sk


def bls_aggregate_signatures(sigs) -> bytes:
    """Aggregate serialized G1 signatures into one 96-byte signature (the
    sum of the points). Raises ValueError on malformed input: callers
    aggregate their own just-produced signatures (the blockwriter's
    span), so garbage here is a bug, not data."""
    pts = [bref.g1_from_bytes(s, subgroup_check=False) for s in sigs]
    return bref.g1_to_bytes(bref.bls_aggregate(pts))


def bls_aggregate_operands(keys, signature: bytes):
    """`verify_aggregate`'s operands, for every provider: (the keys' G2
    points, the aggregated signature's G1 point, not yet subgroup-checked
    and None for the identity), or None where the signature's bytes do
    not decode (the verdict is then False). TypeError unless every key
    is a BLS key."""
    pks = []
    for k in keys:
        pub = k.public_key()
        if not isinstance(pub, BLSPublicKey):
            raise TypeError("verify_aggregate requires BLS keys")
        pks.append(pub.point)
    try:
        return pks, bref.g1_from_bytes(signature, subgroup_check=False)
    except ValueError:
        return None


_HASHERS = {
    "SHA256": hashlib.sha256,
    "SHA384": hashlib.sha384,
    "SHA3_256": hashlib.sha3_256,
    "SHA3_384": hashlib.sha3_384,
}

# digest lengths the reference's prehashed verify takes
_DIGEST_LENS = (32, 48, 64)


def check_signature(key, signature: bytes) -> Optional[tuple[int, int]]:
    """Shared pre-validation: strict DER + positivity + low-S against the
    key's curve order. Returns (r, s), or None when a gate rejects."""
    try:
        r, s = utils.unmarshal_signature(signature)
    except utils.SignatureFormatError:
        return None
    n = key.order if hasattr(key, "order") else utils.P256_N
    if not utils.is_low_s(s, n):
        return None
    return (r, s)


class SWProvider(api.BCCSP):
    """CPU provider (reference: `bccsp/sw/new.go`), P-256 ECDSA, Ed25519
    and BLS12-381."""

    def __init__(self):
        # non-ephemeral keys by SKI, so get_key(ski) resolves them (the
        # reference's in-memory keystore, bccsp/sw/dummyks.go)
        self._mem: dict[bytes, api.Key] = {}

    def _retain(self, key: api.Key) -> None:
        # a public key and its private twin share an SKI: never let the
        # public half displace the private one
        existing = self._mem.get(key.ski())
        if existing is None or not existing.private() or key.private():
            self._mem[key.ski()] = key

    def key_gen(self, opts) -> api.Key:
        if isinstance(opts, api.Ed25519KeyGenOpts):
            key: api.Key = Ed25519PrivateKey(edh.generate_seed())
        elif isinstance(opts, api.BLSKeyGenOpts):
            sk, _ = bref.bls_keygen(os.urandom(32))
            key = BLSPrivateKey(sk)
        elif not isinstance(opts, api.ECDSAKeyGenOpts):
            raise TypeError(f"unsupported KeyGenOpts {opts!r}")
        elif opts.curve != "P-256":
            raise NotImplementedError(NOT_P256)
        else:
            key = ECDSAPrivateKey(p256_host.generate_scalar())
        if not opts.ephemeral:
            self._retain(key)
        return key

    def key_import(self, raw, opts) -> api.Key:
        if isinstance(opts, api.Ed25519PublicKeyImportOpts):
            key: api.Key = raw if isinstance(raw, Ed25519PublicKey) \
                else Ed25519PublicKey(bytes(raw))
        elif isinstance(opts, api.BLSPublicKeyImportOpts):
            key = raw if isinstance(raw, BLSPublicKey) \
                else BLSPublicKey(bytes(raw))
        elif isinstance(opts, api.ECDSAPublicKeyImportOpts):
            key = raw if isinstance(raw, ECDSAPublicKey) \
                else ECDSAPublicKey(*p256_host.decode_spki(bytes(raw)))
        elif isinstance(opts, api.ECDSAPrivateKeyImportOpts):
            key = raw if isinstance(raw, ECDSAPrivateKey) \
                else ECDSAPrivateKey(p256_host.decode_pkcs8(bytes(raw)))
        else:
            raise TypeError(f"unsupported KeyImportOpts {opts!r}")
        if not opts.ephemeral:
            self._retain(key)
        return key

    def get_key(self, ski: bytes) -> api.Key:
        key = self._mem.get(ski)
        if key is None:
            raise KeyError(f"key {ski.hex()} not found")
        return key

    def hash(self, msg: bytes, opts=None) -> bytes:
        alg = getattr(opts, "algorithm", "SHA256") if opts else "SHA256"
        return _HASHERS[alg](msg).digest()

    def sign(self, key: api.Key, digest: bytes, opts=None) -> bytes:
        """Low-S DER signature over a precomputed digest (reference:
        `bccsp/sw/ecdsa.go:27-39`), with RFC 6979 nonces. For an Ed25519
        or BLS key (`sign_message`) `digest` is the message itself: RFC
        8032 and the BLS hash-to-G1 hash internally."""
        if isinstance(key, Ed25519PrivateKey):
            return edh.sign(key.seed, digest)
        if isinstance(key, BLSPrivateKey):
            return bref.g1_to_bytes(bref.bls_sign(key.sk, digest))
        if not isinstance(key, ECDSAPrivateKey):
            raise TypeError("sign requires an ECDSA private key")
        if len(digest) not in _DIGEST_LENS:
            raise ValueError(f"unsupported digest length {len(digest)}")
        r, s = p256_host.sign(key.d, digest)
        return utils.marshal_signature(r, utils.to_low_s(s))

    def verify(self, key: api.Key, signature: bytes, digest: bytes,
               opts=None) -> bool:
        pub = key.public_key()
        if isinstance(pub, Ed25519PublicKey):
            return edh.verify(pub.bytes(), signature, digest)
        if isinstance(pub, BLSPublicKey):
            try:
                sig = bref.g1_from_bytes(signature, subgroup_check=False)
            except ValueError:
                return False
            return bref.bls_verify(pub.point, digest, sig)
        if not isinstance(pub, ECDSAPublicKey):
            raise TypeError("verify requires an ECDSA key")
        if not pub.is_p256():
            raise NotImplementedError(NOT_P256)
        rs = check_signature(pub, signature)
        if rs is None or len(digest) not in _DIGEST_LENS:
            return False
        return p256_host.verify(pub.x, pub.y, digest, *rs)

    def verify_batch(self, items: Sequence[api.VerifyItem]) -> list[bool]:
        out = []
        for it in items:
            if getattr(it.key, "sign_message", False):
                # Ed25519 and BLS hash internally: whichever field the
                # caller set carries the raw message, never pre-hashed
                data = it.message if it.message is not None else it.digest
            else:
                data = it.digest if it.digest is not None \
                    else self.hash(it.message)
            out.append(self.verify(it.key, it.signature, data))
        return out

    def verify_aggregate(self, keys, messages, signature) -> bool:
        """BLS aggregate verify, the host reference (one pairing product
        by `bls12_381_ref`): keys[i] signed messages[i], `signature` is
        the 96-byte aggregated G1 point. The CUDA provider's aggregate
        path gives the same verdicts."""
        ops = bls_aggregate_operands(keys, signature)
        if ops is None:
            return False
        return bref.aggregate_verify(ops[0], list(messages), ops[1])

    # -- pairings (host oracle; the CUDA provider batches these on the
    #    card — reference consumer: idemix credential verification) --

    def pairing_check_batch(self, products) -> list[bool]:
        """prod_j e(P_j, Q_j) == 1 per lane: products [[(P_int_affine,
        Q_twist_int_affine), ...] per lane]."""
        from fabric_tpu_torch.ops import bn254_ref as bref
        out = []
        for lanes in products:
            acc = bref.F12_ONE
            for p, q in lanes:
                acc = bref.f12_mul(acc, bref.miller_loop(q, p))
            out.append(bref.final_exponentiation(acc) == bref.F12_ONE)
        return out

    def bls_verify_batch(self, pk_tw, msgs, sig_points) -> list[bool]:
        """Issuer-credential BLS verify per lane; a None signature point
        (malformed) is False."""
        from fabric_tpu_torch.ops import bn254_ref as bref
        return [s is not None and bref.bls_verify(pk_tw, m, s)
                for m, s in zip(msgs, sig_points)]
