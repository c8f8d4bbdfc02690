"""fabric_tpu_torch.bccsp.ec_host and the sw provider's ECDSA keys off
P-256, against the JAX package's SWProvider (OpenSSL).

For P-224, P-384 and P-521 the port's `SWProvider` verdicts equal
fabric_tpu.bccsp.sw.SWProvider's on valid lanes (digests of 32, 48 and
64 bytes, signed by either side), a tampered message, high-S, r = 0,
r >= n, a 20-byte digest and a wrong key. The keys' SubjectPublicKeyInfo
and PKCS#8 encodings round-trip through the reference's (OpenSSL's), and
the curve constants are held to OpenSSL's public points and to RFC 6979's
P-256 test vector. Keys come from numpy-seeded scalars.
"""

import hashlib

import numpy as np
import pytest
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ec

from fabric_tpu.bccsp import bccsp as japi
from fabric_tpu.bccsp import sw as jsw

from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import ec_host, p256_host, sw, utils

OPENSSL_CURVES = {"P-224": ec.SECP224R1(), "P-256": ec.SECP256R1(),
                  "P-384": ec.SECP384R1(), "P-521": ec.SECP521R1()}
OTHER = ("P-224", "P-384", "P-521")


def _keys(curve: str, seed: int, count: int = 2):
    """(port private key, reference private key) pairs on one scalar."""
    rng = np.random.default_rng(seed)
    c = ec_host.CURVES[curve]
    out = []
    for _ in range(count):
        d = int.from_bytes(rng.bytes(c.size + 8), "big") % (c.n - 1) + 1
        raw = ec.derive_private_key(d, OPENSSL_CURVES[curve])
        out.append((sw.ECDSAPrivateKey(d, curve=curve),
                    jsw.ECDSAPrivateKey(raw)))
    return out


def _lanes(curve: str, seed: int):
    """(kind, key index, signature, digest) lanes over two keys."""
    mine, ref = sw.SWProvider(), jsw.SWProvider()
    keys = _keys(curve, seed)
    n = utils.CURVE_ORDERS[curve]
    msg = b"block %d" % seed
    lanes = []
    for dlen, h in ((32, hashlib.sha256), (48, hashlib.sha384),
                    (64, hashlib.sha512)):
        digest = h(msg).digest()
        lanes.append((f"valid_{dlen}", 0, mine.sign(keys[0][0], digest),
                      digest))
        lanes.append((f"openssl_{dlen}", 1, ref.sign(keys[1][1], digest),
                      digest))
    digest = hashlib.sha256(msg).digest()
    sig = mine.sign(keys[0][0], digest)
    r, s = utils.unmarshal_signature(sig)
    lanes += [
        ("tampered", 0, sig, hashlib.sha256(msg + b"!").digest()),
        ("high_s", 0, utils.marshal_signature(r, n - s), digest),
        ("r_zero", 0, utils.marshal_signature(0, s), digest),
        ("r_ge_n", 0, utils.marshal_signature(r + n, s), digest),
        ("digest_20", 0, mine.sign(keys[0][0], digest), digest[:20]),
        ("wrong_key", 1, sig, digest),
    ]
    return keys, lanes


@pytest.mark.parametrize("curve", OTHER)
def test_sw_verdicts_match_openssl(curve):
    keys, lanes = _lanes(curve, seed=int(curve[2:]))
    mine, ref = sw.SWProvider(), jsw.SWProvider()
    got = [mine.verify(keys[k][0].public_key(), sig, dg)
           for _, k, sig, dg in lanes]
    want = [ref.verify(keys[k][1].public_key(), sig, dg)
            for _, k, sig, dg in lanes]
    assert got == want
    assert got == [kind.startswith(("valid", "openssl"))
                   for kind, *_ in lanes]
    items = [api.VerifyItem(key=keys[k][0].public_key(), signature=sig,
                            digest=dg) for _, k, sig, dg in lanes]
    assert mine.verify_batch(items) == got


@pytest.mark.parametrize("curve", OTHER)
def test_key_encodings_round_trip(curve):
    mine, ref = sw.SWProvider(), jsw.SWProvider()
    (priv, jpriv), = _keys(curve, seed=3, count=1)
    pub = priv.public_key()
    jpub = jpriv.public_key()
    assert (pub.x, pub.y) == (jpub.x, jpub.y)
    assert pub.bytes() == jpub.bytes()
    assert pub.ski() == jpub.ski()
    back = mine.key_import(jpub.bytes(), api.ECDSAPublicKeyImportOpts(
        ephemeral=True))
    assert (back.curve, back.x, back.y) == (curve, pub.x, pub.y)
    assert ref.key_import(pub.bytes(), japi.ECDSAPublicKeyImportOpts(
        ephemeral=True)).bytes() == pub.bytes()
    # PKCS#8: OpenSSL's (with the embedded public key) and the port's own
    p8 = jpriv.raw.private_bytes(serialization.Encoding.DER,
                                 serialization.PrivateFormat.PKCS8,
                                 serialization.NoEncryption())
    imported = mine.key_import(p8, api.ECDSAPrivateKeyImportOpts(
        ephemeral=True))
    assert imported.d == priv.d and imported.public_key().curve == curve
    c = ec_host.CURVES[curve]
    assert ec_host.decode_pkcs8(ec_host.encode_pkcs8(c, priv.d)) == (
        c, priv.d)
    reloaded = serialization.load_der_private_key(
        ec_host.encode_pkcs8(c, priv.d), password=None)
    assert reloaded.private_numbers().private_value == priv.d


@pytest.mark.parametrize("curve", OTHER)
def test_sign_verify_round_trip(curve):
    mine, ref = sw.SWProvider(), jsw.SWProvider()
    key = mine.key_gen(api.ECDSAKeyGenOpts(curve=curve, ephemeral=True))
    pub = key.public_key()
    assert pub.curve == curve
    jpub = ref.key_import(pub.bytes(), japi.ECDSAPublicKeyImportOpts(
        ephemeral=True))
    for dlen in (32, 48, 64):
        digest = hashlib.sha512(b"round trip").digest()[:dlen]
        sig = mine.sign(key, digest)
        assert sig == mine.sign(key, digest)          # RFC 6979
        r, s = utils.unmarshal_signature(sig)
        assert utils.is_low_s(s, pub.order)
        assert mine.verify(pub, sig, digest) and ref.verify(jpub, sig, digest)
    with pytest.raises(ValueError):
        mine.sign(key, digest[:20])


@pytest.mark.parametrize("curve", list(OPENSSL_CURVES))
def test_curve_constants_match_openssl(curve):
    """G, p and b through derive_public against OpenSSL's public points;
    n through utils.CURVE_ORDERS; every curve rejects a point off it."""
    c = ec_host.CURVES[curve]
    assert c.n == utils.CURVE_ORDERS[curve]
    assert ec_host.on_curve(c, c.gx, c.gy)
    assert ec_host.scalar_mult(c, c.n, (c.gx, c.gy)) is None
    for d in (1, 2, c.n - 1, 0xDEADBEEF << 64):
        nums = ec.derive_private_key(d, OPENSSL_CURVES[curve]) \
            .public_key().public_numbers()
        assert ec_host.derive_public(c, d) == (nums.x, nums.y)
    with pytest.raises(ValueError):
        sw.ECDSAPublicKey(1, 2, curve=curve)
    with pytest.raises(ValueError):
        sw.ECDSAPublicKey(c.gx, c.gy + 1, curve=curve)


def test_rfc6979_p256_vector():
    """RFC 6979 A.2.5, P-256 with SHA-256 over "sample": ec_host's signer
    and p256_host's give the published (r, s)."""
    x = 0xC9AFA9D845BA75166B5C215767B1D6934E50C3DB36E89B127B8A622B120F6721
    digest = hashlib.sha256(b"sample").digest()
    want = (0xEFD48B2AACB6A8FD1140DD9CD45E81D69D2C877B56AAF991C34D0EA84EAF3716,
            0xF7CB1C942D657C41D436C7A1B6E29F65F3E900DBB9AFF4064DC4AB2F843ACDA8)
    assert ec_host.sign(ec_host.CURVES["P-256"], x, digest) == want
    assert p256_host.sign(x, digest) == want
