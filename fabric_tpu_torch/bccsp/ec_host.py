"""Pure-Python ECDSA over the NIST curves P-224, P-384 and P-521.

The sw provider's backend for ECDSA keys off P-256 (the card's host has
no `cryptography` wheel; `p256_host` keeps the P-256 lanes). Exact
big-int arithmetic aligned with Go `crypto/ecdsa` and OpenSSL: a digest
keeps its leftmost n.bit_length() bits (bits2int), r and s are
range-checked before any curve math, and the curve equation is decided
exactly. Every curve has a = -3; p, b and G are FIPS 186-4 D.1.2's (SEC 2
2.4-2.6), the orders utils.CURVE_ORDERS'. P-256 is in `CURVES` too, from
`p256_host`'s constants, so keys of every curve encode and decode alike.

Signing is RFC 6979's deterministic ECDSA, the HMAC on the hash whose
length the digest has (SHA-256, SHA-384 or SHA-512; SHA-256 for other
lengths). Keys encode as SubjectPublicKeyInfo (RFC 5480, uncompressed
point) and PKCS#8 (RFC 5208 over RFC 5915's ECPrivateKey).
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
from dataclasses import dataclass
from typing import Optional

from fabric_tpu_torch.bccsp import p256_host, utils


@dataclass(frozen=True)
class Curve:
    name: str
    p: int
    n: int
    b: int
    gx: int
    gy: int
    oid: bytes          # the namedCurve OID's DER content

    @property
    def size(self) -> int:
        """Bytes of a field element and of a scalar."""
        return (self.p.bit_length() + 7) // 8


CURVES = {c.name: c for c in (
    Curve("P-224",
          p=(1 << 224) - (1 << 96) + 1,
          n=utils.CURVE_ORDERS["P-224"],
          b=0xB4050A850C04B3ABF54132565044B0B7D7BFD8BA270B39432355FFB4,
          gx=0xB70E0CBD6BB4BF7F321390B94A03C1D356C21122343280D6115C1D21,
          gy=0xBD376388B5F723FB4C22DFE6CD4375A05A07476444D5819985007E34,
          oid=bytes.fromhex("2b81040021")),                # 1.3.132.0.33
    Curve("P-256", p=p256_host.P, n=p256_host.N, b=p256_host.B,
          gx=p256_host.GX, gy=p256_host.GY,
          oid=bytes.fromhex("2a8648ce3d030107")),      # 1.2.840.10045.3.1.7
    Curve("P-384",
          p=(1 << 384) - (1 << 128) - (1 << 96) + (1 << 32) - 1,
          n=utils.CURVE_ORDERS["P-384"],
          b=int("B3312FA7E23EE7E4988E056BE3F82D19181D9C6EFE8141120314088F"
                "5013875AC656398D8A2ED19D2A85C8EDD3EC2AEF", 16),
          gx=int("AA87CA22BE8B05378EB1C71EF320AD746E1D3B628BA79B9859F741E0"
                 "82542A385502F25DBF55296C3A545E3872760AB7", 16),
          gy=int("3617DE4A96262C6F5D9E98BF9292DC29F8F41DBD289A147CE9DA3113"
                 "B5F0B8C00A60B1CE1D7E819D7A431D7C90EA0E5F", 16),
          oid=bytes.fromhex("2b81040022")),                # 1.3.132.0.34
    Curve("P-521",
          p=(1 << 521) - 1,
          n=utils.CURVE_ORDERS["P-521"],
          b=int("0051953EB9618E1C9A1F929A21A0B68540EEA2DA725B99B315F3B8B4"
                "89918EF109E156193951EC7E937B1652C0BD3BB1BF073573DF883D2C"
                "34F1EF451FD46B503F00", 16),
          gx=int("00C6858E06B70404E9CD9E3ECB662395B4429C648139053FB521F828"
                 "AF606B4D3DBAA14B5E77EFE75928FE1DC127A2FFA8DE3348B3C1856A"
                 "429BF97E7E31C2E5BD66", 16),
          gy=int("011839296A789A3BC0045C8A5FB42C7D1BD998F54449579B446817AF"
                 "BD17273E662C97EE72995EF42640C550B9013FAD0761353C7086A272"
                 "C24088BE94769FD16650", 16),
          oid=bytes.fromhex("2b81040023")),                # 1.3.132.0.35
)}

_INF = (0, 1, 0)    # Jacobian point at infinity (Z == 0)


def on_curve(c: Curve, x: int, y: int) -> bool:
    if not (0 <= x < c.p and 0 <= y < c.p):
        return False
    return (y * y - (x * x * x - 3 * x + c.b)) % c.p == 0


# -- Jacobian arithmetic (dbl-2001-b / add-2007-bl, a = -3) --

def _jdouble(c: Curve, pt):
    X1, Y1, Z1 = pt
    if Z1 == 0 or Y1 == 0:
        return _INF
    P = c.p
    delta = Z1 * Z1 % P
    gamma = Y1 * Y1 % P
    beta = X1 * gamma % P
    alpha = 3 * (X1 - delta) * (X1 + delta) % P
    X3 = (alpha * alpha - 8 * beta) % P
    Z3 = ((Y1 + Z1) * (Y1 + Z1) - gamma - delta) % P
    Y3 = (alpha * (4 * beta - X3) - 8 * gamma * gamma) % P
    return (X3, Y3, Z3)


def _jadd(c: Curve, p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    P = c.p
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return _INF
        return _jdouble(c, p)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    r = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % P * H % P
    return (X3, Y3, Z3)


def _to_affine(c: Curve, pt) -> Optional[tuple[int, int]]:
    X, Y, Z = pt
    if Z == 0:
        return None
    zinv = pow(Z, -1, c.p)
    zinv2 = zinv * zinv % c.p
    return (X * zinv2 % c.p, Y * zinv2 * zinv % c.p)


def scalar_mult(c: Curve, k: int, point: tuple[int, int]
                ) -> Optional[tuple[int, int]]:
    """k * point (affine in/out; None = infinity)."""
    k %= c.n
    acc = _INF
    base = (*point, 1)
    for bit in bin(k)[2:] if k else "":
        acc = _jdouble(c, acc)
        if bit == "1":
            acc = _jadd(c, acc, base)
    return _to_affine(c, acc)


def _double_mult(c: Curve, u1: int, u2: int, q: tuple[int, int]):
    """u1*G + u2*Q by Shamir's interleaving."""
    g = (c.gx, c.gy, 1)
    qj = (*q, 1)
    gq = _jadd(c, g, qj)
    acc = _INF
    for i in range(max(u1.bit_length(), u2.bit_length()) - 1, -1, -1):
        acc = _jdouble(c, acc)
        b1 = (u1 >> i) & 1
        b2 = (u2 >> i) & 1
        if b1 and b2:
            acc = _jadd(c, acc, gq)
        elif b1:
            acc = _jadd(c, acc, g)
        elif b2:
            acc = _jadd(c, acc, qj)
    return _to_affine(c, acc)


def bits2int(c: Curve, data: bytes) -> int:
    """The leftmost n.bit_length() bits of `data` (Go's hashToInt,
    OpenSSL's and RFC 6979's bits2int)."""
    v = int.from_bytes(data, "big")
    excess = len(data) * 8 - c.n.bit_length()
    return v >> excess if excess > 0 else v


def verify(c: Curve, x: int, y: int, digest: bytes, r: int, s: int) -> bool:
    """Exact ECDSA verify over precomputed digest bytes."""
    if not (1 <= r < c.n and 1 <= s < c.n):
        return False
    if not on_curve(c, x, y):
        return False
    e = bits2int(c, digest) % c.n
    w = pow(s, -1, c.n)
    pt = _double_mult(c, e * w % c.n, r * w % c.n, (x, y))
    return pt is not None and pt[0] % c.n == r


# -- RFC 6979 deterministic nonces --

_HMAC_HASH = {32: hashlib.sha256, 48: hashlib.sha384, 64: hashlib.sha512}


def sign(c: Curve, d: int, digest: bytes) -> tuple[int, int]:
    """Deterministic ECDSA (RFC 6979 3.2) over precomputed digest bytes;
    returns raw (r, s), the caller applies the low-S policy."""
    if not 1 <= d < c.n:
        raise ValueError("private scalar out of range")
    hmod = _HMAC_HASH.get(len(digest), hashlib.sha256)
    rlen = (c.n.bit_length() + 7) // 8
    e = bits2int(c, digest) % c.n
    V = b"\x01" * hmod().digest_size
    K = b"\x00" * hmod().digest_size
    seed = d.to_bytes(rlen, "big") + e.to_bytes(rlen, "big")
    K = hmac.new(K, V + b"\x00" + seed, hmod).digest()
    V = hmac.new(K, V, hmod).digest()
    K = hmac.new(K, V + b"\x01" + seed, hmod).digest()
    V = hmac.new(K, V, hmod).digest()
    while True:
        T = b""
        while len(T) * 8 < c.n.bit_length():
            V = hmac.new(K, V, hmod).digest()
            T += V
        k = bits2int(c, T)
        if 1 <= k < c.n:
            pt = scalar_mult(c, k, (c.gx, c.gy))
            r = pt[0] % c.n
            if r:
                s = pow(k, -1, c.n) * (e + r * d) % c.n
                if s:
                    return r, s
        K = hmac.new(K, V + b"\x00", hmod).digest()
        V = hmac.new(K, V, hmod).digest()


def generate_scalar(c: Curve) -> int:
    """Uniform private scalar in [1, n)."""
    return secrets.randbelow(c.n - 1) + 1


def derive_public(c: Curve, d: int) -> tuple[int, int]:
    pt = scalar_mult(c, d, (c.gx, c.gy))
    if pt is None:
        raise ValueError("private scalar is a multiple of the order")
    return pt


# -- DER key encodings --

_EC_PUBLIC_KEY = bytes.fromhex("2a8648ce3d0201")   # 1.2.840.10045.2.1


def _tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        head = bytes([n])
    else:
        size = n.to_bytes((n.bit_length() + 7) // 8, "big")
        head = bytes([0x80 | len(size)]) + size
    return bytes([tag]) + head + content


def _read_tlv(der: bytes, off: int, tag: int) -> tuple[bytes, int]:
    """The content of the DER element with `tag` at der[off:] and the
    offset after it; ValueError on another tag or a bad length."""
    if off + 2 > len(der) or der[off] != tag:
        raise ValueError(f"expected DER tag {tag:#x}")
    n, off = der[off + 1], off + 2
    if n & 0x80:
        k = n & 0x7F
        if not 1 <= k <= 2 or off + k > len(der):
            raise ValueError("bad DER length")
        n, off = int.from_bytes(der[off:off + k], "big"), off + k
    if off + n > len(der):
        raise ValueError("truncated DER element")
    return der[off:off + n], off + n


def _algorithm(c: Curve) -> bytes:
    return _tlv(0x30, _tlv(0x06, _EC_PUBLIC_KEY) + _tlv(0x06, c.oid))


def encode_spki(c: Curve, x: int, y: int) -> bytes:
    """SubjectPublicKeyInfo with the uncompressed point."""
    point = b"\x04" + x.to_bytes(c.size, "big") + y.to_bytes(c.size, "big")
    return _tlv(0x30, _algorithm(c) + _tlv(0x03, b"\x00" + point))


def decode_spki(der: bytes) -> tuple[Curve, int, int]:
    """(curve, x, y) of an uncompressed SubjectPublicKeyInfo on one of
    `CURVES`; ValueError for anything else or a point off the curve."""
    for c in CURVES.values():
        prefix = encode_spki(c, 0, 0)[:-2 * c.size]
        if len(der) == len(prefix) + 2 * c.size and der.startswith(prefix):
            x = int.from_bytes(der[len(prefix):-c.size], "big")
            y = int.from_bytes(der[-c.size:], "big")
            if not on_curve(c, x, y):
                raise ValueError(f"public point not on {c.name}")
            return c, x, y
    raise ValueError("unsupported public key encoding (uncompressed "
                     "SubjectPublicKeyInfo on P-224/256/384/521 only)")


def encode_pkcs8(c: Curve, d: int) -> bytes:
    """PKCS#8 over an ECPrivateKey without the optional public key."""
    ec_key = _tlv(0x30, _tlv(0x02, b"\x01")
                  + _tlv(0x04, d.to_bytes(c.size, "big")))
    return _tlv(0x30, _tlv(0x02, b"\x00") + _algorithm(c)
                + _tlv(0x04, ec_key))


def decode_pkcs8(der: bytes) -> tuple[Curve, int]:
    """(curve, d) of a PKCS#8 EC private key (the ECPrivateKey's optional
    parameters and public key, as OpenSSL writes them, are skipped)."""
    body, end = _read_tlv(der, 0, 0x30)
    if end != len(der):
        raise ValueError("trailing bytes after the private key")
    version, off = _read_tlv(body, 0, 0x02)
    alg, off = _read_tlv(body, off, 0x30)
    inner, _ = _read_tlv(body, off, 0x04)
    c = next((c for c in CURVES.values()
              if _algorithm(c) == _tlv(0x30, alg)), None)
    if version != b"\x00" or c is None:
        raise ValueError("unsupported private key encoding")
    ec_key, _ = _read_tlv(inner, 0, 0x30)
    ec_version, off = _read_tlv(ec_key, 0, 0x02)
    scalar, _ = _read_tlv(ec_key, off, 0x04)
    if ec_version != b"\x01" or len(scalar) != c.size:
        raise ValueError("unsupported ECPrivateKey encoding")
    d = int.from_bytes(scalar, "big")
    if not 1 <= d < c.n:
        raise ValueError("private scalar out of range")
    return c, d
