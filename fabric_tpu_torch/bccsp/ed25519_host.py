"""Pure-Python Ed25519 (RFC 8032) — the host reference for the
multi-scheme device path.

The port's copy of fabric_tpu/bccsp/ed25519_host.py, unchanged in
behaviour: the port imports nothing of the JAX package.

This module is to `ops/ed25519.py` what `p256_host.py` is to
`ops/p256.py`: the wheel-free correctness ORACLE the device kernel is
differentially tested against, and the per-lane host prep that gates
and stages device operands. The acceptance policy lives in ONE place —
`prep_verify` — shared by the host verify and the device staging path,
so the two can only diverge on the curve equation itself (which the
parity tests then pin):

  * non-canonical point encodings (y >= p) are REJECTED;
  * S >= L (non-canonical scalar, malleable) is REJECTED;
  * small-order A or R (torsion points — the signatures libsodium
    calls "unsafe") are REJECTED;
  * the verification equation is the cofactorless [S]B == R + [k]A
    (equivalently [S]B + [k](-A) == R, the form the device computes).

Signing is deterministic (RFC 8032), so host- and wheel-produced
signatures over the same seed are byte-identical.

Arithmetic uses extended twisted Edwards coordinates (X:Y:Z:T) with
the complete a=-1 addition law — the same formulas the device kernel
vectorizes over limb tensors, mirroring how `p256_host.py` mirrors
`ops/p256.py`.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Optional

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, -1, P)) % P
D2 = (2 * D) % P

# base point B: y = 4/5, x recovered even (RFC 8032 §5.1)
BY = (4 * pow(5, -1, P)) % P
BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202

# extended coordinates (X : Y : Z : T), T = X*Y/Z
_IDENT = (0, 1, 1, 0)


def pt_add(p, q):
    """Complete a=-1 twisted Edwards addition (add-2008-hwcd-3)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = (Y1 - X1) * (Y2 - X2) % P
    b = (Y1 + X1) * (Y2 + X2) % P
    c = T1 * D2 % P * T2 % P
    d = 2 * Z1 * Z2 % P
    e, f, g, h = (b - a) % P, (d - c) % P, (d + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def pt_double(p):
    """a=-1 doubling (dbl-2008-hwcd); also complete."""
    X1, Y1, Z1, _ = p
    a = X1 * X1 % P
    b = Y1 * Y1 % P
    c = 2 * Z1 * Z1 % P
    h = (a + b) % P
    e = (h - (X1 + Y1) * (X1 + Y1)) % P
    g = (a - b) % P
    f = (c + g) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def scalar_mult(k: int, p):
    acc = _IDENT
    while k:
        if k & 1:
            acc = pt_add(acc, p)
        p = pt_double(p)
        k >>= 1
    return acc


def pt_equal(p, q) -> bool:
    """Projective equality: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1."""
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and \
        (Y1 * Z2 - Y2 * Z1) % P == 0


def to_affine(p) -> tuple[int, int]:
    X, Y, Z, _ = p
    zi = pow(Z, -1, P)
    return (X * zi % P, Y * zi % P)


def from_affine(x: int, y: int):
    return (x, y, 1, x * y % P)


def on_curve(x: int, y: int) -> bool:
    """-x^2 + y^2 == 1 + d*x^2*y^2 (mod p)."""
    x2, y2 = x * x % P, y * y % P
    return (y2 - x2 - 1 - D * x2 % P * y2) % P == 0


def is_small_order(pt) -> bool:
    """Order divides 8 <=> [8]P is the identity (torsion points)."""
    e = pt_double(pt_double(pt_double(pt)))
    return e[0] % P == 0 and (e[1] - e[2]) % P == 0


# -- encoding (RFC 8032 §5.1.2/5.1.3) --

def encode_point(x: int, y: int) -> bytes:
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decode_point(raw: bytes) -> Optional[tuple[int, int]]:
    """32 bytes -> affine (x, y), or None. STRICT: a non-canonical y
    (y >= p) is rejected — Go's edwards25519 SetBytes does the same —
    so every accepted point has exactly one encoding."""
    if len(raw) != 32:
        return None
    v = int.from_bytes(raw, "little")
    sign = v >> 255
    y = v & ((1 << 255) - 1)
    if y >= P:
        return None                      # non-canonical encoding
    # recover x: x^2 = (y^2 - 1) / (d y^2 + 1)
    u = (y * y - 1) % P
    den = (D * y % P * y + 1) % P
    # p = 5 mod 8: candidate root x = (u/den)^((p+3)/8)
    #            = u * den^3 * (u * den^7)^((p-5)/8)
    x = u * pow(den, 3, P) % P * pow(u * pow(den, 7, P) % P,
                                     (P - 5) // 8, P) % P
    if x * x % P * den % P != u:
        x = x * pow(2, (P - 1) // 4, P) % P     # sqrt(-1) correction
        if x * x % P * den % P != u:
            return None                  # not a curve point
    if x == 0 and sign:
        return None                      # -0 encoding is non-canonical
    if x & 1 != sign:
        x = P - x
    return (x, y)


# -- keys / sign (RFC 8032 §5.1.5/5.1.6) --

def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def generate_seed() -> bytes:
    return secrets.token_bytes(32)


def public_from_seed(seed: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    return encode_point(*to_affine(scalar_mult(a, from_affine(BX, BY))))


def sign(seed: bytes, msg: bytes) -> bytes:
    """Deterministic RFC 8032 signature (R || S, 64 bytes)."""
    h = hashlib.sha512(seed).digest()
    a, prefix = _clamp(h[:32]), h[32:]
    pk = public_from_seed(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(),
                       "little") % L
    renc = encode_point(*to_affine(scalar_mult(r, from_affine(BX, BY))))
    k = int.from_bytes(hashlib.sha512(renc + pk + msg).digest(),
                       "little") % L
    s = (r + k * a) % L
    return renc + s.to_bytes(32, "little")


# -- verification: ONE gate/prep implementation for host and device --

def prep_verify(pk: bytes, signature: bytes, msg: bytes
                ) -> Optional[tuple[int, int, int, int, int, int]]:
    """Host-side gates + device operand staging for one lane.

    Applies the FULL acceptance policy short of the curve equation
    (canonical encodings, S < L, small-order rejection, on-curve
    decompression) and derives the SHA-512 challenge. Returns
    (s, k, neg_ax, ay, rx, ry) — the exact operands the device kernel
    consumes for its [S]B + [k](-A) == R check — or None when the lane
    is host-rejected. `verify` below consumes the SAME tuple, so a
    policy change here cannot desynchronize the two paths (the
    `host_prep_scalars` discipline from the P-256 path)."""
    if len(signature) != 64 or len(pk) != 32:
        return None
    a_pt = decode_point(pk)
    if a_pt is None:
        return None
    r_pt = decode_point(signature[:32])
    if r_pt is None:
        return None
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return None                      # malleable / non-canonical S
    if is_small_order(from_affine(*a_pt)) or \
            is_small_order(from_affine(*r_pt)):
        return None                      # torsion identity/nonce
    k = int.from_bytes(
        hashlib.sha512(signature[:32] + pk + msg).digest(),
        "little") % L
    ax, ay = a_pt
    rx, ry = r_pt
    return (s, k, (P - ax) % P, ay, rx, ry)


def verify(pk: bytes, signature: bytes, msg: bytes) -> bool:
    """Exact Ed25519 verify under the module policy (the oracle)."""
    prep = prep_verify(pk, signature, msg)
    if prep is None:
        return False
    s, k, neg_ax, ay, rx, ry = prep
    # the device formulation, over host ints: [S]B + [k](-A) == R
    acc = pt_add(scalar_mult(s, from_affine(BX, BY)),
                 scalar_mult(k, from_affine(neg_ax, ay)))
    return pt_equal(acc, from_affine(rx, ry))
