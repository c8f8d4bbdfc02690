"""P-256 curve constants and the complete group law on limb tensors.

Port of fabric_tpu/ops/p256.py (constants, the Python-int reference and
the limb-tensor `cadd`/`cdbl`). The verify check is projective, with no
field inversion: accept iff R != ∞ and X ≡ r*Z or X ≡ (r+n)*Z (mod p),
the second candidate covering the x mod n wrap.

  * Complete projective addition (Renes–Costello–Batina 2015, Alg. 1,
    homogeneous (X:Y:Z)): one branchless formula for P+Q, P+P, P+∞ and
    P+(−P) on a prime-order curve.
  * Exception-free doubling (RCB15 Alg. 6, a = -3).
  * The generic verify core (`verify_core`): u1 = e*w, u2 = r*w mod n
    and R = u1*G + u2*Q by a 2-bit Shamir ladder (`double_scalar_mul`)
    for batches whose keys have no comb tables.

The torch versions follow the RCB15 operation sequence step for step,
so their semi-reduced outputs equal the JAX package's limb for limb.
They are the plain versions: on the card the ladder is one kernel
(ops/verify.py, csrc/ladder.cu).
"""

from __future__ import annotations

import torch

from fabric_tpu_torch.ops import limb
from fabric_tpu_torch.ops.limb import L, Mod

# NIST P-256 (FIPS 186-4) domain parameters
P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
B3 = (3 * B) % P
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5

FP = Mod(P)
FN = Mod(N)

_ONE_LIMBS = limb.int_to_limbs(1)
A_LIMBS = limb.int_to_limbs(A)
B_LIMBS = limb.int_to_limbs(B)
B3_LIMBS = limb.int_to_limbs(B3)


# ---------------------------------------------------------------------------
# Reference implementation over Python ints
# ---------------------------------------------------------------------------

def cadd_int(p1, p2):
    """Complete projective addition over Python ints (RCB15 Alg. 1)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    t0 = X1 * X2 % P
    t1 = Y1 * Y2 % P
    t2 = Z1 * Z2 % P
    t3 = (X1 + Y1) * (X2 + Y2) % P
    t3 = (t3 - t0 - t1) % P
    t4 = (X1 + Z1) * (X2 + Z2) % P
    t4 = (t4 - t0 - t2) % P
    t5 = (Y1 + Z1) * (Y2 + Z2) % P
    t5 = (t5 - t1 - t2) % P
    Z3 = (A * t4 + B3 * t2) % P
    X3 = (t1 - Z3) % P
    Z3 = (t1 + Z3) % P
    Y3 = X3 * Z3 % P
    t1 = (t0 + t0 + t0 + A * t2) % P
    t2 = (t0 - A * t2) % P * A % P
    t4 = (B3 * t4 + t2) % P
    Y3 = (Y3 + t1 * t4) % P
    X3 = (t3 * X3 - t5 * t4) % P
    Z3 = (t5 * Z3 + t3 * t1) % P
    return (X3, Y3, Z3)


def cadd4_int(p1, p2):
    """Complete projective addition over Python ints by RCB15 Alg. 4
    (a = -3), step for step as the CUDA kernels' `pt_add`
    (csrc/p256_field.cuh): on canonical inputs the outputs equal the
    kernels' words. The same group element as cadd_int, another
    projective representative."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    t0 = X1 * X2 % P
    t1 = Y1 * Y2 % P
    t2 = Z1 * Z2 % P
    t3 = ((X1 + Y1) * (X2 + Y2) - t0 - t1) % P
    t4 = ((Y1 + Z1) * (Y2 + Z2) - t1 - t2) % P
    Y3 = ((X1 + Z1) * (X2 + Z2) - t0 - t2) % P
    X3 = 3 * (Y3 - B * t2) % P
    Z3 = (t1 - X3) % P
    X3 = (t1 + X3) % P
    t2 = 3 * t2 % P
    Y3 = 3 * (B * Y3 - t2 - t0) % P
    t0 = (3 * t0 - t2) % P
    t1 = t4 * Y3 % P
    t2 = t0 * Y3 % P
    Y3 = (X3 * Z3 + t2) % P
    X3 = (t3 * X3 - t1) % P
    Z3 = (t4 * Z3 + t3 * t0) % P
    return (X3, Y3, Z3)


def cdbl_int(p1):
    """Exception-free projective doubling over ints (RCB15 Alg. 6,
    a = -3): handles infinity and 2-torsion."""
    X, Y, Z = p1
    t0 = X * X % P
    t1 = Y * Y % P
    t2 = Z * Z % P
    t3 = X * Y % P
    t3 = (t3 + t3) % P
    Z3 = X * Z % P
    Z3 = (Z3 + Z3) % P
    Y3 = B * t2 % P
    Y3 = (Y3 - Z3) % P
    X3 = (Y3 + Y3) % P
    Y3 = (X3 + Y3) % P
    X3 = (t1 - Y3) % P
    Y3 = (t1 + Y3) % P
    Y3 = X3 * Y3 % P
    X3 = X3 * t3 % P
    t3 = (t2 + t2) % P
    t2 = (t2 + t3) % P
    Z3 = B * Z3 % P
    Z3 = (Z3 - t2) % P
    Z3 = (Z3 - t0) % P
    t3 = (Z3 + Z3) % P
    Z3 = (Z3 + t3) % P
    t3 = (t0 + t0) % P
    t0 = (t3 + t0) % P
    t0 = (t0 - t2) % P
    t0 = t0 * Z3 % P
    Y3 = (Y3 + t0) % P
    t0 = Y * Z % P
    t0 = (t0 + t0) % P
    Z3 = t0 * Z3 % P
    X3 = (X3 - Z3) % P
    Z3 = t0 * t1 % P
    Z3 = (Z3 + Z3) % P
    Z3 = (Z3 + Z3) % P
    return (X3, Y3, Z3)


def scalar_mul_int(k, pt):
    """Double-and-add over ints using cadd_int (host/test helper)."""
    acc = (0, 1, 0)
    for bit in bin(k)[2:] if k else "":
        acc = cadd_int(acc, acc)
        if bit == "1":
            acc = cadd_int(acc, pt)
    return acc


def to_affine_int(pt):
    X, Y, Z = pt
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    return (X * zi % P, Y * zi % P)


# ---------------------------------------------------------------------------
# Limb-tensor implementation
# ---------------------------------------------------------------------------

def _const_like(limbs, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(limbs, device=like.device).expand(like.shape)


def cadd(p1, p2):
    """Complete projective addition over limb tensors.

    p1, p2: tuples of (…, L) int32 semi-reduced coordinates. Mirrors
    cadd_int exactly (the same RCB15 Alg. 1 sequence)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    a = _const_like(A_LIMBS, X1)
    b3 = _const_like(B3_LIMBS, X1)
    t0 = FP.mulmod(X1, X2)
    t1 = FP.mulmod(Y1, Y2)
    t2 = FP.mulmod(Z1, Z2)
    t3 = FP.mulmod(FP.addmod(X1, Y1), FP.addmod(X2, Y2))
    t3 = FP.submod(FP.submod(t3, t0), t1)
    t4 = FP.mulmod(FP.addmod(X1, Z1), FP.addmod(X2, Z2))
    t4 = FP.submod(FP.submod(t4, t0), t2)
    t5 = FP.mulmod(FP.addmod(Y1, Z1), FP.addmod(Y2, Z2))
    t5 = FP.submod(FP.submod(t5, t1), t2)
    Z3 = FP.addmod(FP.mulmod(a, t4), FP.mulmod(b3, t2))
    X3 = FP.submod(t1, Z3)
    Z3 = FP.addmod(t1, Z3)
    Y3 = FP.mulmod(X3, Z3)
    at2 = FP.mulmod(a, t2)
    n_t1 = FP.addmod(FP.addmod(t0, t0), FP.addmod(t0, at2))
    n_t2 = FP.mulmod(FP.submod(t0, at2), a)
    n_t4 = FP.addmod(FP.mulmod(b3, t4), n_t2)
    Y3 = FP.addmod(Y3, FP.mulmod(n_t1, n_t4))
    X3 = FP.submod(FP.mulmod(t3, X3), FP.mulmod(t5, n_t4))
    Z3 = FP.addmod(FP.mulmod(t5, Z3), FP.mulmod(t3, n_t1))
    return X3, Y3, Z3


def cdbl(p1):
    """Exception-free projective doubling over limb tensors (RCB15
    Alg. 6, a = -3): 8 multiplies against the complete add's 17.
    Mirrors cdbl_int exactly."""
    X, Y, Z = p1
    b = _const_like(B_LIMBS, X)
    t0 = FP.mulmod(X, X)
    t1 = FP.mulmod(Y, Y)
    t2 = FP.mulmod(Z, Z)
    t3 = FP.mulmod(X, Y)
    t3 = FP.addmod(t3, t3)
    Z3 = FP.mulmod(X, Z)
    Z3 = FP.addmod(Z3, Z3)
    Y3 = FP.mulmod(b, t2)
    Y3 = FP.submod(Y3, Z3)
    X3 = FP.addmod(Y3, Y3)
    Y3 = FP.addmod(X3, Y3)
    X3 = FP.submod(t1, Y3)
    Y3 = FP.addmod(t1, Y3)
    Y3 = FP.mulmod(X3, Y3)
    X3 = FP.mulmod(X3, t3)
    t3 = FP.addmod(t2, t2)
    t2 = FP.addmod(t2, t3)
    Z3 = FP.mulmod(b, Z3)
    Z3 = FP.submod(Z3, t2)
    Z3 = FP.submod(Z3, t0)
    t3 = FP.addmod(Z3, Z3)
    Z3 = FP.addmod(Z3, t3)
    t3 = FP.addmod(t0, t0)
    t0 = FP.addmod(t3, t0)
    t0 = FP.submod(t0, t2)
    t0 = FP.mulmod(t0, Z3)
    Y3 = FP.addmod(Y3, t0)
    t0 = FP.mulmod(Y, Z)
    t0 = FP.addmod(t0, t0)
    Z3 = FP.mulmod(t0, Z3)
    X3 = FP.submod(X3, Z3)
    Z3 = FP.mulmod(t0, t1)
    Z3 = FP.addmod(Z3, Z3)
    Z3 = FP.addmod(Z3, Z3)
    return X3, Y3, Z3


def projective_check(X, Z, r, rpn, premask):
    """(…, L) projective X, Z of R = u1*G + u2*Q -> (…,) accept mask:
    premask ∧ Z ≢ 0 ∧ (X ≡ r*Z ∨ X ≡ rpn*Z mod p)."""
    nonzero = (FP.canonical(Z) != 0).any(dim=-1)
    xc = FP.canonical(X)
    ok1 = (xc == FP.canonical(FP.mulmod(r, Z))).all(dim=-1)
    ok2 = (xc == FP.canonical(FP.mulmod(rpn, Z))).all(dim=-1)
    return premask.to(torch.bool) & nonzero & (ok1 | ok2)


# ---------------------------------------------------------------------------
# The Shamir ladder and the generic verify core
# ---------------------------------------------------------------------------

def _select_point(idx, table):
    """Branchless 2^k-way select: idx (B,) in [0, len(table)); table =
    points as tuples of (B, L) coordinate tensors. A balanced select tree
    (log2 depth), as fabric_tpu's `_select_point`."""
    w = idx[:, None]

    def tree(lo_i, coords):
        if len(coords) == 1:
            return coords[0]
        half = len(coords) // 2
        lo = tree(lo_i, coords[:half])
        hi = tree(lo_i + half, coords[half:])
        return torch.where(w < lo_i + half, lo, hi)

    return tuple(tree(0, [t[c] for t in table]) for c in range(3))


def _g_multiple(k: int):
    x, y = to_affine_int(scalar_mul_int(k, (GX, GY, 1)))
    return limb.int_to_limbs(x), limb.int_to_limbs(y)


_G_MULTIPLES = [_g_multiple(k) for k in (1, 2, 3)]


def _bits2(scalar, k: int):
    """Bits k (low) and k + 1 (high) of (B, L) canonical limbs, as
    lo + 2*hi."""
    lo = (scalar[:, k // limb.W] >> (k % limb.W)) & 1
    hi = (scalar[:, (k + 1) // limb.W] >> ((k + 1) % limb.W)) & 1
    return lo + 2 * hi


def double_scalar_mul(u1, u2, qx, qy):
    """R = u1*G + u2*Q for a batch: u1, u2 canonical (B, L) scalars,
    (qx, qy) affine points (B, L). Returns projective (X, Y, Z).

    fabric_tpu's `double_scalar_mul`, step for step: a 16-entry table
    table[i + 4*j] = i*G + j*Q (the G column host constants, the Q side
    11 complete operations), then 128 steps of two doublings and one
    complete add of the entry chosen by bits (254 - 2i, 255 - 2i) of u1
    and u2."""
    B = u1.shape[0]
    dev = u1.device
    ones = torch.as_tensor(_ONE_LIMBS, device=dev).expand(B, L).clone()
    zeros = torch.zeros((B, L), dtype=torch.int32, device=dev)
    inf = (zeros, ones, zeros)
    g_pts = [None] + [tuple(torch.as_tensor(c, device=dev).expand(B, L)
                            for c in (x, y, _ONE_LIMBS))
                      for x, y in _G_MULTIPLES]
    q1 = (qx, qy, ones)
    q2 = cdbl(q1)
    q3 = cadd(q2, q1)
    q_pts = [None, q1, q2, q3]
    table = [inf] + g_pts[1:]
    for j in range(1, 4):
        table.append(q_pts[j])
        for i in range(1, 4):
            table.append(cadd(g_pts[i], q_pts[j]))
    acc = inf
    for i in range(128):
        acc = cdbl(cdbl(acc))
        k = 254 - 2 * i
        sel = _select_point(_bits2(u1, k) + 4 * _bits2(u2, k), table)
        acc = cadd(acc, sel)
    return acc


def verify_core(digest_words, qx, qy, r, rpn, w, premask):
    """Batched ECDSA-P256 accept/reject (fabric_tpu's `verify_core`).

    digest_words: (B, 8) big-endian SHA-256 digest words (int64 masked
        to 32 bits, or int32/uint32 bits).
    qx, qy: (B, L) canonical limbs of the public key's affine point (the
        host guarantees it is on the curve, as the reference does at key
        import).
    r, rpn: (B, L) canonical limbs of r and of r + n if r + n < p else r.
    w: (B, L) canonical limbs of s^-1 mod n.
    premask: (B,) bool host-side DER/range/low-S validity.
    Returns (B,) bool accept mask."""
    e = limb.words_be_to_limbs(digest_words.to(torch.int64) & 0xFFFFFFFF)
    u1 = FN.canonical(FN.mulmod(e, w))
    u2 = FN.canonical(FN.mulmod(r, w))
    X, _, Z = double_scalar_mul(u1, u2, qx, qy)
    return projective_check(X, Z, r, rpn, premask)
