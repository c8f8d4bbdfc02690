"""BLS12-381 pairing and aggregate BLS signatures — exact Python-int
reference.

The port's copy of fabric_tpu/ops/bls12_381_ref.py (stdlib only; the
port imports nothing of fabric_tpu). It is the host oracle of the
batched aggregate-verify kernels (ops/bls12_381_kernel.py,
csrc/bls12_381_pairing.cu), the staged host path (ops/bls12_381.py)
and the sw provider's BLS keys. It is deliberately the SIMPLEST correct
formulation, not a fast one:

  * tower Fp -> Fp2 = Fp[u]/(u^2+1) -> Fp6 = Fp2[v]/(v^3 - (1+u))
    -> Fp12 = Fp6[w]/(w^2 - v);
  * G2 points untwist into E(Fp12) — the M-type twist divides by w^2 /
    w^3 where BN254's D-type multiplied — so the Miller loop is plain
    affine chord-and-tangent lines;
  * the BLS12 ate pairing f_{|x|,Q}(P) over x = -0xd201000000010000,
    with no Frobenius correction steps; with x negative this computes
    e(P, Q)^-1, which is all a product-equals-one check consumes;
  * `final_exponentiation_chain` is the Hayashida-Hayasaka-Teruya chain
    the card's program follows (= final_exponentiation_fast^3, the same
    verdict since gcd(3, r) = 1).

Signatures are min-sig BLS: sk in Zr, pk = sk*G2 on the twist, sig =
sk*H(m) in G1; a span's signatures aggregate to one 96-byte G1 point.
Verify: e(sig, -G2) * prod_i e(H(m_i), pk_i) == 1. Group arithmetic for
keygen, signing, hashing and the subgroup checks runs on plain Fp / Fp2
Jacobian ladders.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_BLS = 0xD201000000010000          # |x|; the BLS parameter is -|x|

# cofactors: h1 clears G1 hash outputs into the order-r subgroup; h2
# is only documented here (subgroup membership is CHECKED, not forced)
H1 = 0x396C8C005555E1568C00AAAB0000AAAB

G1 = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

B_G1 = 4                             # E:  y^2 = x^3 + 4
XI = (1, 1)                          # v^3 = 1 + u; twist b' = 4*XI


# ---------------------------------------------------------------------------
# Tower arithmetic over Python ints (the bn254_ref shapes, XI = 1+u)
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * d % P, -a[1] * d % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_mul(a, b):
    c0, c1, c2 = a
    d0, d1, d2 = b
    t0, t1, t2 = f2_mul(c0, d0), f2_mul(c1, d1), f2_mul(c2, d2)
    r0 = f2_add(t0, f2_mul(XI, f2_add(f2_mul(c1, d2), f2_mul(c2, d1))))
    r1 = f2_add(f2_add(f2_mul(c0, d1), f2_mul(c1, d0)),
                f2_mul(XI, t2))
    r2 = f2_add(f2_add(f2_mul(c0, d2), f2_mul(c2, d0)), t1)
    return (r0, r1, r2)


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_inv(a):
    c0, c1, c2 = a
    t0 = f2_sub(f2_mul(c0, c0), f2_mul(XI, f2_mul(c1, c2)))
    t1 = f2_sub(f2_mul(XI, f2_mul(c2, c2)), f2_mul(c0, c1))
    t2 = f2_sub(f2_mul(c1, c1), f2_mul(c0, c2))
    norm = f2_add(f2_mul(c0, t0),
                  f2_mul(XI, f2_add(f2_mul(c2, t1), f2_mul(c1, t2))))
    ninv = f2_inv(norm)
    return (f2_mul(t0, ninv), f2_mul(t1, ninv), f2_mul(t2, ninv))


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def _f6_mul_v(t):
    """Multiply an Fp6 element by v (w^2 = v, v^3 = XI)."""
    return (f2_mul(XI, t[2]), t[0], t[1])


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    r0 = f6_add(t0, _f6_mul_v(t1))
    r1 = f6_add(f6_mul(a0, b1), f6_mul(a1, b0))
    return (r0, r1)


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_inv(a):
    a0, a1 = a
    t1 = f6_mul(a1, a1)
    norm = f6_sub(f6_mul(a0, a0), _f6_mul_v(t1))
    ninv = f6_inv(norm)
    return (f6_mul(a0, ninv),
            f6_sub(F6_ZERO, f6_mul(a1, ninv)))


def f12_pow(a, e: int):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_mul(base, base)
        e >>= 1
    return out


def f12_conj(a):
    """x -> x^(p^6): conjugation over Fp6 (negate the w half)."""
    return (a[0], f6_sub(F6_ZERO, a[1]))


def f12_eq(a, b) -> bool:
    return a == b


def f12_scalar(x: int):
    return (((x % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


F12_W = (F6_ZERO, F6_ONE)
F12_W2 = f12_mul(F12_W, F12_W)
F12_W3 = f12_mul(F12_W2, F12_W)
F12_W2_INV = f12_inv(F12_W2)
F12_W3_INV = f12_inv(F12_W3)


# ---------------------------------------------------------------------------
# Curve over Fp12 (affine; None = infinity) — the certain-but-slow ops
# ---------------------------------------------------------------------------

def ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if f12_eq(x1, x2):
        if f12_eq(y1, y2):
            if f12_eq(y1, F12_ZERO):
                return None
            lam = f12_mul(f12_mul(f12_scalar(3), f12_mul(x1, x1)),
                          f12_inv(f12_mul(f12_scalar(2), y1)))
        else:
            return None
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_mul(lam, lam), x1), x2)
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    return (x3, y3)


def ec_mul(k: int, p):
    out = None
    for bit in bin(k)[2:] if k else "":
        out = ec_add(out, out)
        if bit == "1":
            out = ec_add(out, p)
    return out


def ec_neg(p):
    if p is None:
        return None
    return (p[0], f12_sub(F12_ZERO, p[1]))


def untwist(q):
    """E'(Fp2) affine (x, y) -> E(Fp12): the M-type map
    (x/w^2, y/w^3) — check: (y/w^3)^2 = (x/w^2)^3 + 4 pulls back to
    y^2 = x^3 + 4*XI, the twist equation."""
    if q is None:
        return None
    (x, y) = q
    ex = (((x[0], x[1]), F2_ZERO, F2_ZERO), F6_ZERO)
    ey = (((y[0], y[1]), F2_ZERO, F2_ZERO), F6_ZERO)
    return (f12_mul(ex, F12_W2_INV), f12_mul(ey, F12_W3_INV))


def _retwist(p12):
    x = f12_mul(p12[0], F12_W2)
    y = f12_mul(p12[1], F12_W3)
    return ((x[0][0][0], x[0][0][1]), (y[0][0][0], y[0][0][1]))


def g1_embed(p):
    if p is None:
        return None
    return (f12_scalar(p[0]), f12_scalar(p[1]))


def on_curve_g1(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B_G1) % P == 0


def on_curve_g2(q) -> bool:
    if q is None:
        return True
    x, y = q
    lhs = f2_mul(y, y)
    rhs = f2_add(f2_mul(x, f2_mul(x, x)), f2_mul((B_G1, 0), XI))
    return lhs == rhs


# ---------------------------------------------------------------------------
# Miller loop + pairing (BLS12 shape: no correction steps)
# ---------------------------------------------------------------------------

def _line(t, q, p):
    """l_{T,Q}(P) for affine T, Q, P on E(Fp12)."""
    xt, yt = t
    xq, yq = q
    xp, yp = p
    if f12_eq(xt, xq) and not f12_eq(yt, yq):
        return f12_sub(xp, xt)            # vertical
    if f12_eq(xt, xq):
        lam = f12_mul(f12_mul(f12_scalar(3), f12_mul(xt, xt)),
                      f12_inv(f12_mul(f12_scalar(2), yt)))
    else:
        lam = f12_mul(f12_sub(yq, yt), f12_inv(f12_sub(xq, xt)))
    return f12_sub(f12_sub(yp, yt), f12_mul(lam, f12_sub(xp, xt)))


def miller_loop(q_tw, p, loop: int = X_BLS) -> tuple:
    """f_{loop, Q}(P): q_tw affine E'(Fp2) (or None), p affine G1 (or
    None). Plain double-and-add over the loop bits — BLS12 curves need
    none of the BN optimal-ate Frobenius corrections. Returns an Fp12
    element (ONE for infinity inputs)."""
    if q_tw is None or p is None:
        return F12_ONE
    q = untwist(q_tw)
    pe = g1_embed(p)
    f = F12_ONE
    t = q
    for bit in bin(loop)[3:]:
        f = f12_mul(f12_mul(f, f), _line(t, t, pe))
        t = ec_add(t, t)
        if bit == "1":
            f = f12_mul(f, _line(t, q, pe))
            t = ec_add(t, q)
    return f


@lru_cache(maxsize=None)
def _final_exp_exponent() -> int:
    return (P ** 12 - 1) // R


def final_exponentiation(f) -> tuple:
    """One pow by (p^12-1)/r — slow and certain. The easy-part
    shortcut (conj * inv, then the hard exponent) is ~3x cheaper and
    pinned against this in tests; aggregate verify uses it."""
    return f12_pow(f, _final_exp_exponent())


@lru_cache(maxsize=None)
def _hard_exponent() -> int:
    # after the easy part f^((p^6-1)(p^2+1)), what remains of
    # (p^12-1)/r is (p^4 - p^2 + 1)/r
    return (P ** 4 - P ** 2 + 1) // R


def final_exponentiation_fast(f) -> tuple:
    """Easy part via conjugate/inverse and x^(p^2) (coefficient-wise
    Frobenius^2), then a single pow by the ~1270-bit hard exponent —
    the structure the batched aggregate check shares across its ONE
    final exp per call."""
    m = f12_mul(f12_conj(f), f12_inv(f))          # f^(p^6-1)
    m = f12_mul(_frob2(m), m)                     # ^(p^2+1)
    return f12_pow(m, _hard_exponent())


@lru_cache(maxsize=None)
def _frob2_gammas() -> tuple:
    """gamma_i = (w^i)^(p^2-1) for i = 0..5, each an Fp scalar (the
    p^2-Frobenius fixes Fp2 elementwise, so x^(p^2) multiplies the
    w^i basis coefficient by gamma_i)."""
    g = pow_xi((P * P - 1) // 6)
    assert g[1] == 0, "gamma must be an Fp scalar"
    out = []
    for i in range(6):
        out.append(pow(g[0], i, P))
    return tuple(out)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


@lru_cache(maxsize=None)
def _frob_gammas() -> tuple:
    """gamma_k = xi^(k*(p-1)/6) in Fp2: the p-power Frobenius sends
    the coefficient c of w^k to conj(c) * gamma_k."""
    return tuple(pow_xi(k * (P - 1) // 6) for k in range(6))


def f12_frob(a):
    """x -> x^p on Fp12 (coefficient-wise Fp2 conjugation times the
    gamma constants; w-exponents 0,2,4 / 1,3,5 across the halves)."""
    g = _frob_gammas()
    (c0, c1, c2), (c3, c4, c5) = a
    return ((f2_conj(c0),
             f2_mul(f2_conj(c1), g[2]),
             f2_mul(f2_conj(c2), g[4])),
            (f2_mul(f2_conj(c3), g[1]),
             f2_mul(f2_conj(c4), g[3]),
             f2_mul(f2_conj(c5), g[5])))


def final_exponentiation_chain(f) -> tuple:
    """The DEVICE-SHAPED final exponentiation: easy part, then the
    Hayashida-Hayasaka-Teruya addition chain for the BLS12 family,

        3*(p^4 - p^2 + 1)/r = (x-1)^2 * (x+p) * (x^2 + p^2 - 1) + 3

    with x = -|x| (so pow-by-|x| plus cyclotomic conjugations — every
    step is a static square-and-multiply, a Frobenius or a conjugate,
    exactly the op set of the tower's register machine). Returns
    final_exponentiation_fast(f)**3; since Phi_12(p) = p^4 - p^2 + 1
    is ~1 mod 3, gcd(3, r) = 1 and the cube is 1 iff the fast result
    is 1 — equivalent for every product-equals-one check. Pinned
    against the single-pow oracle in tests; the device final-exp
    program mirrors this chain instruction for instruction."""
    m = f12_mul(f12_conj(f), f12_inv(f))          # f^(p^6-1)
    m = f12_mul(_frob2(m), m)                     # ^(p^2+1)
    u = X_BLS
    t0 = f12_mul(f12_pow(m, u), m)                # m^(u+1) = m^-(x-1)
    y1 = f12_mul(f12_pow(t0, u), t0)              # m^((x-1)^2)
    y2 = f12_mul(f12_conj(f12_pow(y1, u)),
                 f12_frob(y1))                    # y1^(x+p)
    y3 = f12_mul(f12_mul(f12_pow(f12_pow(y2, u), u),
                         _frob2(y2)),
                 f12_conj(y2))                    # y2^(x^2+p^2-1)
    m3 = f12_mul(f12_mul(m, m), m)
    return f12_mul(y3, m3)


def pow_xi(e: int) -> tuple:
    out = F2_ONE
    base = XI
    while e:
        if e & 1:
            out = f2_mul(out, base)
        base = f2_mul(base, base)
        e >>= 1
    return out


def _frob2(a):
    """x -> x^(p^2) on Fp12: Fp2 coefficients are fixed; the basis
    element w^(2i) (resp. w^(2i+1)) picks up gamma_(2i) (gamma_(2i+1))
    with gamma_i = xi^(i*(p^2-1)/6) in Fp."""
    g = _frob2_gammas()
    (c0, c1, c2), (c3, c4, c5) = a
    scale = lambda c, s: (c[0] * s % P, c[1] * s % P)  # noqa: E731
    return ((scale(c0, g[0]), scale(c1, g[2]), scale(c2, g[4])),
            (scale(c3, g[1]), scale(c4, g[3]), scale(c5, g[5])))


def pairing(q_tw, p) -> tuple:
    return final_exponentiation(miller_loop(q_tw, p))


# ---------------------------------------------------------------------------
# Fast Jacobian group arithmetic (plain Fp / Fp2 — keygen, signing,
# hashing, subgroup checks; differential-tested vs the embedded ops)
# ---------------------------------------------------------------------------

def _jac_ops(two):
    """(add, sub, mul, zero) for Fp (two=False) or Fp2 (two=True)."""
    if two:
        return (f2_add, f2_sub, f2_mul, F2_ZERO)
    return (lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
            lambda a, b: a * b % P, 0)


def _jac_dbl(pt, two):
    fadd, fsub, fmul, fzero = _jac_ops(two)
    X, Y, Z = pt
    if Z == fzero or Y == fzero:
        return None
    A = fmul(X, X)
    B = fmul(Y, Y)
    C = fmul(B, B)
    D = fsub(fmul(fadd(X, B), fadd(X, B)), fadd(A, C))
    D = fadd(D, D)
    E = fadd(fadd(A, A), A)
    F = fmul(E, E)
    X3 = fsub(F, fadd(D, D))
    c8 = fadd(fadd(fadd(C, C), fadd(C, C)), fadd(fadd(C, C),
                                                 fadd(C, C)))
    Y3 = fsub(fmul(E, fsub(D, X3)), c8)
    Z3 = fmul(fadd(Y, Y), Z)
    return (X3, Y3, Z3)


def _jac_add(p1, p2, two):
    fadd, fsub, fmul, fzero = _jac_ops(two)
    if p1 is None or p1[2] == fzero:
        return p2
    if p2 is None or p2[2] == fzero:
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = fmul(Z1, Z1)
    Z2Z2 = fmul(Z2, Z2)
    U1 = fmul(X1, Z2Z2)
    U2 = fmul(X2, Z1Z1)
    S1 = fmul(fmul(Y1, Z2), Z2Z2)
    S2 = fmul(fmul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 != S2:
            return None
        return _jac_dbl(p1, two)
    H = fsub(U2, U1)
    I = fmul(fadd(H, H), fadd(H, H))
    J = fmul(H, I)
    r = fadd(fsub(S2, S1), fsub(S2, S1))
    V = fmul(U1, I)
    X3 = fsub(fsub(fmul(r, r), J), fadd(V, V))
    S1J = fmul(S1, J)
    Y3 = fsub(fmul(r, fsub(V, X3)), fadd(S1J, S1J))
    Z3 = fmul(fmul(fsub(fmul(fadd(Z1, Z2), fadd(Z1, Z2)),
                        fadd(Z1Z1, Z2Z2)), H),
              (1 if not two else F2_ONE))
    return (X3, Y3, Z3)


def _jac_to_affine(pt, two):
    if pt is None:
        return None
    _, _, fmul, fzero = _jac_ops(two)
    X, Y, Z = pt
    if Z == fzero:
        return None
    zi = f2_inv(Z) if two else pow(Z, -1, P)
    zi2 = fmul(zi, zi)
    return (fmul(X, zi2), fmul(fmul(Y, zi2), zi))


def _jac_mul(k: int, aff, two):
    if aff is None or k == 0:
        return None
    one = F2_ONE if two else 1
    base = (aff[0], aff[1], one)
    acc = None
    for bit in bin(k)[2:]:
        acc = _jac_dbl(acc, two) if acc is not None else acc
        if bit == "1":
            acc = _jac_add(acc, base, two) if acc is not None else base
    return _jac_to_affine(acc, two)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    one = 1
    return _jac_to_affine(
        _jac_add((p1[0], p1[1], one), (p2[0], p2[1], one), False),
        False)


def g1_mul(k: int, p):
    return _jac_mul(k, p, False)


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % P)


def g2_add(q1, q2):
    if q1 is None:
        return q2
    if q2 is None:
        return q1
    return _jac_to_affine(
        _jac_add((q1[0], q1[1], F2_ONE), (q2[0], q2[1], F2_ONE), True),
        True)


def g2_mul(k: int, q):
    return _jac_mul(k, q, True)


def g2_neg(q):
    if q is None:
        return None
    return (q[0], f2_neg(q[1]))


def g1_in_subgroup(p) -> bool:
    return p is None or (on_curve_g1(p) and g1_mul(R, p) is None)


def g2_in_subgroup(q) -> bool:
    # memoized: the full-order scalar mult is ~255 Fp2 point ops of
    # host math, and the points reaching this gate per aggregate call
    # are a committee's handful of long-lived public keys (already
    # subgroup-checked once at key import) — cache the verdict so the
    # orderer's per-span aggregate check doesn't re-pay it. G2 points
    # are nested int tuples, hence hashable; the bound keeps an
    # adversarial stream of fresh untrusted points from growing it.
    return q is None or _g2_in_subgroup_memo(q)


@lru_cache(maxsize=4096)
def _g2_in_subgroup_memo(q) -> bool:
    return on_curve_g2(q) and g2_mul(R, q) is None


# ---------------------------------------------------------------------------
# min-sig BLS: sk in Zr, pk = sk*G2 (twist), sig = sk*H(m) in G1
# ---------------------------------------------------------------------------

def hash_to_g1(msg: bytes):
    """Try-and-increment onto E(Fp) (p = 3 mod 4 so sqrt is one pow),
    then clear the G1 cofactor so the output lands in the order-r
    subgroup. Deterministic; NOT the RFC 9380 SSWU encoding — this
    reference defines the scheme's message map, and both the host and
    (future) device paths share it."""
    ctr = 0
    while True:
        x = int.from_bytes(
            hashlib.sha256(b"ftpu-bls12381-g1|" + msg + b"|" +
                           ctr.to_bytes(4, "big")).digest(),
            "big") % P
        rhs = (x * x % P * x + B_G1) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P == rhs:
            if y & 1:
                y = P - y
            out = g1_mul(H1, (x, y))
            if out is not None:
                return out
        ctr += 1


def bls_keygen(seed: bytes):
    """(sk, pk): pk = sk*G2 affine on E'(Fp2)."""
    sk = int.from_bytes(
        hashlib.sha512(b"ftpu-bls12381-sk|" + seed).digest(),
        "big") % R
    sk = sk or 1
    return sk, g2_mul(sk, (G2_X, G2_Y))


def bls_sign(sk: int, msg: bytes):
    return g1_mul(sk, hash_to_g1(msg))


def bls_aggregate(sigs):
    """Sum of G1 signature points (None entries poison to None)."""
    acc = None
    for s in sigs:
        if s is None:
            return None
        acc = g1_add(acc, s)
    return acc


def bls_verify(pk, msg: bytes, sig) -> bool:
    """Single-signature oracle: e(sig, -G2) * e(H(m), pk) == 1."""
    return aggregate_verify([pk], [msg], sig)


def aggregate_verify(pks, msgs, agg_sig) -> bool:
    """prod_i e(H(m_i), pk_i) == e(agg_sig, G2): one Miller loop per
    pair, ONE shared final exponentiation — the batched structure the
    device path inherits. Subgroup-checks every input (a pk outside
    the order-r subgroup breaks aggregation soundness)."""
    if agg_sig is None or len(pks) != len(msgs) or not pks:
        return False
    if not g1_in_subgroup(agg_sig):
        return False
    f = miller_loop(g2_neg((G2_X, G2_Y)), agg_sig)
    for pk, msg in zip(pks, msgs):
        if pk is None or not g2_in_subgroup(pk):
            return False
        f = f12_mul(f, miller_loop(pk, hash_to_g1(msg)))
    return final_exponentiation_fast(f) == F12_ONE


# ---------------------------------------------------------------------------
# Serialization (uncompressed; infinity = all-zero)
# ---------------------------------------------------------------------------

def g1_to_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 96
    return p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big")


def g1_from_bytes(raw: bytes, subgroup_check: bool = True):
    if len(raw) != 96:
        raise ValueError("G1 point must be 96 bytes (uncompressed)")
    if raw == b"\x00" * 96:
        return None
    p = (int.from_bytes(raw[:48], "big"),
         int.from_bytes(raw[48:], "big"))
    if p[0] >= P or p[1] >= P or not on_curve_g1(p):
        raise ValueError("not a BLS12-381 G1 point")
    if subgroup_check and not g1_in_subgroup(p):
        raise ValueError("G1 point outside the order-r subgroup")
    return p


def g2_to_bytes(q) -> bytes:
    if q is None:
        return b"\x00" * 192
    (x0, x1), (y0, y1) = q
    return b"".join(v.to_bytes(48, "big") for v in (x0, x1, y0, y1))


def g2_from_bytes(raw: bytes, subgroup_check: bool = True):
    if len(raw) != 192:
        raise ValueError("G2 point must be 192 bytes (uncompressed)")
    if raw == b"\x00" * 192:
        return None
    v = [int.from_bytes(raw[i * 48:(i + 1) * 48], "big")
         for i in range(4)]
    if any(c >= P for c in v):
        raise ValueError("G2 coordinate out of range")
    q = ((v[0], v[1]), (v[2], v[3]))
    if not on_curve_g2(q):
        raise ValueError("not a BLS12-381 G2 point")
    if subgroup_check and not g2_in_subgroup(q):
        raise ValueError("G2 point outside the order-r subgroup")
    return q
