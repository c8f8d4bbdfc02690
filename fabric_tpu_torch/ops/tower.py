"""Fp2/Fp6/Fp12 pairing tower over Montgomery limb tensors, plain torch.

Port of fabric_tpu/ops/tower.py. The `Tower` is parameterized as the JAX
class is, by

  * ``F``       — a `mont.MontMod` context (BN254's 20-limb field);
  * ``xi``      — the sextic-twist non-residue as a small-int Fp2 pair
                  (BN254: 9 + u), expanded into add chains;
  * ``b3_tw``   — 3*b' on the twist, exact Fp2 ints;
  * ``gammas``  — xi^(k*(p-1)/6) for k = 0..5, the Frobenius constants;
  * ``mtwist``  — the sparse-line placement (D-type: slots w^0, w, w^3;
                  M-type: w^0, w^2, w^3).

The layout is the JAX package's: Fp2 = Fp[u]/(u^2+1) as (a0, a1);
Fp6 = Fp2[v]/(v^3 - xi) as (c0, c1, c2); Fp12 = Fp6[w]/(w^2 - v) as
(d0, d1), each Fp value a (..., L) int32 tensor of 13-bit limbs below
2m. Every method takes and returns the same nested tuples as the JAX
method of the same name and computes the same MontMod operations on the
same operands, so the limbs agree exactly. Where the JAX code runs
independent products one after another, this port stacks them along a
new leading axis and runs one MontMod call (`_muls`, `_f2_muls`): the
operations are elementwise over the leading axes, so every row is the
product the JAX code computes, in a fraction of the eager launches.

The JAX scans become Python loops: `pow_scan` and `Asm.pow_static`
branch on the exponent's static bits where the JAX code computes both
sides and selects (the same limbs), and `run_final_exp` walks the
program's rows. Lane-dependent choices (`select_pt`, `select_f12`)
stay selects.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Shape-only helpers (no field context)
# ---------------------------------------------------------------------------

def select_pt(mask, a, b):
    """Lane select between two Fp2 point triples; mask: (B,) bool."""
    m = mask[:, None]
    return tuple(
        (torch.where(m, x[0], y[0]), torch.where(m, x[1], y[1]))
        for x, y in zip(a, b))


def select_f12(mask, a, b):
    m = mask[:, None]
    return tuple(
        tuple((torch.where(m, x[0], y[0]), torch.where(m, x[1], y[1]))
              for x, y in zip(c6a, c6b))
        for c6a, c6b in zip(a, b))


def flat_from_f12(f):
    """Nested-tuple f12 -> (12, ...) stacked coeff tensor."""
    return torch.stack([c for half in f for fp2 in half for c in fp2])


def f12_from_flat(x):
    return tuple(
        tuple((x[h * 6 + j * 2], x[h * 6 + j * 2 + 1])
              for j in range(3))
        for h in range(2))


def pow_scan(x, e: int, mul, sqr):
    """Square-and-multiply by a static positive exponent, msb first
    (fabric_tpu's `pow_scan`, with a branch on each static bit where the
    scan selects)."""
    acc = x
    for b in bin(e)[3:]:                 # skip the leading 1
        acc = sqr(acc)
        if b == "1":
            acc = mul(acc, x)
    return acc


# -- the final-exp register machine (fabric_tpu.ops.tower) --

OP_MUL, OP_CONJ, OP_FROB = 0, 1, 2
NREG = 8


class Asm:
    """Assembles a final-exp chain into (op, dst, a, b) rows."""

    def __init__(self):
        self.rows = []

    def emit(self, op, dst, a, b=0):
        self.rows.append((op, dst, a, b))

    def mul(self, dst, a, b):
        self.emit(OP_MUL, dst, a, b)

    def sqr(self, dst, a):
        self.emit(OP_MUL, dst, a, a)

    def conj(self, dst, a):
        self.emit(OP_CONJ, dst, a)

    def frob(self, dst, a):
        self.emit(OP_FROB, dst, a)

    def copy(self, dst, a):
        self.conj(dst, a)            # conj . conj = identity
        self.conj(dst, dst)

    def pow_static(self, dst, src, tmp, e: int):
        """dst = src^e for a static positive e: square-and-multiply over
        e's bits (src, tmp, dst must be distinct registers)."""
        assert len({dst, src, tmp}) == 3 and e > 0
        self.copy(tmp, src)          # acc <- src (leading bit)
        for b in bin(e)[3:]:
            self.sqr(tmp, tmp)
            if b == "1":
                self.mul(tmp, tmp, src)
        self.copy(dst, tmp)

    def program(self) -> np.ndarray:
        return np.asarray(self.rows, dtype=np.int32)


# the easy part's last row: m = m^(p^2) * m (both curves' programs)
EASY_LAST = (OP_MUL, 2, 6, 2)


def cyclotomic_row(program) -> int:
    """The row from which the program's squarings square elements of the
    cyclotomic subgroup: the one after the easy part's `mul(2, 6, 2)`
    (every later squaring squares m or a value made from it; f and 1/f in
    registers 0 and 1 are overwritten before they are squared). A program
    without that row gets none (its length)."""
    rows = [tuple(r) for r in np.asarray(program).tolist()]
    return rows.index(EASY_LAST) + 1 if EASY_LAST in rows else len(rows)


# -- the cooperative pairing layer's schedule (csrc/pairing_coop.cuh) --
#
# Each round as its jobs' Fp products: an Fp2 product is three jobs of one
# Fp product (pairing_coop.cuh products), a domain conversion on load or
# store one, a sum, term or coefficient none. Thread t of a group of n
# runs jobs t, t + n, ..., so a round costs the thread with the most
# products that many in series (`chain`), and all of its jobs' products
# are executed (`executed`).

def coop_parts(n_f2: int, others: int = 0) -> tuple:
    return (1,) * (3 * n_f2) + (0,) * others


COOP_DBL_ROUNDS = (coop_parts(12 + 7), coop_parts(6, 6), coop_parts(13 + 3))
COOP_ADD_ROUNDS = (coop_parts(7), coop_parts(6), coop_parts(13 + 6))
# 1/f: a0^2 and a1^2, N's six products, the adjoint's three, the Fp2
# norm's inverse on one thread (2 squarings, 2 products, and 2 products
# by R^2 beside the binary Euclid algorithm, which holds no product), 1/N,
# a / N
COOP_INV_ROUNDS = (coop_parts(12), coop_parts(6), coop_parts(3), (6,),
                   coop_parts(3), coop_parts(12))
COOP_ROW_ROUNDS = {"cyc": coop_parts(9), "mul": coop_parts(18),
                   "frob": coop_parts(6), "conj": ()}


def coop_cost(rounds, group: int) -> tuple[int, int]:
    """(chain, executed) Fp products of `rounds` on a group of `group`."""
    chain = sum(max(sum(r[t::group]) for t in range(min(group, len(r))))
                for r in rounds if r)
    return chain, sum(sum(r) for r in rounds)


def coop_miller_products(loop: int, points: int, group: int
                         ) -> tuple[int, int]:
    """(chain, executed) Fp products of a Miller lane on a group: the load
    (2 + 4 `points` values), each doubling step's three product rounds,
    each set bit's addition step's three and one more addition step a
    further point, the store."""
    bits = bin(loop)[3:]
    dbl = coop_cost(COOP_DBL_ROUNDS, group)
    add = coop_cost(COOP_ADD_ROUNDS, group)
    ends = coop_cost(((1,) * (2 + 4 * points), (1,) * 12), group)
    n_add = bits.count("1") + points - 1
    return tuple(ends[i] + len(bits) * dbl[i] + n_add * add[i]
                 for i in range(2))


def coop_final_exp_products(program, nterms: int, group: int
                            ) -> tuple[int, int]:
    """(chain, executed) Fp products of a final-exp lane on a group: the
    terms' loads and product, 1/f's rounds, each row's product round (a
    squaring from cyclotomic_row(program) on a cyclotomic one), the
    store."""
    cyc_from = cyclotomic_row(program)
    rounds = [(1,) * 12] * nterms + [COOP_ROW_ROUNDS["mul"]] * (nterms - 1)
    rounds += [(1,) * 12, *COOP_INV_ROUNDS]
    for row, (op, _, a, b) in enumerate(np.asarray(program).tolist()):
        rounds.append(COOP_ROW_ROUNDS[
            "conj" if op == OP_CONJ else "frob"
            if op == OP_FROB else "cyc"
            if a == b and row >= cyc_from else "mul"])
    return coop_cost(rounds, group)


def _flat6(a):
    return [c for fp2 in a for c in fp2]


def _nest6(cs):
    return ((cs[0], cs[1]), (cs[2], cs[3]), (cs[4], cs[5]))


class Tower:
    """One pairing curve's Fp12 tower over a MontMod limb context."""

    def __init__(self, F, xi, b3_tw, gammas, mtwist: bool = False):
        assert len(xi) == 2 and min(xi) >= 0
        self.F = F
        self.xi = tuple(int(c) for c in xi)
        self.b3_tw = tuple(int(c) % F.m for c in b3_tw)
        self.gammas = [tuple(int(c) % F.m for c in g) for g in gammas]
        assert len(self.gammas) == 6
        self.mtwist = bool(mtwist)
        self._dev: dict = {}

    # -- host constant staging --

    def const_fp2(self, c, device):
        """Exact Fp2 int pair -> Montgomery limb constants on `device`
        (cached by value)."""
        key = (tuple(c), str(device))
        t = self._dev.get(key)
        if t is None:
            F = self.F
            t = self._dev[key] = tuple(
                torch.as_tensor(F.to_mont(v), device=device) for v in c)
        return t

    def _b3(self, like):
        return tuple(v.expand(like.shape)
                     for v in self.const_fp2(self.b3_tw, like.device))

    def _one(self, like):
        return self.const_fp2((1, 0), like.device)[0].expand(like.shape)

    # -- stacked MontMod calls --

    def _map(self, op, xs, ys):
        """op over the stacked lists xs, ys (Fp tensors of one shape):
        the rows of one MontMod call."""
        if len(xs) == 1:
            return [op(xs[0], ys[0])]
        return list(op(torch.stack(xs), torch.stack(ys)).unbind(0))

    def _muls(self, xs, ys):
        return self._map(self.F.mul, xs, ys)

    def _f2_muls(self, pairs):
        """Karatsuba f2_mul of every (a, b) pair, all 3n base products in
        one MontMod call."""
        F = self.F
        n = len(pairs)
        a0 = torch.stack([a[0] for a, _ in pairs])
        a1 = torch.stack([a[1] for a, _ in pairs])
        b0 = torch.stack([b[0] for _, b in pairs])
        b1 = torch.stack([b[1] for _, b in pairs])
        m = F.mul(torch.cat([a0, a1, F.add(a0, a1)]),
                  torch.cat([b0, b1, F.add(b0, b1)]))
        m0, m1, m2 = m[:n], m[n:2 * n], m[2 * n:]
        re, im = F.sub(m0, m1), F.sub(F.sub(m2, m0), m1)
        return list(zip(re.unbind(0), im.unbind(0)))

    def _f2_map(self, op, xs, ys):
        """An Fp op componentwise over lists of Fp2 values."""
        out = self._map(op, [c for x in xs for c in x],
                        [c for y in ys for c in y])
        return [(out[2 * i], out[2 * i + 1]) for i in range(len(xs))]

    # -- Fp small-scalar add chains --

    def fp_small(self, x, k: int):
        """x * k for a small positive static int, via a binary add chain
        (no Montgomery multiply)."""
        F = self.F
        acc = None
        base = x
        while k:
            if k & 1:
                acc = base if acc is None else F.add(acc, base)
            k >>= 1
            if k:
                base = F.add(base, base)
        if acc is None:
            return torch.zeros_like(x)
        return acc

    # -- Fp2 --

    def f2_add(self, a, b):
        return self._f2_map(self.F.add, [a], [b])[0]

    def f2_sub(self, a, b):
        return self._f2_map(self.F.sub, [a], [b])[0]

    def f2_mul(self, a, b):
        """Karatsuba: 3 base multiplications."""
        return self._f2_muls([(a, b)])[0]

    def f2_sqr(self, a):
        return self.f2_mul(a, a)

    def f2_scale(self, a, s):
        """Fp2 times an Fp element."""
        m = self._muls([a[0], a[1]], [s, s])
        return (m[0], m[1])

    def f2_neg(self, a):
        F = self.F
        return (F.neg(a[0]), F.neg(a[1]))

    def f2_conj(self, a):
        return (a[0], self.F.neg(a[1]))

    def f2_mul_xi(self, a):
        """Multiply by xi = x0 + x1*u:
        ((x0*a0 - x1*a1), (x1*a0 + x0*a1)), small-int add chains (a0 and
        a1 stacked through each chain)."""
        x0, x1 = self.xi
        F = self.F
        both = torch.stack([a[0], a[1]])
        s0, s1 = self.fp_small(both, x0), self.fp_small(both, x1)
        return (F.sub(s0[0], s1[1]), F.add(s1[0], s0[1]))

    def f2_small(self, a, k: int):
        """Multiply by a small positive int via a binary add chain."""
        acc = None
        base = a
        while k:
            if k & 1:
                acc = base if acc is None else self.f2_add(acc, base)
            k >>= 1
            if k:
                base = self.f2_add(base, base)
        return acc

    # -- Fp6 --

    def f6_add(self, a, b):
        return _nest6(self._map(self.F.add, _flat6(a), _flat6(b)))

    def f6_sub(self, a, b):
        return _nest6(self._map(self.F.sub, _flat6(a), _flat6(b)))

    def _f6_muls(self, pairs):
        """fabric_tpu's f6_mul for every (a, b) pair: the 9 Fp2 products
        of each, all in one `_f2_muls`."""
        prods = self._f2_muls([
            (x, y) for a, b in pairs for x, y in (
                (a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
                (a[1], b[2]), (a[2], b[1]), (a[0], b[1]),
                (a[1], b[0]), (a[0], b[2]), (a[2], b[0]))])
        out = []
        for i in range(len(pairs)):
            t0, t1, t2, x12, x21, x01, x10, x02, x20 = prods[9 * i:9 * i + 9]
            s12, s01, s02 = self._f2_map(self.F.add, [x12, x01, x02],
                                         [x21, x10, x20])
            r0 = self.f2_add(t0, self.f2_mul_xi(s12))
            r1 = self.f2_add(s01, self.f2_mul_xi(t2))
            r2 = self.f2_add(s02, t1)
            out.append((r0, r1, r2))
        return out

    def f6_mul(self, a, b):
        return self._f6_muls([(a, b)])[0]

    def f6_mul_v(self, a):
        """Multiply an Fp6 element by v (v^3 = xi)."""
        return (self.f2_mul_xi(a[2]), a[0], a[1])

    # -- Fp12 --

    def f12_mul(self, a, b):
        a0, a1 = a
        b0, b1 = b
        t0, t1, t01 = self._f6_muls([(a0, b0), (a1, b1),
                                     (self.f6_add(a0, a1),
                                      self.f6_add(b0, b1))])
        r0 = self.f6_add(t0, self.f6_mul_v(t1))
        r1 = self.f6_sub(t01, self.f6_add(t0, t1))
        return (r0, r1)

    def f12_sqr(self, a):
        return self.f12_mul(a, a)

    # -- the card's Fp12 formulas (csrc/bls12_381_tower.cuh, distributed
    # over a warp by csrc/pairing_coop.cuh): the same field values as
    # f12_mul, in fewer products --

    def _f6_karatsuba(self, pairs):
        """Karatsuba Fp6 products of every (a, b) pair: a0b0, a1b1, a2b2,
        (a1 + a2)(b1 + b2), (a0 + a1)(b0 + b1), (a0 + a2)(b0 + b2), all
        6n in one `_f2_muls`."""
        add, sub, xi = self.f2_add, self.f2_sub, self.f2_mul_xi
        prods = self._f2_muls([
            (x, y) for a, b in pairs for x, y in (
                (a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
                (add(a[1], a[2]), add(b[1], b[2])),
                (add(a[0], a[1]), add(b[0], b[1])),
                (add(a[0], a[2]), add(b[0], b[2])))])
        out = []
        for i in range(len(pairs)):
            p = prods[6 * i:6 * i + 6]
            out.append((add(p[0], xi(sub(p[3], add(p[1], p[2])))),
                        add(sub(p[4], add(p[0], p[1])), xi(p[2])),
                        add(sub(p[5], add(p[0], p[2])), p[1])))
        return out

    def f12_sqr_complex(self, a):
        """a^2 by the complex method over Karatsuba Fp6 (12 Fp2
        products): t = a0 a1, u = (a0 + a1)(a0 + v a1); (u - t - v t,
        2t)."""
        a0, a1 = a
        t, u = self._f6_karatsuba([
            (a0, a1), (self.f6_add(a0, a1),
                       self.f6_add(a0, self.f6_mul_v(a1)))])
        return (self.f6_sub(u, self.f6_add(t, self.f6_mul_v(t))),
                self.f6_add(t, t))

    def _sparse_terms(self, g, x, y):
        """The 5 products of Fp6 g times (x + y v): g0 x, g1 y,
        (g0 + g1)(x + y), g2 y, g2 x."""
        add = self.f2_add
        return [(g[0], x), (g[1], y), (add(g[0], g[1]), add(x, y)),
                (g[2], y), (g[2], x)]

    def _sparse_value(self, q):
        """g (x + y v) from `_sparse_terms`' products."""
        add, sub = self.f2_add, self.f2_sub
        return (add(q[0], self.f2_mul_xi(q[3])),
                sub(q[2], add(q[0], q[1])), add(q[1], q[4]))

    def f12_mul_line(self, f, A, B, C):
        """f times the sparse line `line_to_f12(A, B, C)` in 13 Fp2
        products: M-type l = (C + B v) + (A v) w, D-type l = A + (B + C v)
        w; Karatsuba over the two halves, r0 = f0 l0 + v f1 l1, r1 =
        (f0 + f1)(l0 + l1) - f0 l0 - f1 l1."""
        f0, f1 = f
        g = self.f6_add(f0, f1)
        add = self.f2_add
        if self.mtwist:                  # f0 (C + B v), f1 (A v)
            terms = (self._sparse_terms(f0, C, B)
                     + [(f1[0], A), (f1[1], A), (f1[2], A)]
                     + self._sparse_terms(g, C, add(A, B)))
        else:                            # f0 A, f1 (B + C v)
            terms = ([(f0[0], A), (f0[1], A), (f0[2], A)]
                     + self._sparse_terms(f1, B, C)
                     + self._sparse_terms(g, add(A, B), C))
        q = self._f2_muls(terms)
        if self.mtwist:
            t0 = self._sparse_value(q[0:5])
            t1 = (self.f2_mul_xi(q[7]), q[5], q[6])
        else:
            t0 = (q[0], q[1], q[2])
            t1 = self._sparse_value(q[3:8])
        t2 = self._sparse_value(q[8:13])
        return (self.f6_add(t0, self.f6_mul_v(t1)),
                self.f6_sub(t2, self.f6_add(t0, t1)))

    def f12_sqr_cyclotomic(self, f):
        """The Granger-Scott squaring of an element of the cyclotomic
        subgroup (anything past the final exponentiation's easy part),
        9 Fp2 squarings over Fp4 = Fp2[w^3]: the pairs (g0, g3), (g1, g4),
        (g2, g5) of f = sum g_i w^i are slots (0, 4), (3, 2), (1, 5) of
        (d0, d1); pair (a, b) squares to (a^2 + xi b^2, (a + b)^2 - a^2 -
        b^2), and each slot becomes 3 such a coefficient -+ 2 itself. It
        equals f12_mul(f, f) only inside that subgroup."""
        add, sub, xi = self.f2_add, self.f2_sub, self.f2_mul_xi
        z = [f[0][0], f[0][1], f[0][2], f[1][0], f[1][1], f[1][2]]
        pairs = ((0, 4), (3, 2), (1, 5))
        s = self._f2_muls([(x, x) for a, b in pairs
                           for x in (z[a], z[b], add(z[a], z[b]))])
        lo = [add(s[3 * k], xi(s[3 * k + 1])) for k in range(3)]
        hi = [sub(s[3 * k + 2], add(s[3 * k], s[3 * k + 1]))
              for k in range(3)]

        def three(c, zi, plus):          # 3c + 2zi or 3c - 2zi
            d = add(c, zi) if plus else sub(c, zi)
            return add(add(d, d), c)
        out = [three(lo[0], z[0], False), three(lo[1], z[1], False),
               three(lo[2], z[2], False), three(xi(hi[2]), z[3], True),
               three(hi[0], z[4], True), three(hi[1], z[5], True)]
        return (tuple(out[:3]), tuple(out[3:]))

    def f12_conj(self, f):
        """x -> x^(p^6): negate the w half. Inverse inside the cyclotomic
        subgroup (post easy part)."""
        d0, d1 = f
        neg = self.F.neg(torch.stack(_flat6(d1))).unbind(0)
        return (d0, _nest6(neg))

    def f12_one_like(self, x):
        """Fp12 one, broadcast to the batch shape of Fp element x."""
        one = self._one(x)
        z = torch.zeros_like(x)
        return (((one, z), (z, z), (z, z)), ((z, z), (z, z), (z, z)))

    def f12_frob(self, f):
        """x -> x^p: coefficient-wise Fp2 conjugation times the gamma
        constants."""
        d0, d1 = f
        cs = [d0[1], d0[2], d1[0], d1[1], d1[2]]
        ks = [2, 4, 1, 3, 5]
        conj = [self.f2_conj(c) for c in [d0[0]] + cs]
        consts = [tuple(v.expand(c[0].shape) for v in self.const_fp2(
            self.gammas[k], c[0].device)) for k, c in zip(ks, cs)]
        g = self._f2_muls(list(zip(conj[1:], consts)))
        return ((conj[0], g[0], g[1]), (g[2], g[3], g[4]))

    # -- inversion (Fermat) --

    def fp_inv(self, x):
        """Montgomery Fermat inverse: x^(p-2) over the exponent's bits."""
        F = self.F
        return pow_scan(x, F.m - 2, F.mul, lambda a: F.mul(a, a))

    def f2_inv(self, a):
        F = self.F
        sq = self._muls([a[0], a[1]], [a[0], a[1]])
        d = self.fp_inv(F.add(sq[0], sq[1]))
        m = self._muls([a[0], F.neg(a[1])], [d, d])
        return (m[0], m[1])

    def f6_inv(self, a):
        """Adjoint/norm method (mirrors the int references)."""
        f2_sub, f2_add, f2_mul_xi = self.f2_sub, self.f2_add, self.f2_mul_xi
        c0, c1, c2 = a
        c00, c12, c22, c01, c11, c02 = self._f2_muls(
            [(c0, c0), (c1, c2), (c2, c2), (c0, c1), (c1, c1), (c0, c2)])
        t0 = f2_sub(c00, f2_mul_xi(c12))
        t1 = f2_sub(f2_mul_xi(c22), c01)
        t2 = f2_sub(c11, c02)
        n0, n2, n1 = self._f2_muls([(c0, t0), (c2, t1), (c1, t2)])
        norm = f2_add(n0, f2_mul_xi(f2_add(n2, n1)))
        ninv = self.f2_inv(norm)
        r = self._f2_muls([(t0, ninv), (t1, ninv), (t2, ninv)])
        return tuple(r)

    def f12_inv(self, a):
        a0, a1 = a
        t1, t0 = self._f6_muls([(a1, a1), (a0, a0)])
        norm = self.f6_sub(t0, self.f6_mul_v(t1))
        ninv = self.f6_inv(norm)
        r0, r1 = self._f6_muls([(a0, ninv), (a1, ninv)])
        neg = self.F.neg(torch.stack(_flat6(r1))).unbind(0)
        return (r0, _nest6(neg))

    def f12_select(self, bit, a, b):
        mask = torch.as_tensor(bit, device=a[0][0][0].device).expand(
            a[0][0][0].shape[:1])
        return select_f12(mask, a, b)

    # -- sparse line placement --

    def line_to_f12(self, A, B, C):
        """Sparse line as a full Fp12 element: D-type A + B*w + C*w^3 in
        slots ((A, 0, 0), (B, C, 0)); M-type ((C, B, 0), (0, A, 0))."""
        z0 = torch.zeros_like(A[0])
        z = (z0, z0)
        if self.mtwist:
            return ((C, B, z), (z, A, z))
        return ((A, z, z), (B, C, z))

    # -- complete twist-curve steps (RCB15 a=0) --

    def g2_dbl_line(self, T, xP, yP):
        """Complete a=0 doubling (RCB15 Alg 9 with b3 on the twist) plus
        the tangent line at T evaluated at P = (xP, yP) in G1.
        Coefficients (scaled by Z^3):
          A = 2*Y*Z^2 * yP,  B = -3*X^2*Z * xP,  C = 3*X^3 - 2*Y^2*Z."""
        f2_add, f2_sub, f2_small = self.f2_add, self.f2_sub, self.f2_small
        X, Y, Z = T
        b3 = self._b3(X[0])
        # the products of T's coordinates alone (fabric_tpu computes
        # f2_sqr(Z) twice, as Z2 and as the doubling's t2: equal limbs)
        Z2, X2, YZ, t0, XY = self._f2_muls(
            [(Z, Z), (X, X), (Y, Z), (Y, Y), (X, Y)])
        YZ2, X2Z, X2X, YYZ, t2 = self._f2_muls(
            [(Y, Z2), (X2, Z), (X2, X), (Y, YZ), (b3, Z2)])
        A, B = self._f2_scales([(f2_small(YZ2, 2), yP),
                                (self.f2_neg(f2_small(X2Z, 3)), xP)])
        C = f2_sub(f2_small(X2X, 3), f2_small(YYZ, 2))
        # RCB15 Alg 9 doubling
        Z3 = f2_small(t0, 8)
        X3, Z3 = self._f2_muls([(t2, Z3), (YZ, Z3)])
        Y3 = f2_add(t0, t2)
        t1 = f2_small(t2, 2)
        t2 = f2_add(t1, t2)
        t0 = f2_sub(t0, t2)
        Y3, X3b = self._f2_muls([(t0, Y3), (t0, XY)])
        Y3 = f2_add(X3, Y3)
        X3 = f2_small(X3b, 2)
        return (X3, Y3, Z3), self.line_to_f12(A, B, C)

    def _f2_scales(self, pairs):
        """f2_scale of every (a, s) pair in one MontMod call."""
        m = self._muls([c for a, _ in pairs for c in a],
                       [s for _, s in pairs for _ in range(2)])
        return [(m[2 * i], m[2 * i + 1]) for i in range(len(pairs))]

    def _rcb_add(self, X1, Y1, Z1, X2, Y2, Z2, b3, first=()):
        """RCB15 Alg 7 (a = 0), fabric_tpu's operation order; `first`
        are extra Fp2 products run with its first six (the line's).
        Returns ((X3, Y3, Z3), the extra products)."""
        f2_add, f2_sub = self.f2_add, self.f2_sub
        s = self._f2_map(self.F.add, [X1, X2, Y1, Y2, X1, X2],
                         [Y1, Y2, Z1, Z2, Z1, Z2])
        prods = self._f2_muls([(X1, X2), (Y1, Y2), (Z1, Z2), (s[0], s[1]),
                               (s[2], s[3]), (s[4], s[5]), *first])
        t0, t1, t2, t3, t4, X3 = prods[:6]
        t3 = f2_sub(t3, f2_add(t0, t1))
        t4 = f2_sub(t4, f2_add(t1, t2))
        Y3 = f2_sub(X3, f2_add(t0, t2))      # Y3 = X1*Z2 + X2*Z1
        t0 = self.f2_small(t0, 3)            # 3*X1*X2
        t2, Y3 = self._f2_muls([(b3, t2), (b3, Y3)])
        Z3 = f2_add(t1, t2)
        t1 = f2_sub(t1, t2)
        X3, t31, Y3, t1Z3, Z3, t03 = self._f2_muls(
            [(t4, Y3), (t3, t1), (Y3, t0), (t1, Z3), (Z3, t4), (t0, t3)])
        X3 = f2_sub(t31, X3)
        Y3 = f2_add(t1Z3, Y3)
        Z3 = f2_add(Z3, t03)
        return (X3, Y3, Z3), prods[6:]

    def g2_add_line(self, T, Q, xP, yP):
        """Complete a=0 mixed addition T + Q (RCB15 Alg 7 with Z2 = 1)
        plus the chord line through T, Q evaluated at P:
          A = (X - xQ*Z) * yP,  B = -(Y - yQ*Z) * xP,
          C = (Y - yQ*Z)*xQ - (X - xQ*Z)*yQ."""
        X1, Y1, Z1 = T
        xQ, yQ = Q
        b3 = self._b3(X1[0])
        one = self._one(X1[0])
        Z2 = (one, torch.zeros_like(one))
        out, (xQZ, yQZ) = self._rcb_add(X1, Y1, Z1, xQ, yQ, Z2, b3,
                                        first=((xQ, Z1), (yQ, Z1)))
        dX, dY = self._f2_map(self.F.sub, [X1, Y1], [xQZ, yQZ])
        dYx, dXy = self._f2_muls([(dY, xQ), (dX, yQ)])
        A, B = self._f2_scales([(dX, yP), (self.f2_neg(dY), xP)])
        C = self.f2_sub(dYx, dXy)
        return out, self.line_to_f12(A, B, C)

    def g2_dbl(self, T):
        """RCB15 Alg 9 complete doubling on the twist (no line)."""
        f2_add, f2_sub, f2_small = self.f2_add, self.f2_sub, self.f2_small
        X, Y, Z = T
        b3 = self._b3(X[0])
        t0, t1, Z2, XY = self._f2_muls([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        t2 = self.f2_mul(b3, Z2)
        Z3 = f2_small(t0, 8)
        X3, Z3 = self._f2_muls([(t2, Z3), (t1, Z3)])
        Y3 = f2_add(t0, t2)
        t1 = f2_small(t2, 2)
        t2 = f2_add(t1, t2)
        t0 = f2_sub(t0, t2)
        Y3, X3b = self._f2_muls([(t0, Y3), (t0, XY)])
        Y3 = f2_add(X3, Y3)
        X3 = f2_small(X3b, 2)
        return X3, Y3, Z3

    def g2_add_mixed(self, T, Q):
        """RCB15 Alg 7 complete mixed addition T + (affine Q), no line."""
        X1, Y1, Z1 = T
        xQ, yQ = Q
        one = self._one(X1[0])
        out, _ = self._rcb_add(X1, Y1, Z1, xQ, yQ,
                               (one, torch.zeros_like(one)),
                               self._b3(X1[0]))
        return out

    def g2_add(self, T, Q):
        """RCB15 Alg 7 complete projective addition T + Q, no line (the
        MSM's joint-table step)."""
        X1, Y1, Z1 = T
        X2, Y2, Z2 = Q
        out, _ = self._rcb_add(X1, Y1, Z1, X2, Y2, Z2, self._b3(X1[0]))
        return out

    # -- verdict + final exponentiation --

    def gt_is_one(self, f):
        """(B,) bool: is the GT element the identity? Canonical-compare
        every coefficient (mont(1) for c000, zero elsewhere)."""
        F = self.F
        c = F.canonical(flat_from_f12(f))            # (12, ..., L)
        one = F.canonical(self._one(c[0]))
        return (c[0] == one).all(dim=-1) & (c[1:] == 0).all(dim=-1).all(
            dim=0)

    def coop_selftest_rows(self, vals):
        """The cooperative layer's self-test (csrc/pairing_coop.cuh
        selftest_group) by this tower: vals (n, 42) plain ints, a case's
        x, y (Fp12), a line's A, B, C and c (Fp12, cyclotomic) -> (n, 110)
        canonical plain ints: x^2 twice (the serial and the group's), x
        times the sparse line twice, c^2 by Granger-Scott twice, x * y,
        1/x, x^p, and the inverse of x's first coefficient twice (the
        binary Euclid and Fermat's)."""
        F = self.F
        n = len(vals)
        cols = [torch.as_tensor(np.stack([F.to_mont(v[k]) for v in vals]))
                for k in range(42)]
        x = f12_from_flat(cols[0:12])
        y = f12_from_flat(cols[12:24])
        A, B, C = (cols[24], cols[25]), (cols[26], cols[27]), \
            (cols[28], cols[29])
        c = f12_from_flat(cols[30:42])
        sq = flat_from_f12(self.f12_sqr_complex(x))
        ln = flat_from_f12(self.f12_mul_line(x, A, B, C))
        cy = flat_from_f12(self.f12_sqr_cyclotomic(c))
        outs = [*sq, *sq, *ln, *ln, *cy, *cy,
                *flat_from_f12(self.f12_mul(x, y)),
                *flat_from_f12(self.f12_inv(x)),
                *flat_from_f12(self.f12_frob(x))]
        rows = [[F.from_limbs(o[i].numpy()) for o in outs]
                for i in range(n)]
        for r, v in zip(rows, vals):
            a = v[0] % F.m
            r += [pow(a, F.m - 2, F.m)] * 2
        return rows

    def run_final_exp(self, f, program, cyc_from=None):
        """Seed the register file with (f, 1/f) and zeros, then run the
        curve's final-exp program (registers 0/1 are inputs; the result
        lands in register 0) row by row. With `cyc_from`, a `mul(d, a,
        a)` at that row or later runs as f12_sqr_cyclotomic (its operand
        lies in the cyclotomic subgroup from there on: the same value)."""
        z = torch.zeros_like(f[0][0][0])
        zero = ((z, z),) * 3
        regs = [f, self.f12_inv(f)] + [(zero, zero)] * (NREG - 2)
        for row, (op, dst, a, b) in enumerate(np.asarray(program).tolist()):
            if op == OP_MUL and a == b and cyc_from is not None \
                    and row >= cyc_from:
                regs[dst] = self.f12_sqr_cyclotomic(regs[a])
            elif op == OP_MUL:
                regs[dst] = self.f12_mul(regs[a], regs[b])
            elif op == OP_CONJ:
                regs[dst] = self.f12_conj(regs[a])
            elif op == OP_FROB:
                regs[dst] = self.f12_frob(regs[a])
            else:
                raise ValueError(f"unknown final-exp op {op}")
        return regs[0]
