// BN254's pairing tower and twist arithmetic on the 32-bit core
// (bn254_field.cuh), for csrc/bn254_pairing.cu and csrc/g2_msm.cu.
//
// The shapes are fabric_tpu/ops/tower.py's, so that the Miller values and
// the MSM's projective points equal the plain torch version's
// (ops/tower.py) field value for field value:
//   Fp2 = Fp[u]/(u^2+1), Karatsuba (3 products; a square by the complex
//   method, 2);
//   Fp6 = Fp2[v]/(v^3 - xi), xi = xi0 + xi1*u;
//   Fp12 = Fp6[w]/(w^2 - v);
//   Frobenius: conjugate every Fp2 coefficient, times gamma_k
//   (= xi^(k(p-1)/6)) on slots (d0: -, 2, 4; d1: 1, 3, 5);
//   inversion by the adjoint/norm method down to an Fp inverse (Fermat for
//   f2_inv, the binary Euclid algorithm for f2_inv_binary, which 1/f uses);
//   the D-type sparse line A + B*w + C*w^3 in slots ((A, 0, 0), (B, C, 0));
//   the twist steps, RCB15 a = 0: Alg 9 doubling with the tangent line
//   (A = 2YZ^2 yP, B = -3X^2Z xP, C = 3X^3 - 2Y^2Z), Alg 7 mixed addition
//   with the chord line (A = (X - xQ Z) yP, B = -(Y - yQ Z) xP,
//   C = (Y - yQ Z) xQ - (X - xQ Z) yQ), and both without lines (the MSM's).
// The Fp12 operations come in their cheapest forms, each a set of
// independent Fp2 products that the cooperative layer (pairing_coop.cuh)
// spreads over a group of threads and the serial functions below run on
// one: the product by Karatsuba over Fp6 (18 Fp2 products), the square by
// the complex method (12), the product by the sparse line (13), the
// Granger-Scott square inside the cyclotomic subgroup (9 squares); the
// tangent and chord steps are regrouped into three rounds of independent
// products (16 and 19) that drop the recomputed Y Z and Z^2 and the
// products by Z2 = 1.
// Small integer multiples (xi's coefficients, 2, 3, 8) are binary add
// chains, as in the JAX code. The constants (mont one, R^2, the domain
// factors, b3' = 9/(9+u), the gammas, xi, t) are not typed here: the host
// computes them from bn254_ref (ops/bn254.py consts_words) and the kernels
// copy them into shared memory as BnConsts.
//
// As in bls12_381_tower.cuh, a few __noinline__ bodies hold the field
// products (nvcc takes minutes when every product is inlined): f2_mul,
// f2_sqr, f2_scale and fp2_part. The Fp2 additions, negations and small
// multiples are __noinline__ bodies too, taking their operands by value:
// inlined at every use they make the kernels tens of thousands of
// instructions, past the instruction cache, and by reference every
// temporary sits on the stack. The Fp6 and Fp12 operations, the Frobenius,
// the inversions and the twist steps are __noinline__ calls over
// references. Outputs may alias inputs. Everything lives in namespace
// bn254, where the cooperative layer finds it by argument-dependent lookup.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bn254_field.cuh"

namespace {
namespace bn254 {

constexpr int NW = 8;        // words a value

struct Fp2 {
  Fp c0, c1;
};

struct Fp6 {
  Fp2 c[3];
};

struct Fp12 {
  Fp6 d0, d1;
};

struct G2P {                 // projective (X : Y : Z) on the twist
  Fp2 X, Y, Z;
};

struct G2A {                 // affine (x, y) on the twist
  Fp2 x, y;
};

struct BnConsts {
  Fp one;                    // 2^256 mod p: Montgomery 1
  Fp r2;                     // 2^512 mod p: plain -> Montgomery
  Fp c_in;                   // 2^252 mod p: R = 2^260 limbs -> R = 2^256
  Fp c_out;                  // 2^260 mod p: R = 2^256 -> R = 2^260 limbs
  Fp2 b3;                    // 3 b' on the twist, Montgomery
  Fp2 gamma[6];              // xi^(k(p-1)/6), Montgomery
  uint32_t xi0, xi1;         // xi = xi0 + xi1 u
  uint32_t t_lo, t_hi;       // the BN parameter t
};

constexpr int BN_CONST_WORDS = sizeof(BnConsts) / 4;
static_assert(BN_CONST_WORDS == 148, "BnConsts layout");

// Fp2 zero and one (the cooperative layer's generic code reaches them
// through the constants' type)
__device__ __forceinline__ Fp2 f2_zero(const BnConsts&) {
  return {fp_zero(), fp_zero()};
}

__device__ __forceinline__ Fp2 f2_one(const BnConsts& k) {
  return {k.one, fp_zero()};
}

// -- Fp helpers --

// x * k by a binary add chain (fabric_tpu's fp_small)
__device__ __forceinline__ Fp fp_small(const Fp& x, uint32_t k) {
  Fp acc = fp_zero(), base = x;
  bool have = false;
  while (k) {
    if (k & 1u) {
      acc = have ? fp_add(acc, base) : base;
      have = true;
    }
    k >>= 1;
    if (k) base = fp_add(base, base);
  }
  return acc;
}

// -- Fp2 --

__device__ __noinline__ Fp2 f2_add(Fp2 a, Fp2 b) {
  return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}

__device__ __noinline__ Fp2 f2_sub(Fp2 a, Fp2 b) {
  return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}

__device__ __noinline__ Fp2 f2_neg(Fp2 a) {
  return {fp_neg(a.c0), fp_neg(a.c1)};
}

__device__ __noinline__ Fp2 f2_conj(Fp2 a) {
  return {a.c0, fp_neg(a.c1)};
}

__device__ __forceinline__ Fp2 f2_zero() { return {fp_zero(), fp_zero()}; }

__device__ __noinline__ Fp2 f2_mul(Fp2 a, Fp2 b) {
  const Fp m0 = fp_mul(a.c0, b.c0);
  const Fp m1 = fp_mul(a.c1, b.c1);
  const Fp m2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return {fp_sub(m0, m1), fp_sub(fp_sub(m2, m0), m1)};
}

// The Fp2 product x y as three Fp products, for three threads:
// part c of it (x0 y0, x1 y1, (x0 + x1)(y0 + y1)), and the product from
// its parts: f2_mul's values
__device__ __noinline__ Fp fp2_part(Fp2 x, Fp2 y, int c) {
  const Fp a = c == 0 ? x.c0 : c == 1 ? x.c1 : fp_add(x.c0, x.c1);
  const Fp b = c == 0 ? y.c0 : c == 1 ? y.c1 : fp_add(y.c0, y.c1);
  return fp_mul(a, b);
}

__device__ __noinline__ Fp2 f2_from_parts(const Fp* m) {
  return {fp_sub(m[0], m[1]), fp_sub(fp_sub(m[2], m[0]), m[1])};
}

// the complex squaring: (a0 + a1)(a0 - a1) and 2 a0 a1, 2 products
__device__ __noinline__ Fp2 f2_sqr(Fp2 a) {
  const Fp m0 = fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1));
  const Fp m1 = fp_mul(a.c0, a.c1);
  return {m0, fp_add(m1, m1)};
}

__device__ __noinline__ Fp2 f2_scale(Fp2 a, Fp s) {
  return {fp_mul(a.c0, s), fp_mul(a.c1, s)};
}

__device__ __noinline__ Fp2 f2_mul_xi(Fp2 a, const BnConsts& k) {
  return {fp_sub(fp_small(a.c0, k.xi0), fp_small(a.c1, k.xi1)),
          fp_add(fp_small(a.c0, k.xi1), fp_small(a.c1, k.xi0))};
}

__device__ __noinline__ Fp2 f2_small(Fp2 a, uint32_t k) {
  return {fp_small(a.c0, k), fp_small(a.c1, k)};
}

__device__ __noinline__ void f2_inv(Fp2& out, const Fp2& a) {
  Fp d;
  fp_inv(d, fp_add(fp_mul(a.c0, a.c0), fp_mul(a.c1, a.c1)));
  const Fp c0 = fp_mul(a.c0, d), c1 = fp_mul(fp_neg(a.c1), d);
  out.c0 = c0;
  out.c1 = c1;
}

// 1/a with the Fp inverse by the binary extended Euclid algorithm (1/f's;
// f2_inv keeps Fermat's)
__device__ __noinline__ void f2_inv_binary(Fp2& out, const Fp2& a,
                                           const BnConsts& k) {
  Fp d;
  fp_inv_binary(d, fp_add(fp_mul(a.c0, a.c0), fp_mul(a.c1, a.c1)), k.r2);
  const Fp c0 = fp_mul(a.c0, d), c1 = fp_mul(fp_neg(a.c1), d);
  out.c0 = c0;
  out.c1 = c1;
}

// -- Fp6 --

__device__ __forceinline__ void f6_add(Fp6& r, const Fp6& a, const Fp6& b) {
#pragma unroll
  for (int i = 0; i < 3; ++i) r.c[i] = f2_add(a.c[i], b.c[i]);
}

__device__ __forceinline__ void f6_sub(Fp6& r, const Fp6& a, const Fp6& b) {
#pragma unroll
  for (int i = 0; i < 3; ++i) r.c[i] = f2_sub(a.c[i], b.c[i]);
}

// times v (v^3 = xi)
__device__ __forceinline__ void f6_mul_v(Fp6& r, const Fp6& a,
                                         const BnConsts& k) {
  const Fp2 t = f2_mul_xi(a.c[2], k);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = t;
}

// -- Fp12 --

__device__ __forceinline__ void f12_one(Fp12& r, const BnConsts& k) {
  r.d0.c[0] = {k.one, fp_zero()};
  r.d0.c[1] = r.d0.c[2] = f2_zero();
  r.d1.c[0] = r.d1.c[1] = r.d1.c[2] = f2_zero();
}

__device__ __forceinline__ void f12_zero(Fp12& r) {
#pragma unroll
  for (int i = 0; i < 3; ++i) r.d0.c[i] = r.d1.c[i] = f2_zero();
}

// -- the formulas the cooperative layer distributes (pairing_coop.cuh) --
//
// Each is a set of independent Fp2 products and six output coefficients.
// `*_operands(..., j, x, y)` picks product j's operands (additions only):
// the product is f2_mul(x, y) (`cyc_operand`'s f2_sqr(x)); `*_term(...,
// j)` adds term j out of the products and `*_coef(..., i)` coefficient i
// (slot i: d0.c0..c2, d1.c0..c2) out of the terms (the cyclotomic
// squaring's out of the products). The serial functions below loop over
// j, then over i; pairing_coop.cuh runs the same calls on a group of
// threads, a round of products, one of terms and one of coefficients. A
// coefficient reads terms or products and at most its own input slot, so
// an output may alias its input. They are bls12_381_tower.cuh's, but for
// the line: BN254's twist is D-type, the line's coefficients in slots w^0,
// w^1 and w^3.

__device__ __forceinline__ Fp2& f12_slot(Fp12& f, int i) {
  return i < 3 ? f.d0.c[i] : f.d1.c[i - 3];
}

__device__ __forceinline__ const Fp2& f12_slot(const Fp12& f, int i) {
  return i < 3 ? f.d0.c[i] : f.d1.c[i - 3];
}

// Karatsuba over Fp6, 6 Fp2 products: a0b0, a1b1, a2b2, (a1 + a2)(b1 + b2),
// (a0 + a1)(b0 + b1), (a0 + a2)(b0 + b2)
__device__ __forceinline__ void f6k_operands(const Fp6& a, const Fp6& b,
                                             int j, Fp2& x, Fp2& y) {
  if (j < 3) {
    x = a.c[j];
    y = b.c[j];
    return;
  }
  const int m = j == 3 ? 1 : 0, n = j == 4 ? 1 : 2;  // (1,2) (0,1) (0,2)
  x = f2_add(a.c[m], a.c[n]);
  y = f2_add(b.c[m], b.c[n]);
}

__device__ __forceinline__ Fp2 f6k_coef(const Fp2* p, int i,
                                        const BnConsts& k) {
  if (i == 0)
    return f2_add(p[0], f2_mul_xi(f2_sub(p[3], f2_add(p[1], p[2])), k));
  if (i == 1)
    return f2_add(f2_sub(p[4], f2_add(p[0], p[1])), f2_mul_xi(p[2], k));
  return f2_add(f2_sub(p[5], f2_add(p[0], p[2])), p[1]);
}

// term j of the Karatsuba Fp6 products in p: coefficient j % 3 of the
// product of products 6 (j / 3) .. 6 (j / 3) + 5
__device__ __noinline__ Fp2 f6k_term(const Fp2* p, int j, const BnConsts& k) {
  return f6k_coef(p + 6 * (j / 3), j % 3, k);
}

// r = (T0 + v T1, T2 - T0 - T1) from terms t (T0 = t0..2, T1 = t3..5, T2
// = t6..8): Karatsuba over the Fp12 halves, (v t)_i = xi t_2, t_0, t_1
__device__ __noinline__ Fp2 kara_coef(const Fp2* t, int i, const BnConsts& k) {
  if (i < 3) return f2_add(t[i], i == 0 ? f2_mul_xi(t[5], k) : t[2 + i]);
  return f2_sub(t[3 + i], f2_add(t[i - 3], t[i]));
}

// a * b, Karatsuba over Fp6 twice: a0 b0 (products 0-5), a1 b1 (6-11),
// (a0 + a1)(b0 + b1) (12-17); terms f6k_term (9), then kara_coef
constexpr int MUL_PRODS = 18;

__device__ __forceinline__ void mul_operands(const Fp12& a, const Fp12& b,
                                             int j, Fp2& x, Fp2& y) {
  if (j < 6) {
    f6k_operands(a.d0, b.d0, j, x, y);
  } else if (j < 12) {
    f6k_operands(a.d1, b.d1, j - 6, x, y);
  } else {
    Fp6 sa, sb;
    f6_add(sa, a.d0, a.d1);
    f6_add(sb, b.d0, b.d1);
    f6k_operands(sa, sb, j - 12, x, y);
  }
}

// a^2 by the complex method: t = a0 a1 (products 0-5), u = (a0 + a1)(a0 +
// v a1) (6-11); terms f6k_term (6), then r0 = u - t - v t, r1 = 2t
constexpr int SQR_PRODS = 12;

__device__ __forceinline__ void sqr_operands(const Fp12& a, int j, Fp2& x,
                                             Fp2& y, const BnConsts& k) {
  if (j < 6) {
    f6k_operands(a.d0, a.d1, j, x, y);
  } else {
    Fp6 s, t;
    f6_add(s, a.d0, a.d1);
    f6_mul_v(t, a.d1, k);
    f6_add(t, a.d0, t);
    f6k_operands(s, t, j - 6, x, y);
  }
}

// r from the terms (t = a0 a1: 0-2, u: 3-5)
__device__ __noinline__ Fp2 sqr_coef(const Fp2* t, int i, const BnConsts& k) {
  if (i >= 3) return f2_add(t[i - 3], t[i - 3]);
  const Fp2 vt = i == 0 ? f2_mul_xi(t[2], k) : t[i - 1];
  return f2_sub(t[3 + i], f2_add(t[i], vt));
}

// f * the D-type line A + (B + C v) w, 13 products: f0 A (0-2), f1 (B +
// C v) by sparse Karatsuba (3-7), (f0 + f1)((A + B) + C v) (8-12); terms
// line_term (9), then kara_coef. The sparse Karatsuba product of g by
// (x + y v): g0 x, g1 y, (g0 + g1)(x + y), g2 y, g2 x.
constexpr int LINE_PRODS = 13;

__device__ __forceinline__ void line_operands(const Fp12& f, const Fp2& A,
                                              const Fp2& B, const Fp2& C,
                                              int j, Fp2& x, Fp2& y) {
  if (j < 3) {
    x = f.d0.c[j];
    y = A;
    return;
  }
  Fp2 g0, g1, g2, a = B;
  if (j < 8) {
    g0 = f.d1.c[0];
    g1 = f.d1.c[1];
    g2 = f.d1.c[2];
    j -= 3;
  } else {
    g0 = f2_add(f.d0.c[0], f.d1.c[0]);
    g1 = f2_add(f.d0.c[1], f.d1.c[1]);
    g2 = f2_add(f.d0.c[2], f.d1.c[2]);
    a = f2_add(A, B);
    j -= 8;
  }
  x = j == 0 ? g0 : j == 1 ? g1 : j == 2 ? f2_add(g0, g1) : g2;
  y = j == 0 || j == 4 ? a : j == 2 ? f2_add(a, C) : C;
}

// the terms: f0 l0 = (q0, q1, q2) (0-2), f1 l1 (3-5), (f0 + f1)(l0 + l1)
// (6-8), the last two from their sparse products (q0 + xi q3, q2 - q0 -
// q1, q1 + q4); then kara_coef
__device__ __noinline__ Fp2 line_term(const Fp2* q, int j,
                                      const BnConsts& k) {
  if (j < 3) return q[j];
  const Fp2* s = j < 6 ? q + 3 : q + 8;
  switch (j < 6 ? j - 3 : j - 6) {
    case 0: return f2_add(s[0], f2_mul_xi(s[3], k));
    case 1: return f2_sub(s[2], f2_add(s[0], s[1]));
    default: return f2_add(s[1], s[4]);
  }
}

// The Granger-Scott squaring of an element of the cyclotomic subgroup
// (f^(p^6 + 1) = 1: anything past the final exponentiation's easy part),
// over Fp4 = Fp2[s]/(s^2 - xi), s = w^3. With f = sum g_i w^i (slots 0..5
// hold g0, g2, g4, g1, g3, g5) the Fp4 pairs are (g0, g3), (g1, g4) and
// (g2, g5): slots (0, 4), (3, 2) and (1, 5). Products 3k, 3k + 1, 3k + 2
// are pair k's a^2, b^2 and (a + b)^2; its square is (a^2 + xi b^2,
// (a + b)^2 - a^2 - b^2), and each output slot is 3 such a coefficient
// -+ 2 its own input slot. It equals f12_mul(f, f) only inside the
// subgroup.
constexpr int CYC_PRODS = 9;

__device__ __forceinline__ int cyc_slot(int k, int m) {
  return k == 0 ? (m ? 4 : 0) : k == 1 ? (m ? 2 : 3) : (m ? 5 : 1);
}

__device__ __forceinline__ Fp2 cyc_operand(const Fp12& f, int j) {
  const int k = j / 3, m = j % 3;
  const Fp2& a = f12_slot(f, cyc_slot(k, 0));
  const Fp2& b = f12_slot(f, cyc_slot(k, 1));
  return m == 0 ? a : m == 1 ? b : f2_add(a, b);
}

__device__ __noinline__ Fp2 cyc_coef(const Fp12& f, const Fp2* s, int i,
                                     const BnConsts& k) {
  // slot -> (its Fp4 pair, first or second coefficient of the square)
  const int pair = i == 0 || i == 4 ? 0 : i == 2 || i == 3 ? 2 : 1;
  const bool hi = i == 4 || i == 5 || i == 3;
  const Fp2* t = s + 3 * pair;
  Fp2 c = hi ? f2_sub(t[2], f2_add(t[0], t[1]))
             : f2_add(t[0], f2_mul_xi(t[1], k));
  if (i == 3) c = f2_mul_xi(c, k);       // g1' = 3 xi (pair 2's hi) + 2 g1
  const Fp2& z = f12_slot(f, i);
  Fp2 d = hi ? f2_add(c, z) : f2_sub(c, z);
  d = f2_add(d, d);
  return f2_add(d, c);
}

// the Frobenius slot by slot: conjugate, times gamma_k (slots 1..5: k = 2,
// 4, 1, 3, 5; slot 0 times one), one product a slot
__device__ __forceinline__ void frob_operands(const Fp12& a, int i, Fp2& x,
                                              Fp2& y, const BnConsts& k) {
  x = f2_conj(f12_slot(a, i));
  if (i == 0) {
    y = f2_one(k);
  } else {
    y = k.gamma[i == 1 ? 2 : i == 2 ? 4 : i == 3 ? 1 : i == 4 ? 3 : 5];
  }
}

// The serial forms: one thread runs every product, term and coefficient,
// the Fp6 sums the per-index operands would recompute made once (the
// same operands).

// 6 Karatsuba Fp6 products of a and b into p
__device__ __noinline__ void f6k_products(Fp2* p, const Fp6& a,
                                             const Fp6& b) {
  Fp2 x, y;
  for (int j = 0; j < 6; ++j) {
    f6k_operands(a, b, j, x, y);
    p[j] = f2_mul(x, y);
  }
}

__device__ __noinline__ void f12_mul(Fp12& r, const Fp12& a, const Fp12& b,
                                     const BnConsts& k) {
  Fp2 p[MUL_PRODS], t[9];
  Fp6 sa, sb;
  f6_add(sa, a.d0, a.d1);
  f6_add(sb, b.d0, b.d1);
  f6k_products(p, a.d0, b.d0);
  f6k_products(p + 6, a.d1, b.d1);
  f6k_products(p + 12, sa, sb);
  for (int j = 0; j < 9; ++j) t[j] = f6k_term(p, j, k);
  for (int i = 0; i < 6; ++i) f12_slot(r, i) = kara_coef(t, i, k);
}

__device__ __noinline__ void f12_sqr(Fp12& r, const Fp12& a,
                                     const BnConsts& k) {
  Fp2 p[SQR_PRODS], t[6];
  Fp6 s, u;
  f6_add(s, a.d0, a.d1);
  f6_mul_v(u, a.d1, k);
  f6_add(u, a.d0, u);
  f6k_products(p, a.d0, a.d1);
  f6k_products(p + 6, s, u);
  for (int j = 0; j < 6; ++j) t[j] = f6k_term(p, j, k);
  for (int i = 0; i < 6; ++i) f12_slot(r, i) = sqr_coef(t, i, k);
}

// g (x + y v) by sparse Karatsuba: g0 x, g1 y, (g0 + g1)(x + y), g2 y,
// g2 x into q (line_operands' order)
__device__ __noinline__ void sparse_products(Fp2* q, const Fp6& g,
                                                const Fp2& x, const Fp2& y) {
  q[0] = f2_mul(g.c[0], x);
  q[1] = f2_mul(g.c[1], y);
  q[2] = f2_mul(f2_add(g.c[0], g.c[1]), f2_add(x, y));
  q[3] = f2_mul(g.c[2], y);
  q[4] = f2_mul(g.c[2], x);
}

__device__ __noinline__ void f12_mul_line(Fp12& r, const Fp12& f,
                                          const Fp2& A, const Fp2& B,
                                          const Fp2& C, const BnConsts& k) {
  Fp2 q[LINE_PRODS], t[9];
  Fp6 g;
  f6_add(g, f.d0, f.d1);
  for (int j = 0; j < 3; ++j) q[j] = f2_mul(f.d0.c[j], A);
  sparse_products(q + 3, f.d1, B, C);
  sparse_products(q + 8, g, f2_add(A, B), C);
  for (int j = 0; j < 9; ++j) t[j] = line_term(q, j, k);
  for (int i = 0; i < 6; ++i) f12_slot(r, i) = kara_coef(t, i, k);
}

__device__ __noinline__ void f12_sqr_cyclotomic(Fp12& r, const Fp12& f,
                                                const BnConsts& k) {
  Fp2 s[CYC_PRODS];
  for (int j = 0; j < CYC_PRODS; ++j) s[j] = f2_sqr(cyc_operand(f, j));
  for (int i = 0; i < 6; ++i) f12_slot(r, i) = cyc_coef(f, s, i, k);
}

__device__ __forceinline__ void f12_conj(Fp12& r, const Fp12& a) {
  r.d0 = a.d0;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.d1.c[i] = f2_neg(a.d1.c[i]);
}

__device__ __noinline__ void f12_frob(Fp12& r, const Fp12& a,
                                      const BnConsts& k) {
  Fp2 c[6], x, y;
  for (int i = 0; i < 6; ++i) {
    frob_operands(a, i, x, y, k);
    c[i] = i ? f2_mul(x, y) : x;
  }
  for (int i = 0; i < 6; ++i) f12_slot(r, i) = c[i];
}

// a * b by Karatsuba over Fp6 (6 Fp2 products; 1/f's)
__device__ __noinline__ void f6_mul(Fp6& r, const Fp6& a, const Fp6& b,
                                    const BnConsts& k) {
  Fp2 p[6];
  f6k_products(p, a, b);
  for (int i = 0; i < 3; ++i) r.c[i] = f6k_coef(p, i, k);
}

__device__ __noinline__ void f6_inv(Fp6& r, const Fp6& a, const BnConsts& k) {
  const Fp2 &c0 = a.c[0], &c1 = a.c[1], &c2 = a.c[2];
  const Fp2 t0 = f2_sub(f2_sqr(c0), f2_mul_xi(f2_mul(c1, c2), k));
  const Fp2 t1 = f2_sub(f2_mul_xi(f2_sqr(c2), k), f2_mul(c0, c1));
  const Fp2 t2 = f2_sub(f2_sqr(c1), f2_mul(c0, c2));
  const Fp2 norm = f2_add(f2_mul(c0, t0),
                          f2_mul_xi(f2_add(f2_mul(c2, t1), f2_mul(c1, t2)), k));
  Fp2 ninv;
  f2_inv_binary(ninv, norm, k);
  r.c[0] = f2_mul(t0, ninv);
  r.c[1] = f2_mul(t1, ninv);
  r.c[2] = f2_mul(t2, ninv);
}

__device__ __noinline__ void f12_inv(Fp12& r, const Fp12& a,
                                     const BnConsts& k) {
  Fp6 t1, t0, ninv;
  f6_mul(t1, a.d1, a.d1, k);
  f6_mul(t0, a.d0, a.d0, k);
  f6_mul_v(t1, t1, k);
  f6_sub(t0, t0, t1);
  f6_inv(ninv, t0, k);
  f6_mul(t0, a.d0, ninv, k);
  f6_mul(t1, a.d1, ninv, k);
  r.d0 = t0;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.d1.c[i] = f2_neg(t1.c[i]);
}

// c000 == 1 and every other coefficient 0, canonically
__device__ __forceinline__ bool gt_is_one(const Fp12& f, const BnConsts& k) {
  bool ok = fp_eq_words(fp_canonical(f.d0.c[0].c0), fp_canonical(k.one)) &&
            fp_is_zero(f.d0.c[0].c1);
#pragma unroll
  for (int i = 1; i < 3; ++i)
    ok = ok && fp_is_zero(f.d0.c[i].c0) && fp_is_zero(f.d0.c[i].c1);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    ok = ok && fp_is_zero(f.d1.c[i].c0) && fp_is_zero(f.d1.c[i].c1);
  return ok;
}

// the D-type sparse line as an Fp12 element (the tower self-test's output)
__device__ __forceinline__ void line_to_f12(Fp12& l, const Fp2& A,
                                            const Fp2& B, const Fp2& C) {
  l.d0.c[0] = A;
  l.d0.c[1] = l.d0.c[2] = f2_zero();
  l.d1.c[0] = B;
  l.d1.c[1] = C;
  l.d1.c[2] = f2_zero();
}

// -- the twist steps (RCB15, a = 0) --

// The twist steps keep their Fp2 temporaries in a local array that the
// bodies below write through references: held in registers across the
// calls, they fill every register, and the callers' own values spill.
__device__ __noinline__ void mul_to(Fp2& r, Fp2 a, Fp2 b) { r = f2_mul(a, b); }
__device__ __noinline__ void sqr_to(Fp2& r, Fp2 a) { r = f2_sqr(a); }
__device__ __noinline__ void add_to(Fp2& r, Fp2 a, Fp2 b) { r = f2_add(a, b); }
__device__ __noinline__ void sub_to(Fp2& r, Fp2 a, Fp2 b) { r = f2_sub(a, b); }
__device__ __noinline__ void small_to(Fp2& r, Fp2 a, uint32_t k) {
  r = f2_small(a, k);
}

// RCB15 Alg 9 doubling of T in place (the MSM's): t0 = Y^2, t2 = b3' Z^2,
// u = t0 - 3 t2: T' = (2 u XY, 8 t0 t2 + u (t0 + t2), 8 t0 YZ)
__device__ __noinline__ void g2_dbl(G2P& T, const BnConsts& k) {
  Fp2 m[6];                              // t0, t2, 8 t0, u, XY, YZ
  sqr_to(m[0], T.Y);
  sqr_to(m[1], T.Z);
  mul_to(m[1], k.b3, m[1]);
  small_to(m[2], m[0], 8);
  small_to(m[3], m[1], 3);
  sub_to(m[3], m[0], m[3]);
  mul_to(m[4], T.X, T.Y);
  mul_to(m[5], T.Y, T.Z);
  mul_to(T.Z, m[5], m[2]);
  mul_to(m[4], m[3], m[4]);
  small_to(T.X, m[4], 2);
  add_to(m[5], m[0], m[1]);
  mul_to(m[5], m[3], m[5]);
  mul_to(m[1], m[1], m[2]);
  add_to(T.Y, m[1], m[5]);
}

// RCB15 Alg 7 with Z2 = 1, T += Q (the MSM's): t0 = X1 x2, t1 = Y1 y2,
// t3 = (X1 + Y1)(x2 + y2) - t0 - t1, t4 = (Y1 + Z1)(y2 + 1) - t1 - Z1,
// Y3 = b3' ((X1 + Z1)(x2 + 1) - t0 - Z1), Z3 = t1 + b3' Z1, t1' = t1 -
// b3' Z1: T' = (t3 t1' - t4 Y3, t1' Z3 + Y3 3t0, Z3 t4 + 3t0 t3)
__device__ __noinline__ void g2_add_mixed(G2P& T, const G2A& Q,
                                          const BnConsts& k) {
  Fp2 m[9], s[2];             // t0, t1, t3, t4, Y3, b3' Z1, Z3, t1', 3 t0
  mul_to(m[0], T.X, Q.x);
  mul_to(m[1], T.Y, Q.y);
  add_to(s[0], T.X, T.Y);
  add_to(s[1], Q.x, Q.y);
  mul_to(m[2], s[0], s[1]);
  add_to(s[0], m[0], m[1]);
  sub_to(m[2], m[2], s[0]);
  add_to(s[0], T.Y, T.Z);
  add_to(s[1], Q.y, f2_one(k));
  mul_to(m[3], s[0], s[1]);
  add_to(s[0], m[1], T.Z);
  sub_to(m[3], m[3], s[0]);
  add_to(s[0], T.X, T.Z);
  add_to(s[1], Q.x, f2_one(k));
  mul_to(m[4], s[0], s[1]);
  add_to(s[0], m[0], T.Z);
  sub_to(m[4], m[4], s[0]);
  mul_to(m[4], k.b3, m[4]);
  mul_to(m[5], k.b3, T.Z);
  add_to(m[6], m[1], m[5]);
  sub_to(m[7], m[1], m[5]);
  small_to(m[8], m[0], 3);
  mul_to(s[0], m[2], m[7]);
  mul_to(s[1], m[3], m[4]);
  sub_to(T.X, s[0], s[1]);
  mul_to(s[0], m[7], m[6]);
  mul_to(s[1], m[4], m[8]);
  add_to(T.Y, s[0], s[1]);
  mul_to(s[0], m[6], m[3]);
  mul_to(s[1], m[8], m[2]);
  add_to(T.Z, s[0], s[1]);
}

// The doubling with its tangent line at the old T, evaluated at (xP,
// yP), on the cooperative layer's three rounds of products
// (pairing_coop.cuh dbl_operands1..3): Z^2, X^2, YZ, Y^2, XY, Y yP, Z xP;
// then (Y yP) Z^2, (Z xP) X^2, X^2 X, Y (YZ), b3' Z^2, YZ 8Y^2; then t2 8t0,
// (t0 - 3t2)(t0 + t2), (t0 - 3t2) XY (t0 = Y^2, t2 = b3' Z^2): Alg 9's
// values without its second Y Z and Z^2.
__device__ __noinline__ void g2_dbl_line(G2P& T, Fp2& A, Fp2& B, Fp2& C,
                                         const Fp& xP, const Fp& yP,
                                         const BnConsts& k) {
  Fp2 m[3];                              // Z^2, X^2, YZ
  sqr_to(m[0], T.Z);
  sqr_to(m[1], T.X);
  mul_to(m[2], T.Y, T.Z);
  A = f2_scale(T.Y, yP);
  mul_to(A, A, m[0]);
  small_to(A, A, 2);
  B = f2_scale(T.Z, xP);
  mul_to(B, B, m[1]);
  small_to(B, B, 3);
  B = f2_neg(B);
  mul_to(C, m[1], T.X);
  small_to(C, C, 3);
  mul_to(m[1], T.Y, m[2]);
  small_to(m[1], m[1], 2);
  sub_to(C, C, m[1]);
  // Alg 9 on (X^2 and Y Z no longer needed): the doubling's products
  Fp2 d[4];                              // t0, t2, 8 t0, u
  sqr_to(d[0], T.Y);
  mul_to(d[1], k.b3, m[0]);
  small_to(d[2], d[0], 8);
  small_to(d[3], d[1], 3);
  sub_to(d[3], d[0], d[3]);
  mul_to(T.Z, m[2], d[2]);
  mul_to(m[1], T.X, T.Y);
  mul_to(m[1], d[3], m[1]);
  small_to(T.X, m[1], 2);
  add_to(m[0], d[0], d[1]);
  mul_to(m[0], d[3], m[0]);
  mul_to(d[1], d[1], d[2]);
  add_to(T.Y, d[1], m[0]);
}

// The mixed addition T + Q with its chord line through the old T and Q at
// (xP, yP): dX = X - xQ Z, dY = Y - yQ Z, A = dX yP, B = -dY xP, C = dY xQ
// - dX yQ, then g2_add_mixed (Alg 7's values with Z2 = 1: no product by
// it).
__device__ __noinline__ void g2_add_line(G2P& T, Fp2& A, Fp2& B, Fp2& C,
                                         const G2A& Q, const Fp& xP,
                                         const Fp& yP, const BnConsts& k) {
  Fp2 m[3];                              // dX, dY, dX yQ
  mul_to(m[0], Q.x, T.Z);
  sub_to(m[0], T.X, m[0]);
  mul_to(m[1], Q.y, T.Z);
  sub_to(m[1], T.Y, m[1]);
  A = f2_scale(m[0], yP);
  B = f2_scale(f2_neg(m[1]), xP);
  mul_to(C, m[1], Q.x);
  mul_to(m[2], m[0], Q.y);
  sub_to(C, C, m[2]);
  g2_add_mixed(T, Q, k);
}

// The tower's traits for the cooperative layer (pairing_coop.cuh): its
// types, its formulas' product counts and the Miller loop's points (Q,
// then the two correction points Q1 and nQ2); the layer finds the
// functions above through these types.
struct BnTower {
  using Fp = bn254::Fp;
  using Fp2 = bn254::Fp2;
  using Fp6 = bn254::Fp6;
  using Fp12 = bn254::Fp12;
  using Consts = BnConsts;
  static constexpr int NW = bn254::NW;
  static constexpr int SQR_PRODS = bn254::SQR_PRODS;
  static constexpr int MUL_PRODS = bn254::MUL_PRODS;
  static constexpr int LINE_PRODS = bn254::LINE_PRODS;
  static constexpr int CYC_PRODS = bn254::CYC_PRODS;
  static constexpr int MILLER_POINTS = 3;
};

// -- loads and stores in the plain version's layout --

// value i of a (n, B, 20) limb tensor, lane `lane`, into R = 2^256
__device__ __noinline__ Fp fp_load(const int* base, int B, int i, int lane,
                                   const BnConsts& k) {
  return fp_mul(fp_load13(base + (static_cast<size_t>(i) * B + lane) * 20),
                k.c_in);
}

__device__ __noinline__ void fp_store(int* base, int B, int i, int lane,
                                      const Fp& x, const BnConsts& k) {
  fp_store13(base + (static_cast<size_t>(i) * B + lane) * 20,
             fp_canonical(fp_mul(x, k.c_out)));
}

__device__ __forceinline__ void f12_load(Fp12& f, const int* base, int B,
                                         int lane, const BnConsts& k) {
  for (int i = 0; i < 6; ++i) {
    f12_slot(f, i).c0 = fp_load(base, B, 2 * i, lane, k);
    f12_slot(f, i).c1 = fp_load(base, B, 2 * i + 1, lane, k);
  }
}

__device__ __forceinline__ void f12_store(int* base, int B, int lane,
                                          const Fp12& f, const BnConsts& k) {
  for (int i = 0; i < 6; ++i) {
    fp_store(base, B, 2 * i, lane, f12_slot(f, i).c0, k);
    fp_store(base, B, 2 * i + 1, lane, f12_slot(f, i).c1, k);
  }
}

// BnConsts from its words (the kernels copy it into shared memory)
__device__ __forceinline__ void consts_load(BnConsts& k,
                                            const uint32_t* words, int tid,
                                            int nthreads) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(&k);
  for (int i = tid; i < BN_CONST_WORDS; i += nthreads) dst[i] = words[i];
}

// a Montgomery value as its canonical plain value (the self-tests' out)
__device__ __noinline__ Fp fp_to_plain(const Fp& a) {
  Fp one = fp_zero();
  one.w[0] = 1;
  return fp_canonical(fp_mul(a, one));
}

// -- the tower self-test's per-case body (bn254_pairing.cu; host tests) --
//
// in: 36 plain values as 8 words each: x (Fp12, 12), y (Fp12, 12), P (2),
// T (projective, 6), Q (affine, 4). out: 90 canonical plain values:
// f2_mul(x.c0, y.c0), f2_sqr(x.c0), f2_inv(x.c0), f12_mul(x, y), f12_frob(x),
// f12_inv(x), g2_dbl_line(T, P) (T', line), g2_add_line(T, Q, P) (T',
// line), g2_dbl(T), g2_add_mixed(T, Q) (ops/bn254.py TOWER_OUT).
constexpr int BN_TOWER_IN = 36;
constexpr int BN_TOWER_OUT = 90;

__device__ __noinline__ void bn_tower_selftest(const uint32_t* in,
                                               const BnConsts& k,
                                               uint32_t* out) {
  Fp v[BN_TOWER_IN];
  for (int i = 0; i < BN_TOWER_IN; ++i) {
    Fp a;
    for (int j = 0; j < 8; ++j) a.w[j] = in[8 * i + j];
    v[i] = fp_mul(a, k.r2);
  }
  Fp12 x, y, r;
  for (int i = 0; i < 6; ++i) {
    f12_slot(x, i) = {v[2 * i], v[2 * i + 1]};
    f12_slot(y, i) = {v[12 + 2 * i], v[13 + 2 * i]};
  }
  const Fp xP = v[24], yP = v[25];
  const G2P T = {{v[26], v[27]}, {v[28], v[29]}, {v[30], v[31]}};
  const G2A Q = {{v[32], v[33]}, {v[34], v[35]}};
  int n = 0;
  auto put = [&](const Fp& a) {
    const Fp c = fp_to_plain(a);
    for (int j = 0; j < 8; ++j) out[8 * n + j] = c.w[j];
    ++n;
  };
  auto put2 = [&](const Fp2& a) {
    put(a.c0);
    put(a.c1);
  };
  auto put12 = [&](Fp12& a) {
    for (int i = 0; i < 6; ++i) put2(f12_slot(a, i));
  };
  auto putpt = [&](const G2P& p) {
    put2(p.X);
    put2(p.Y);
    put2(p.Z);
  };
  put2(f2_mul(x.d0.c[0], y.d0.c[0]));
  put2(f2_sqr(x.d0.c[0]));
  Fp2 inv, A, B, C;
  f2_inv(inv, x.d0.c[0]);
  put2(inv);
  f12_mul(r, x, y, k);
  put12(r);
  f12_frob(r, x, k);
  put12(r);
  f12_inv(r, x, k);
  put12(r);
  G2P t = T;
  g2_dbl_line(t, A, B, C, xP, yP, k);
  line_to_f12(r, A, B, C);
  putpt(t);
  put12(r);
  t = T;
  g2_add_line(t, A, B, C, Q, xP, yP, k);
  line_to_f12(r, A, B, C);
  putpt(t);
  put12(r);
  t = T;
  g2_dbl(t, k);
  putpt(t);
  t = T;
  g2_add_mixed(t, Q, k);
  putpt(t);
}

}  // namespace bn254
}  // namespace
