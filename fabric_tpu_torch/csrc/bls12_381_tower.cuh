// BLS12-381's pairing tower and twist arithmetic on the 32-bit core
// (bls12_381_field.cuh), for csrc/bls12_381_pairing.cu.
//
// The shapes are fabric_tpu/ops/tower.py's, operation for operation, as
// bn254_tower.cuh's are for BN254, so that the Miller values equal the
// plain torch version's (ops/tower.py over the 30-limb field) field value
// for field value, not up to an Fp2 factor:
//   Fp2 = Fp[u]/(u^2+1), Karatsuba (3 products);
//   Fp6 = Fp2[v]/(v^3 - xi), xi = 1 + u, schoolbook (9 Fp2 products);
//   Fp12 = Fp6[w]/(w^2 - v), Karatsuba over Fp6 (3 Fp6 products);
//   Frobenius: conjugate every Fp2 coefficient, times gamma_k
//   (= xi^(k(p-1)/6)) on slots (d0: -, 2, 4; d1: 1, 3, 5);
//   inversion by the adjoint/norm method down to Fermat in Fp (the binary
//   Euclid inverse for the cooperative layer's, f2_inv_binary);
//   and, for the cooperative layer (pairing_coop.cuh) and beside f12_mul,
//   the same values in fewer products: Karatsuba Fp6 (6 Fp2 products),
//   f12_sqr by the complex method, f12_mul_line (the sparse line) and
//   f12_sqr_cyclotomic (Granger-Scott, inside the cyclotomic subgroup);
//   the M-type sparse line: the D-type's coefficients A, B, C scaled by
//   w^3 (which the final exponentiation kills) in slots
//   ((C, B, 0), (0, A, 0)), i.e. w^0, w^2 and w^3;
//   the twist steps, RCB15 a = 0: Alg 9 doubling with the tangent line
//   (A = 2YZ^2 yP, B = -3X^2Z xP, C = 3X^3 - 2Y^2Z), Alg 7 mixed addition
//   with the chord line (A = (X - xQ Z) yP, B = -(Y - yQ Z) xP,
//   C = (Y - yQ Z) xQ - (X - xQ Z) yQ), and both without lines.
// Small integer multiples (xi's coefficients, 2, 3, 8) are binary add
// chains, as in the JAX code. The constants (mont one, R^2, the domain
// factors, b3' = 12(1+u), the gammas, xi) are not typed here: the host
// computes them from bls12_381_ref (ops/bls12_381_kernel.py consts_words)
// and the kernels copy them into shared memory as BlsConsts.
//
// As in bn254_tower.cuh, a few __noinline__ bodies hold the field
// products (nvcc took minutes when every product was inlined): f2_mul,
// f2_sqr, f2_scale and fp2_part (the cooperative layer's). The Fp2
// additions, negations and small multiples are __noinline__ bodies too:
// inlined at every use they make the cooperative kernels tens of
// thousands of instructions, past the instruction cache, and slow the
// build. The Fp2 bodies take their operands by value (in registers: a
// reference needs its operand in memory, the kernels' stack). The Fp6 and Fp12 products, the Frobenius, the inversions and
// the twist steps are __noinline__ calls over references. Outputs may
// alias inputs.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bls12_381_field.cuh"

namespace {
namespace bls381 {

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

struct BlsConsts {
  Fp one;                    // 2^384 mod p: Montgomery 1
  Fp r2;                     // 2^768 mod p: plain -> Montgomery
  Fp c_in;                   // 2^378 mod p: R = 2^390 limbs -> R = 2^384
  Fp c_out;                  // 2^390 mod p: R = 2^384 -> R = 2^390 limbs
  Fp2 b3;                    // 3 b' = 12(1+u) on the twist, Montgomery
  Fp2 gamma[6];              // xi^(k(p-1)/6), Montgomery
  uint32_t xi0, xi1;         // xi = xi0 + xi1 u
};

// 218 words from the host (Fp's alignment pads the struct to 220)
constexpr int CONST_WORDS = 218;
static_assert(offsetof(BlsConsts, xi1) == 4 * (CONST_WORDS - 1),
              "BlsConsts layout");

// Fp2 zero and one (the cooperative layer's generic code reaches them
// through the constants' type)
__device__ __forceinline__ Fp2 f2_zero(const BlsConsts&) {
  return {fp_zero(), fp_zero()};
}

__device__ __forceinline__ Fp2 f2_one(const BlsConsts& k) {
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

// a call: the one body that holds field products, so that every function
// above it compiles to calls and additions (a few seconds of ptxas where
// inlining the products took minutes)
__device__ __noinline__ Fp2 f2_mul(Fp2 a, Fp2 b) {
  const Fp m0 = fp_mul(a.c0, b.c0);
  const Fp m1 = fp_mul(a.c1, b.c1);
  const Fp m2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return {fp_sub(m0, m1), fp_sub(fp_sub(m2, m0), m1)};
}

// the complex squaring: (a0 + a1)(a0 - a1) and 2 a0 a1, 2 products
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

__device__ __noinline__ Fp2 f2_sqr(Fp2 a) {
  const Fp m0 = fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1));
  const Fp m1 = fp_mul(a.c0, a.c1);
  return {m0, fp_add(m1, m1)};
}

__device__ __noinline__ Fp2 f2_scale(Fp2 a, Fp s) {
  return {fp_mul(a.c0, s), fp_mul(a.c1, s)};
}

__device__ __noinline__ Fp2 f2_mul_xi(Fp2 a, const BlsConsts& k) {
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

// 1/a with the Fp inverse by the binary extended Euclid algorithm (the
// cooperative final exponentiation's; f2_inv keeps Fermat's)
__device__ __noinline__ void f2_inv_binary(Fp2& out, const Fp2& a,
                                           const BlsConsts& k) {
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
                                         const BlsConsts& k) {
  const Fp2 t = f2_mul_xi(a.c[2], k);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = t;
}

__device__ __noinline__ void f6_mul(Fp6& r, const Fp6& a, const Fp6& b,
                                    const BlsConsts& k) {
  const Fp2 t0 = f2_mul(a.c[0], b.c[0]), t1 = f2_mul(a.c[1], b.c[1]),
            t2 = f2_mul(a.c[2], b.c[2]);
  const Fp2 r0 = f2_add(t0, f2_mul_xi(f2_add(f2_mul(a.c[1], b.c[2]),
                                             f2_mul(a.c[2], b.c[1])), k));
  const Fp2 r1 = f2_add(f2_add(f2_mul(a.c[0], b.c[1]), f2_mul(a.c[1], b.c[0])),
                        f2_mul_xi(t2, k));
  const Fp2 r2 = f2_add(f2_add(f2_mul(a.c[0], b.c[2]), f2_mul(a.c[2], b.c[0])),
                        t1);
  r.c[0] = r0;
  r.c[1] = r1;
  r.c[2] = r2;
}

__device__ __noinline__ void f6_inv(Fp6& r, const Fp6& a, const BlsConsts& k) {
  const Fp2 &c0 = a.c[0], &c1 = a.c[1], &c2 = a.c[2];
  const Fp2 t0 = f2_sub(f2_sqr(c0), f2_mul_xi(f2_mul(c1, c2), k));
  const Fp2 t1 = f2_sub(f2_mul_xi(f2_sqr(c2), k), f2_mul(c0, c1));
  const Fp2 t2 = f2_sub(f2_sqr(c1), f2_mul(c0, c2));
  const Fp2 norm = f2_add(f2_mul(c0, t0),
                          f2_mul_xi(f2_add(f2_mul(c2, t1), f2_mul(c1, t2)), k));
  Fp2 ninv;
  f2_inv(ninv, norm);
  r.c[0] = f2_mul(t0, ninv);
  r.c[1] = f2_mul(t1, ninv);
  r.c[2] = f2_mul(t2, ninv);
}

// -- Fp12 --

__device__ __forceinline__ void f12_one(Fp12& r, const BlsConsts& k) {
  r.d0.c[0] = {k.one, fp_zero()};
  r.d0.c[1] = r.d0.c[2] = f2_zero();
  r.d1.c[0] = r.d1.c[1] = r.d1.c[2] = f2_zero();
}

__device__ __forceinline__ void f12_zero(Fp12& r) {
#pragma unroll
  for (int i = 0; i < 3; ++i) r.d0.c[i] = r.d1.c[i] = f2_zero();
}

__device__ __noinline__ void f12_mul(Fp12& r, const Fp12& a, const Fp12& b,
                                     const BlsConsts& k) {
  Fp6 t0, t1, sa, sb, t2;
  f6_mul(t0, a.d0, b.d0, k);
  f6_mul(t1, a.d1, b.d1, k);
  f6_add(sa, a.d0, a.d1);
  f6_add(sb, b.d0, b.d1);
  f6_mul(t2, sa, sb, k);
  f6_add(sa, t0, t1);
  f6_sub(r.d1, t2, sa);
  f6_mul_v(t1, t1, k);
  f6_add(r.d0, t0, t1);
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
// threads, a round of products, one of terms and one of coefficients,
// every job of a product round through ONE f2_mul (or f2_sqr) call site:
// a warp runs the distinct call sites and formulas of a round one after
// another. A coefficient reads terms or products and at most its own
// input slot, so an output may alias its input.

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
                                        const BlsConsts& k) {
  if (i == 0)
    return f2_add(p[0], f2_mul_xi(f2_sub(p[3], f2_add(p[1], p[2])), k));
  if (i == 1)
    return f2_add(f2_sub(p[4], f2_add(p[0], p[1])), f2_mul_xi(p[2], k));
  return f2_add(f2_sub(p[5], f2_add(p[0], p[2])), p[1]);
}

// A product's coefficients come in two rounds: first "terms", each an
// Fp6 product's coefficient (one short formula a job), then the outputs
// from the terms: a warp runs every distinct formula of a round one after
// another, so short rounds beat one round of long, different formulas.
//
// term j of the Karatsuba Fp6 products in p: coefficient j % 3 of the
// product of products 6 (j / 3) .. 6 (j / 3) + 5
__device__ __noinline__ Fp2 f6k_term(const Fp2* p, int j,
                                     const BlsConsts& k) {
  return f6k_coef(p + 6 * (j / 3), j % 3, k);
}

// r = (T0 + v T1, T2 - T0 - T1) from terms t (T0 = t0..2, T1 = t3..5, T2
// = t6..8): Karatsuba over the Fp12 halves, (v t)_i = xi t_2, t_0, t_1
__device__ __noinline__ Fp2 kara_coef(const Fp2* t, int i,
                                      const BlsConsts& k) {
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
                                             Fp2& y, const BlsConsts& k) {
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
__device__ __noinline__ Fp2 sqr_coef(const Fp2* t, int i,
                                     const BlsConsts& k) {
  if (i >= 3) return f2_add(t[i - 3], t[i - 3]);
  const Fp2 vt = i == 0 ? f2_mul_xi(t[2], k) : t[i - 1];
  return f2_sub(t[3 + i], f2_add(t[i], vt));
}

// f * the M-type line (C + B v) + (A v) w, 13 products: f0 (C + B v) by
// sparse Karatsuba (0-4), f1 (A v) (5-7), (f0 + f1)(C + (A + B) v)
// (8-12); terms line_term (9), then kara_coef
constexpr int LINE_PRODS = 13;

__device__ __forceinline__ void line_operands(const Fp12& f, const Fp2& A,
                                              const Fp2& B, const Fp2& C,
                                              int j, Fp2& x, Fp2& y) {
  if (j >= 5 && j < 8) {
    x = f.d1.c[j - 5];
    y = A;
    return;
  }
  Fp2 g0, g1, g2, b = B;
  if (j < 5) {
    g0 = f.d0.c[0];
    g1 = f.d0.c[1];
    g2 = f.d0.c[2];
  } else {
    g0 = f2_add(f.d0.c[0], f.d1.c[0]);
    g1 = f2_add(f.d0.c[1], f.d1.c[1]);
    g2 = f2_add(f.d0.c[2], f.d1.c[2]);
    b = f2_add(A, B);
    j -= 8;
  }
  x = j == 0 ? g0 : j == 1 ? g1 : j == 2 ? f2_add(g0, g1) : g2;
  y = j == 1 || j == 3 ? b : j == 2 ? f2_add(C, b) : C;
}

// the terms: f0 l0 (0-2), f1 l1 = (xi q7, q5, q6) (3-5), (f0 + f1)(l0 +
// l1) (6-8); then kara_coef
__device__ __noinline__ Fp2 line_term(const Fp2* q, int j,
                                      const BlsConsts& k) {
  const Fp2* s = j < 6 ? q : q + 8;      // f0 l0 or (f0 + f1)(l0 + l1)
  switch (j < 6 ? j : j - 6) {
    case 0: return f2_add(s[0], f2_mul_xi(s[3], k));
    case 1: return f2_sub(s[2], f2_add(s[0], s[1]));
    case 2: return f2_add(s[1], s[4]);
    case 3: return f2_mul_xi(q[7], k);
    case 4: return q[5];
    default: return q[6];
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
                                     const BlsConsts& k) {
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
                                              Fp2& y, const BlsConsts& k) {
  x = f2_conj(f12_slot(a, i));
  if (i == 0) {
    y = f2_one(k);
  } else {
    y = k.gamma[i == 1 ? 2 : i == 2 ? 4 : i == 3 ? 1 : i == 4 ? 3 : 5];
  }
}

__device__ __noinline__ void f12_sqr(Fp12& r, const Fp12& a,
                                     const BlsConsts& k) {
  Fp2 p[SQR_PRODS], t[6], x, y;
  for (int j = 0; j < SQR_PRODS; ++j) {
    sqr_operands(a, j, x, y, k);
    p[j] = f2_mul(x, y);
  }
  for (int j = 0; j < 6; ++j) t[j] = f6k_term(p, j, k);
  for (int i = 0; i < 6; ++i) f12_slot(r, i) = sqr_coef(t, i, k);
}

__device__ __noinline__ void f12_mul_line(Fp12& r, const Fp12& f,
                                          const Fp2& A, const Fp2& B,
                                          const Fp2& C, const BlsConsts& k) {
  Fp2 q[LINE_PRODS], t[9], x, y;
  for (int j = 0; j < LINE_PRODS; ++j) {
    line_operands(f, A, B, C, j, x, y);
    q[j] = f2_mul(x, y);
  }
  for (int j = 0; j < 9; ++j) t[j] = line_term(q, j, k);
  for (int i = 0; i < 6; ++i) f12_slot(r, i) = kara_coef(t, i, k);
}

__device__ __noinline__ void f12_sqr_cyclotomic(Fp12& r, const Fp12& f,
                                                const BlsConsts& k) {
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
                                      const BlsConsts& k) {
  const Fp2 c00 = f2_conj(a.d0.c[0]);
  const Fp2 c01 = f2_mul(f2_conj(a.d0.c[1]), k.gamma[2]);
  const Fp2 c02 = f2_mul(f2_conj(a.d0.c[2]), k.gamma[4]);
  const Fp2 c10 = f2_mul(f2_conj(a.d1.c[0]), k.gamma[1]);
  const Fp2 c11 = f2_mul(f2_conj(a.d1.c[1]), k.gamma[3]);
  const Fp2 c12 = f2_mul(f2_conj(a.d1.c[2]), k.gamma[5]);
  r.d0.c[0] = c00;
  r.d0.c[1] = c01;
  r.d0.c[2] = c02;
  r.d1.c[0] = c10;
  r.d1.c[1] = c11;
  r.d1.c[2] = c12;
}

__device__ __noinline__ void f12_inv(Fp12& r, const Fp12& a,
                                     const BlsConsts& k) {
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
__device__ __forceinline__ bool gt_is_one(const Fp12& f, const BlsConsts& k) {
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

// the M-type sparse line as an Fp12 element: slots w^0, w^2, w^3
__device__ __forceinline__ void line_to_f12(Fp12& l, const Fp2& A,
                                            const Fp2& B, const Fp2& C) {
  l.d0.c[0] = C;
  l.d0.c[1] = B;
  l.d0.c[2] = f2_zero();
  l.d1.c[0] = f2_zero();
  l.d1.c[1] = A;
  l.d1.c[2] = f2_zero();
}

// -- the twist steps (RCB15, a = 0) --

// RCB15 Alg 9 doubling of T in place (the body shared with the line step)
__device__ __forceinline__ void g2_dbl_body(G2P& T, const BlsConsts& k) {
  const Fp2 X = T.X, Y = T.Y, Z = T.Z;
  Fp2 t0 = f2_sqr(Y);
  Fp2 Z3 = f2_small(t0, 8);
  Fp2 t1 = f2_mul(Y, Z);
  Fp2 t2 = f2_mul(k.b3, f2_sqr(Z));
  Fp2 X3 = f2_mul(t2, Z3);
  Fp2 Y3 = f2_add(t0, t2);
  Z3 = f2_mul(t1, Z3);
  t1 = f2_small(t2, 2);
  t2 = f2_add(t1, t2);
  t0 = f2_sub(t0, t2);
  Y3 = f2_mul(t0, Y3);
  Y3 = f2_add(X3, Y3);
  t1 = f2_mul(X, Y);
  X3 = f2_mul(t0, t1);
  T.X = f2_small(X3, 2);
  T.Y = Y3;
  T.Z = Z3;
}

__device__ __noinline__ void g2_dbl(G2P& T, const BlsConsts& k) {
  g2_dbl_body(T, k);
}

// doubling plus the tangent line at the old T, evaluated at (xP, yP)
__device__ __noinline__ void g2_dbl_line(G2P& T, Fp12& l, const Fp& xP,
                                         const Fp& yP, const BlsConsts& k) {
  const Fp2 X = T.X, Y = T.Y, Z = T.Z;
  const Fp2 Z2 = f2_sqr(Z), X2 = f2_sqr(X), YZ = f2_mul(Y, Z);
  const Fp2 A = f2_scale(f2_small(f2_mul(Y, Z2), 2), yP);
  const Fp2 B = f2_scale(f2_neg(f2_small(f2_mul(X2, Z), 3)), xP);
  const Fp2 C = f2_sub(f2_small(f2_mul(X2, X), 3), f2_small(f2_mul(Y, YZ), 2));
  g2_dbl_body(T, k);
  line_to_f12(l, A, B, C);
}

// RCB15 Alg 7 with Z2 = 1 (Z2 still enters as the Fp2 (one, 0)), T += Q
__device__ __forceinline__ void g2_add_body(G2P& T, const G2A& Q,
                                            const BlsConsts& k) {
  const Fp2 X1 = T.X, Y1 = T.Y, Z1 = T.Z;
  const Fp2 X2 = Q.x, Y2 = Q.y, Z2 = {k.one, fp_zero()};
  Fp2 t0 = f2_mul(X1, X2);
  Fp2 t1 = f2_mul(Y1, Y2);
  Fp2 t2 = f2_mul(Z1, Z2);
  Fp2 t3 = f2_mul(f2_add(X1, Y1), f2_add(X2, Y2));
  t3 = f2_sub(t3, f2_add(t0, t1));
  Fp2 t4 = f2_mul(f2_add(Y1, Z1), f2_add(Y2, Z2));
  t4 = f2_sub(t4, f2_add(t1, t2));
  Fp2 X3 = f2_mul(f2_add(X1, Z1), f2_add(X2, Z2));
  Fp2 Y3 = f2_sub(X3, f2_add(t0, t2));
  t0 = f2_small(t0, 3);
  t2 = f2_mul(k.b3, t2);
  Fp2 Z3 = f2_add(t1, t2);
  t1 = f2_sub(t1, t2);
  Y3 = f2_mul(k.b3, Y3);
  X3 = f2_mul(t4, Y3);
  X3 = f2_sub(f2_mul(t3, t1), X3);
  Y3 = f2_mul(Y3, t0);
  Y3 = f2_add(f2_mul(t1, Z3), Y3);
  Z3 = f2_mul(Z3, t4);
  Z3 = f2_add(Z3, f2_mul(t0, t3));
  T.X = X3;
  T.Y = Y3;
  T.Z = Z3;
}

__device__ __noinline__ void g2_add_mixed(G2P& T, const G2A& Q,
                                          const BlsConsts& k) {
  g2_add_body(T, Q, k);
}

// mixed addition plus the chord line through the old T and Q at (xP, yP)
__device__ __noinline__ void g2_add_line(G2P& T, Fp12& l, const G2A& Q,
                                         const Fp& xP, const Fp& yP,
                                         const BlsConsts& k) {
  const Fp2 dX = f2_sub(T.X, f2_mul(Q.x, T.Z));
  const Fp2 dY = f2_sub(T.Y, f2_mul(Q.y, T.Z));
  const Fp2 A = f2_scale(dX, yP);
  const Fp2 B = f2_scale(f2_neg(dY), xP);
  const Fp2 C = f2_sub(f2_mul(dY, Q.x), f2_mul(dX, Q.y));
  g2_add_body(T, Q, k);
  line_to_f12(l, A, B, C);
}

// The tower's traits for the cooperative layer (pairing_coop.cuh): its
// types and its formulas' product counts; the layer finds the functions
// above through these types.
struct BlsTower {
  using Fp = bls381::Fp;
  using Fp2 = bls381::Fp2;
  using Fp6 = bls381::Fp6;
  using Fp12 = bls381::Fp12;
  using Consts = BlsConsts;
  static constexpr int SQR_PRODS = bls381::SQR_PRODS;
  static constexpr int MUL_PRODS = bls381::MUL_PRODS;
  static constexpr int LINE_PRODS = bls381::LINE_PRODS;
  static constexpr int CYC_PRODS = bls381::CYC_PRODS;
};

// -- loads and stores in the plain version's layout --

// value i of a (n, B, 30) limb tensor, lane `lane`, into R = 2^384
__device__ __noinline__ Fp fp_load(const int* base, int B, int i, int lane,
                                   const BlsConsts& k) {
  return fp_mul(fp_load13(base + (static_cast<size_t>(i) * B + lane) * NL),
                k.c_in);
}

__device__ __noinline__ void fp_store(int* base, int B, int i, int lane,
                                      const Fp& x, const BlsConsts& k) {
  fp_store13(base + (static_cast<size_t>(i) * B + lane) * NL,
             fp_canonical(fp_mul(x, k.c_out)));
}

__device__ __forceinline__ void f12_load(Fp12& f, const int* base, int B,
                                         int lane, const BlsConsts& k) {
  for (int i = 0; i < 6; ++i) {
    f12_slot(f, i).c0 = fp_load(base, B, 2 * i, lane, k);
    f12_slot(f, i).c1 = fp_load(base, B, 2 * i + 1, lane, k);
  }
}

__device__ __forceinline__ void f12_store(int* base, int B, int lane,
                                          Fp12& f, const BlsConsts& k) {
  for (int i = 0; i < 6; ++i) {
    fp_store(base, B, 2 * i, lane, f12_slot(f, i).c0, k);
    fp_store(base, B, 2 * i + 1, lane, f12_slot(f, i).c1, k);
  }
}

// BlsConsts from its words (the kernels copy it into shared memory)
__device__ __forceinline__ void consts_load(BlsConsts& k,
                                            const uint32_t* words, int tid,
                                            int nthreads) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(&k);
  for (int i = tid; i < CONST_WORDS; i += nthreads) dst[i] = words[i];
}

// a Montgomery value as its canonical plain value (the self-tests' out)
__device__ __noinline__ Fp fp_to_plain(const Fp& a) {
  Fp one = fp_zero();
  one.w[0] = 1;
  return fp_canonical(fp_mul(a, one));
}

// -- the tower self-test's per-case body (bls12_381_pairing.cu; host
// tests) --
//
// in: 36 plain values as 12 words each: x (Fp12, 12), y (Fp12, 12), P (2),
// T (projective, 6), Q (affine, 4). out: 90 canonical plain values:
// f2_mul(x.c0, y.c0), f2_sqr(x.c0), f2_inv(x.c0), f12_mul(x, y), f12_frob(x),
// f12_inv(x), g2_dbl_line(T, P) (T', line), g2_add_line(T, Q, P) (T',
// line), g2_dbl(T), g2_add_mixed(T, Q) (ops/bls12_381_kernel.py
// TOWER_OUT).
constexpr int TOWER_IN = 36;
constexpr int TOWER_OUT = 90;

__device__ __noinline__ void tower_selftest(const uint32_t* in,
                                            const BlsConsts& k,
                                            uint32_t* out) {
  Fp v[TOWER_IN];
#pragma unroll 1
  for (int i = 0; i < TOWER_IN; ++i) {
    Fp a;
    for (int j = 0; j < NW; ++j) a.w[j] = in[NW * i + j];
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
    for (int j = 0; j < NW; ++j) out[NW * n + j] = c.w[j];
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
  Fp2 inv;
  f2_inv(inv, x.d0.c[0]);
  put2(inv);
  f12_mul(r, x, y, k);
  put12(r);
  f12_frob(r, x, k);
  put12(r);
  f12_inv(r, x, k);
  put12(r);
  G2P t = T;
  g2_dbl_line(t, r, xP, yP, k);
  putpt(t);
  put12(r);
  t = T;
  g2_add_line(t, r, Q, xP, yP, k);
  putpt(t);
  put12(r);
  t = T;
  g2_dbl(t, k);
  putpt(t);
  t = T;
  g2_add_mixed(t, Q, k);
  putpt(t);
}

}  // namespace bls381
}  // namespace
