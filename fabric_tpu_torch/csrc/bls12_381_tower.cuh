// BLS12-381's pairing tower and twist arithmetic on the 32-bit core
// (bls12_381_field.cuh), for csrc/bls12_381_pairing.cu.
//
// The shapes are fabric_tpu/ops/tower.py's, operation for operation, as
// bn254_tower.cuh's are for BN254, so that the Miller values equal the
// plain torch version's (ops/tower.py over the 30-limb field) field value
// for field value, not up to an Fp2 factor:
//   Fp2 = Fp[u]/(u^2+1), Karatsuba (3 products);
//   Fp6 = Fp2[v]/(v^3 - xi), xi = 1 + u, schoolbook (9 Fp2 products);
//   Fp12 = Fp6[w]/(w^2 - v), Karatsuba over Fp6 (3 Fp6 products); f12_sqr
//   is f12_mul(a, a);
//   Frobenius: conjugate every Fp2 coefficient, times gamma_k
//   (= xi^(k(p-1)/6)) on slots (d0: -, 2, 4; d1: 1, 3, 5);
//   inversion by the adjoint/norm method down to Fermat in Fp;
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
// As in bn254_tower.cuh, f2_mul is the one __noinline__ body that holds
// field products (nvcc took minutes when every product was inlined); the
// Fp6 and Fp12 products, the Frobenius, the inversions and the twist steps
// are __noinline__ calls over references. Outputs may alias inputs.

#pragma once

#include <cuda_runtime.h>
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

constexpr int CONST_WORDS = sizeof(BlsConsts) / 4;
static_assert(CONST_WORDS == 218, "BlsConsts layout");

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

__device__ __forceinline__ Fp2 f2_add(const Fp2& a, const Fp2& b) {
  return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 f2_sub(const Fp2& a, const Fp2& b) {
  return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2 f2_neg(const Fp2& a) {
  return {fp_neg(a.c0), fp_neg(a.c1)};
}

__device__ __forceinline__ Fp2 f2_conj(const Fp2& a) {
  return {a.c0, fp_neg(a.c1)};
}

__device__ __forceinline__ Fp2 f2_zero() { return {fp_zero(), fp_zero()}; }

// a call: the one body that holds field products, so that every function
// above it compiles to calls and additions (a few seconds of ptxas where
// inlining the products took minutes)
__device__ __noinline__ Fp2 f2_mul(const Fp2& a, const Fp2& b) {
  const Fp m0 = fp_mul(a.c0, b.c0);
  const Fp m1 = fp_mul(a.c1, b.c1);
  const Fp m2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return {fp_sub(m0, m1), fp_sub(fp_sub(m2, m0), m1)};
}

__device__ __forceinline__ Fp2 f2_sqr(const Fp2& a) { return f2_mul(a, a); }

__device__ __forceinline__ Fp2 f2_scale(const Fp2& a, const Fp& s) {
  return {fp_mul(a.c0, s), fp_mul(a.c1, s)};
}

__device__ __forceinline__ Fp2 f2_mul_xi(const Fp2& a, const BlsConsts& k) {
  return {fp_sub(fp_small(a.c0, k.xi0), fp_small(a.c1, k.xi1)),
          fp_add(fp_small(a.c0, k.xi1), fp_small(a.c1, k.xi0))};
}

__device__ __forceinline__ Fp2 f2_small(const Fp2& a, uint32_t k) {
  return {fp_small(a.c0, k), fp_small(a.c1, k)};
}

__device__ __noinline__ void f2_inv(Fp2& out, const Fp2& a) {
  Fp d;
  fp_inv(d, fp_add(fp_mul(a.c0, a.c0), fp_mul(a.c1, a.c1)));
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

// -- loads and stores in the plain version's layout --

// value i of a (n, B, 30) limb tensor, lane `lane`, into R = 2^384
__device__ __forceinline__ Fp fp_load(const int* base, int B, int i,
                                      int lane, const BlsConsts& k) {
  return fp_mul(fp_load13(base + (static_cast<size_t>(i) * B + lane) * NL),
                k.c_in);
}

__device__ __forceinline__ void fp_store(int* base, int B, int i, int lane,
                                         const Fp& x, const BlsConsts& k) {
  fp_store13(base + (static_cast<size_t>(i) * B + lane) * NL,
             fp_canonical(fp_mul(x, k.c_out)));
}

__device__ __forceinline__ Fp2& f12_slot(Fp12& f, int i) {
  return i < 3 ? f.d0.c[i] : f.d1.c[i - 3];
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
  Fp one = fp_zero();
  one.w[0] = 1;
  auto put = [&](const Fp& a) {
    const Fp c = fp_canonical(fp_mul(a, one));
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
