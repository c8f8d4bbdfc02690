// 13-bit-limb modular arithmetic and the P-256 complete addition, shared
// by the port's CUDA kernels (ptree.cu, sha_windows.cu, fused_resident.cu).
//
// The JAX package's limb.Mod / ptree.KMod, operation for operation: a
// 256-bit value is 20 little-endian int32 limbs of 13 bits, semi-reduced
// (limbs in [0, 2^13], value < 2^256 + 2^243); every product column stays
// below 20 * 2^26 < 2^31, so every int32 bound proved in
// fabric_tpu_torch/ops/limb.py holds here. A modulus enters as its packed
// constants (25, 20) int32, fabric_tpu_torch/ops/ptree.py
// KMod.pack_consts: rows [c256, sub_off, m_limbs, A, B3, fold_hi[0..19]].
// The same functions serve p (the field) and n (the group order): n is not
// a Solinas prime, and the fold_hi rows carry it as they carry p.
//
// Everything sits in an anonymous namespace: each kernel library is its
// own translation unit.

#pragma once

#include <stdint.h>

namespace {

constexpr int L = 20;                 // limbs per 256-bit value
constexpr int W = 13;                 // bits per limb
constexpr int MASK = (1 << W) - 1;
constexpr int NCONST = 5 + L;         // packed constant rows
constexpr int ROW_C256 = 0 * L;
constexpr int ROW_SUB_OFF = 1 * L;
constexpr int ROW_M = 2 * L;
constexpr int ROW_A = 3 * L;
constexpr int ROW_B3 = 4 * L;
constexpr int ROW_FOLD_HI = 5 * L;    // fold_hi[k] at ROW_FOLD_HI + k * L

// Three carry rounds: non-negative limbs < 2^31 -> limbs in [0, 2^13]. Each
// round adds limb i-1's carry into limb i; the top carry is dropped.
template <int N>
__device__ __forceinline__ void carry3(int (&x)[N]) {
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    int carry_in = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = x[i] >> W;
      x[i] = (x[i] & MASK) + carry_in;
      carry_in = c;
    }
  }
}

// Fold bits >= 256 back in: x = hi * 2^256 + lo == hi * c256 + lo (mod p).
// Input: carried limbs of width K in {L, L+1, L+2}, value < 2^274.
// Output: width L, value < 2^256 + 2^243.
template <int K>
__device__ __forceinline__ void fold256(int (&out)[L], const int (&x)[K],
                                        const int* C) {
  int h0 = x[L - 1] >> 9;
  int h1 = 0;
  if constexpr (K > L) {
    h0 += (x[L] & 0x1FF) << 4;
    h1 = x[L] >> 9;
  }
  if constexpr (K > L + 1) {
    h1 += (x[L + 1] & 0x1FF) << 4;
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int lo = (i == L - 1) ? (x[i] & 0x1FF) : x[i];
    out[i] = lo + h0 * C[ROW_C256 + i];
  }
  if constexpr (K > L) {
    // h1 weighs 2^13 more than h0: c256 shifted up one limb
#pragma unroll
    for (int i = 1; i < L; ++i) out[i] += h1 * C[ROW_C256 + i - 1];
  }
  carry3(out);
}

__device__ __noinline__ void mulmod(int* out, const int* a, const int* b,
                                    const int* C) {
  int cols[2 * L];
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int ai = a[i];
#pragma unroll
    for (int j = 0; j < L; ++j) cols[i + j] += ai * b[j];
  }
  carry3(cols);
  int acc[L + 2];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = cols[i];
  acc[L] = 0;
  acc[L + 1] = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int h = cols[L + k];
#pragma unroll
    for (int i = 0; i < L; ++i) acc[i] += h * C[ROW_FOLD_HI + k * L + i];
  }
  carry3(acc);
  int t[L], u[L];
  fold256<L + 2>(t, acc, C);
  fold256<L>(u, t, C);
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = u[i];
}

__device__ __noinline__ void addmod(int* out, const int* a, const int* b,
                                    const int* C) {
  int s[L + 1];
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = a[i] + b[i];
  s[L] = 0;
  carry3(s);
  int u[L];
  fold256<L + 1>(u, s, C);
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = u[i];
}

// a - b + 4p with 4p redistributed so that no limb goes negative
__device__ __noinline__ void submod(int* out, const int* a, const int* b,
                                    const int* C) {
  int s[L + 1];
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = a[i] + C[ROW_SUB_OFF + i] - b[i];
  s[L] = 0;
  carry3(s);
  int u[L];
  fold256<L + 1>(u, s, C);
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = u[i];
}

// Semi-reduced -> canonical [0, p): exact carry, then two conditional
// subtractions (the value is < 2^256 + 2^243 < 2p).
__device__ __noinline__ void canonical(int* out, const int* a,
                                       const int* C) {
  int x[L];
  int c = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int t = a[i] + c;
    x[i] = t & MASK;
    c = t >> W;
  }
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    int s[L];
    int borrow = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int t = x[i] - C[ROW_M + i] + borrow;
      s[i] = t & MASK;
      borrow = t >> W;                // arithmetic shift: borrow = -1
    }
    if (borrow >= 0) {
#pragma unroll
      for (int i = 0; i < L; ++i) x[i] = s[i];
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = x[i];
}

// Complete projective addition (RCB15 Alg. 1), the operation sequence of
// fabric_tpu/ops/ptree.py cadd_k. Outputs may alias inputs: they are
// written only after every input has been read.
__device__ void cadd(int* X3o, int* Y3o, int* Z3o, const int* X1,
                     const int* Y1, const int* Z1, const int* X2,
                     const int* Y2, const int* Z2, const int* C) {
  const int* a = C + ROW_A;
  const int* b3 = C + ROW_B3;
  int t0[L], t1[L], t2[L], t3[L], t4[L], t5[L], u[L], v[L];
  int X3[L], Y3[L], Z3[L], at2[L], nt1[L], nt2[L], nt4[L];
  mulmod(t0, X1, X2, C);
  mulmod(t1, Y1, Y2, C);
  mulmod(t2, Z1, Z2, C);
  addmod(u, X1, Y1, C);
  addmod(v, X2, Y2, C);
  mulmod(t3, u, v, C);
  submod(t3, t3, t0, C);
  submod(t3, t3, t1, C);
  addmod(u, X1, Z1, C);
  addmod(v, X2, Z2, C);
  mulmod(t4, u, v, C);
  submod(t4, t4, t0, C);
  submod(t4, t4, t2, C);
  addmod(u, Y1, Z1, C);
  addmod(v, Y2, Z2, C);
  mulmod(t5, u, v, C);
  submod(t5, t5, t1, C);
  submod(t5, t5, t2, C);
  mulmod(u, a, t4, C);
  mulmod(v, b3, t2, C);
  addmod(Z3, u, v, C);
  submod(X3, t1, Z3, C);
  addmod(Z3, t1, Z3, C);
  mulmod(Y3, X3, Z3, C);
  mulmod(at2, a, t2, C);
  addmod(u, t0, t0, C);
  addmod(v, t0, at2, C);
  addmod(nt1, u, v, C);
  submod(u, t0, at2, C);
  mulmod(nt2, u, a, C);
  mulmod(u, b3, t4, C);
  addmod(nt4, u, nt2, C);
  mulmod(u, nt1, nt4, C);
  addmod(Y3, Y3, u, C);
  mulmod(u, t3, X3, C);
  mulmod(v, t5, nt4, C);
  submod(X3, u, v, C);
  mulmod(u, t5, Z3, C);
  mulmod(v, t3, nt1, C);
  addmod(Z3, u, v, C);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    X3o[i] = X3[i];
    Y3o[i] = Y3[i];
    Z3o[i] = Z3[i];
  }
}

__device__ bool equal_limbs(const int* a, const int* b) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < L; ++i) eq &= (a[i] == b[i]);
  return eq;
}

// The projective verify check on R = (X : Y : Z): Z != 0 and X == r*Z or
// X == rpn*Z (mod p), r and rpn canonical limbs in global memory.
__device__ bool projective_check(const int* X, const int* Z,
                                 const int* __restrict__ r,
                                 const int* __restrict__ rpn, const int* C) {
  int zc[L], xc[L], s[L], t[L];
  canonical(zc, Z, C);
  bool nonzero = false;
#pragma unroll
  for (int i = 0; i < L; ++i) nonzero |= (zc[i] != 0);
  canonical(xc, X, C);
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = r[i];
  mulmod(t, s, Z, C);
  canonical(t, t, C);
  const bool ok1 = equal_limbs(xc, t);
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = rpn[i];
  mulmod(t, s, Z, C);
  canonical(t, t, C);
  const bool ok2 = equal_limbs(xc, t);
  return nonzero && (ok1 || ok2);
}

}  // namespace
