// 13-bit-limb modular arithmetic for stage A's products mod n (stage_a.cuh,
// so sha_windows.cu and fused_resident.cu). The P-256 field and its
// complete addition live in p256_field.cuh, on 32-bit limbs.
//
// The JAX package's limb.Mod / ptree.KMod, operation for operation: a
// 256-bit value is 20 little-endian int32 limbs of 13 bits, semi-reduced
// (limbs in [0, 2^13], value < 2^256 + 2^243); every product column stays
// below 20 * 2^26 < 2^31, so every int32 bound proved in
// fabric_tpu_torch/ops/limb.py holds here. A modulus enters as its packed
// constants (25, 20) int32, fabric_tpu_torch/ops/ptree.py
// KMod.pack_consts: rows [c256, sub_off, m_limbs, A, B3, fold_hi[0..19]]
// (the curve rows A and B3 go unread here). The kernels use it for n, the
// group order, which is not a Solinas prime: the fold_hi rows carry it as
// they would carry p.
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

}  // namespace
