// Arithmetic mod n, the order of the P-256 group, on 32-bit limbs: stage
// A's two scalar products u1 = e*w and u2 = r*w (mod n), shared by
// sha_windows.cu and fused_resident.cu through stage_a.cuh.
//
// Values are p256_field.cuh's Fe: 8 little-endian uint32_t words, here a
// residue mod n. Every function is __forceinline__ over fixed arrays
// indexed by compile-time constants (the loops unroll fully), so the
// operands live in registers and nothing reaches the stack; n and its
// constants are compile-time words, as p256_field.cuh's fe_p_word. The
// code is portable C++ (uint64_t accumulators, no inline PTX), so the host
// compiler builds the same header for tests/test_torch_stage_a_host.py;
// PTX carry chains are a later tuning.
//
// n is not a Solinas prime, so the product is Montgomery's (CIOS: Koc,
// Acar, Kaliski, "Analyzing and comparing Montgomery multiplication
// algorithms", 1996), R = 2^256, n0 = -n^-1 mod 2^32:
//     mn_mont(a, b) = a * b * R^-1 mod n, canonical.
// Bound: for a < 2^256 = R and b < n every step of the loop keeps the
// running value t below 2n: t_i = (t_(i-1) + a_i*b + m_i*n) / 2^32 with
// t_(i-1) < 2n and a_i, m_i < 2^32 has a numerator below 2n + (2^32 - 1)n
// + (2^32 - 1)n = 2^33 n, so t_i < 2n (induction from t_0 = 0). The result
// is below 2n and one conditional subtraction of n makes it canonical. So
// a may be any 256-bit value, which lets the digest e enter unreduced (it
// may be >= n), as in the JAX package; b must be below n.
// tests/test_torch_stage_a_host.py checks the bound on the extremes.
//
// Both of stage A's products share w, so one product by R^2 mod n turns w
// into w*R mod n, and two more give u1 = mont(e, wR) = e*w and u2 =
// mont(r, wR) = r*w in plain form: three products for two.

#pragma once

#include <stdint.h>

#include "p256_field.cuh"

namespace {

// n = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
// word i
__host__ __device__ __forceinline__ constexpr uint32_t mn_n_word(int i) {
  return i == 0   ? 0xFC632551u
         : i == 1 ? 0xF3B9CAC2u
         : i == 2 ? 0xA7179E84u
         : i == 3 ? 0xBCE6FAADu
         : i == 6 ? 0u
                  : 0xFFFFFFFFu;
}

// R^2 mod n = 2^512 mod n, word i
__host__ __device__ __forceinline__ constexpr uint32_t mn_r2_word(int i) {
  return i == 0   ? 0xBE79EEA2u
         : i == 1 ? 0x83244C95u
         : i == 2 ? 0x49BD6FA6u
         : i == 3 ? 0x4699799Cu
         : i == 4 ? 0x2B6BEC59u
         : i == 5 ? 0x2845B239u
         : i == 6 ? 0xF3D95620u
                  : 0x66E12D94u;
}

constexpr uint32_t MN_N0 = 0xEE00BC4Fu;   // -n^-1 mod 2^32

// The CIOS loop: t + top * 2^256 = a * b * R^-1 (mod n), below 2n for
// a < 2^256 and b < n (top is 0 or 1). Returns top.
__device__ __forceinline__ uint32_t mn_cios(Fe& t, const Fe& a,
                                            const Fe& b) {
  uint32_t acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // acc += a_i * b (fits: (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1)
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += static_cast<uint64_t>(a.w[i]) * b.w[j] + acc[j];
      acc[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += acc[8];
    acc[8] = static_cast<uint32_t>(c);
    acc[9] = static_cast<uint32_t>(c >> 32);
    // acc = (acc + m * n) / 2^32, m chosen so the low word cancels
    const uint32_t m = acc[0] * MN_N0;
    c = (static_cast<uint64_t>(m) * mn_n_word(0) + acc[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += static_cast<uint64_t>(m) * mn_n_word(j) + acc[j];
      acc[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += acc[8];
    acc[7] = static_cast<uint32_t>(c);
    acc[8] = acc[9] + static_cast<uint32_t>(c >> 32);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) t.w[k] = acc[k];
  return acc[8];
}

// t + top * 2^256 in [0, 2n) -> [0, n): subtract n where it does not
// borrow past the top bit.
__device__ __forceinline__ Fe mn_reduce_once(const Fe& t, uint32_t top) {
  Fe s;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(t.w[i]) - mn_n_word(i) + br;
    s.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;                     // 0 or -1
  }
  const bool keep = static_cast<int64_t>(top) + br < 0;   // t < n
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = keep ? t.w[i] : s.w[i];
  return r;
}

// a * b * R^-1 mod n, canonical, for a < 2^256 and b < n
__device__ __forceinline__ Fe mn_mont(const Fe& a, const Fe& b) {
  Fe t;
  const uint32_t top = mn_cios(t, a, b);
  return mn_reduce_once(t, top);
}

__device__ __forceinline__ Fe mn_r2() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = mn_r2_word(i);
  return r;
}

// Stage A's scalars: u1 = e*w, u2 = r*w (mod n), canonical, for any e, r,
// w below 2^256 (e the digest, unreduced).
__device__ __forceinline__ void mn_scalars(const Fe& e, const Fe& r,
                                           const Fe& w, Fe& u1, Fe& u2) {
  const Fe wR = mn_mont(w, mn_r2());        // w * R mod n, below n
  u1 = mn_mont(e, wR);
  u2 = mn_mont(r, wR);
}

// The self-test's per-case body, run by field_selftest.cu on the card and
// by the host build in the tests: e as (8,) big-endian words (the digest's
// form), r and w as 32-byte big-endian rows (the host's form) -> out[0:8]
// u1 = e*w mod n, out[8:16] u2 = r*w mod n, little-endian words.
__device__ __forceinline__ void mn_selftest(const uint32_t* e_be,
                                            const uint8_t* r8,
                                            const uint8_t* w8,
                                            uint32_t* out) {
  uint32_t ew[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ew[i] = e_be[i];
  Fe u1, u2;
  mn_scalars(fe_from_be_words(ew), fe_load_be(r8), fe_load_be(w8), u1, u2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = u1.w[i];
    out[8 + i] = u2.w[i];
  }
}

}  // namespace
