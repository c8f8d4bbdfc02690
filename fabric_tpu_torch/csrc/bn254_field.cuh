// The field mod BN254's p on 32-bit limbs, Montgomery form for R = 2^256:
// the core of the pairing kernels (csrc/bn254_pairing.cu, csrc/g2_msm.cu).
//
//   p = 0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47
//
// An element is 8 little-endian uint32_t words holding a value below 2p of
// its residue class, in Montgomery form x * 2^256 mod p (lazy reduction):
//   * fp_mul is CIOS Montgomery multiplication (word-level reduction: p is
//     dense, no Solinas fold). Inputs below 2p give a product below 4p^2 <
//     p * 2^256 (4p < 2^256), so one REDC pass returns a value below 2p and
//     needs no final subtraction;
//   * fp_add subtracts 2p once when the sum reaches it; fp_sub adds 2p back
//     on a borrow: both keep values below 2p;
//   * fp_canonical (one conditional subtraction of p) gives [0, p), for
//     compares and stores only;
//   * fp_inv is Fermat's x^(p-2) by square-and-multiply over p - 2's bits;
//     fp_inv_binary the binary extended Euclid algorithm (variable time,
//     far fewer cycles on the card: the final exponentiation's 1/f).
// The kernels' operands arrive as the plain torch version's 13-bit limbs in
// Montgomery form for R = 2^260 (ops/mont.py, values below 2p):
// fp_load13 packs them into words, and a product by 2^252 mod p moves a
// value into R = 2^256 (x 2^260 * 2^252 / 2^256 = x 2^256); on the way out
// a product by 2^260 mod p moves it back, canonical, and fp_store13 splits
// it into 13-bit limbs. Those factors reach the kernels with the tower's
// constants (bn254_tower.cuh BnConsts), computed on the host.
//
// As fe25519.cuh: portable C++ (uint64_t accumulators, no inline PTX) that
// the host compiler also builds for tests/test_torch_bn254_field_host.py.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace bn254 {

// 16-byte aligned: shared-memory operands load and store as 128-bit words
struct alignas(16) Fp {
  uint32_t w[8];
};

// p, word i
__host__ __device__ __forceinline__ constexpr uint32_t bn_p_word(int i) {
  return i == 0   ? 0xD87CFD47u
         : i == 1 ? 0x3C208C16u
         : i == 2 ? 0x6871CA8Du
         : i == 3 ? 0x97816A91u
         : i == 4 ? 0x8181585Du
         : i == 5 ? 0xB85045B6u
         : i == 6 ? 0xE131A029u
                  : 0x30644E72u;
}

// 2p, word i (2p < 2^255)
__host__ __device__ __forceinline__ constexpr uint32_t bn_2p_word(int i) {
  return (bn_p_word(i) << 1) | (i == 0 ? 0u : bn_p_word(i - 1) >> 31);
}

// -p^-1 mod 2^32
constexpr uint32_t BN_PINV = 0xE4866389u;

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0u;
  return r;
}

// x - m (m = p or 2p by `two`) where that does not borrow, else x
__device__ __forceinline__ Fp fp_sub_m_if(const Fp& x, bool two) {
  Fp t;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(x.w[i]) -
                      (two ? bn_2p_word(i) : bn_p_word(i)) + br;
    t.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;
  }
  const bool keep = br != 0;
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = keep ? x.w[i] : t.w[i];
  return r;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + b.w[i];
    s.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return fp_sub_m_if(s, true);          // a + b < 4p < 2^256: no carry out
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t t = static_cast<int64_t>(a.w[i]) - b.w[i] + br;
    d.w[i] = static_cast<uint32_t>(t);
    br = t >> 32;
  }
  // a - b in (-2p, 2p): on a borrow add 2p back (the carry out cancels it)
  const uint32_t mask = br != 0 ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(d.w[i]) + (bn_2p_word(i) & mask);
    d.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return d;
}

__device__ __forceinline__ Fp fp_neg(const Fp& a) { return fp_sub(fp_zero(), a); }

// CIOS Montgomery product a * b / 2^256 mod p: inputs below 2p, output
// below 2p
__device__ __forceinline__ Fp fp_mul(const Fp& a, const Fp& b) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += static_cast<uint64_t>(a.w[j]) * b.w[i] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[8];
    t[8] = static_cast<uint32_t>(c);
    t[9] = static_cast<uint32_t>(c >> 32);
    const uint32_t m = t[0] * BN_PINV;
    c = static_cast<uint64_t>(m) * bn_p_word(0) + t[0];
    c >>= 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += static_cast<uint64_t>(m) * bn_p_word(j) + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[8];
    t[7] = static_cast<uint32_t>(c);
    t[8] = t[9] + static_cast<uint32_t>(c >> 32);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = t[i];
  return r;
}

__device__ __forceinline__ Fp fp_canonical(const Fp& x) {
  return fp_sub_m_if(x, false);
}

__device__ __forceinline__ bool fp_eq_words(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  return fp_eq_words(fp_canonical(a), fp_zero());
}

// x^(p-2): square-and-multiply from p - 2's top bit (bit 253) down
__device__ __noinline__ void fp_inv(Fp& out, const Fp& x) {
  Fp acc = x;
  for (int i = 252; i >= 0; --i) {
    acc = fp_mul(acc, acc);
    const uint32_t e = bn_p_word(i >> 5) - (i < 32 ? 2u : 0u);
    if ((e >> (i & 31)) & 1u) acc = fp_mul(acc, x);
  }
  out = acc;
}

__device__ __forceinline__ bool w_is_one(const Fp& a) {
  uint32_t acc = a.w[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < 8; ++i) acc |= a.w[i];
  return acc == 0;
}

// a >= b as 256-bit integers
__device__ __forceinline__ bool w_geq(const Fp& a, const Fp& b) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    br = (static_cast<int64_t>(a.w[i]) - b.w[i] + br) >> 32;
  return br == 0;
}

// a - b (a >= b)
__device__ __forceinline__ void w_sub(Fp& a, const Fp& b) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(a.w[i]) - b.w[i] + br;
    a.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;
  }
}

__device__ __forceinline__ void w_half(Fp& a) {
#pragma unroll
  for (int i = 0; i < 7; ++i) a.w[i] = (a.w[i] >> 1) | (a.w[i + 1] << 31);
  a.w[7] >>= 1;
}

// a / 2 mod p for a < p: (a + p) / 2 when a is odd (a + p < 2^255)
__device__ __forceinline__ void w_half_mod(Fp& a) {
  const uint32_t odd = a.w[0] & 1u ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + (bn_p_word(i) & odd);
    a.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  w_half(a);
}

// x^-1 for x in Montgomery form (below 2p; 0 for 0, as fp_inv): the
// binary extended Euclid algorithm on a = x mod p and p (Hankerson,
// Menezes, Vanstone, Alg. 2.22), keeping u = x1 a and v = x2 a mod p, then
// two products by R^2 move a^-1 = x^-1 R^-1 to x^-1 R. Variable time: its
// input is public (a product of pairings). At most 2 * 254 halvings and
// as many subtractions; the bound on the rounds only guards the card
// against a value it was never meant to see.
__device__ __noinline__ void fp_inv_binary(Fp& out, const Fp& x,
                                           const Fp& r2) {
  Fp u = fp_canonical(x), v, x1 = fp_zero(), x2 = fp_zero();
  if (fp_eq_words(u, fp_zero())) {
    out = u;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v.w[i] = bn_p_word(i);
  x1.w[0] = 1u;
  for (int round = 0; round < 4 * 256 && !w_is_one(u) && !w_is_one(v);
       ++round) {
    while (!(u.w[0] & 1u)) {
      w_half(u);
      w_half_mod(x1);
    }
    while (!(v.w[0] & 1u)) {
      w_half(v);
      w_half_mod(x2);
    }
    if (w_geq(u, v)) {
      w_sub(u, v);
      x1 = fp_canonical(fp_sub(x1, x2));
    } else {
      w_sub(v, u);
      x2 = fp_canonical(fp_sub(x2, x1));
    }
    // u = v happens only at u = v = 1 (gcd(a, p) = 1); a zero would
    // never turn odd
    if (fp_eq_words(u, fp_zero()) || fp_eq_words(v, fp_zero())) break;
  }
  const Fp inv = w_is_one(u) ? x1 : x2;
  out = fp_mul(fp_mul(inv, r2), r2);
}

// 20 13-bit limbs (any value below 2^256, limbs up to 2^13) -> words
__device__ __forceinline__ Fp fp_load13(const int* __restrict__ src) {
  Fp r;
  uint64_t acc = 0;
  int nacc = 0, j = 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    acc += static_cast<uint64_t>(static_cast<uint32_t>(__ldg(src + i)))
           << nacc;
    nacc += 13;
    if (nacc >= 32) {
      r.w[j++] = static_cast<uint32_t>(acc);
      acc >>= 32;
      nacc -= 32;
    }
  }
  return r;
}

// words (a value below 2^256) -> 20 strict 13-bit limbs
__device__ __forceinline__ void fp_store13(int* dst, const Fp& x) {
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    const int bit = 13 * i, w = bit >> 5, s = bit & 31;
    uint64_t v = x.w[w] >> s;
    if (s > 19 && w < 7) v |= static_cast<uint64_t>(x.w[w + 1]) << (32 - s);
    dst[i] = static_cast<int>(v & 0x1FFFu);
  }
}

// The self-test's per-case body (bn254_pairing.cu on the card, the host
// build in the tests): a, b plain values below 2p as 8 words, r2 = 2^512
// mod p -> out[0:8] a mod p, [8:16] a + b, [16:24] a - b, [24:32] a * b,
// [32:40] a^-1 (0 for 0; Fermat's), [40:48] a^-1 by the binary Euclid
// algorithm, canonical plain words.
__device__ __forceinline__ void bn_fp_selftest(const uint32_t* a32,
                                               const uint32_t* b32,
                                               const Fp& r2, uint32_t* out) {
  Fp a, b, one = fp_zero();
  one.w[0] = 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.w[i] = a32[i];
    b.w[i] = b32[i];
  }
  const Fp am = fp_mul(a, r2), bm = fp_mul(b, r2);
  Fp inv, inv_b;
  fp_inv(inv, am);
  fp_inv_binary(inv_b, am, r2);
  const Fp res[6] = {fp_canonical(a), fp_canonical(fp_mul(fp_add(am, bm), one)),
                     fp_canonical(fp_mul(fp_sub(am, bm), one)),
                     fp_canonical(fp_mul(fp_mul(am, bm), one)),
                     fp_canonical(fp_mul(inv, one)),
                     fp_canonical(fp_mul(inv_b, one))};
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) out[8 * k + i] = res[k].w[i];
}

}  // namespace bn254
}  // namespace
