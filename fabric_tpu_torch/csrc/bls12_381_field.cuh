// The field mod BLS12-381's p on 32-bit limbs, Montgomery form for
// R = 2^384: the core of the aggregate-verify kernels
// (csrc/bls12_381_pairing.cu).
//
//   p = 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624
//         1eabfffeb153ffffb9feffffffffaaab   (381 bits)
//
// An element is 12 little-endian uint32_t words holding a value below 2p of
// its residue class, in Montgomery form x * 2^384 mod p (lazy reduction):
//   * fp_mul is CIOS Montgomery multiplication (word-level reduction).
//     4p < 2^383 < R, so inputs below 2p give a product below 4p^2 < p * R
//     and one REDC pass returns a value below 2p with no final subtraction;
//   * fp_add subtracts 2p once when the sum reaches it; fp_sub adds 2p back
//     on a borrow: both keep values below 2p;
//   * fp_canonical (one conditional subtraction of p) gives [0, p), for
//     compares and stores only;
//   * fp_inv is Fermat's x^(p-2) by square-and-multiply over p - 2's bits;
//     fp_inv_binary the binary extended Euclid algorithm (variable time,
//     ~6x fewer cycles on the card: the final exponentiation's 1/f).
// The kernels' operands arrive as the plain torch version's 30 x 13-bit
// limbs in Montgomery form for R = 2^390 (ops/mont.py, values below 2p):
// fp_load13 packs them into words, and a product by 2^378 mod p moves a
// value into R = 2^384 (x 2^390 * 2^378 / 2^384 = x 2^384); on the way out
// a product by 2^390 mod p moves it back, canonical, and fp_store13 splits
// it into 13-bit limbs. Those factors reach the kernels with the tower's
// constants (bls12_381_tower.cuh BlsConsts), computed on the host.
//
// As bn254_field.cuh: portable C++ (uint64_t accumulators, no inline PTX)
// that the host compiler also builds for
// tests/test_torch_bls12_381_field_host.py. Everything lives in namespace
// bls381 so that its names (Fp, fp_mul, ...) never meet BN254's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace bls381 {

constexpr int NW = 12;       // words a value
constexpr int NL = 30;       // 13-bit limbs a value in the plain layout

// 16-byte aligned: shared-memory operands load and store as 128-bit words
struct alignas(16) Fp {
  uint32_t w[NW];
};

// p, word i
__host__ __device__ __forceinline__ constexpr uint32_t p_word(int i) {
  return i == 0    ? 0xFFFFAAABu
         : i == 1  ? 0xB9FEFFFFu
         : i == 2  ? 0xB153FFFFu
         : i == 3  ? 0x1EABFFFEu
         : i == 4  ? 0xF6B0F624u
         : i == 5  ? 0x6730D2A0u
         : i == 6  ? 0xF38512BFu
         : i == 7  ? 0x64774B84u
         : i == 8  ? 0x434BACD7u
         : i == 9  ? 0x4B1BA7B6u
         : i == 10 ? 0x397FE69Au
                   : 0x1A0111EAu;
}

// 2p, word i (2p < 2^382)
__host__ __device__ __forceinline__ constexpr uint32_t p2_word(int i) {
  return (p_word(i) << 1) | (i == 0 ? 0u : p_word(i - 1) >> 31);
}

// -p^-1 mod 2^32
constexpr uint32_t PINV = 0xFFFCFFFDu;

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0u;
  return r;
}

// x - m (m = p or 2p by `two`) where that does not borrow, else x
__device__ __forceinline__ Fp fp_sub_m_if(const Fp& x, bool two) {
  Fp t;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int64_t d = static_cast<int64_t>(x.w[i]) -
                      (two ? p2_word(i) : p_word(i)) + br;
    t.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;
  }
  const bool keep = br != 0;
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = keep ? x.w[i] : t.w[i];
  return r;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + b.w[i];
    s.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return fp_sub_m_if(s, true);          // a + b < 4p < 2^384: no carry out
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int64_t t = static_cast<int64_t>(a.w[i]) - b.w[i] + br;
    d.w[i] = static_cast<uint32_t>(t);
    br = t >> 32;
  }
  // a - b in (-2p, 2p): on a borrow add 2p back (the carry out cancels it)
  const uint32_t mask = br != 0 ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += static_cast<uint64_t>(d.w[i]) + (p2_word(i) & mask);
    d.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return d;
}

__device__ __forceinline__ Fp fp_neg(const Fp& a) { return fp_sub(fp_zero(), a); }

// CIOS Montgomery product a * b / 2^384 mod p: inputs below 2p, output
// below 2p
__device__ __forceinline__ Fp fp_mul(const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += static_cast<uint64_t>(a.w[j]) * b.w[i] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[NW];
    t[NW] = static_cast<uint32_t>(c);
    t[NW + 1] = static_cast<uint32_t>(c >> 32);
    const uint32_t m = t[0] * PINV;
    c = static_cast<uint64_t>(m) * p_word(0) + t[0];
    c >>= 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c += static_cast<uint64_t>(m) * p_word(j) + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = static_cast<uint32_t>(c);
    t[NW] = t[NW + 1] + static_cast<uint32_t>(c >> 32);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = t[i];
  return r;
}

__device__ __forceinline__ Fp fp_canonical(const Fp& x) {
  return fp_sub_m_if(x, false);
}

__device__ __forceinline__ bool fp_eq_words(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  return fp_eq_words(fp_canonical(a), fp_zero());
}

// x^(p-2): square-and-multiply from p - 2's top bit (bit 380) down (p's
// low word ends in 0xAAAB, so p - 2 only changes word 0)
__device__ __noinline__ void fp_inv(Fp& out, const Fp& x) {
  Fp acc = x;
  for (int i = 379; i >= 0; --i) {
    acc = fp_mul(acc, acc);
    const uint32_t e = p_word(i >> 5) - (i < 32 ? 2u : 0u);
    if ((e >> (i & 31)) & 1u) acc = fp_mul(acc, x);
  }
  out = acc;
}

// -- the binary extended-Euclid inverse (the cooperative final
// exponentiation's 1/f, pairing_coop.cuh) --

__device__ __forceinline__ bool w_is_one(const Fp& a) {
  uint32_t acc = a.w[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < NW; ++i) acc |= a.w[i];
  return acc == 0;
}

// a >= b as 384-bit integers
__device__ __forceinline__ bool w_geq(const Fp& a, const Fp& b) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i)
    br = (static_cast<int64_t>(a.w[i]) - b.w[i] + br) >> 32;
  return br == 0;
}

// a - b (a >= b)
__device__ __forceinline__ void w_sub(Fp& a, const Fp& b) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int64_t d = static_cast<int64_t>(a.w[i]) - b.w[i] + br;
    a.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;
  }
}

// a / 2 mod p for a < p: (a + p) / 2 when a is odd (a + p < 2^382)
__device__ __forceinline__ void w_half_mod(Fp& a) {
  const uint32_t odd = a.w[0] & 1u ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + (p_word(i) & odd);
    a.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
#pragma unroll
  for (int i = 0; i < NW - 1; ++i)
    a.w[i] = (a.w[i] >> 1) | (a.w[i + 1] << 31);
  a.w[NW - 1] >>= 1;
}

__device__ __forceinline__ void w_half(Fp& a) {
#pragma unroll
  for (int i = 0; i < NW - 1; ++i)
    a.w[i] = (a.w[i] >> 1) | (a.w[i + 1] << 31);
  a.w[NW - 1] >>= 1;
}

// x^-1 for x in Montgomery form (below 2p; 0 for 0, as fp_inv): the
// binary extended Euclid algorithm on a = x mod p and p (Hankerson,
// Menezes, Vanstone, Alg. 2.22), keeping u = x1 a and v = x2 a mod p, then
// two products by R^2 move a^-1 = x^-1 R^-1 to x^-1 R. Variable time: its
// input is public (a product of pairings). At most 2 * 381 halvings and
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
  for (int i = 0; i < NW; ++i) v.w[i] = p_word(i);
  x1.w[0] = 1u;
  for (int round = 0; round < 4 * 384 && !w_is_one(u) && !w_is_one(v);
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

// 30 13-bit limbs (any value below 2^384, limbs up to 2^13) -> words.
// Plain loads: the self-test also reads a local array through it.
__device__ __forceinline__ Fp fp_load13(const int* src) {
  Fp r;
  uint64_t acc = 0;
  int nacc = 0, j = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    acc += static_cast<uint64_t>(static_cast<uint32_t>(src[i])) << nacc;
    nacc += 13;
    if (nacc >= 32) {
      r.w[j++] = static_cast<uint32_t>(acc);
      acc >>= 32;
      nacc -= 32;
    }
  }
  return r;
}

// words (a value below 2^384) -> 30 strict 13-bit limbs
__device__ __forceinline__ void fp_store13(int* dst, const Fp& x) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int bit = 13 * i, w = bit >> 5, s = bit & 31;
    uint64_t v = x.w[w] >> s;
    if (s > 19 && w < NW - 1)
      v |= static_cast<uint64_t>(x.w[w + 1]) << (32 - s);
    dst[i] = static_cast<int>(v & 0x1FFFu);
  }
}

// The self-test's per-case body (bls12_381_pairing.cu on the card, the host
// build in the tests): a, b plain values below 2p as 12 words, r2 = 2^768
// mod p -> out[0:12] a mod p, [12:24] a + b, [24:36] a - b, [36:48] a * b,
// [48:60] a^-1 (0 for 0), [60:72] a through the 13-bit layout (a * 2^390
// mod p stored as 30 limbs, loaded back and moved into R = 2^384 by c_in),
// canonical plain words.
__device__ __forceinline__ void fp_selftest(const uint32_t* a32,
                                            const uint32_t* b32,
                                            const Fp& r2, const Fp& c_in,
                                            const Fp& c_out, uint32_t* out) {
  Fp a, b, one = fp_zero();
  one.w[0] = 1;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    a.w[i] = a32[i];
    b.w[i] = b32[i];
  }
  const Fp am = fp_mul(a, r2), bm = fp_mul(b, r2);
  Fp inv;
  fp_inv(inv, am);
  int limbs[NL];
  fp_store13(limbs, fp_canonical(fp_mul(am, c_out)));
  const Fp back = fp_mul(fp_load13(limbs), c_in);
  const Fp res[6] = {fp_canonical(a), fp_canonical(fp_mul(fp_add(am, bm), one)),
                     fp_canonical(fp_mul(fp_sub(am, bm), one)),
                     fp_canonical(fp_mul(fp_mul(am, bm), one)),
                     fp_canonical(fp_mul(inv, one)),
                     fp_canonical(fp_mul(back, one))};
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int i = 0; i < NW; ++i) out[NW * k + i] = res[k].w[i];
}

}  // namespace bls381
}  // namespace
