// The field mod p = 2^255 - 19 and the extended twisted Edwards group law
// of Ed25519 (a = -1) on 32-bit limbs, for csrc/ed25519_verify.cu.
//
// A field element is 8 little-endian uint32_t words holding any value in
// [0, 2^256) of its residue class (2^256 = 2p + 38, so a value has up to
// three forms): add, sub and mul take and return such values (a weak
// reduction), and only f25_canonical, used by the check and the
// self-test, subtracts p up to twice to reach [0, p). 2^256 == 38 (mod p),
// so a carry out of bit 256 folds back as + 38 and a borrow as - 38: the
// product's top 256 bits fold in as 38 * hi, and the carry of that sum
// folds once more. As p256_field.cuh: every function is __forceinline__
// over fixed arrays indexed by compile-time constants, portable C++
// (uint64_t accumulators, no inline PTX) that the host compiler also
// builds for tests/test_torch_fe25519_host.py.
//
// Points are extended coordinates (X : Y : Z : T), T = X*Y/Z:
//   ed_add, add-2008-hwcd-3 (Hisil, Wong, Carter, Dawson 2008) with 2d as
//     a constant: 9 products; complete for Ed25519 (d is not a square), so
//     P + P, P + (-P) and the identity need no special case;
//   ed_dbl, dbl-2008-hwcd: 8 products.
// Both mirror bccsp/ed25519_host.py pt_add and pt_double operation for
// operation; outputs may alias inputs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_field.cuh"

namespace {

struct F25 {
  uint32_t w[8];
};

struct EdPt {
  F25 X, Y, Z, T;
};

// p = 2^255 - 19, word i
__host__ __device__ __forceinline__ constexpr uint32_t f25_p_word(int i) {
  return i == 0 ? 0xFFFFFFEDu : i == 7 ? 0x7FFFFFFFu : 0xFFFFFFFFu;
}

// 2d = 2 * (-121665/121666) mod p, word i
__host__ __device__ __forceinline__ constexpr uint32_t f25_d2_word(int i) {
  return i == 0   ? 0x26B2F159u
         : i == 1 ? 0xEBD69B94u
         : i == 2 ? 0x8283B156u
         : i == 3 ? 0x00E0149Au
         : i == 4 ? 0xEEF3D130u
         : i == 5 ? 0x198E80F2u
         : i == 6 ? 0x56DFFCE7u
                  : 0x2406D9DCu;
}

__device__ __forceinline__ F25 f25_small(uint32_t v) {
  F25 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = i == 0 ? v : 0u;
  return r;
}

__device__ __forceinline__ F25 f25_d2() {
  F25 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = f25_d2_word(i);
  return r;
}

// x + v for v < 2^32; returns the carry out of bit 256
__device__ __forceinline__ uint32_t f25_add_word(F25& x, uint32_t v) {
  uint64_t c = v;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += x.w[i];
    x.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
}

// x - v for v < 2^32; returns the borrow out of bit 256 (0 or 1)
__device__ __forceinline__ uint32_t f25_sub_word(F25& x, uint32_t v) {
  int64_t br = -static_cast<int64_t>(v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(x.w[i]) + br;
    x.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;                     // 0 or -1
  }
  return br != 0 ? 1u : 0u;
}

// x + c * 2^256 (mod p) for c < 2^26, into [0, 2^256): + 38c; a carry out
// of that leaves x below 38c, so adding 38 once more (rare, a branch)
// cannot carry.
__device__ __forceinline__ void f25_fold(F25& x, uint32_t c) {
  if (f25_add_word(x, 38u * c) != 0) f25_add_word(x, 38u);
}

__device__ __forceinline__ F25 f25_add(const F25& a, const F25& b) {
  F25 s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + b.w[i];
    s.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  f25_fold(s, static_cast<uint32_t>(c));
  return s;
}

// a - b: a borrow from bit 256 added 2^256 == 38, so 38 comes off; a borrow
// out of that leaves x above 2^256 - 38, and 38 more (rare) cannot borrow.
__device__ __forceinline__ F25 f25_sub(const F25& a, const F25& b) {
  F25 r;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(a.w[i]) - b.w[i] + br;
    r.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;
  }
  if (f25_sub_word(r, br != 0 ? 38u : 0u) != 0) f25_sub_word(r, 38u);
  return r;
}

__device__ __forceinline__ F25 f25_mul(const F25& a, const F25& b) {
  uint32_t c[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t t = static_cast<uint64_t>(a.w[i]) * b.w[j] + c[i + j] +
                         carry;
      c[i + j] = static_cast<uint32_t>(t);
      carry = t >> 32;
    }
    c[i + 8] = static_cast<uint32_t>(carry);
  }
  // lo + 38 * hi: each column below 39 * 2^32 + 40, its carry below 40
  F25 r;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    carry += static_cast<uint64_t>(c[i]) +
             static_cast<uint64_t>(c[i + 8]) * 38u;
    r.w[i] = static_cast<uint32_t>(carry);
    carry >>= 32;
  }
  f25_fold(r, static_cast<uint32_t>(carry));
  return r;
}

// x - p where that does not borrow, else x
__device__ __forceinline__ F25 f25_sub_p_if(const F25& x) {
  F25 t;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(x.w[i]) - f25_p_word(i) + br;
    t.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;
  }
  const bool keep = br != 0;          // x < p
  F25 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = keep ? x.w[i] : t.w[i];
  return r;
}

// x in [0, 2^256) -> x mod p in [0, p): 2^256 < 3p, so two conditional
// subtractions
__device__ __forceinline__ F25 f25_canonical(const F25& x) {
  return f25_sub_p_if(f25_sub_p_if(x));
}

__device__ __forceinline__ bool f25_eq(const F25& a, const F25& b) {
  const F25 x = f25_canonical(a), y = f25_canonical(b);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= x.w[i] ^ y.w[i];
  return acc == 0;
}

// A 32-byte big-endian row (16-byte aligned) -> its value
__device__ __forceinline__ F25 f25_load_be(const uint8_t* src) {
  uint32_t words[8];
  be_bytes_to_words(words, src);
  F25 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = words[7 - i];
  return r;
}

__device__ __forceinline__ EdPt ed_identity() {
  EdPt p;
  p.X = f25_small(0);
  p.Y = f25_small(1);
  p.Z = f25_small(1);
  p.T = f25_small(0);
  return p;
}

// add-2008-hwcd-3, as ed25519_host.pt_add
__device__ __forceinline__ void ed_add(EdPt& out, const EdPt& p,
                                       const EdPt& q) {
  const F25 a = f25_mul(f25_sub(p.Y, p.X), f25_sub(q.Y, q.X));
  const F25 b = f25_mul(f25_add(p.Y, p.X), f25_add(q.Y, q.X));
  const F25 c = f25_mul(f25_mul(p.T, f25_d2()), q.T);
  F25 d = f25_mul(p.Z, q.Z);
  d = f25_add(d, d);
  const F25 e = f25_sub(b, a), f = f25_sub(d, c), g = f25_add(d, c),
            h = f25_add(b, a);
  out.X = f25_mul(e, f);
  out.Y = f25_mul(g, h);
  out.Z = f25_mul(f, g);
  out.T = f25_mul(e, h);
}

// dbl-2008-hwcd, as ed25519_host.pt_double
__device__ __forceinline__ void ed_dbl(EdPt& out, const EdPt& p) {
  const F25 a = f25_mul(p.X, p.X);
  const F25 b = f25_mul(p.Y, p.Y);
  F25 c = f25_mul(p.Z, p.Z);
  c = f25_add(c, c);
  const F25 xy = f25_add(p.X, p.Y);
  const F25 h = f25_add(a, b);
  const F25 e = f25_sub(h, f25_mul(xy, xy));
  const F25 g = f25_sub(a, b);
  const F25 f = f25_add(c, g);
  out.X = f25_mul(e, f);
  out.Y = f25_mul(g, h);
  out.Z = f25_mul(f, g);
  out.T = f25_mul(e, h);
}

// The self-test's per-case bodies, run by field_selftest.cu on the card and
// by the host build in the tests. ops: a, b as 8 little-endian words (any
// value below 2^256) -> out[0:8] a mod p, [8:16] a + b, [16:24] a - b,
// [24:32] a * b, canonical words.
__device__ __forceinline__ void f25_selftest_ops(const uint32_t* a32,
                                                 const uint32_t* b32,
                                                 uint32_t* out) {
  F25 a, b;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.w[i] = a32[i];
    b.w[i] = b32[i];
  }
  const F25 res[4] = {f25_canonical(a), f25_canonical(f25_add(a, b)),
                      f25_canonical(f25_sub(a, b)),
                      f25_canonical(f25_mul(a, b))};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) out[8 * k + i] = res[k].w[i];
}

__device__ __forceinline__ EdPt ed_from_words(const uint32_t* w) {
  EdPt p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p.X.w[i] = w[i];
    p.Y.w[i] = w[8 + i];
    p.Z.w[i] = w[16 + i];
    p.T.w[i] = w[24 + i];
  }
  return p;
}

__device__ __forceinline__ void ed_to_words(uint32_t* w, const EdPt& p) {
  const F25 c[4] = {f25_canonical(p.X), f25_canonical(p.Y),
                    f25_canonical(p.Z), f25_canonical(p.T)};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) w[8 * k + i] = c[k].w[i];
}

// group law: p, q as 32 words each (X, Y, Z, T) -> out[0:32] ed_add(p, q),
// out[32:64] ed_dbl(p), canonical words (outputs aliased on purpose)
__device__ __forceinline__ void ed_selftest(const uint32_t* p32,
                                            const uint32_t* q32,
                                            uint32_t* out) {
  EdPt p = ed_from_words(p32), q = ed_from_words(q32), d = p;
  ed_add(q, p, q);
  ed_dbl(d, d);
  ed_to_words(out, q);
  ed_to_words(out + 32, d);
}

}  // namespace
