// The field mod p = 2^255 - 19 and Ed25519's group law (a = -1) on 32-bit
// limbs, for csrc/ed25519_verify.cu.
//
// A field element is 8 little-endian uint32_t words holding any value in
// [0, 2^256) of its residue class (2^256 = 2p + 38, so a value has up to
// three forms): add, sub, mul and sqr take and return such values (a weak
// reduction), and only f25_canonical, used by the check and the
// self-test, subtracts p up to twice to reach [0, p). 2^256 == 38 (mod p),
// so a carry out of bit 256 folds back as + 38 and a borrow as - 38: the
// product's top 256 bits fold in as 38 * hi, and the carry of that sum
// folds once more. As p256_field.cuh: every function is __forceinline__
// over fixed arrays indexed by compile-time constants, and on the card
// (__CUDA_ARCH__) the carries run in PTX carry chains: the products by
// columns (a partial product's chain mad.lo.cc/madc.hi.cc/addc into a
// three-word accumulator), the fold by 38 as one mad.lo chain and one
// mad.hi chain, add and sub as add.cc/addc and sub.cc/subc. The host
// compiler builds the portable C++ beside them (uint64_t accumulators) for
// tests/test_torch_fe25519_host.py: both compute the same words, the same
// products and the same conditional folds; only the carries are taken
// another way.
//
// f25_sqr is a squaring of its own: the 28 cross products a_i a_j (i < j)
// by columns, doubled by a one-bit shift, plus the 8 squares a_i^2 in one
// carry chain: 36 partial products where f25_mul takes 64.
//
// Points (ref10's representations, Bernstein, Duif, Lange, Schwabe, Yang,
// "High-speed high-security signatures", 2011):
//   EdP2 (X : Y : Z), x = X/Z, y = Y/Z;
//   EdP3 (X : Y : Z : T), extended, T = XY/Z;
//   EdP1 ((X : Z), (Y : T)), "completed", x = X/Z, y = Y/T: what an addition
//     or a doubling returns, turned into P2 by 3 products or P3 by 4;
//   EdCached (Y + X, Y - X, 2Z, 2d T), a P3 prepared as the right operand
//     of an addition;
//   EdNiels (y + x, y - x, 2d x y), an affine point so prepared (the
//     fixed-base table's entries): a mixed addition.
// ed_add_cached (P3 + cached -> P1, 4 products; `neg` adds -Q by swapping
// Y + X with Y - X and the sign of 2dT), ed_madd (P3 + Niels -> P1, 3)
// and ed_dbl (P2 -> P1, 4 squarings) are add-2008-hwcd-3 and dbl-2008-hwcd
// (Hisil, Wong, Carter, Dawson 2008) split at the completed point: P1 ->
// P3 gives the same X, Y, Z, T as those formulas, and both are complete
// for Ed25519 (d is not a square), so P + P, P + (-P) and the identity
// need no special case.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_field.cuh"

namespace {

struct F25 {
  uint32_t w[8];
};

struct EdP2 {
  F25 X, Y, Z;
};

struct EdP3 {
  F25 X, Y, Z, T;
};

struct EdP1 {
  F25 X, Y, Z, T;
};

struct EdCached {
  F25 ypx, ymx, z2, t2d;
};

struct EdNiels {
  F25 ypx, ymx, xy2d;
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
#if defined(__CUDA_ARCH__)
  uint32_t c;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(x.w[0]), "+r"(x.w[1]), "+r"(x.w[2]), "+r"(x.w[3]),
        "+r"(x.w[4]), "+r"(x.w[5]), "+r"(x.w[6]), "+r"(x.w[7]), "=r"(c)
      : "r"(v));
  return c;
#else
  uint64_t c = v;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += x.w[i];
    x.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
#endif
}

// x - v for v < 2^32; returns the borrow out of bit 256 (0 or 1)
__device__ __forceinline__ uint32_t f25_sub_word(F25& x, uint32_t v) {
#if defined(__CUDA_ARCH__)
  uint32_t br;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(x.w[0]), "+r"(x.w[1]), "+r"(x.w[2]), "+r"(x.w[3]),
        "+r"(x.w[4]), "+r"(x.w[5]), "+r"(x.w[6]), "+r"(x.w[7]), "=r"(br)
      : "r"(v));
  return br & 1u;
#else
  int64_t br = -static_cast<int64_t>(v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(x.w[i]) + br;
    x.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;                     // 0 or -1
  }
  return br != 0 ? 1u : 0u;
#endif
}

// x + c * 2^256 (mod p) for c < 2^26, into [0, 2^256): + 38c; a carry out
// of that leaves x below 38c, so adding 38 once more (rare, a branch)
// cannot carry.
__device__ __forceinline__ void f25_fold(F25& x, uint32_t c) {
  if (f25_add_word(x, 38u * c) != 0) f25_add_word(x, 38u);
}

__device__ __forceinline__ F25 f25_add(const F25& a, const F25& b) {
  F25 s;
  uint32_t c;
#if defined(__CUDA_ARCH__)
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]),
        "=r"(s.w[4]), "=r"(s.w[5]), "=r"(s.w[6]), "=r"(s.w[7]), "=r"(c)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
#else
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc += static_cast<uint64_t>(a.w[i]) + b.w[i];
    s.w[i] = static_cast<uint32_t>(acc);
    acc >>= 32;
  }
  c = static_cast<uint32_t>(acc);
#endif
  f25_fold(s, c);
  return s;
}

// a - b: a borrow from bit 256 added 2^256 == 38, so 38 comes off; a borrow
// out of that leaves x above 2^256 - 38, and 38 more (rare) cannot borrow.
__device__ __forceinline__ F25 f25_sub(const F25& a, const F25& b) {
  F25 r;
  uint32_t br;
#if defined(__CUDA_ARCH__)
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
        "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7]), "=r"(br)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  br &= 1u;
#else
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(a.w[i]) - b.w[i] + acc;
    r.w[i] = static_cast<uint32_t>(d);
    acc = d >> 32;
  }
  br = acc != 0 ? 1u : 0u;
#endif
  if (f25_sub_word(r, 38u * br) != 0) f25_sub_word(r, 38u);
  return r;
}

// The 8 x 8 product a * b -> c (16 words). On the card by columns
// (product scanning): column k sums a_i * b_j over i + j = k into a
// three-word accumulator, each partial product one carry chain
// (mad.lo.cc, madc.hi.cc, addc), which ptxas makes one 64-bit multiply-add
// and a carry add.
__device__ __forceinline__ void f25_mul_wide(uint32_t (&c)[16], const F25& a,
                                             const F25& b) {
#if defined(__CUDA_ARCH__)
  uint32_t c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int k = 0; k < 15; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = k - i;
      if (j < 0 || j > 7) continue;
      asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
          "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
          "addc.u32 %2, %2, 0;"
          : "+r"(c0), "+r"(c1), "+r"(c2)
          : "r"(a.w[i]), "r"(b.w[j]));
    }
    c[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  c[15] = c0;
#else
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
#endif
}

// a^2 -> c (16 words): the cross products a_i a_j (i < j) by columns,
// doubled, plus the squares a_i^2 at columns 2i and 2i + 1.
__device__ __forceinline__ void f25_sqr_wide(uint32_t (&c)[16], const F25& a) {
#if defined(__CUDA_ARCH__)
  uint32_t c0 = 0, c1 = 0, c2 = 0;
  c[0] = 0;
#pragma unroll
  for (int k = 1; k < 14; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = k - i;
      if (j <= i || j > 7) continue;
      asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
          "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
          "addc.u32 %2, %2, 0;"
          : "+r"(c0), "+r"(c1), "+r"(c2)
          : "r"(a.w[i]), "r"(a.w[j]));
    }
    c[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  c[14] = c0;
  c[15] = c1;
#pragma unroll
  for (int k = 15; k > 0; --k) c[k] = __funnelshift_l(c[k - 1], c[k], 1);
  c[0] = 0;
  asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]), "+r"(c[4]),
        "+r"(c[5]), "+r"(c[6]), "+r"(c[7]), "+r"(c[8]), "+r"(c[9]),
        "+r"(c[10]), "+r"(c[11]), "+r"(c[12]), "+r"(c[13]), "+r"(c[14]),
        "+r"(c[15])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
#else
#pragma unroll
  for (int k = 0; k < 16; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      const uint64_t t = static_cast<uint64_t>(a.w[i]) * a.w[j] +
                         c[i + j] + carry;
      c[i + j] = static_cast<uint32_t>(t);
      carry = t >> 32;
    }
    c[i + 8] = static_cast<uint32_t>(carry);
  }
#pragma unroll
  for (int k = 15; k > 0; --k) c[k] = (c[k] << 1) | (c[k - 1] >> 31);
  c[0] <<= 1;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t sq = static_cast<uint64_t>(a.w[i]) * a.w[i];
    carry += static_cast<uint64_t>(c[2 * i]) + static_cast<uint32_t>(sq);
    c[2 * i] = static_cast<uint32_t>(carry);
    carry >>= 32;
    carry += static_cast<uint64_t>(c[2 * i + 1]) + (sq >> 32);
    c[2 * i + 1] = static_cast<uint32_t>(carry);
    carry >>= 32;
  }
#endif
}

// c (16 words) mod p into [0, 2^256): lo + 38 * hi (the carry out below
// 40), then that carry folded.
__device__ __forceinline__ F25 f25_reduce_wide(const uint32_t (&c)[16]) {
  F25 r;
  uint32_t top;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = c[i];
#if defined(__CUDA_ARCH__)
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(r.w[0]), "+r"(r.w[1]), "+r"(r.w[2]), "+r"(r.w[3]),
        "+r"(r.w[4]), "+r"(r.w[5]), "+r"(r.w[6]), "+r"(r.w[7]), "=r"(top)
      : "r"(c[8]), "r"(c[9]), "r"(c[10]), "r"(c[11]), "r"(c[12]),
        "r"(c[13]), "r"(c[14]), "r"(c[15]), "r"(38u));
#else
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    carry += static_cast<uint64_t>(r.w[i]) +
             static_cast<uint64_t>(c[i + 8]) * 38u;
    r.w[i] = static_cast<uint32_t>(carry);
    carry >>= 32;
  }
  top = static_cast<uint32_t>(carry);
#endif
  f25_fold(r, top);
  return r;
}

__device__ __forceinline__ F25 f25_mul(const F25& a, const F25& b) {
  uint32_t c[16];
  f25_mul_wide(c, a, b);
  return f25_reduce_wide(c);
}

__device__ __forceinline__ F25 f25_sqr(const F25& a) {
  uint32_t c[16];
  f25_sqr_wide(c, a);
  return f25_reduce_wide(c);
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

// -- the group law --

__device__ __forceinline__ EdP2 ed_p1_to_p2(const EdP1& p) {
  return {f25_mul(p.X, p.T), f25_mul(p.Y, p.Z), f25_mul(p.Z, p.T)};
}

__device__ __forceinline__ EdP3 ed_p1_to_p3(const EdP1& p) {
  return {f25_mul(p.X, p.T), f25_mul(p.Y, p.Z), f25_mul(p.Z, p.T),
          f25_mul(p.X, p.Y)};
}

__device__ __forceinline__ EdCached ed_to_cached(const EdP3& p) {
  return {f25_add(p.Y, p.X), f25_sub(p.Y, p.X), f25_add(p.Z, p.Z),
          f25_mul(p.T, f25_d2())};
}

// 2p: XX = X^2, YY = Y^2, B = 2 Z^2, AA = (X + Y)^2; X' = AA - (YY + XX),
// Y' = YY + XX, Z' = YY - XX, T' = B - (YY - XX)
__device__ __forceinline__ EdP1 ed_dbl(const EdP2& p) {
  const F25 xx = f25_sqr(p.X), yy = f25_sqr(p.Y), zz = f25_sqr(p.Z),
            aa = f25_sqr(f25_add(p.X, p.Y));
  const F25 y = f25_add(yy, xx), z = f25_sub(yy, xx);
  return {f25_sub(aa, y), y, z, f25_sub(f25_add(zz, zz), z)};
}

// the completed sum from PP = (Y1 + X1)(y2 + x2), MM = (Y1 - X1)(y2 - x2),
// TT = T1 * 2d t2 and ZZ = 2 Z1 z2: X' = PP - MM, Y' = PP + MM, Z' = ZZ +
// TT, T' = ZZ - TT; with neg (adding -q: PP and MM took q's halves
// swapped) Z' = ZZ - TT, T' = ZZ + TT
__device__ __forceinline__ EdP1 ed_sum(const F25& pp, const F25& mm,
                                       const F25& tt, const F25& zz,
                                       bool neg) {
  const F25 a = f25_add(zz, tt), b = f25_sub(zz, tt);
  EdP1 r = {f25_sub(pp, mm), f25_add(pp, mm), a, b};
  if (neg) {
    r.Z = b;
    r.T = a;
  }
  return r;
}

// p + q (neg: p - q), q cached
__device__ __forceinline__ EdP1 ed_add_cached(const EdP3& p,
                                              const EdCached& q, bool neg) {
  const F25 pp = f25_mul(f25_add(p.Y, p.X), neg ? q.ymx : q.ypx);
  const F25 mm = f25_mul(f25_sub(p.Y, p.X), neg ? q.ypx : q.ymx);
  return ed_sum(pp, mm, f25_mul(p.T, q.t2d), f25_mul(p.Z, q.z2), neg);
}

// p + q, q an affine point in Niels form
__device__ __forceinline__ EdP1 ed_madd(const EdP3& p, const EdNiels& q) {
  const F25 pp = f25_mul(f25_add(p.Y, p.X), q.ypx);
  const F25 mm = f25_mul(f25_sub(p.Y, p.X), q.ymx);
  return ed_sum(pp, mm, f25_mul(p.T, q.xy2d), f25_add(p.Z, p.Z), false);
}

// The self-test's per-case bodies, run by field_selftest.cu on the card and
// by the host build in the tests. ops: a, b as 8 little-endian words (any
// value below 2^256) -> out[0:8] a mod p, [8:16] a + b, [16:24] a - b,
// [24:32] a * b, [32:40] a^2, canonical words.
constexpr int F25_SELFTEST_OUT = 40;

__device__ __forceinline__ void f25_selftest_ops(const uint32_t* a32,
                                                 const uint32_t* b32,
                                                 uint32_t* out) {
  F25 a, b;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.w[i] = a32[i];
    b.w[i] = b32[i];
  }
  const F25 res[5] = {f25_canonical(a), f25_canonical(f25_add(a, b)),
                      f25_canonical(f25_sub(a, b)),
                      f25_canonical(f25_mul(a, b)),
                      f25_canonical(f25_sqr(a))};
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) out[8 * k + i] = res[k].w[i];
}

__device__ __forceinline__ EdP3 ed_from_words(const uint32_t* w) {
  EdP3 p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p.X.w[i] = w[i];
    p.Y.w[i] = w[8 + i];
    p.Z.w[i] = w[16 + i];
    p.T.w[i] = w[24 + i];
  }
  return p;
}

__device__ __forceinline__ void ed_to_words(uint32_t* w, const EdP3& p) {
  const F25 c[4] = {f25_canonical(p.X), f25_canonical(p.Y),
                    f25_canonical(p.Z), f25_canonical(p.T)};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) w[8 * k + i] = c[k].w[i];
}

// group law: p, q as 32 words each (X, Y, Z, T) -> out (ED_SELFTEST_OUT
// words, four points as canonical P3 words): p + q by the cached addition,
// 2p by the doubling of p's P2, p + q by the mixed addition of q's Niels
// form (q's (X, Y) taken as its affine point: the cases give Z = 1), and
// p - q by the cached addition with neg.
constexpr int ED_SELFTEST_OUT = 128;

__device__ __forceinline__ void ed_selftest(const uint32_t* p32,
                                            const uint32_t* q32,
                                            uint32_t* out) {
  const EdP3 p = ed_from_words(p32), q = ed_from_words(q32);
  const EdCached qc = ed_to_cached(q);
  const EdNiels qn = {f25_add(q.Y, q.X), f25_sub(q.Y, q.X),
                      f25_mul(f25_mul(q.X, q.Y), f25_d2())};
  ed_to_words(out, ed_p1_to_p3(ed_add_cached(p, qc, false)));
  ed_to_words(out + 32, ed_p1_to_p3(ed_dbl(EdP2{p.X, p.Y, p.Z})));
  ed_to_words(out + 64, ed_p1_to_p3(ed_madd(p, qn)));
  ed_to_words(out + 96, ed_p1_to_p3(ed_add_cached(p, qc, true)));
}

}  // namespace
