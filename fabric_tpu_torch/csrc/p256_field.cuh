// The P-256 base field and its complete addition on 32-bit limbs, shared by
// the tree kernel (ptree.cu) and the resident kernel (fused_resident.cu).
//
// A field element is 8 little-endian uint32_t words holding any value in
// [0, 2^256) of its residue class (p < 2^256 < 2p, so a value has at most
// two forms): add, sub and mul take and return such values, and only
// fe_canonical, used by the check and the self-test, subtracts p once to
// reach [0, p); no operation spends a compare-and-select on it. Every
// function is __forceinline__ and works on values and fixed-size arrays
// indexed only by compile-time constants (the loops are fully unrolled),
// so that nothing reaches the stack: the operands live in registers. On
// the card (__CUDA_ARCH__) the carries run in PTX carry chains: the 8 x 8
// product by columns, a partial product's chain mad.lo.cc/madc.hi.cc/addc
// into a three-word accumulator (fe_mul_wide), add and sub and the folds
// of d as add.cc/addc and sub.cc/subc. The host compiler builds the portable C++
// beside them (uint64_t accumulators) for tests/test_torch_p256_field_host.py:
// both compute the same words, the same schoolbook product and the same
// conditional folds, only the carries are taken another way. The Solinas
// column sums stay portable signed 64-bit arithmetic on both.
//
// The comb tables (and the points entry's r and rpn) are 13-bit limbs: 20
// little-endian int32 limbs, semi-reduced (limbs in [0, 2^13], value <
// 2^256 + 2^243); fe_from13 converts them on load. Scalars that come from
// the host as 32-byte big-endian rows (r, rpn, w) are read by fe_load_be.
//
// Multiplication: an 8 x 8 schoolbook product to 16 words, then P-256's
// Solinas reduction (FIPS 186-4 D.2.3, s1 + 2s2 + 2s3 + s4 + s5 - d1 - d2
// - d3 - d4) in signed 64-bit column sums, and the carry out of bit 256
// folded back with 2^256 == d = 2^224 - 2^192 - 2^96 + 1 (mod p). Add and
// sub fold their carry or borrow the same way.
//
// Complete addition: RCB15 (Renes, Costello, Batina, "Complete addition
// formulas for prime order elliptic curves", 2015) Algorithm 4, for
// a = -3: 12 multiplications, 2 by the constant b, 29 additions. It has no
// exceptional cases (P + P, P + (-P), P + inf, inf + inf), and its output
// may alias its inputs. Doubling (pt_dbl, the Shamir ladder's): RCB15
// Algorithm 6 for a = -3, exception-free (inf and 2-torsion), 11
// multiplications and 2 by b, step for step as ops/p256.py cdbl_int.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Fe {
  uint32_t w[8];
};

struct Pt {
  Fe X, Y, Z;
};

// p = 2^256 - 2^224 + 2^192 + 2^96 - 1, word i
__host__ __device__ __forceinline__ constexpr uint32_t fe_p_word(int i) {
  return i < 3 ? 0xFFFFFFFFu : i < 6 ? 0u : i == 6 ? 1u : 0xFFFFFFFFu;
}

// d = 2^256 - p = 2^224 - 2^192 - 2^96 + 1, word i: 2^256 == d (mod p)
__host__ __device__ __forceinline__ constexpr uint32_t fe_d_word(int i) {
  return i == 0 ? 1u : i < 3 ? 0u : i < 6 ? 0xFFFFFFFFu
                                         : i == 6 ? 0xFFFFFFFEu : 0u;
}

// the curve constant b, word i
__host__ __device__ __forceinline__ constexpr uint32_t fe_b_word(int i) {
  return i == 0   ? 0x27D2604Bu
         : i == 1 ? 0x3BCE3C3Eu
         : i == 2 ? 0xCC53B0F6u
         : i == 3 ? 0x651D06B0u
         : i == 4 ? 0x769886BCu
         : i == 5 ? 0xB3EBBD55u
         : i == 6 ? 0xAA3A93E7u
                  : 0x5AC635D8u;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_b() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = fe_b_word(i);
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

// x in [0, 2^256) -> x mod p in [0, p): one conditional subtraction
// (2^256 < 2p).
__device__ __forceinline__ Fe fe_canonical(const Fe& x) {
  Fe t;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(x.w[i]) - fe_p_word(i) + br;
    t.w[i] = static_cast<uint32_t>(d);
    br = d >> 32;                     // 0 or -1
  }
  const bool keep = br != 0;          // x < p
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = keep ? x.w[i] : t.w[i];
  return r;
}

// Signed column sums (each well inside int64) -> words; returns the signed
// carry out of bit 256.
__device__ __forceinline__ int64_t fe_carry_cols(Fe& r,
                                                 const int64_t (&c)[8]) {
  int64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t s = c[i] + carry;
    r.w[i] = static_cast<uint32_t>(s);
    carry = s >> 32;                  // arithmetic: floor division
  }
  return carry;
}

// x + t * 2^256 with |t| < 2^31, as columns of x + t * (2^224 - 2^192 -
// 2^96 + 1).
__device__ __forceinline__ int64_t fe_fold_top(Fe& x, int64_t t) {
  int64_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = x.w[i];
  c[0] += t;
  c[3] -= t;
  c[6] -= t;
  c[7] += t;
  return fe_carry_cols(x, c);
}

// x + t * 2^256 (mod p) -> [0, 2^256), for x in [0, 2^256) and
// |t| <= 2^12. The first fold leaves a value in (-2^237, 2^256 + 2^237),
// so its carry t2 is -1, 0 or 1; folding t2 once more (rarely needed, so a
// branch) lands in [0, 2^256): t2 = 1 left low words below 2^237, t2 = -1
// left them above 2^256 - 2^237, and the fold moves them by less than
// 2^224.
__device__ __forceinline__ Fe fe_reduce_top(Fe x, int64_t t) {
  const int64_t t2 = fe_fold_top(x, t);
  if (t2 != 0) fe_fold_top(x, t2);
  return x;
}

// x + (d & m), one pass; returns the carry out of bit 256.
__device__ __forceinline__ uint32_t fe_add_d_pass(Fe& x, uint32_t m) {
#if defined(__CUDA_ARCH__)
  uint32_t c;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, %10;\n\t"
      "addc.cc.u32 %4, %4, %10;\n\t"
      "addc.cc.u32 %5, %5, %10;\n\t"
      "addc.cc.u32 %6, %6, %11;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(x.w[0]), "+r"(x.w[1]), "+r"(x.w[2]), "+r"(x.w[3]),
        "+r"(x.w[4]), "+r"(x.w[5]), "+r"(x.w[6]), "+r"(x.w[7]), "=r"(c)
      : "r"(m & 1u), "r"(m), "r"(m & 0xFFFFFFFEu));
  return c;
#else
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(x.w[i]) + (fe_d_word(i) & m);
    x.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
#endif
}

// x - (d & m), one pass; returns the borrow as a mask (0 or all ones).
__device__ __forceinline__ uint32_t fe_sub_d_pass(Fe& x, uint32_t m) {
#if defined(__CUDA_ARCH__)
  uint32_t br;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, %10;\n\t"
      "subc.cc.u32 %4, %4, %10;\n\t"
      "subc.cc.u32 %5, %5, %10;\n\t"
      "subc.cc.u32 %6, %6, %11;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(x.w[0]), "+r"(x.w[1]), "+r"(x.w[2]), "+r"(x.w[3]),
        "+r"(x.w[4]), "+r"(x.w[5]), "+r"(x.w[6]), "+r"(x.w[7]), "=r"(br)
      : "r"(m & 1u), "r"(m), "r"(m & 0xFFFFFFFEu));
  return br;
#else
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t t = static_cast<int64_t>(x.w[i]) - (fe_d_word(i) & m) + br;
    x.w[i] = static_cast<uint32_t>(t);
    br = t >> 32;
  }
  return static_cast<uint32_t>(br);
#endif
}

// x + d (m all ones) or x (m zero), for x in [0, 2^256), mod p: a carry out
// of bit 256 leaves x + d - 2^256 < d, and adding d once more (rare, so a
// branch) cannot carry.
__device__ __forceinline__ void fe_add_d(Fe& x, uint32_t m) {
  if (fe_add_d_pass(x, m) != 0) fe_add_d_pass(x, 0xFFFFFFFFu);
}

// x - d (m all ones) or x (m zero), mod p: a borrow leaves x - d + 2^256
// >= 2^256 - d, and subtracting d once more (rare) cannot borrow.
__device__ __forceinline__ void fe_sub_d(Fe& x, uint32_t m) {
  if (fe_sub_d_pass(x, m) != 0) fe_sub_d_pass(x, 0xFFFFFFFFu);
}

// a + b: a carry out of bit 256 is worth d (mod p)
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s;
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
  fe_add_d(s, 0u - c);
  return s;
}

// a - b: a borrow from bit 256 is worth -d (mod p), the multiple-of-p
// offset that brings the difference back into [0, 2^256)
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
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
#else
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t d = static_cast<int64_t>(a.w[i]) - b.w[i] + acc;
    r.w[i] = static_cast<uint32_t>(d);
    acc = d >> 32;
  }
  br = static_cast<uint32_t>(acc);
#endif
  fe_sub_d(r, br);
  return r;
}

// The 8 x 8 schoolbook product a * b -> c (16 words). On the card by
// columns (product scanning): column k sums a_i * b_j over i + j = k into
// a three-word accumulator, each partial product one carry chain, its low
// half by mad.lo.cc, its high half by madc.hi.cc and the carry out by
// addc; ptxas makes each such chain one 64-bit multiply-add (IMAD.WIDE)
// and a carry add. (By rows, a chain of eight low halves then eight high
// halves, every partial product took an IMAD, an IMAD.HI and carry adds
// of their own.)
__device__ __forceinline__ void fe_mul_wide(uint32_t (&c)[16], const Fe& a,
                                            const Fe& b) {
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

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t c[16];
  fe_mul_wide(c, a, b);
  // Solinas: s1 + 2s2 + 2s3 + s4 + s5 - d1 - d2 - d3 - d4, by word
  int64_t v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = c[k];
  int64_t col[8];
  col[0] = v[0] + v[8] + v[9] - v[11] - v[12] - v[13] - v[14];
  col[1] = v[1] + v[9] + v[10] - v[12] - v[13] - v[14] - v[15];
  col[2] = v[2] + v[10] + v[11] - v[13] - v[14] - v[15];
  col[3] = v[3] + 2 * (v[11] + v[12]) + v[13] - v[15] - v[8] - v[9];
  col[4] = v[4] + 2 * (v[12] + v[13]) + v[14] - v[9] - v[10];
  col[5] = v[5] + 2 * (v[13] + v[14]) + v[15] - v[10] - v[11];
  col[6] = v[6] + 3 * v[14] + 2 * v[15] + v[13] - v[8] - v[9];
  col[7] = v[7] + 3 * v[15] + v[8] - v[10] - v[11] - v[12] - v[13];
  Fe r;
  const int64_t top = fe_carry_cols(r, col);     // in [-4, 6]
  return fe_reduce_top(r, top);
}

// 20 semi-reduced 13-bit limbs (each in [0, 2^13], so a limb may carry into
// the next) -> [0, 2^256). Word j gathers the limbs that start in its 32
// bits, shifted into place, plus the carry from word j - 1; the bits past
// 256 (below 2^6 for these inputs) fold back.
__device__ __forceinline__ Fe fe_from13(const int* l) {
  Fe r;
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 20; ++i) {
      if (13 * i >= 32 * j && 13 * i < 32 * (j + 1))
        acc += static_cast<uint64_t>(static_cast<uint32_t>(l[i]))
               << (13 * i - 32 * j);
    }
    r.w[j] = static_cast<uint32_t>(acc);
    acc >>= 32;
  }
  return fe_reduce_top(r, static_cast<int64_t>(acc));
}

// (8,) big-endian words, word 0 the most significant -> a 256-bit value
// (here a field element; modn32.cuh reads scalars mod n the same way)
__device__ __forceinline__ Fe fe_from_be_words(const uint32_t (&words)[8]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = words[7 - i];
  return r;
}

// (8,) words from a 32-byte row of 32-bit words (16-byte aligned)
__device__ __forceinline__ void load_words(uint32_t (&words)[8],
                                           const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 q = __ldg(v + h);
    words[4 * h] = q.x;
    words[4 * h + 1] = q.y;
    words[4 * h + 2] = q.z;
    words[4 * h + 3] = q.w;
  }
}

// (32,) big-endian bytes of a 256-bit value (16-byte aligned) -> (8,)
// big-endian words, word 0 the most significant, as the digest words: two
// 16-byte loads and a byte swap per word.
__device__ __forceinline__ void be_bytes_to_words(uint32_t (&words)[8],
                                                  const uint8_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 q = __ldg(v + h);
    const uint32_t part[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      words[4 * h + k] = __byte_perm(part[k], 0, 0x0123);   // byte swap
  }
}

// A 32-byte big-endian row (r, rpn, w: the host's form) -> its value
__device__ __forceinline__ Fe fe_load_be(const uint8_t* src) {
  uint32_t words[8];
  be_bytes_to_words(words, src);
  return fe_from_be_words(words);
}

__device__ __forceinline__ Pt pt_infinity() {
  Pt p;
  p.X = fe_zero();
  p.Y = fe_zero();
  p.Y.w[0] = 1;
  p.Z = fe_zero();
  return p;
}

// RCB15 Algorithm 4 (a = -3), step for step; out may alias p or q.
__device__ __forceinline__ void pt_add(Pt& out, const Pt& p, const Pt& q) {
  const Fe b = fe_b();
  Fe t0 = fe_mul(p.X, q.X);                 // 1
  Fe t1 = fe_mul(p.Y, q.Y);                 // 2
  Fe t2 = fe_mul(p.Z, q.Z);                 // 3
  Fe t3 = fe_add(p.X, p.Y);                 // 4
  Fe t4 = fe_add(q.X, q.Y);                 // 5
  t3 = fe_mul(t3, t4);                      // 6
  t4 = fe_add(t0, t1);                      // 7
  t3 = fe_sub(t3, t4);                      // 8
  t4 = fe_add(p.Y, p.Z);                    // 9
  Fe X3 = fe_add(q.Y, q.Z);                 // 10
  t4 = fe_mul(t4, X3);                      // 11
  X3 = fe_add(t1, t2);                      // 12
  t4 = fe_sub(t4, X3);                      // 13
  X3 = fe_add(p.X, p.Z);                    // 14
  Fe Y3 = fe_add(q.X, q.Z);                 // 15
  X3 = fe_mul(X3, Y3);                      // 16
  Y3 = fe_add(t0, t2);                      // 17
  Y3 = fe_sub(X3, Y3);                      // 18
  Fe Z3 = fe_mul(b, t2);                    // 19
  X3 = fe_sub(Y3, Z3);                      // 20
  Z3 = fe_add(X3, X3);                      // 21
  X3 = fe_add(X3, Z3);                      // 22
  Z3 = fe_sub(t1, X3);                      // 23
  X3 = fe_add(t1, X3);                      // 24
  Y3 = fe_mul(b, Y3);                       // 25
  t1 = fe_add(t2, t2);                      // 26
  t2 = fe_add(t1, t2);                      // 27
  Y3 = fe_sub(Y3, t2);                      // 28
  Y3 = fe_sub(Y3, t0);                      // 29
  t1 = fe_add(Y3, Y3);                      // 30
  Y3 = fe_add(t1, Y3);                      // 31
  t1 = fe_add(t0, t0);                      // 32
  t0 = fe_add(t1, t0);                      // 33
  t0 = fe_sub(t0, t2);                      // 34
  t1 = fe_mul(t4, Y3);                      // 35
  t2 = fe_mul(t0, Y3);                      // 36
  Y3 = fe_mul(X3, Z3);                      // 37
  Y3 = fe_add(Y3, t2);                      // 38
  X3 = fe_mul(t3, X3);                      // 39
  X3 = fe_sub(X3, t1);                      // 40
  Z3 = fe_mul(t4, Z3);                      // 41
  t1 = fe_mul(t3, t0);                      // 42
  Z3 = fe_add(Z3, t1);                      // 43
  out.X = X3;
  out.Y = Y3;
  out.Z = Z3;
}

// RCB15 Algorithm 6 (a = -3), step for step as ops/p256.py cdbl_int (so
// on canonical inputs the canonical outputs equal cdbl_int's); out may
// alias p: p is read only before out is written.
__device__ __forceinline__ void pt_dbl(Pt& out, const Pt& p) {
  const Fe b = fe_b();
  Fe t0 = fe_mul(p.X, p.X);
  Fe t1 = fe_mul(p.Y, p.Y);
  Fe t2 = fe_mul(p.Z, p.Z);
  Fe t3 = fe_mul(p.X, p.Y);
  t3 = fe_add(t3, t3);
  Fe Z3 = fe_mul(p.X, p.Z);
  Z3 = fe_add(Z3, Z3);
  Fe Y3 = fe_mul(b, t2);
  Y3 = fe_sub(Y3, Z3);
  Fe X3 = fe_add(Y3, Y3);
  Y3 = fe_add(X3, Y3);
  X3 = fe_sub(t1, Y3);
  Y3 = fe_add(t1, Y3);
  Y3 = fe_mul(X3, Y3);
  X3 = fe_mul(X3, t3);
  t3 = fe_add(t2, t2);
  t2 = fe_add(t2, t3);
  Z3 = fe_mul(b, Z3);
  Z3 = fe_sub(Z3, t2);
  Z3 = fe_sub(Z3, t0);
  t3 = fe_add(Z3, Z3);
  Z3 = fe_add(Z3, t3);
  t3 = fe_add(t0, t0);
  t0 = fe_add(t3, t0);
  t0 = fe_sub(t0, t2);
  t0 = fe_mul(t0, Z3);
  Y3 = fe_add(Y3, t0);
  t0 = fe_mul(p.Y, p.Z);
  t0 = fe_add(t0, t0);
  Z3 = fe_mul(t0, Z3);
  X3 = fe_sub(X3, Z3);
  Z3 = fe_mul(t0, t1);
  Z3 = fe_add(Z3, Z3);
  Z3 = fe_add(Z3, Z3);
  out.X = X3;
  out.Y = Y3;
  out.Z = Z3;
}

// The verify check on R = (X : Y : Z): Z != 0 and X == r*Z or X == rpn*Z
// (mod p), compared in canonical form. Invariant under projective scaling
// of R.
__device__ __forceinline__ bool pt_check(const Pt& R, const Fe& r,
                                         const Fe& rpn) {
  const Fe x = fe_canonical(R.X);
  const bool ok1 = fe_eq(x, fe_canonical(fe_mul(r, R.Z)));
  const bool ok2 = fe_eq(x, fe_canonical(fe_mul(rpn, R.Z)));
  return !fe_is_zero(fe_canonical(R.Z)) && (ok1 || ok2);
}

// The self-test's per-case bodies, run by field_selftest.cu on the card and
// by the host build in the tests. ops: a and b in 13-bit limbs -> out[0:8]
// a mod p, [8:16] a + b, [16:24] a - b, [24:32] a * b, canonical words
// (the operations chained as the kernels chain them, on the converted
// values, which may be >= p).
__device__ __forceinline__ void fe_selftest_ops(const int* a13, const int* b13,
                                                uint32_t* out) {
  const Fe a = fe_from13(a13);
  const Fe b = fe_from13(b13);
  const Fe res[4] = {fe_canonical(a), fe_canonical(fe_add(a, b)),
                     fe_canonical(fe_sub(a, b)),
                     fe_canonical(fe_mul(a, b))};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) out[8 * k + i] = res[k].w[i];
}

// add: two points of 3 x 20 13-bit limbs -> out[0:24] X3, Y3, Z3 words
__device__ __forceinline__ void fe_selftest_add(const int* p13, const int* q13,
                                                uint32_t* out) {
  Pt p, q;
  p.X = fe_from13(p13);
  p.Y = fe_from13(p13 + 20);
  p.Z = fe_from13(p13 + 40);
  q.X = fe_from13(q13);
  q.Y = fe_from13(q13 + 20);
  q.Z = fe_from13(q13 + 40);
  pt_add(p, p, q);                          // aliased output on purpose
  const Fe X = fe_canonical(p.X), Y = fe_canonical(p.Y),
           Z = fe_canonical(p.Z);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = X.w[i];
    out[8 + i] = Y.w[i];
    out[16 + i] = Z.w[i];
  }
}

// dbl: a point of 3 x 20 13-bit limbs -> out[0:24] X3, Y3, Z3 of pt_dbl,
// canonical words
__device__ __forceinline__ void fe_selftest_dbl(const int* p13,
                                                uint32_t* out) {
  Pt p;
  p.X = fe_from13(p13);
  p.Y = fe_from13(p13 + 20);
  p.Z = fe_from13(p13 + 40);
  pt_dbl(p, p);                             // aliased output on purpose
  const Fe X = fe_canonical(p.X), Y = fe_canonical(p.Y),
           Z = fe_canonical(p.Z);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = X.w[i];
    out[8 + i] = Y.w[i];
    out[16 + i] = Z.w[i];
  }
}

}  // namespace
