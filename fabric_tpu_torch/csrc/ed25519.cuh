// The Ed25519 check of one lane, [S]B + [k](-A) == R, on fe25519.cuh: the
// lane body of csrc/ed25519_verify.cu, built by the host compiler for
// tests/test_torch_fe25519_host.py; the device half of
// fabric_tpu/ops/ed25519.py verify_core (comb_mul_base, ladder_mul).
//
// [k](-A) first, on signed radix-16 digits: k + 0x88...8 (64 nibbles of 8;
// k < L < 2^253, so no carry leaves the 256 bits) read nibble by nibble,
// less 8, is the unique expansion k = sum d_i 16^i with d_i in [-8, 7].
// The lane builds 0..8 * (-A) in cached form (ed_add_cached adds -A to the
// last entry seven times; entry 0 is the identity) in local memory,
// indexed by |d_i|, the sign handed to the addition. From the top digit's
// entry taken as a P2 (2X : 2Y : 2Z) = (ypx - ymx, ypx + ymx, 2Z) without
// a product, each lower digit takes four doublings (three P2 -> P2, 7
// products each; the last P2 -> P3, 8) and one cached addition whose
// result is doubled next (P1 -> P2, 7); the last addition's T costs one
// product more.
// Then [S]B: 32 rows of the fixed-base table, row i*256 + w for window i's
// byte w = (S >> 8i) & 255, added to the accumulator one after another by
// the mixed addition (7 products a row, the last one stays completed). The
// table (ops/ed25519.py kernel_table) holds j * 2^(8i) * B in Niels form
// (y + x, y - x, 2dxy) as 3 coordinates x 8 little-endian words of their
// canonical values, 96 bytes an entry (the identity (1, 1, 0)), read as six
// 16-byte loads.
// The check on the completed sum (x = X/Z, y = Y/T): X == rx * Z and
// Y == ry * T, compared in canonical form.
// Products a lane: the table 65, the digits 63 * 36 + 1, [S]B 32 * 7 - 4,
// the check 2: 2,556 (1,008 of them squarings), where the
// extended-coordinate ladder of 2-bit windows took 3,508.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

namespace {

constexpr int ED_TAB_ENTRIES = 9;     // 0..8 * (-A)
constexpr int ED_NIELS_WORDS = 24;    // a fixed-base entry

// word i of a, chosen by a select chain (a stays in registers)
__device__ __forceinline__ uint32_t f25_word(const F25& a, int i) {
  uint32_t r = a.w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) r = i == k ? a.w[k] : r;
  return r;
}

// k + 0x88...8 (k < 2^255 - 0x88...8: no carry out of the 256 bits)
__device__ __forceinline__ F25 ed_digit_bias(const F25& k) {
  F25 r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(k.w[i]) + 0x88888888u;
    r.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return r;
}

// signed digit i (0..63) of k from kb = ed_digit_bias(k): in [-8, 7]
__device__ __forceinline__ int ed_digit(const F25& kb, int i) {
  return static_cast<int>((f25_word(kb, i >> 3) >> (4 * (i & 7))) & 15u) -
         8;
}

// one fixed-base entry: 24 words (16-byte aligned)
__device__ __forceinline__ EdNiels ed_load_niels(const uint32_t* e) {
  const uint4* v = reinterpret_cast<const uint4*>(e);
  uint32_t w[ED_NIELS_WORDS];
#pragma unroll
  for (int k = 0; k < ED_NIELS_WORDS / 4; ++k) {
    const uint4 q = __ldg(v + k);
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
  EdNiels n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    n.ypx.w[i] = w[i];
    n.ymx.w[i] = w[8 + i];
    n.xy2d.w[i] = w[16 + i];
  }
  return n;
}

// tab[0..8] = 0..8 * P in cached form, P = (x, y) affine
__device__ __forceinline__ void ed_cached_table(
    EdCached (&tab)[ED_TAB_ENTRIES], const F25& x, const F25& y) {
  tab[0] = {f25_small(1), f25_small(1), f25_small(2), f25_small(0)};
  EdP3 acc = {x, y, f25_small(1), f25_mul(x, y)};
  tab[1] = ed_to_cached(acc);
#pragma unroll 1
  for (int m = 2; m < ED_TAB_ENTRIES; ++m) {
    acc = ed_p1_to_p3(ed_add_cached(acc, tab[1], false));
    tab[m] = ed_to_cached(acc);
  }
}

// [k]P from its cached table: the top digit's entry as a P2, then per
// lower digit four doublings and one cached addition. Returns a P3.
__device__ __forceinline__ EdP3 ed_mul_digits(
    const F25& k, const EdCached (&tab)[ED_TAB_ENTRIES]) {
  const F25 kb = ed_digit_bias(k);
  int d = ed_digit(kb, 63);
  EdCached e = tab[d < 0 ? -d : d];
  EdP2 acc = {d < 0 ? f25_sub(e.ymx, e.ypx) : f25_sub(e.ypx, e.ymx),
              f25_add(e.ypx, e.ymx), e.z2};
  EdP1 t{};
#pragma unroll 1
  for (int i = 62; i >= 0; --i) {
#pragma unroll 1
    for (int j = 0; j < 3; ++j) acc = ed_p1_to_p2(ed_dbl(acc));
    const EdP3 a3 = ed_p1_to_p3(ed_dbl(acc));
    d = ed_digit(kb, i);
    e = tab[d < 0 ? -d : d];
    t = ed_add_cached(a3, e, d < 0);
    acc = ed_p1_to_p2(t);
  }
  return {acc.X, acc.Y, acc.Z, f25_mul(t.X, t.Y)};
}

// premask-free core for one lane's operands (S and k as 256-bit values,
// -A and R affine)
__device__ __forceinline__ bool ed25519_check(
    const F25& s, const F25& k, const F25& anx, const F25& ay, const F25& rx,
    const F25& ry, const uint32_t* __restrict__ tab) {
  EdCached tk[ED_TAB_ENTRIES];
  ed_cached_table(tk, anx, ay);
  EdP3 acc = ed_mul_digits(k, tk);
  EdP1 t{};
#pragma unroll 1
  for (int wi = 0; wi < 32; ++wi) {
    const uint32_t byte = (f25_word(s, wi >> 2) >> (8 * (wi & 3))) & 255u;
    const size_t row = static_cast<size_t>(wi) * 256 + byte;
    t = ed_madd(acc, ed_load_niels(tab + row * ED_NIELS_WORDS));
    if (wi < 31) acc = ed_p1_to_p3(t);
  }
  return f25_eq(t.X, f25_mul(rx, t.Z)) && f25_eq(t.Y, f25_mul(ry, t.T));
}

// The kernel's lane body: s8, k8, anx8, ay8, rx8, ry8 (B, 32) uint8
// big-endian rows (ops/ed25519.py stage_rows), premask (B,) bool, tab the
// kernel's table, out (B,) bool. A lane with premask off rejects without
// computing.
__device__ __forceinline__ void ed25519_lane(
    size_t b, const uint8_t* __restrict__ s8, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ anx8, const uint8_t* __restrict__ ay8,
    const uint8_t* __restrict__ rx8, const uint8_t* __restrict__ ry8,
    const uint8_t* __restrict__ premask, const uint32_t* __restrict__ tab,
    uint8_t* __restrict__ out) {
  if (!premask[b]) {
    out[b] = 0;
    return;
  }
  const size_t o = b * 32;
  out[b] = ed25519_check(f25_load_be(s8 + o), f25_load_be(k8 + o),
                         f25_load_be(anx8 + o), f25_load_be(ay8 + o),
                         f25_load_be(rx8 + o), f25_load_be(ry8 + o), tab)
               ? 1
               : 0;
}

// The host tests' entry: [k]P by the digits for k in [0, 2^253) and an
// affine P, as a canonical P3.
__device__ __forceinline__ void ed_mul_digits_words(const uint32_t* k32,
                                                    const uint32_t* x32,
                                                    const uint32_t* y32,
                                                    uint32_t* out) {
  F25 k, x, y;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    k.w[i] = k32[i];
    x.w[i] = x32[i];
    y.w[i] = y32[i];
  }
  EdCached tab[ED_TAB_ENTRIES];
  ed_cached_table(tab, x, y);
  ed_to_words(out, ed_mul_digits(k, tab));
}

}  // namespace
