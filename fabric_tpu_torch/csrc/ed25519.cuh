// The Ed25519 check of one lane, [S]B + [k](-A) == R, on fe25519.cuh: the
// lane body of csrc/ed25519_verify.cu, built by the host compiler for
// tests/test_torch_fe25519_host.py; the device half of
// fabric_tpu/ops/ed25519.py verify_core (comb_mul_base, ladder_mul).
//
// [S]B: 32 rows of the fixed-base table, row i*256 + w for window i's byte
// w = (S >> 8i) & 255, summed one after another with ed_add. The table
// (ops/ed25519.py kernel_table) holds j * 2^(8i) * B as 4 coordinates x 8
// little-endian words of their canonical plain-domain values (Z = 1), 128
// bytes an entry, read as eight 16-byte loads.
// [k](-A): a 4-entry table (identity, -A, 2(-A), 3(-A)) and 128 steps of
// two doublings and one addition of the entry chosen by bits (254 - 2i,
// 255 - 2i) of k, walked from the top word as in ladder.cuh. The 4-entry
// table is indexed by the data and lives in local memory.
// The check: X3 == rx * Z3 and Y3 == ry * Z3, compared in canonical form.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

namespace {

// word i of a, chosen by a select chain (a stays in registers)
__device__ __forceinline__ uint32_t f25_word(const F25& a, int i) {
  uint32_t r = a.w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) r = i == k ? a.w[k] : r;
  return r;
}

// one table entry: 32 words (16-byte aligned)
__device__ __forceinline__ EdPt ed_load_entry(const uint32_t* e) {
  const uint4* v = reinterpret_cast<const uint4*>(e);
  uint32_t w[32];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint4 q = __ldg(v + k);
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
  return ed_from_words(w);
}

// premask-free core for one lane's operands (S and k as 256-bit values,
// -A and R affine)
__device__ __forceinline__ bool ed25519_check(
    const F25& s, const F25& k, const F25& anx, const F25& ay, const F25& rx,
    const F25& ry, const uint32_t* __restrict__ tab) {
  EdPt acc = ed_identity();
#pragma unroll 1
  for (int wd = 0; wd < 8; ++wd) {
    uint32_t v = f25_word(s, wd);
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const size_t row = static_cast<size_t>(4 * wd + q) * 256 + (v & 255u);
      ed_add(acc, acc, ed_load_entry(tab + row * 32));
      v >>= 8;
    }
  }
  EdPt t4[4];
  t4[0] = ed_identity();
  t4[1].X = anx;
  t4[1].Y = ay;
  t4[1].Z = f25_small(1);
  t4[1].T = f25_mul(anx, ay);
  ed_dbl(t4[2], t4[1]);
  ed_add(t4[3], t4[2], t4[1]);
  EdPt ka = ed_identity();
#pragma unroll 1
  for (int wd = 7; wd >= 0; --wd) {
    uint32_t kw = f25_word(k, wd);
#pragma unroll 1
    for (int st = 0; st < 16; ++st) {
      ed_dbl(ka, ka);
      ed_dbl(ka, ka);
      ed_add(ka, ka, t4[kw >> 30]);
      kw <<= 2;
    }
  }
  ed_add(acc, acc, ka);
  return f25_eq(acc.X, f25_mul(rx, acc.Z)) &&
         f25_eq(acc.Y, f25_mul(ry, acc.Z));
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

}  // namespace
