// SHA-256 compression (FIPS 180-4) for one lane in uint32 registers,
// shared by sha_windows.cu and fused_resident.cu.
//
// The round constants and initial state enter as a (72,) array, the
// 64 round constants followed by the 8 initial words
// (fabric_tpu_torch/ops/sha256.py sha_consts_on, fabric_tpu's
// _sha_consts), which a kernel copies into shared memory once per block:
// every thread of a warp reads the same constant in the same round, a
// broadcast.

#pragma once

#include <stdint.h>

namespace {

constexpr int SHA_NCONST = 72;        // 64 round constants + 8 initial words
constexpr int SHA_H0 = 64;            // offset of the initial words

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// state += the 64 rounds over one 16-word block (big-endian words already
// assembled by the host pack). The message schedule is a rolling window of
// 16 words: w[t & 15] holds W[t - 16] until round t overwrites it with W[t].
__device__ __forceinline__ void sha256_compress(
    uint32_t (&st)[8], const uint32_t* __restrict__ blk, const uint32_t* K) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = blk[i];
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt = w[t & 15];
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      wt += s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + K[t] + wt;
    const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// SHA-256 of one lane's pre-padded message: `live` blocks of 16 words from
// `blk`. Blocks at or past `live` are never read, so whatever they hold
// cannot change the state: the per-lane masking of the JAX block loop.
__device__ __forceinline__ void sha256_lane(uint32_t (&st)[8],
                                            const uint32_t* __restrict__ blk,
                                            int live, const uint32_t* K) {
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = K[SHA_H0 + i];
  for (int j = 0; j < live; ++j) sha256_compress(st, blk + 16 * j, K);
}

}  // namespace
