// SHA-256 compression (FIPS 180-4) for one lane in uint32 registers,
// shared by the stage-A entries (stage_a.cuh: sha_windows.cu,
// fused_resident.cu).
//
// The round constants and the initial state are compile-time words
// (sha_k, sha_h0; the same values as fabric_tpu_torch/ops/sha256.py
// sha_consts, which the host test compares): with the 64 rounds unrolled
// each constant is an immediate operand of its round's add, so no
// constant is loaded.
//
// Blocks are read as four 16-byte loads each, and block j + 1's loads are
// issued before block j's 64 rounds, into registers: the load of the next
// block is in flight under the current compression. This is the TPU
// kernel's double buffer of message tiles (fabric_tpu/ops/fused_verify.py
// _sha_kernel_dma) on this card, where one compression (~1,400 integer
// operations a thread) outlasts a load from device memory many times over.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ __forceinline__ constexpr uint32_t sha_k(int t) {
  switch (t) {
    case 0: return 0x428A2F98u;  case 1: return 0x71374491u;
    case 2: return 0xB5C0FBCFu;  case 3: return 0xE9B5DBA5u;
    case 4: return 0x3956C25Bu;  case 5: return 0x59F111F1u;
    case 6: return 0x923F82A4u;  case 7: return 0xAB1C5ED5u;
    case 8: return 0xD807AA98u;  case 9: return 0x12835B01u;
    case 10: return 0x243185BEu; case 11: return 0x550C7DC3u;
    case 12: return 0x72BE5D74u; case 13: return 0x80DEB1FEu;
    case 14: return 0x9BDC06A7u; case 15: return 0xC19BF174u;
    case 16: return 0xE49B69C1u; case 17: return 0xEFBE4786u;
    case 18: return 0x0FC19DC6u; case 19: return 0x240CA1CCu;
    case 20: return 0x2DE92C6Fu; case 21: return 0x4A7484AAu;
    case 22: return 0x5CB0A9DCu; case 23: return 0x76F988DAu;
    case 24: return 0x983E5152u; case 25: return 0xA831C66Du;
    case 26: return 0xB00327C8u; case 27: return 0xBF597FC7u;
    case 28: return 0xC6E00BF3u; case 29: return 0xD5A79147u;
    case 30: return 0x06CA6351u; case 31: return 0x14292967u;
    case 32: return 0x27B70A85u; case 33: return 0x2E1B2138u;
    case 34: return 0x4D2C6DFCu; case 35: return 0x53380D13u;
    case 36: return 0x650A7354u; case 37: return 0x766A0ABBu;
    case 38: return 0x81C2C92Eu; case 39: return 0x92722C85u;
    case 40: return 0xA2BFE8A1u; case 41: return 0xA81A664Bu;
    case 42: return 0xC24B8B70u; case 43: return 0xC76C51A3u;
    case 44: return 0xD192E819u; case 45: return 0xD6990624u;
    case 46: return 0xF40E3585u; case 47: return 0x106AA070u;
    case 48: return 0x19A4C116u; case 49: return 0x1E376C08u;
    case 50: return 0x2748774Cu; case 51: return 0x34B0BCB5u;
    case 52: return 0x391C0CB3u; case 53: return 0x4ED8AA4Au;
    case 54: return 0x5B9CCA4Fu; case 55: return 0x682E6FF3u;
    case 56: return 0x748F82EEu; case 57: return 0x78A5636Fu;
    case 58: return 0x84C87814u; case 59: return 0x8CC70208u;
    case 60: return 0x90BEFFFAu; case 61: return 0xA4506CEBu;
    case 62: return 0xBEF9A3F7u; default: return 0xC67178F2u;
  }
}

__host__ __device__ __forceinline__ constexpr uint32_t sha_h0(int i) {
  return i == 0   ? 0x6A09E667u
         : i == 1 ? 0xBB67AE85u
         : i == 2 ? 0x3C6EF372u
         : i == 3 ? 0xA54FF53Au
         : i == 4 ? 0x510E527Fu
         : i == 5 ? 0x9B05688Cu
         : i == 6 ? 0x1F83D9ABu
                  : 0x5BE0CD19u;
}

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One 64-byte block: 16 big-endian words (assembled by the host pack), as
// four 16-byte vectors.
struct ShaBlock {
  uint4 q[4];
};

__device__ __forceinline__ ShaBlock load_block(
    const uint32_t* __restrict__ src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
  ShaBlock b;
#pragma unroll
  for (int k = 0; k < 4; ++k) b.q[k] = __ldg(v + k);
  return b;
}

// state += the 64 rounds over one block. The message schedule is a rolling
// window of 16 words: w[t & 15] holds W[t - 16] until round t overwrites
// it with W[t].
__device__ __forceinline__ void sha256_compress(uint32_t (&st)[8],
                                                const ShaBlock& blk) {
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[4 * k] = blk.q[k].x;
    w[4 * k + 1] = blk.q[k].y;
    w[4 * k + 2] = blk.q[k].z;
    w[4 * k + 3] = blk.q[k].w;
  }
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
    const uint32_t t1 = h + S1 + ch + sha_k(t) + wt;
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
// cannot change the state: the per-lane masking of the JAX block loop. The
// next block's loads go out before the current block's rounds; on the last
// block they read that block again (index clamped), never a block past it.
__device__ __forceinline__ void sha256_lane(uint32_t (&st)[8],
                                            const uint32_t* __restrict__ blk,
                                            int live) {
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = sha_h0(i);
  if (live <= 0) return;
  ShaBlock cur = load_block(blk);
  for (int j = 0; j < live; ++j) {
    const ShaBlock nxt = load_block(blk + 16 * min(j + 1, live - 1));
    sha256_compress(st, cur);
    cur = nxt;
  }
}

}  // namespace
