// Stage A of the fused verify, one lane: SHA-256 of the message (or the
// lane's precomputed digest), the digest as 13-bit limbs, u1 = e*w and
// u2 = r*w mod n in canonical form, and comb windows. The device half of
// fabric_tpu/ops/fused_verify.py _sha_scalar_rows, _words_to_limbs_rows
// and _windows_rows, shared by sha_windows.cu and fused_resident.cu.

#pragma once

#include <stdint.h>

#include "field13.cuh"
#include "sha256.cuh"

namespace {

// (8,) big-endian digest words -> (20,) 13-bit limbs of the 256-bit
// big-endian integer (word 7 least significant). e is NOT reduced mod n
// first: a digest >= n enters mulmod as it is, as in the JAX package.
__device__ __forceinline__ void words_to_limbs(int (&e)[L],
                                               const uint32_t (&words)[8]) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int bit0 = W * i, j0 = bit0 / 32, s0 = bit0 % 32;
    uint32_t v = words[7 - j0] >> s0;
    if (s0 + W > 32 && j0 + 1 < 8) v |= words[7 - (j0 + 1)] << (32 - s0);
    e[i] = static_cast<int>(v & MASK);
  }
}

// (32,) big-endian bytes of a 256-bit value (16-byte aligned) -> (8,)
// big-endian words, word 0 the most significant, as the digest words.
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

// Window i of WB bits of a canonical scalar: bits [i*WB, (i+1)*WB), which
// span at most three 13-bit limbs for WB <= 16 (a 16-bit window can start
// near a limb's top and take two more; the last one spans limbs 18-19).
template <int WB>
__device__ __forceinline__ int window(const int (&u)[L], int i) {
  const int bit0 = i * WB, j0 = bit0 / W, off = bit0 % W;
  int v = u[j0] >> off;
  int got = W - off;
#pragma unroll
  for (int j = j0 + 1; j < L && got < WB; ++j, got += W) v |= u[j] << got;
  return v & ((1 << WB) - 1);
}

template <int WB>
__device__ __forceinline__ void windows(int* __restrict__ out,
                                        const int (&u)[L]) {
#pragma unroll
  for (int i = 0; i < 256 / WB; ++i) out[i] = window<WB>(u, i);
}

// Lane `lane`'s digest words, u1 and u2. blocks (B, NB, 16) words,
// nblocks (B,) live counts, digests (B, 8) words taken where has_digest
// is set; rl and wl the lane's r and w as canonical limbs; Cn the packed
// mod-n constants and K the SHA constants, both in shared memory.
__device__ __forceinline__ void sha_scalars(
    int lane, const uint32_t* __restrict__ blocks, int NB,
    const int* __restrict__ nblocks, const uint32_t* __restrict__ digests,
    const uint8_t* __restrict__ has_digest, int (&rl)[L], int (&wl)[L],
    const int* Cn, const uint32_t* K, uint32_t (&words)[8], int (&u1)[L],
    int (&u2)[L]) {
  const size_t b = static_cast<size_t>(lane);
  if (has_digest[b]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) words[k] = digests[b * 8 + k];
  } else {
    const int live = min(max(nblocks[b], 0), NB);
    sha256_lane(words, blocks + b * NB * 16, live, K);
  }
  int e[L], t[L];
  words_to_limbs(e, words);
  mulmod(t, e, wl, Cn);
  canonical(u1, t, Cn);
  mulmod(t, rl, wl, Cn);
  canonical(u2, t, Cn);
}

}  // namespace
