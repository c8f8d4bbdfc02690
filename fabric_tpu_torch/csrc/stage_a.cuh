// Stage A of the fused verify, one lane: the digest words (SHA-256 of the
// lane's blocks, or its given digest), u1 = e*w and u2 = r*w mod n in
// canonical form, and the comb windows. The device half of
// fabric_tpu/ops/fused_verify.py _sha_scalar_rows and _windows_rows, and
// of the scalar stage of fabric_tpu/ops/comb.py comb_verify_with_tables;
// shared by sha_windows.cu and fused_resident.cu, and built by the host
// compiler for tests/test_torch_stage_a_host.py.
//
// Everything stays in 32-bit words: r and w are read as 32-byte big-endian
// rows (fe_load_be), the digest enters mod-n arithmetic as its big-endian
// words (not reduced mod n first, as in the JAX package), the products are
// modn32.cuh's, and a window of WB bits is cut from the word that holds it
// (WB divides 32, so no window spans two words).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "modn32.cuh"
#include "sha256.cuh"

namespace {

// (8,) words -> a (8,) int64 row (the port's digest form: each word
// zero-extended), as four 16-byte stores
__device__ __forceinline__ void store_words(int64_t* dst,
                                            const uint32_t (&words)[8]) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = make_uint4(words[2 * k], 0u, words[2 * k + 1], 0u);
}

// Window i of WB bits of a canonical scalar: bits [i*WB, (i+1)*WB)
template <int WB>
__device__ __forceinline__ uint32_t window(const Fe& u, int i) {
  return (u.w[i * WB / 32] >> (i * WB % 32)) & ((1u << WB) - 1u);
}

// The 256/WB windows of u as an int32 row (16-byte aligned), four to a
// 16-byte store
template <int WB>
__device__ __forceinline__ void store_windows(int* dst, const Fe& u) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < 256 / WB / 4; ++k)
    v[k] = make_uint4(window<WB>(u, 4 * k), window<WB>(u, 4 * k + 1),
                      window<WB>(u, 4 * k + 2), window<WB>(u, 4 * k + 3));
}

// Lane b's digest words: its digest where has_digest is set, else SHA-256
// of its first nblocks[b] (clamped to [0, NB]) blocks. blocks (B, NB, 16),
// digests (B, 8) 32-bit words.
__device__ __forceinline__ void stage_a_words(
    uint32_t (&words)[8], size_t b, const uint32_t* __restrict__ blocks,
    int NB, const int* __restrict__ nblocks,
    const uint32_t* __restrict__ digests,
    const uint8_t* __restrict__ has_digest) {
  if (has_digest[b]) {
    load_words(words, digests + b * 8);
  } else {
    const int live = min(max(nblocks[b], 0), NB);
    sha256_lane(words, blocks + b * NB * 16, live);
  }
}

// The three entries' lane bodies (sha_windows.cu runs one per thread).
// r8 and w8 are (B, 32) big-endian rows; w1 (B, 256/WG) and w2 (B,
// 256/WQ) int32 windows; words (B, 8) int64.

// Message lanes (the fused tier): r and w are loaded first, so their loads
// are in flight under the SHA rounds.
template <int WG, int WQ>
__device__ __forceinline__ void sha_windows_lane(
    size_t b, const uint32_t* __restrict__ blocks, int NB,
    const int* __restrict__ nblocks, const uint32_t* __restrict__ digests,
    const uint8_t* __restrict__ has_digest, const uint8_t* __restrict__ r8,
    const uint8_t* __restrict__ w8, int* __restrict__ w1,
    int* __restrict__ w2, int64_t* __restrict__ words_out) {
  const Fe r = fe_load_be(r8 + b * 32), w = fe_load_be(w8 + b * 32);
  uint32_t words[8];
  stage_a_words(words, b, blocks, NB, nblocks, digests, has_digest);
  Fe u1, u2;
  mn_scalars(fe_from_be_words(words), r, w, u1, u2);
  store_windows<WG>(w1 + b * (256 / WG), u1);
  store_windows<WQ>(w2 + b * (256 / WQ), u2);
  store_words(words_out + b * 8, words);
}

// Digest lanes (the commit path's scalar stage): no blocks, every lane
// takes its (8,) digest words.
template <int WG, int WQ>
__device__ __forceinline__ void digest_windows_lane(
    size_t b, const uint32_t* __restrict__ digests,
    const uint8_t* __restrict__ r8, const uint8_t* __restrict__ w8,
    int* __restrict__ w1, int* __restrict__ w2) {
  uint32_t words[8];
  load_words(words, digests + b * 8);
  Fe u1, u2;
  mn_scalars(fe_from_be_words(words), fe_load_be(r8 + b * 32),
             fe_load_be(w8 + b * 32), u1, u2);
  store_windows<WG>(w1 + b * (256 / WG), u1);
  store_windows<WQ>(w2 + b * (256 / WQ), u2);
}

// The digest-only SHA-256 entry: SHA-256 of the lane's first nblocks[b]
// blocks (no block: the initial state, as in the JAX loop).
__device__ __forceinline__ void sha256_digest_lane(
    size_t b, const uint32_t* __restrict__ blocks, int NB,
    const int* __restrict__ nblocks, int64_t* __restrict__ words_out) {
  uint32_t st[8];
  sha256_lane(st, blocks + b * NB * 16, min(max(nblocks[b], 0), NB));
  store_words(words_out + b * 8, st);
}

}  // namespace
