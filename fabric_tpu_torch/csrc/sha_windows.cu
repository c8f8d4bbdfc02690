// Stage A of the fused verify on Hopper: device SHA-256, the mod-n
// scalars and the comb windows, in three entries on one core
// (stage_a.cuh):
//
//   sha_windows_launch (message lanes, the fused tier). Replaces the
//     Pallas TPU kernels fabric_tpu/ops/fused_verify.py _sha_kernel and
//     its streaming twin _sha_kernel_dma (one function, reached through
//     sha_windows). Per lane:
//         words = has_digest ? digest : SHA-256(blocks[:nblocks])
//         u1 = e*w mod n, u2 = r*w mod n (e = words, 256-bit big-endian)
//         w1 = the WG-bit windows of u1, w2 = the WQ-bit windows of u2
//     Inputs: blocks (B, NB, 16) 32-bit big-endian words, nblocks (B,)
//     int32, digests (B, 8) 32-bit words, has_digest (B,) bool, r8 and w8
//     (B, 32) uint8 big-endian rows. Outputs: w1 (B, 256/WG) int32, w2
//     (B, 256/WQ) int32, words (B, 8) int64 (the 32-bit words
//     zero-extended, the port's digest form).
//   digest_windows_launch (digest lanes, the commit path's scalar stage;
//     in the JAX package XLA, fabric_tpu/ops/comb.py comb_verify_with_tables
//     and the byte-to-limb conversions of fabric_tpu/bccsp/tpu.py
//     _comb_pipeline_digest): the same with every lane's words its digest
//     and no blocks; outputs w1 and w2.
//   sha256_digest_launch (fabric_tpu's sha256_blocks, which is XLA there):
//     the SHA part alone, (B, 8) int64 words.
//
// What bounds it on this card: 32-bit integer operations for message
// lanes, bytes for digest lanes. A compression is ~1,384 operations at the
// least (48 schedule words of 10 and 64 rounds of 14, counting a rotate as
// one funnel shift, ch/maj as one LOP3 each and up to three addends as one
// IADD3); the two mod-n products add ~512 multiply-adds at the least (8 x 8
// 32-bit partial products, a low and a high IMAD each, plus a Montgomery
// reduction of the same size). At 5 live blocks per lane that is ~7,400
// operations per lane against ~840 bytes moved (chip_smoke.py sha_bound).
// A digest lane does the products alone (~512 operations) against ~220
// bytes: the bytes bound it.
//
// The design: one thread per lane, everything in registers. The blocks are
// read as 16-byte vectors with the next block's loads issued before the
// current block's rounds (sha256.cuh: the TPU kernel's double buffer,
// in registers); the round constants are immediates; r and w are read as
// bytes and the products are Montgomery products on 32-bit limbs
// (modn32.cuh: three for the two, w turned into w*R once); windows are cut
// from the product's words and written, like the digest words, with
// 16-byte stores. Blocks at or past a lane's count are never read, which
// is the TPU kernel's masked state update without the wasted compressions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_a.cuh"

namespace {

constexpr int THREADS = 128;

template <int WG, int WQ>
__global__ void __launch_bounds__(THREADS)
sha_windows_kernel(const uint32_t* __restrict__ blocks,
                   const int* __restrict__ nblocks,
                   const uint32_t* __restrict__ digests,
                   const uint8_t* __restrict__ has_digest,
                   const uint8_t* __restrict__ r8,
                   const uint8_t* __restrict__ w8, int* __restrict__ w1,
                   int* __restrict__ w2, int64_t* __restrict__ words,
                   int B, int NB) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  sha_windows_lane<WG, WQ>(static_cast<size_t>(lane), blocks, NB, nblocks,
                           digests, has_digest, r8, w8, w1, w2, words);
}

template <int WG, int WQ>
__global__ void __launch_bounds__(THREADS)
digest_windows_kernel(const uint32_t* __restrict__ digests,
                      const uint8_t* __restrict__ r8,
                      const uint8_t* __restrict__ w8, int* __restrict__ w1,
                      int* __restrict__ w2, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  digest_windows_lane<WG, WQ>(static_cast<size_t>(lane), digests, r8, w8,
                              w1, w2);
}

__global__ void __launch_bounds__(THREADS)
sha256_digest_kernel(const uint32_t* __restrict__ blocks,
                     const int* __restrict__ nblocks,
                     int64_t* __restrict__ words, int B, int NB) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  sha256_digest_lane(static_cast<size_t>(lane), blocks, NB, nblocks, words);
}

int grid_for(int B) { return (B + THREADS - 1) / THREADS; }

}  // namespace

// Each launch enqueues its kernel on `stream` and returns
// cudaGetLastError(): 0 when the launch was accepted. None allocates or
// synchronises. wbits_g and wbits_q must both be 8 or both be 16, the
// pairs the provider's routes use (G16 comes only with Q16).
extern "C" int sha_windows_launch(const void* blocks, const void* nblocks,
                                  const void* digests, const void* has_digest,
                                  const void* r8, const void* w8, void* w1,
                                  void* w2, void* words, int B, int NB,
                                  int wbits_g, int wbits_q, void* stream) {
  if (B <= 0) return 0;
  if (NB < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bl = static_cast<const uint32_t*>(blocks);
  const auto* nb = static_cast<const int*>(nblocks);
  const auto* dg = static_cast<const uint32_t*>(digests);
  const auto* hd = static_cast<const uint8_t*>(has_digest);
  const auto* r = static_cast<const uint8_t*>(r8);
  const auto* w = static_cast<const uint8_t*>(w8);
  if (wbits_g == 8 && wbits_q == 8) {
    sha_windows_kernel<8, 8><<<grid_for(B), THREADS, 0, s>>>(
        bl, nb, dg, hd, r, w, static_cast<int*>(w1), static_cast<int*>(w2),
        static_cast<int64_t*>(words), B, NB);
  } else if (wbits_g == 16 && wbits_q == 16) {
    sha_windows_kernel<16, 16><<<grid_for(B), THREADS, 0, s>>>(
        bl, nb, dg, hd, r, w, static_cast<int*>(w1), static_cast<int*>(w2),
        static_cast<int64_t*>(words), B, NB);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int digest_windows_launch(const void* digests, const void* r8,
                                     const void* w8, void* w1, void* w2,
                                     int B, int wbits_g, int wbits_q,
                                     void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dg = static_cast<const uint32_t*>(digests);
  const auto* r = static_cast<const uint8_t*>(r8);
  const auto* w = static_cast<const uint8_t*>(w8);
  if (wbits_g == 8 && wbits_q == 8) {
    digest_windows_kernel<8, 8><<<grid_for(B), THREADS, 0, s>>>(
        dg, r, w, static_cast<int*>(w1), static_cast<int*>(w2), B);
  } else if (wbits_g == 16 && wbits_q == 16) {
    digest_windows_kernel<16, 16><<<grid_for(B), THREADS, 0, s>>>(
        dg, r, w, static_cast<int*>(w1), static_cast<int*>(w2), B);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The digest-only entry: (B, 8) int64 SHA-256 words of each lane's first
// nblocks[lane] blocks (no block: the initial state, as in the JAX loop).
extern "C" int sha256_digest_launch(const void* blocks, const void* nblocks,
                                    void* words, int B, int NB,
                                    void* stream) {
  if (B <= 0) return 0;
  if (NB < 1) return static_cast<int>(cudaErrorInvalidValue);
  sha256_digest_kernel<<<grid_for(B), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int*>(nblocks),
      static_cast<int64_t*>(words), B, NB);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sha_windows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
