// Stage A of the fused verify on Hopper: device SHA-256, the mod-n
// scalars and the comb windows; and the digest-only SHA-256 entry.
//
// Replaces the Pallas TPU kernels fabric_tpu/ops/fused_verify.py
// _sha_kernel and its streaming twin _sha_kernel_dma (one function,
// reached through sha_windows). Per lane it computes what sha_windows
// computes:
//     words = has_digest ? digest : SHA-256(blocks[:nblocks])
//     e = words as a 256-bit big-endian integer, in 13-bit limbs
//     u1 = e*w mod n, u2 = r*w mod n, canonical
//     w1 = the WG-bit windows of u1, w2 = the WQ-bit windows of u2
// Inputs: blocks (B, NB, 16) 32-bit big-endian words, nblocks (B,) int32,
// digests (B, 8) 32-bit words, has_digest (B,) bool, r and w (B, 20) int32
// canonical limbs, consts_n (25, 20) int32 packed as
// fabric_tpu_torch/ops/ptree.py KMod(FN).pack_consts, shc (72,) the SHA
// constants. Outputs: w1 (B, 256/WG) int32, w2 (B, 256/WQ) int32, words
// (B, 8) int64 (the 32-bit words zero-extended, the port's digest form).
// sha256_digest_launch runs the SHA part alone (fabric_tpu's
// sha256_blocks, which is XLA there): (B, 8) int64 words.
//
// Design (the simple first version). One thread per lane, as in ptree.cu:
// the lane's blocks are compressed one after the other in registers, with
// the 13-bit-limb mod-n arithmetic of field13.cuh after them. Blocks at or
// past a lane's count are never read, which is the TPU kernel's masked
// state update without the wasted compressions. The TPU's double buffer
// of message tiles into VMEM has no counterpart yet: each thread reads its
// own 64-byte blocks straight from global memory, lane-strided (NB*64
// bytes apart), so a warp's loads are not coalesced. Staging a block tile
// per warp through shared memory with cp.async (or TMA) is this kernel's
// open speed item.
//
// What bounds it on this card: 32-bit integer operations. A compression
// is ~1,384 of them at the least (48 schedule words of 10 and 64 rounds
// of 14, counting a rotate as one funnel shift, ch/maj as one LOP3 each
// and up to three addends as one IADD3); the two mod-n products add ~512
// multiply-adds at the least (8 x 8 32-bit partial products, a low and a
// high IMAD each, plus a Montgomery reduction of the same size: n is not
// a Solinas prime). At 5 live blocks per lane that is ~7,400 operations
// per lane against
// ~840 bytes moved, so the operations bound it (chip_smoke.py sha_bound).
// This design's mulmod is 13-bit-limb schoolbook (859 IMAD), out of line.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_a.cuh"

namespace {

constexpr int THREADS = 128;

// Copy the packed mod-n constants and the SHA constants into shared memory.
__device__ __forceinline__ void load_consts(int* Cn, uint32_t* K,
                                            const int* __restrict__ consts_n,
                                            const uint32_t* __restrict__ shc) {
  for (int i = threadIdx.x; i < NCONST * L; i += blockDim.x)
    Cn[i] = consts_n[i];
  for (int i = threadIdx.x; i < SHA_NCONST; i += blockDim.x) K[i] = shc[i];
  __syncthreads();
}

template <int WG, int WQ>
__global__ void __launch_bounds__(THREADS)
sha_windows_kernel(const uint32_t* __restrict__ blocks,
                   const int* __restrict__ nblocks,
                   const uint32_t* __restrict__ digests,
                   const uint8_t* __restrict__ has_digest,
                   const int* __restrict__ r, const int* __restrict__ w,
                   const int* __restrict__ consts_n,
                   const uint32_t* __restrict__ shc, int* __restrict__ w1,
                   int* __restrict__ w2, int64_t* __restrict__ words_out,
                   int B, int NB) {
  __shared__ int Cn[NCONST * L];
  __shared__ uint32_t K[SHA_NCONST];
  load_consts(Cn, K, consts_n, shc);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t b = static_cast<size_t>(lane);
  uint32_t words[8];
  int rl[L], wl[L], u1[L], u2[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    rl[i] = r[b * L + i];
    wl[i] = w[b * L + i];
  }
  sha_scalars(lane, blocks, NB, nblocks, digests, has_digest, rl, wl, Cn, K,
              words, u1, u2);
  windows<WG>(w1 + b * (256 / WG), u1);
  windows<WQ>(w2 + b * (256 / WQ), u2);
#pragma unroll
  for (int k = 0; k < 8; ++k) words_out[b * 8 + k] = words[k];
}

__global__ void __launch_bounds__(THREADS)
sha256_digest_kernel(const uint32_t* __restrict__ blocks,
                     const int* __restrict__ nblocks,
                     const uint32_t* __restrict__ shc,
                     int64_t* __restrict__ words_out, int B, int NB) {
  __shared__ uint32_t K[SHA_NCONST];
  for (int i = threadIdx.x; i < SHA_NCONST; i += blockDim.x) K[i] = shc[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t b = static_cast<size_t>(lane);
  uint32_t st[8];
  sha256_lane(st, blocks + b * NB * 16, min(max(nblocks[b], 0), NB), K);
#pragma unroll
  for (int k = 0; k < 8; ++k) words_out[b * 8 + k] = st[k];
}

template <int WG, int WQ>
void launch(int blocks_n, cudaStream_t s, const void* blocks,
            const void* nblocks, const void* digests, const void* has_digest,
            const void* r, const void* w, const void* consts_n,
            const void* shc, void* w1, void* w2, void* words, int B,
            int NB) {
  sha_windows_kernel<WG, WQ><<<blocks_n, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int*>(nblocks),
      static_cast<const uint32_t*>(digests),
      static_cast<const uint8_t*>(has_digest), static_cast<const int*>(r),
      static_cast<const int*>(w), static_cast<const int*>(consts_n),
      static_cast<const uint32_t*>(shc), static_cast<int*>(w1),
      static_cast<int*>(w2), static_cast<int64_t*>(words), B, NB);
}

}  // namespace

// Launches stage A on `stream` and returns cudaGetLastError(): 0 when the
// launch was accepted. wbits_g and wbits_q must both be 8 or both be 16,
// the pairs the provider's routes use (G16 comes only with Q16). Allocates
// nothing and does not synchronise.
extern "C" int sha_windows_launch(const void* blocks, const void* nblocks,
                                  const void* digests, const void* has_digest,
                                  const void* r, const void* w,
                                  const void* consts_n, const void* shc,
                                  void* w1, void* w2, void* words, int B,
                                  int NB, int wbits_g, int wbits_q,
                                  void* stream) {
  if (B <= 0) return 0;
  if (NB < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = (B + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wbits_g == 8 && wbits_q == 8) {
    launch<8, 8>(n, s, blocks, nblocks, digests, has_digest, r, w, consts_n,
                 shc, w1, w2, words, B, NB);
  } else if (wbits_g == 16 && wbits_q == 16) {
    launch<16, 16>(n, s, blocks, nblocks, digests, has_digest, r, w,
                   consts_n, shc, w1, w2, words, B, NB);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The digest-only entry: (B, 8) int64 SHA-256 words of each lane's first
// nblocks[lane] blocks (no block: the initial state, as in the JAX loop).
extern "C" int sha256_digest_launch(const void* blocks, const void* nblocks,
                                    const void* shc, void* words, int B,
                                    int NB, void* stream) {
  if (B <= 0) return 0;
  if (NB < 1) return static_cast<int>(cudaErrorInvalidValue);
  sha256_digest_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int*>(nblocks),
      static_cast<const uint32_t*>(shc), static_cast<int64_t*>(words), B,
      NB);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sha_windows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
