// Batched G2 multi-scalar multiplication on BN254's twist, on Hopper: per
// lane sum_t k_t * Q_t, the idemix presentations' Schnorr recombinations
// s_sk*Y~ + s_r*G~ - c*T~ and their subgroup lanes [6x^2]T~
// (CUDAProvider.g2_msm_batch). Not a port of a Pallas kernel: the JAX
// package runs it as one XLA scan, fabric_tpu/ops/bn254.py g2_msm_scan
// (:332). In the port its plain torch version is over a million small
// launches a call, so the card runs it as this one kernel:
//
//   g2_msm_launch: k (B, T, 8) little-endian 32-bit scalar words, q (4T, B,
//     20) int32 limbs of the affine points (ops/bn254.py
//     stage_g2_msm_words), consts (148 words, BnConsts), out (6, B, 20): the
//     projective sum (X, Y, Z), canonical; B, T (1..8), nbits (1..256).
//
// What bounds it on this card: 32-bit integer multiply-adds. Per bit one
// complete doubling (9 Fp2 products: 27 field products) and one complete
// mixed addition (14 Fp2 products: 42) for each set bit of the lane's
// scalars, 256 IMAD a product (chip_smoke.py pairing_vs_plain counts the
// set bits of the run's scalars for its bound). The scalars and points are ~400 bytes a lane.
//
// The design, a simple first kernel: one thread per lane on the tower's
// twist steps (bn254_tower.cuh), the points converted once into local
// memory, the scalars read as words from global memory at each bit. Each
// lane adds where its own bit is set: a branch, so a warp runs an addition
// when any of its lanes needs it (with random scalars nearly always), and
// the result is the point fabric_tpu's masked select gives.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_pairing.cuh"

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
g2_msm_kernel(const uint32_t* __restrict__ kw, const int* __restrict__ q,
              const uint32_t* __restrict__ consts, int* __restrict__ out,
              int B, int nterms, int nbits) {
  __shared__ BnConsts k;
  bn_consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  bn_msm_lane(kw, q, B, nterms, nbits, lane, k, out);
}

}  // namespace

// Enqueues the kernel on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a term count or width it does not take).
extern "C" int g2_msm_launch(const void* kw, const void* q,
                             const void* consts, void* out, int B,
                             int nterms, int nbits, void* stream) {
  if (nterms < 1 || nterms > BN_MSM_MAX_TERMS || nbits < 1 || nbits > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  g2_msm_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(kw), static_cast<const int*>(q),
      static_cast<const uint32_t*>(consts), static_cast<int*>(out), B,
      nterms, nbits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* g2_msm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
