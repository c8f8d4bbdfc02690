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
//     stage_g2_msm_words), consts (148 words, BnConsts), scratch (the
//     joint tables of lanes of more than three terms, g2_msm_scratch_bytes
//     (B, T) bytes; for T <= 3 none, may be null), out (6, B, 20): the
//     projective sum (X, Y, Z), canonical; any B, T >= 1, nbits (1..256).
//   g2_msm_scratch_bytes(B, T): the scratch a call needs, 0 for T <= 3.
//
// What bounds it on this card: 32-bit integer multiply-adds. Per bit one
// complete doubling (9 Fp2 products: 25 field products) and, per window of
// three terms, one complete projective addition (14 Fp2 products: 42)
// where the window's bits are not all zero, 256 IMAD a product
// (chip_smoke.py msm_products counts them on the run's scalars and launch
// order). The scalars and points are ~400 bytes a lane.
//
// The design: one thread per lane on the tower's twist steps
// (bn254_tower.cuh, its Fp2 bodies out of line with operands by value).
// A lane first builds its joint table (bn254_pairing.cuh bn_msm_lane: the
// 7 subset sums of a window's three points, projective in local memory,
// so that T + (-T) and Q + Q are entries like any other), then takes one
// doubling and one addition of the indexed entry a bit: ~254 additions
// for a three-term lane where one addition per set bit of each scalar
// was ~381. The addition is computed, then kept where the index is
// nonzero: no branch inside a warp. The provider launches only the live
// lanes, ordered by class (live terms, then top bit), so a warp's lanes
// share their length: the warp starts at its highest top bit
// (__reduce_max_sync) and skips an addition no lane of it needs
// (__any_sync), which makes the subgroup lanes' warps (one 127-bit scalar
// of weight 70, the same for every lane) run 127 doublings and 70
// additions. Up to three terms (one window: the idemix lanes) the table
// sits in local memory (g2_msm_kernel<1>); a lane of more terms takes
// g2_msm_kernel<0>, the same chain with its tables in the scratch buffer
// the wrapper allocates, so any term count runs on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_pairing.cuh"

namespace {

using namespace bn254;

constexpr int THREADS = 64;

template <int NW>
__global__ void __launch_bounds__(THREADS)
g2_msm_kernel(const uint32_t* __restrict__ kw, const int* __restrict__ q,
              const uint32_t* __restrict__ consts, G2P* __restrict__ scratch,
              int* __restrict__ out, int B, int nterms, int nbits) {
  __shared__ BnConsts k;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  bn_msm_thread<NW>(kw, q, B, nterms, nbits,
                    blockIdx.x * blockDim.x + threadIdx.x, k, out, scratch);
}

}  // namespace

// Enqueues the kernel on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a term count or width it does not take).
extern "C" int g2_msm_launch(const void* kw, const void* q,
                             const void* consts, void* scratch, void* out,
                             int B, int nterms, int nbits, void* stream) {
  if (nterms < 1 || nbits < 1 || nbits > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const int grid = (B + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(kw);
  const int* pts = static_cast<const int*>(q);
  const uint32_t* c = static_cast<const uint32_t*>(consts);
  int* o = static_cast<int*>(out);
  if (nterms <= BN_MSM_WINDOW)
    g2_msm_kernel<1><<<grid, THREADS, 0, s>>>(k, pts, c, nullptr, o, B,
                                              nterms, nbits);
  else
    g2_msm_kernel<0><<<grid, THREADS, 0, s>>>(
        k, pts, c, static_cast<G2P*>(scratch), o, B, nterms, nbits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long g2_msm_scratch_bytes(int B, int nterms) {
  return B > 0 && nterms > 0
             ? bn_msm_scratch_entries(B, nterms) *
                   static_cast<long long>(sizeof(G2P))
             : 0;
}

extern "C" const char* g2_msm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
