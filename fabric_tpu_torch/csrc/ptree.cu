// The per-signature complete-add tree and projective check, for Hopper.
//
// Replaces the Pallas TPU kernel fabric_tpu/ops/ptree.py:_kernel (reached
// through tree_verify_points). Per lane it computes what tree_verify_points
// computes: R = the sum of the lane's M gathered projective comb points by
// RCB15 complete additions, then
//     accept = premask && Z != 0 && (X == r*Z || X == rpn*Z)   (mod p).
// Inputs: pts (B, M, 3, 20) int32 semi-reduced 13-bit limbs, r and rpn
// (B, 20) int32 canonical, premask (B,) bool, consts (25, 20) int32 packed
// as fabric_tpu_torch/ops/ptree.py KMod.pack_consts; output (B,) bool.
//
// Design (the simple first version). One thread per lane keeps a running
// sum acc = cadd(acc, P_m) over its M points; the TPU kernel paired points
// by halves across a (M, 512-lane) VMEM tile. The two give the same group
// element, complete addition has no exceptional cases (P+P, P+(-P), P+inf)
// and the check X == r*Z is invariant under projective scaling, so the
// verdicts agree although the intermediate limbs do not. The arithmetic,
// in field13.cuh, is the JAX package's 13-bit-limb KMod, operation for
// operation (carry3,
// fold at 2^256, offset subtraction, the fold_hi rows and the two-limb pad
// before the second carry3 in mulmod), so every int32 bound proved in
// ops/limb.py holds here: product columns stay below 20 * 2^26 < 2^31 and
// no limb goes negative except in the final borrow of the conditional
// subtraction, where the arithmetic >> reads the borrow as -1.
//
// What bounds it on this card: int32 multiply-adds. This design's mulmod
// is 400 IMAD of schoolbook product, 400 of fold_hi and 59 in the two
// folds at 2^256; its complete add is 17 mulmods and 23 add/sub (39 IMAD
// each), ~15.5k IMAD, and a lane does M-1 of them plus the check: ~1.6e10
// IMAD at M = 32 and 32,768 lanes, ~0.95 ms at the H100 SXM's 64
// IMAD/clk/SM x 132 SMs x 1.98 GHz. The function itself needs far fewer:
// 14 field multiplies per add for a = -3 (RCB15 Alg. 4), each 64 32-bit
// partial products (a low and a high IMAD) with P-256's multiply-free
// Solinas fold, ~1.8e9 IMAD or ~0.11 ms (chip_smoke.py tree_bound), still
// above the ~0.075 ms to read the 251 MB of points at 3.35 TB/s. So the
// kernel is compute-bound, not bandwidth-bound.
//
// What this design leaves on the table: the field operations are
// out-of-line functions over per-thread arrays, so every operand lives in
// local memory (L1/L2 traffic, not registers); 13-bit limbs spend ~2.5x the
// multiplies a 32-bit-limb design with mul.hi/mad.cc would; and the points
// are read lane-strided, not coalesced. `nvcc -Xptxas -v` (CUDA 12.8,
// sm_90a) reports 96 registers, a 1,680-byte stack and no spill stores:
// the operands sit in that stack, not in spilled registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field13.cuh"

namespace {

constexpr int MAX_POINTS = 64;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
ptree_verify_kernel(const int* __restrict__ pts, const int* __restrict__ r,
                    const int* __restrict__ rpn,
                    const uint8_t* __restrict__ premask,
                    const int* __restrict__ consts,
                    uint8_t* __restrict__ out, int B, int M) {
  __shared__ int C[NCONST * L];
  for (int i = threadIdx.x; i < NCONST * L; i += blockDim.x) C[i] = consts[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int* p = pts + static_cast<size_t>(lane) * M * 3 * L;
  int X[L], Y[L], Z[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    X[i] = p[i];
    Y[i] = p[L + i];
    Z[i] = p[2 * L + i];
  }
  for (int m = 1; m < M; ++m) {
    const int* q = p + static_cast<size_t>(m) * 3 * L;
    int X2[L], Y2[L], Z2[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      X2[i] = q[i];
      Y2[i] = q[L + i];
      Z2[i] = q[2 * L + i];
    }
    cadd(X, Y, Z, X, Y, Z, X2, Y2, Z2, C);
  }

  out[lane] = (premask[lane] != 0) &&
              projective_check(X, Z, r + static_cast<size_t>(lane) * L,
                               rpn + static_cast<size_t>(lane) * L, C);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): 0 when
// the launch was accepted. Allocates nothing and does not synchronise.
extern "C" int ptree_verify_launch(const void* pts, const void* r,
                                   const void* rpn, const void* premask,
                                   const void* consts, void* out, int B,
                                   int M, void* stream) {
  if (B <= 0) return 0;
  if (M < 1 || M > MAX_POINTS) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + THREADS - 1) / THREADS;
  ptree_verify_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pts), static_cast<const int*>(r),
      static_cast<const int*>(rpn), static_cast<const uint8_t*>(premask),
      static_cast<const int*>(consts), static_cast<uint8_t*>(out), B, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ptree_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
