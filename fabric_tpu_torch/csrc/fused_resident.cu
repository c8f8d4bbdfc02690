// The single-program fused verify on Hopper: SHA-256, the mod-n scalars,
// 8-bit comb windows, the gather from the comb tables and the 64-point
// complete-add sum with the projective check, in one kernel.
//
// Replaces the Pallas TPU kernel fabric_tpu/ops/fused_verify.py
// _resident_kernel (reached through fused_verify_resident). Per lane:
//     stage A at 8/8-bit windows (stage_a.cuh, as sha_windows.cu)
//     R = sum_i g8[i*256 + w1_i] + sum_i q8[(i*K + key)*256 + w2_i]
//     accept = premask && 0 <= key < K && Z != 0
//              && (X == r*Z || X == rpn*Z)   (mod p)
// Inputs: as sha_windows.cu plus key_idx (B,) int32, rpn (B, 20) int32,
// premask (B,) bool, consts_p (25, 20) the packed mod-p constants, g8
// (8192, 3, 20) int32 and q8 (K*8192, 3, 20) int32 (comb.g_tables and
// comb.build_q_tables); output (B,) bool.
//
// Design (the simple first version). One thread per lane. On the TPU the
// tables were pinned in VMEM across grid steps; here they stay in global
// memory and the gather reads them through L2: the g8 table and K key
// slots take 1.97 MB each, which fused_verify.RESIDENT_TABLE_BUDGET keeps
// within half of the H100's 50 MB L2. The sum is a running sum over the 64
// gathered points (the TPU kernel summed by halves over its tile; complete
// addition has no exceptional cases and the check is projective, so the
// verdicts agree), with the arithmetic of field13.cuh. A lane whose
// premask is off, or whose key slot is out of range, rejects at once and
// reads nothing.
//
// What bounds it on this card: int32 multiply-adds. The 63 complete
// additions dominate (~0.22 ms of least work at 32,768 lanes; ptree.cu's
// header gives the count), then stage A (~7,400 operations a lane); the
// gather reads 64 x 240 bytes a lane. chip_smoke.py resident_bound adds
// the three.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_a.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWIN = 32;              // 8-bit windows per scalar
constexpr int NENT = 256;             // table entries per window
constexpr int PT = 3 * L;             // int32s per projective point

__global__ void __launch_bounds__(THREADS)
fused_resident_kernel(const uint32_t* __restrict__ blocks,
                      const int* __restrict__ nblocks,
                      const uint32_t* __restrict__ digests,
                      const uint8_t* __restrict__ has_digest,
                      const int* __restrict__ key_idx,
                      const int* __restrict__ r, const int* __restrict__ rpn,
                      const int* __restrict__ w,
                      const uint8_t* __restrict__ premask,
                      const int* __restrict__ consts_n,
                      const int* __restrict__ consts_p,
                      const uint32_t* __restrict__ shc,
                      const int* __restrict__ g_tab,
                      const int* __restrict__ q_tab,
                      uint8_t* __restrict__ out, int B, int NB, int K) {
  __shared__ int Cn[NCONST * L];
  __shared__ int Cp[NCONST * L];
  __shared__ uint32_t SK[SHA_NCONST];
  for (int i = threadIdx.x; i < NCONST * L; i += blockDim.x) {
    Cn[i] = consts_n[i];
    Cp[i] = consts_p[i];
  }
  for (int i = threadIdx.x; i < SHA_NCONST; i += blockDim.x) SK[i] = shc[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t b = static_cast<size_t>(lane);
  const int key = key_idx[b];
  if (!premask[b] || key < 0 || key >= K) {
    out[b] = 0;
    return;
  }
  uint32_t words[8];
  int u1[L], u2[L];
  sha_scalars(lane, blocks, NB, nblocks, digests, has_digest, r, w, Cn, SK,
              words, u1, u2);
  int wg[NWIN], wq[NWIN];
  windows<8>(wg, u1);
  windows<8>(wq, u2);

  int X[L], Y[L], Z[L];
  const int* p = g_tab + static_cast<size_t>(wg[0]) * PT;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    X[i] = p[i];
    Y[i] = p[L + i];
    Z[i] = p[2 * L + i];
  }
  for (int m = 1; m < 2 * NWIN; ++m) {
    const size_t row =
        m < NWIN ? static_cast<size_t>(m) * NENT + wg[m]
                 : (static_cast<size_t>(m - NWIN) * K + key) * NENT +
                       wq[m - NWIN];
    const int* q = (m < NWIN ? g_tab : q_tab) + row * PT;
    int X2[L], Y2[L], Z2[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      X2[i] = q[i];
      Y2[i] = q[L + i];
      Z2[i] = q[2 * L + i];
    }
    cadd(X, Y, Z, X, Y, Z, X2, Y2, Z2, Cp);
  }
  out[b] = projective_check(X, Z, r + b * L, rpn + b * L, Cp);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): 0 when
// the launch was accepted. Allocates nothing and does not synchronise.
extern "C" int fused_resident_launch(
    const void* blocks, const void* nblocks, const void* digests,
    const void* has_digest, const void* key_idx, const void* r,
    const void* rpn, const void* w, const void* premask,
    const void* consts_n, const void* consts_p, const void* shc,
    const void* g_tab, const void* q_tab, void* out, int B, int NB, int K,
    void* stream) {
  if (B <= 0) return 0;
  if (NB < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  fused_resident_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int*>(nblocks),
      static_cast<const uint32_t*>(digests),
      static_cast<const uint8_t*>(has_digest),
      static_cast<const int*>(key_idx), static_cast<const int*>(r),
      static_cast<const int*>(rpn), static_cast<const int*>(w),
      static_cast<const uint8_t*>(premask),
      static_cast<const int*>(consts_n), static_cast<const int*>(consts_p),
      static_cast<const uint32_t*>(shc), static_cast<const int*>(g_tab),
      static_cast<const int*>(q_tab), static_cast<uint8_t*>(out), B, NB, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
