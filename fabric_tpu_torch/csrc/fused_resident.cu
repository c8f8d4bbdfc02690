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
// Inputs: as sha_windows.cu's message entry (r8 and w8 (B, 32) uint8
// big-endian rows), plus key_idx (B,) int32, rpn8 (B, 32) uint8, premask
// (B,) bool, g8 (8192, 3, 20) int32 and q8 (K*8192, 3, 20) int32
// (comb.g_tables and comb.build_q_tables), and T, the threads per lane;
// output (B,) bool.
//
// What bounds it on this card: 32-bit integer operations. The 63 complete
// additions dominate (~0.22 ms of least work at 32,768 lanes; ptree.cu's
// header gives the count), then stage A (~7,400 operations a lane); the
// gather reads 64 x 240 bytes a lane. chip_smoke.py resident_bound adds
// the three.
//
// The design. A lane owns a group of T threads. Thread 0 of the group runs
// stage A once (stage_a.cuh: SHA-256 with pipelined block loads, the
// Montgomery products of modn32.cuh, all inlined in registers) and leaves
// the lane's 64 windows in shared memory; after __syncwarp the group gathers and sums its 64 points as the
// tree kernel does (tree_sum.cuh, on the 32-bit field core of
// p256_field.cuh: interleaved running sums, shuffle merges, int4 loads),
// and thread 0 runs the check. On the TPU the tables were pinned in VMEM
// across grid steps; here they stay in global memory and the gather reads
// them through L2: the g8 table and K key slots take 1.97 MB each, which
// fused_verify.RESIDENT_TABLE_BUDGET keeps within half of the H100's 50 MB
// L2. The sum's order differs from the TPU kernel's halving; complete
// addition has no exceptional cases and the check is projective, so the
// verdicts agree. A lane whose premask is off, or whose key slot is out of
// range, rejects at once and reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_a.cuh"
#include "tree_sum.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWIN = 32;              // 8-bit windows per scalar
constexpr int NENT = 256;             // table entries per window

// Lane rows from the windows thread 0 left in shared memory.
struct ResidentRows {
  const uint8_t* win;                 // 2 * NWIN windows: G side, Q side
  const int* g_tab;
  const int* q_tab;
  int key, K;
  __device__ __forceinline__ const int* row(int m) const {
    const size_t r =
        m < NWIN ? static_cast<size_t>(m) * NENT + win[m]
                 : (static_cast<size_t>(m - NWIN) * K + key) * NENT + win[m];
    return (m < NWIN ? g_tab : q_tab) + r * PT_INTS;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
fused_resident_kernel(const uint32_t* __restrict__ blocks,
                      const int* __restrict__ nblocks,
                      const uint32_t* __restrict__ digests,
                      const uint8_t* __restrict__ has_digest,
                      const int* __restrict__ key_idx,
                      const uint8_t* __restrict__ r8,
                      const uint8_t* __restrict__ rpn8,
                      const uint8_t* __restrict__ w8,
                      const uint8_t* __restrict__ premask,
                      const int* __restrict__ g_tab,
                      const int* __restrict__ q_tab,
                      uint8_t* __restrict__ out, int B, int NB, int K,
                      int T) {
  __shared__ uint8_t win[THREADS][2 * NWIN];   // one row per lane slot
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = gid / T, t = gid - lane * T;
  if (lane >= B) return;                    // the whole group leaves
  const size_t b = static_cast<size_t>(lane);
  const int key = key_idx[b];
  if (!premask[b] || key < 0 || key >= K) {
    if (t == 0) out[b] = 0;
    return;
  }
  uint8_t* lw = win[threadIdx.x / T];
  if (t == 0) {
    const Fe r = fe_load_be(r8 + b * 32), w = fe_load_be(w8 + b * 32);
    uint32_t words[8];
    stage_a_words(words, b, blocks, NB, nblocks, digests, has_digest);
    Fe u1, u2;
    mn_scalars(fe_from_be_words(words), r, w, u1, u2);
#pragma unroll
    for (int i = 0; i < NWIN; ++i) {
      lw[i] = static_cast<uint8_t>(window<8>(u1, i));
      lw[NWIN + i] = static_cast<uint8_t>(window<8>(u2, i));
    }
  }
  __syncwarp(group_mask(T));                // the windows reach the group
  const ResidentRows rows{lw, g_tab, q_tab, key, K};
  const Pt R = group_sum(rows, 2 * NWIN, t, T);
  if (t == 0)
    out[b] = pt_check(R, fe_load_be(r8 + b * 32), fe_load_be(rpn8 + b * 32));
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError(): 0 when
// the launch was accepted. Allocates nothing and does not synchronise.
extern "C" int fused_resident_launch(
    const void* blocks, const void* nblocks, const void* digests,
    const void* has_digest, const void* key_idx, const void* r8,
    const void* rpn8, const void* w8, const void* premask,
    const void* g_tab, const void* q_tab, void* out, int B, int NB, int K,
    int T, void* stream) {
  if (B <= 0) return 0;
  if (NB < 1 || K < 1 || !(T == 1 || T == 2 || T == 4 || T == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid =
      static_cast<int>((static_cast<long long>(B) * T + THREADS - 1) /
                       THREADS);
  fused_resident_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(blocks), static_cast<const int*>(nblocks),
      static_cast<const uint32_t*>(digests),
      static_cast<const uint8_t*>(has_digest),
      static_cast<const int*>(key_idx), static_cast<const uint8_t*>(r8),
      static_cast<const uint8_t*>(rpn8), static_cast<const uint8_t*>(w8),
      static_cast<const uint8_t*>(premask), static_cast<const int*>(g_tab), static_cast<const int*>(q_tab),
      static_cast<uint8_t*>(out), B, NB, K, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
