// The per-signature complete-add tree and projective check, for Hopper.
//
// Replaces the Pallas TPU kernel fabric_tpu/ops/ptree.py:_kernel (reached
// through tree_verify_points). Per lane it computes what tree_verify_points
// computes: R = the sum of the lane's M projective comb points, then
//     accept = premask && Z != 0 && (X == r*Z || X == rpn*Z)   (mod p).
// Two entries share one device function (tree_lane):
//   ptree_verify_launch: the gathered points, pts (B, M, 3, 20) int32
//     semi-reduced 13-bit limbs;
//   ptree_windows_launch: the comb windows and the tables, gathering each
//     lane's rows itself: w1 (B, 256/wbits_g) and w2 (B, 256/wbits_q)
//     int32 windows, key_idx (B,) int32, g_tab (256/wbits_g * 2^wbits_g,
//     3, 20) and q_tab (256/wbits_q * K * 2^wbits_q, 3, 20) int32; point
//     m < 256/wbits_g is g_tab[m * 2^wbits_g + w1[m]], point 256/wbits_g + i
//     is q_tab[(i * K + key) * 2^wbits_q + w2[i]] (ops/comb.py's gather,
//     windows taken modulo 2^wbits); a lane whose key slot is outside
//     [0, K) rejects. This removes the (B, M, 3, 20) intermediate that the
//     gather wrote to device memory and the tree read back.
// The points entry takes r and rpn as (B, 20) int32 canonical limbs, the
// windows entry as r8 and rpn8 (B, 32) uint8 big-endian rows (the host's
// form, read per lane by fe_load_be). Both take premask (B,) bool, write
// (B,) bool, and take T, the threads per lane. A lane with premask off
// rejects without reading its points.
//
// What bounds it on this card: 32-bit integer operations. A complete
// addition needs 14 field products at the least (RCB15 Alg. 4 for a = -3:
// 12M + 2m_b), 64 32-bit partial products of a low and a high IMAD each
// with P-256's multiply-free Solinas fold; a lane does M - 1 of them and
// the check's two: ~0.11 ms at M = 32 and 32,768 lanes at the H100 SXM's
// 64 int32 operations/clk/SM (chip_smoke.py tree_bound), above the
// ~0.075 ms to read the lanes' 240-byte points once at 3.35 TB/s.
//
// The design (p256_field.cuh, tree_sum.cuh): 32-bit limbs in registers
// (every field operation inlined over fixed arrays, nothing on the stack),
// RCB15 Alg. 4 with b as an immediate, T threads per lane summing
// interleaved points and merging by shuffles, each point read as 15 int4
// loads. T = 1 is the wrappers' choice: on the H100 the kernel is bound by
// instruction issue, not by latency, and T > 1 issues the merge rounds'
// additions on every thread of a group, which costs more than the extra
// warps gain (chip_smoke.py times every T). The TPU
// kernel paired points by halves across a VMEM tile; the sum here is
// another order of complete additions, which gives the same group element,
// and the check is invariant under projective scaling, so the verdicts
// agree lane for lane although the coordinates do not. Left for later:
// PTX carry chains (mad.lo.cc/madc.hi) in the product and the folds, and a
// 32-bit table layout (96 bytes a point instead of 240).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tree_sum.cuh"

namespace {

constexpr int MAX_POINTS = 64;
constexpr int THREADS = 128;
constexpr int L13 = 20;                     // 13-bit limbs per value

// Lane rows of the points entry: the lane's M points, one after another,
// and its r and rpn as 13-bit limbs.
struct PointRows {
  const int* base;
  const int* r13;
  const int* rpn13;
  __device__ __forceinline__ const int* row(int m) const {
    return base + static_cast<size_t>(m) * PT_INTS;
  }
  __device__ __forceinline__ Fe r() const { return load_fe(r13); }
  __device__ __forceinline__ Fe rpn() const { return load_fe(rpn13); }
};

// Lane rows of the windows entry: comb.gather_from_windows' indices, and
// the lane's r and rpn as 32-byte big-endian rows.
struct WindowRows {
  const int* w1;                            // this lane's G-side windows
  const int* w2;                            // this lane's Q-side windows
  const int* g_tab;
  const int* q_tab;
  const uint8_t* r8;
  const uint8_t* rpn8;
  int key, K, nwin_g, bits_g, bits_q;
  __device__ __forceinline__ Fe r() const { return fe_load_be(r8); }
  __device__ __forceinline__ Fe rpn() const { return fe_load_be(rpn8); }
  __device__ __forceinline__ const int* row(int m) const {
    if (m < nwin_g) {
      const size_t r = (static_cast<size_t>(m) << bits_g) +
                       (__ldg(w1 + m) & ((1 << bits_g) - 1));
      return g_tab + r * PT_INTS;
    }
    const int i = m - nwin_g;
    const size_t r = ((static_cast<size_t>(i) * K + key) << bits_q) +
                     (__ldg(w2 + i) & ((1 << bits_q) - 1));
    return q_tab + r * PT_INTS;
  }
};

// One lane on its group of T threads: the sum, then the check by thread 0.
template <class LaneRows>
__device__ __forceinline__ void tree_lane(const LaneRows& rows, int M, int t,
                                          int T, int lane,
                                          uint8_t* __restrict__ out) {
  const Pt R = group_sum(rows, M, t, T);
  if (t == 0) out[lane] = pt_check(R, rows.r(), rows.rpn());
}

__global__ void __launch_bounds__(THREADS, 1)
ptree_points_kernel(const int* __restrict__ pts, const int* __restrict__ r,
                    const int* __restrict__ rpn,
                    const uint8_t* __restrict__ premask,
                    uint8_t* __restrict__ out, int B, int M, int T) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = gid / T, t = gid - lane * T;
  if (lane >= B) return;                    // the whole group leaves
  if (!premask[lane]) {
    if (t == 0) out[lane] = 0;
    return;
  }
  const size_t off = static_cast<size_t>(lane) * L13;
  const PointRows rows{pts + static_cast<size_t>(lane) * M * PT_INTS,
                       r + off, rpn + off};
  tree_lane(rows, M, t, T, lane, out);
}

__global__ void __launch_bounds__(THREADS, 1)
ptree_windows_kernel(const int* __restrict__ w1, const int* __restrict__ w2,
                     const int* __restrict__ key_idx,
                     const int* __restrict__ g_tab,
                     const int* __restrict__ q_tab,
                     const uint8_t* __restrict__ r8,
                     const uint8_t* __restrict__ rpn8,
                     const uint8_t* __restrict__ premask,
                     uint8_t* __restrict__ out, int B, int K, int bits_g,
                     int bits_q, int T) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = gid / T, t = gid - lane * T;
  if (lane >= B) return;
  const int key = key_idx[lane];
  if (!premask[lane] || key < 0 || key >= K) {
    if (t == 0) out[lane] = 0;
    return;
  }
  const int nwin_g = 256 / bits_g, nwin_q = 256 / bits_q;
  const size_t off = static_cast<size_t>(lane) * 32;
  const WindowRows rows{w1 + static_cast<size_t>(lane) * nwin_g,
                        w2 + static_cast<size_t>(lane) * nwin_q,
                        g_tab, q_tab, r8 + off, rpn8 + off, key, K, nwin_g,
                        bits_g, bits_q};
  tree_lane(rows, nwin_g + nwin_q, t, T, lane, out);
}

int blocks_for(int B, int T) {
  return static_cast<int>((static_cast<long long>(B) * T + THREADS - 1) /
                          THREADS);
}

bool t_ok(int T) { return T == 1 || T == 2 || T == 4 || T == 8; }

bool bits_ok(int b) { return b >= 1 && b <= 16 && (256 % b) == 0; }

}  // namespace

// Each launch enqueues the kernel on `stream` and returns
// cudaGetLastError(): 0 when the launch was accepted. Neither allocates nor
// synchronises.
extern "C" int ptree_verify_launch(const void* pts, const void* r,
                                   const void* rpn, const void* premask,
                                   void* out, int B, int M, int T,
                                   void* stream) {
  if (B <= 0) return 0;
  if (M < 1 || M > MAX_POINTS || !t_ok(T))
    return static_cast<int>(cudaErrorInvalidValue);
  ptree_points_kernel<<<blocks_for(B, T), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pts), static_cast<const int*>(r),
      static_cast<const int*>(rpn), static_cast<const uint8_t*>(premask),
      static_cast<uint8_t*>(out), B, M, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptree_windows_launch(const void* w1, const void* w2,
                                    const void* key_idx, const void* g_tab,
                                    const void* q_tab, const void* r8,
                                    const void* rpn8, const void* premask,
                                    void* out, int B, int K, int wbits_g,
                                    int wbits_q, int T, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || !bits_ok(wbits_g) || !bits_ok(wbits_q) || !t_ok(T) ||
      (256 / wbits_g) + (256 / wbits_q) > MAX_POINTS)
    return static_cast<int>(cudaErrorInvalidValue);
  ptree_windows_kernel<<<blocks_for(B, T), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w1), static_cast<const int*>(w2),
      static_cast<const int*>(key_idx), static_cast<const int*>(g_tab),
      static_cast<const int*>(q_tab), static_cast<const uint8_t*>(r8),
      static_cast<const uint8_t*>(rpn8), static_cast<const uint8_t*>(premask),
      static_cast<uint8_t*>(out), B, K, wbits_g, wbits_q, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ptree_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
