// A lane's comb-point sum on T threads, shared by the tree kernel
// (ptree.cu) and the resident kernel (fused_resident.cu).
//
// A lane owns T consecutive threads of a warp (T = 1, 2, 4 or 8, aligned
// to T). Thread t of the group keeps a running sum over the lane's points
// t, t + T, t + 2T, ... (so the group's T threads read T neighbouring
// points together); then log2(T) rounds of __shfl_xor_sync hand each
// thread its partner's partial sum, and one complete addition merges the
// two. That is M - 1 additions per lane in all (M >= T), as with one
// thread, with T times the warps in flight. RCB15's addition is symmetric
// in its operands, so after the last round every thread of the group holds
// the same sum.
//
// A point is read from device memory as 15 int4 loads (3 x 20 int32 13-bit
// limbs, 240 bytes, 16-byte aligned in every table and in the points
// tensor) and converted to 32-bit words on the way in.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "p256_field.cuh"

namespace {

constexpr int PT_INTS = 60;                 // int32s per 13-bit point row

__device__ __forceinline__ Pt load_point(const int* __restrict__ row) {
  const int4* v = reinterpret_cast<const int4*>(row);
  int l[PT_INTS];
#pragma unroll
  for (int k = 0; k < PT_INTS / 4; ++k) {
    const int4 q = __ldg(v + k);
    l[4 * k] = q.x;
    l[4 * k + 1] = q.y;
    l[4 * k + 2] = q.z;
    l[4 * k + 3] = q.w;
  }
  Pt p;
  p.X = fe_from13(l);
  p.Y = fe_from13(l + 20);
  p.Z = fe_from13(l + 40);
  return p;
}

// 20 int32 13-bit limbs (r or rpn: 80 bytes, 16-byte aligned) -> canonical
__device__ __forceinline__ Fe load_fe(const int* __restrict__ src) {
  const int4* v = reinterpret_cast<const int4*>(src);
  int l[20];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int4 q = __ldg(v + k);
    l[4 * k] = q.x;
    l[4 * k + 1] = q.y;
    l[4 * k + 2] = q.z;
    l[4 * k + 3] = q.w;
  }
  return fe_from13(l);
}

// The shuffle mask of the calling thread's group of T threads.
__device__ __forceinline__ unsigned group_mask(int T) {
  const int base = (threadIdx.x & 31) & ~(T - 1);
  return (T == 32 ? 0xFFFFFFFFu : ((1u << T) - 1u)) << base;
}

__device__ __forceinline__ Fe shfl_xor_fe(const Fe& a, int off,
                                          unsigned mask) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = __shfl_xor_sync(mask, a.w[i], off);
  return r;
}

// The sum of a lane's M points on its T threads (t = this thread's index
// in the group). `lane.row(m)` gives point m's row in device memory. Every
// thread of the group must call it (the shuffles name the whole group).
template <class LaneRows>
__device__ __forceinline__ Pt group_sum(const LaneRows& lane, int M, int t,
                                        int T) {
  Pt acc = t < M ? load_point(lane.row(t)) : pt_infinity();
  for (int m = t + T; m < M; m += T) {
    const Pt q = load_point(lane.row(m));
    pt_add(acc, acc, q);
  }
  if (T > 1) {
    const unsigned mask = group_mask(T);
    for (int off = 1; off < T; off <<= 1) {
      Pt o;
      o.X = shfl_xor_fe(acc.X, off, mask);
      o.Y = shfl_xor_fe(acc.Y, off, mask);
      o.Z = shfl_xor_fe(acc.Z, off, mask);
      pt_add(acc, acc, o);
    }
  }
  return acc;
}

}  // namespace
