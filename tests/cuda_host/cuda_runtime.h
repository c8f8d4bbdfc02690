// A stand-in for CUDA's cuda_runtime.h, so that the host C++ compiler can
// build the port's device headers (fabric_tpu_torch/csrc/*.cuh) for the
// tests: the execution-space keywords become plain C++, and the few
// device types and intrinsics the headers use get host definitions.
#pragma once

#include <stdint.h>

#include <algorithm>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __noinline__ __attribute__((noinline))

struct alignas(16) uint4 {
  unsigned int x, y, z, w;
};

inline uint4 make_uint4(unsigned int x, unsigned int y, unsigned int z,
                        unsigned int w) {
  return uint4{x, y, z, w};
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// the bytes of (y:x) picked by the four selector nibbles of s
inline unsigned int __byte_perm(unsigned int x, unsigned int y,
                                unsigned int s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  unsigned int r = 0;
  for (int k = 0; k < 4; ++k)
    r |= static_cast<unsigned int>((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFF)
         << (8 * k);
  return r;
}

// the low 32 bits of (hi:lo) >> (n & 31)
inline unsigned int __funnelshift_r(unsigned int lo, unsigned int hi,
                                    unsigned int n) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<unsigned int>(v >> (n & 31));
}

// one host thread runs a whole group's rounds (csrc/pairing_coop.cuh), so
// a warp's barrier has nothing to wait for, and no clock is read
inline void __syncwarp(unsigned int = 0xFFFFFFFFu) {}

inline long long clock64() { return 0; }

// one host thread is a whole warp of one lane: a vote or a reduction
// over the warp is the lane's own value
inline int __any_sync(unsigned int, int pred) { return pred != 0; }

inline unsigned int __ballot_sync(unsigned int, int pred) {
  return pred != 0 ? 1u : 0u;
}

inline int __reduce_max_sync(unsigned int, int v) { return v; }

// one host thread runs the groups one after another: a fence has nothing
// to order, an atomic nothing to race, and a load has no L1 to bypass
inline void __threadfence() {}

inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}

template <class T>
inline T __ldcg(const T* p) {
  return *p;
}

// leading zero bits of a 32-bit word (32 for zero)
inline int __clz(unsigned int x) { return x ? __builtin_clz(x) : 32; }

using std::max;
using std::min;
