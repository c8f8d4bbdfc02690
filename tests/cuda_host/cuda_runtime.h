// A stand-in for CUDA's cuda_runtime.h, so that the host C++ compiler can
// build the port's device headers (fabric_tpu_torch/csrc/*.cuh) for the
// tests: the execution-space keywords become plain C++.
#pragma once

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __noinline__ __attribute__((noinline))
