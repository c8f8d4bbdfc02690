// Self-tests of the 32-bit cores on the card: per case, the same bodies
// the host builds of the headers run in tests/test_torch_p256_field_host.py
// and tests/test_torch_stage_a_host.py, so that the nvcc-built cores are
// held to Python ints on the same edge operands. Not a port of a TPU kernel
// and not on any verify path.
//
// field_selftest_launch, the P-256 field core (p256_field.cuh; ops/ptree.py
// field_selftest):
//   cases i < n_ops: a13, b13 (n_ops, 20) int32 13-bit limbs -> out_ops
//     (n_ops, 32) uint32: a mod p, a + b, a - b, a * b (canonical words);
//   cases n_ops + j < n_ops + n_add: p13, q13 (n_add, 60) int32 points ->
//     out_add (n_add, 24) uint32: X3, Y3, Z3 of RCB15 Alg. 4.
// dbl_selftest_launch, the ladder's doubling (pt_dbl; ops/verify.py
// dbl_selftest): p13 (n, 60) int32 points -> out (n, 24) uint32: X3, Y3,
// Z3 of RCB15 Alg. 6, canonical words.
// f25_selftest_launch, the field mod 2^255 - 19 (fe25519.cuh;
// ops/ed25519.py f25_selftest): a, b (n, 8) 32-bit little-endian words ->
// out (n, 40) uint32: a mod p, a + b, a - b, a * b, a^2 (canonical
// words).
// ed_selftest_launch, Ed25519's group law (fe25519.cuh; ops/ed25519.py
// ed_selftest): p, q (n, 32) words of extended points (q affine, Z = 1)
// -> out (n, 128) uint32: p + q by the cached addition, 2p by the P2
// doubling, p + q by the Niels mixed addition, p - q (canonical P3
// words).
// modn_selftest_launch, the mod-n core (modn32.cuh; ops/fused_verify.py
// modn_selftest): e (n, 8) 32-bit big-endian words, r8 and w8 (n, 32)
// uint8 big-endian rows -> out (n, 16) uint32: u1 = e*w and u2 = r*w mod n.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "modn32.cuh"
#include "p256_field.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
field_selftest_kernel(const int* __restrict__ a13,
                      const int* __restrict__ b13, int n_ops,
                      const int* __restrict__ p13,
                      const int* __restrict__ q13, int n_add,
                      uint32_t* __restrict__ out_ops,
                      uint32_t* __restrict__ out_add) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_ops) {
    fe_selftest_ops(a13 + 20 * i, b13 + 20 * i, out_ops + 32 * i);
  } else if (i - n_ops < n_add) {
    const int j = i - n_ops;
    fe_selftest_add(p13 + 60 * j, q13 + 60 * j, out_add + 24 * j);
  }
}

__global__ void __launch_bounds__(THREADS)
modn_selftest_kernel(const uint32_t* __restrict__ e,
                     const uint8_t* __restrict__ r8,
                     const uint8_t* __restrict__ w8, int n,
                     uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mn_selftest(e + 8 * i, r8 + 32 * i, w8 + 32 * i, out + 16 * i);
}

__global__ void __launch_bounds__(THREADS)
dbl_selftest_kernel(const int* __restrict__ p13, int n,
                    uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) fe_selftest_dbl(p13 + 60 * i, out + 24 * i);
}

__global__ void __launch_bounds__(THREADS)
f25_selftest_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int n,
                    uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    f25_selftest_ops(a + 8 * i, b + 8 * i, out + F25_SELFTEST_OUT * i);
}

__global__ void __launch_bounds__(THREADS)
ed_selftest_kernel(const uint32_t* __restrict__ p,
                   const uint32_t* __restrict__ q, int n,
                   uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    ed_selftest(p + 32 * i, q + 32 * i, out + ED_SELFTEST_OUT * i);
}

}  // namespace

// Enqueues the kernel on `stream`; returns cudaGetLastError().
extern "C" int field_selftest_launch(const void* a13, const void* b13,
                                     int n_ops, const void* p13,
                                     const void* q13, int n_add,
                                     void* out_ops, void* out_add,
                                     void* stream) {
  const int n = n_ops + n_add;
  if (n <= 0) return 0;
  field_selftest_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a13), static_cast<const int*>(b13), n_ops,
      static_cast<const int*>(p13), static_cast<const int*>(q13), n_add,
      static_cast<uint32_t*>(out_ops), static_cast<uint32_t*>(out_add));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int modn_selftest_launch(const void* e, const void* r8,
                                    const void* w8, int n, void* out,
                                    void* stream) {
  if (n <= 0) return 0;
  modn_selftest_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(e), static_cast<const uint8_t*>(r8),
      static_cast<const uint8_t*>(w8), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbl_selftest_launch(const void* p13, int n, void* out,
                                   void* stream) {
  if (n <= 0) return 0;
  dbl_selftest_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(p13), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int f25_selftest_launch(const void* a, const void* b, int n,
                                   void* out, void* stream) {
  if (n <= 0) return 0;
  f25_selftest_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ed_selftest_launch(const void* p, const void* q, int n,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  ed_selftest_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q), n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* field_selftest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
