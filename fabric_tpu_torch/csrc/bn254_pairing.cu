// Batched BN254 optimal-ate pairings on Hopper, for the idemix credential
// checks (CUDAProvider.pairing_check_batch, bls_verify_batch). Not a port
// of a Pallas kernel: the JAX package runs these as XLA programs,
// fabric_tpu/ops/bn254.py miller_loop_batch (:137) and final_exp_batch
// (:251, the register-machine program of :190), which
// pairing_product_is_one (:260) chains. In the port their plain torch
// versions are millions of small launches a call, so the card runs each
// as one kernel:
//
//   bn254_miller_launch: pts (14, B, 20) int32 limbs (xP, yP, Q, Q1, nQ2;
//     ops/bn254.py miller_loop_batch), consts (148 words, BnConsts), out
//     (12, B, 20), B, the loop's bits after its leading one as two 32-bit
//     halves (lo, hi) and their count (1..64).
//   bn254_final_exp_launch: f (12, T*B, 20) Miller values, consts, the
//     program (rows, 4) int32 and its row count, gt (12, B, 20), ok (B,)
//     bool, T, B.
//
// Beside them, on no path, the self-tests of the core and the tower
// (ops/bn254.py fp_selftest, tower_selftest; chip_smoke.py field_vs_ints):
//   bn_fp_selftest_launch: a, b (n, 8) 32-bit little-endian words of plain
//     values below 2p, consts -> out (n, 40) uint32: a mod p, a + b,
//     a - b, a * b, a^-1 (canonical words).
//   bn_tower_selftest_launch: cases (n, 288) words of 36 plain values,
//     consts -> out (n, 720) uint32: the 90 canonical values of
//     bn_tower_selftest (bn254_tower.cuh).
//
// What bounds them on this card: 32-bit integer multiply-adds. A field
// product is 8 x 8 partial products (a low and a high IMAD each) and a
// Montgomery reduction of the same size: 256 IMAD. The full Miller loop is
// 64 steps of f^2 (81 products), a doubling with its tangent line (52) and
// f * line (81), 36 of them an addition with its chord line (58) and
// f * line (81), then two more additions: 18,978 products a lane. The
// final exponentiation is 1/f (510 products: four Fp6 products, the
// adjoint, 362 for Fermat's inverse in Fp), the program's 286 Fp12
// products (81 each) and 10 Frobenius maps (15): 23,826 a lane, 81 more
// for each further term. Operands and results are ~2 KB a lane, so bytes
// do not bound them (chip_smoke.py miller_products, final_exp_products,
// bn_bound).
//
// The design, a simple first kernel: one thread per lane, the field on
// 8 x 32-bit words (bn254_field.cuh: CIOS, lazy reduction below 2p), the
// tower's Fp6/Fp12 products, Frobenius, inversions and twist steps as
// calls over operands in local memory (bn254_tower.cuh), the constants in
// shared memory. The Miller loop branches on its bits (the same for every
// lane), and the final exponentiation interprets the program's rows (the
// same for every lane): no divergence. Later speed work (ROADMAP queue 2):
// sparse line products, PTX carry chains, Fp12 in registers, several
// threads a lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_pairing.cuh"

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
bn254_miller_kernel(const int* __restrict__ pts,
                    const uint32_t* __restrict__ consts, int* __restrict__ out,
                    int B, uint32_t bits_lo, uint32_t bits_hi, int nbits) {
  __shared__ BnConsts k;
  bn_consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  bn_miller_lane(pts, B, lane, bits_lo, bits_hi, nbits, k, out);
}

__global__ void __launch_bounds__(THREADS)
bn254_final_exp_kernel(const int* __restrict__ f,
                       const uint32_t* __restrict__ consts,
                       const int* __restrict__ prog, int nrows,
                       int* __restrict__ gt, uint8_t* __restrict__ ok,
                       int nterms, int B) {
  __shared__ BnConsts k;
  bn_consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  bn_final_exp_lane(f, nterms, B, lane, prog, nrows, k, gt, ok);
}

__global__ void __launch_bounds__(THREADS)
bn_fp_selftest_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b,
                      const uint32_t* __restrict__ consts, int n,
                      uint32_t* __restrict__ out) {
  __shared__ BnConsts k;
  bn_consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bn_fp_selftest(a + 8 * i, b + 8 * i, k.r2, out + 40 * i);
}

__global__ void __launch_bounds__(THREADS)
bn_tower_selftest_kernel(const uint32_t* __restrict__ cases,
                         const uint32_t* __restrict__ consts, int n,
                         uint32_t* __restrict__ out) {
  __shared__ BnConsts k;
  bn_consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    bn_tower_selftest(cases + 8 * BN_TOWER_IN * i, k,
                      out + 8 * BN_TOWER_OUT * i);
}

}  // namespace

// Each enqueues its kernel on `stream` and returns cudaGetLastError(): 0
// when the launch was accepted. Neither allocates nor synchronises.
extern "C" int bn254_miller_launch(const void* pts, const void* consts,
                                   void* out, int B, int bits_lo,
                                   int bits_hi, int nbits, void* stream) {
  if (B <= 0) return 0;
  bn254_miller_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pts), static_cast<const uint32_t*>(consts),
      static_cast<int*>(out), B, static_cast<uint32_t>(bits_lo),
      static_cast<uint32_t>(bits_hi), nbits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn254_final_exp_launch(const void* f, const void* consts,
                                      const void* prog, int nrows, void* gt,
                                      void* ok, int nterms, int B,
                                      void* stream) {
  if (B <= 0) return 0;
  bn254_final_exp_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(f), static_cast<const uint32_t*>(consts),
      static_cast<const int*>(prog), nrows, static_cast<int*>(gt),
      static_cast<uint8_t*>(ok), nterms, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_fp_selftest_launch(const void* a, const void* b,
                                     const void* consts, int n, void* out,
                                     void* stream) {
  if (n <= 0) return 0;
  bn_fp_selftest_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(consts), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_tower_selftest_launch(const void* cases,
                                        const void* consts, int n, void* out,
                                        void* stream) {
  if (n <= 0) return 0;
  bn_tower_selftest_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cases),
      static_cast<const uint32_t*>(consts), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bn254_pairing_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
