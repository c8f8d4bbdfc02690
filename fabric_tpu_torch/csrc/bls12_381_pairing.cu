// BLS12-381 aggregate verification on Hopper, for the orderer's span of
// block signatures (CUDAProvider.verify_aggregate). Not a port of a Pallas
// kernel: the JAX package runs these as XLA programs,
// fabric_tpu/ops/bls12_381_kernel.py miller_loop_batch (:87),
// _product_reduce (:172) and final_exp_batch (:158) with gt_is_one, which
// pairs_product_is_one (:189) chains. In the port their plain torch
// versions are millions of small launches a call, so the card runs each
// as a kernel:
//
//   bls_miller_launch: pts (6, B, 30) int32 limbs (xP, yP, qx0, qx1, qy0,
//     qy1; ops/bls12_381_kernel.py stage_pairs), mask (B,) bool, consts
//     (218 words, BlsConsts), out (12, B, 30), B, the loop's bits after
//     its leading one as two 32-bit halves (lo, hi) and their count
//     (1..64).
//   bls_reduce_launch: f (12, B, 30) in place, consts, nodes (B - 1
//     Fp12 values of 144 words: the tree's inner nodes), cnt (B ints,
//     zero; the launch leaves them zero), B (a power of two, at least 2):
//     the halving product of the B lanes into lane 0, canonical, in one
//     launch.
//   bls_final_exp_launch: f (12, B, 30), consts, the program (rows, 4)
//     int32, its row count and the row from which its squarings are
//     cyclotomic, gt (12, B, 30), ok (B,) bool, B. The provider runs it
//     on one lane: the product of every pair.
//
// Beside them, on no path, the self-tests of the core, the tower and the
// cooperative layer (ops/bls12_381_kernel.py fp_selftest, tower_selftest,
// coop_selftest; chip_smoke.py field_vs_ints):
//   bls_fp_selftest_launch: a, b (n, 12) 32-bit little-endian words of
//     plain values below 2p, consts -> out (n, 72) uint32: a mod p,
//     a + b, a - b, a * b, a^-1 and a through the 13-bit layout
//     (canonical words).
//   bls_tower_selftest_launch: cases (n, 432) words of 36 plain values,
//     consts -> out (n, 1080) uint32: the 90 canonical values of
//     tower_selftest (bls12_381_tower.cuh).
//   bls_coop_selftest_launch: cases (n, 504) words of 42 plain values,
//     consts -> out (n, 1326) uint32: coop_selftest_group's 110 canonical
//     values and 6 clock counts (bls12_381_pairing.cuh), a warp a case.
//
// What bounds them on this card: 32-bit integer multiply-adds. A field
// product is 12 x 12 partial products (a low and a high IMAD each) and a
// Montgomery reduction of the same size: 576 IMAD. A Miller lane over
// |x| = 0xd201000000010000 is 63 doubling steps (f^2 by the complex
// method: 12 Fp2 products; the tangent step: 16; f^2 times the sparse
// line: 13) and 5 addition steps (19 and 13): 8,247 Fp products as
// executed (ops/bls12_381_kernel.py miller_products). The reduce is B - 1
// Fp12 products (54 Fp products each), log2(B) of them in series. The
// final exponentiation is 1/f
// (the adjoint in Fp6 products, a binary Euclid inverse in Fp), then the
// program's rows: a cyclotomic squaring 27 Fp products, a product 54, a
// Frobenius 18. Operands and results are ~2 KB a lane, so bytes do not
// bound them (chip_smoke.py bls_vs_plain: bn_reading at BLS_MUL_IMAD).
//
// The design. Every entry runs on the field of 12 x 32-bit words
// (bls12_381_field.cuh: CIOS, lazy reduction below 2p) and a lane over a
// warp, one lane a block, on pairing_coop.cuh: the lane's Fp12 values in
// shared memory,
// each operation's Fp2 products as rounds of one Fp product a thread
// (three a product), its additions in short rounds of one formula each,
// rounds separated by __syncwarp(); the Miller loop branches on its bits
// and the final exponentiation interprets the program's rows, both the
// same for every lane. Its chain: 337 Fp products in series a Miller
// lane, 404 a final exponentiation (the schedules' counts,
// miller_products and final_exp_products), against 14,177 and 29,181
// for one thread a lane. The reduce is one launch of B / 2 warps, a warp
// a node of the product tree (pairing_coop.cuh reduce_group): a node's
// Fp12 product is cooperative (54 Fp products in rounds of up to 32: 2
// on the chain, against 54 in series on one thread), and the warp that
// reaches a node second carries on to its parent, so a call's chain is
// log2(B) cooperative products in one launch (ops/bls12_381_kernel.py
// reduce_products). The constants sit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381_pairing.cuh"

namespace {

using namespace bls381;

constexpr int THREADS = 32;   // the serial self-tests: one thread a case
constexpr int GROUP = 32;     // the cooperative entries: a warp a lane

// a lane a block of one warp
__global__ void __launch_bounds__(GROUP)
bls_miller_kernel(const int* __restrict__ pts,
                  const uint8_t* __restrict__ mask,
                  const uint32_t* __restrict__ consts, int* __restrict__ out,
                  int B, uint32_t bits_lo, uint32_t bits_hi, int nbits) {
  __shared__ BlsConsts k;
  __shared__ coop::MillerState<BlsTower> st;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const coop::Group g{static_cast<int>(threadIdx.x), GROUP, false};
  coop::miller_group<BlsTower>(g, st, pts, mask, B, blockIdx.x, bits_lo,
                               bits_hi, nbits, k, out);
}

// a node of the product tree's first level a block of one warp
__global__ void __launch_bounds__(GROUP)
bls_reduce_kernel(int* __restrict__ f, const uint32_t* __restrict__ consts,
                  uint32_t* __restrict__ nodes, int* __restrict__ cnt,
                  int B) {
  __shared__ BlsConsts k;
  __shared__ ReduceState st;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const coop::Group g{static_cast<int>(threadIdx.x), GROUP, false};
  reduce_group(g, st, f, nodes, cnt, B, blockIdx.x, k);
}

__global__ void __launch_bounds__(GROUP)
bls_final_exp_kernel(const int* __restrict__ f,
                     const uint32_t* __restrict__ consts,
                     const int* __restrict__ prog, int nrows, int cyc_from,
                     int* __restrict__ gt, uint8_t* __restrict__ ok, int B) {
  __shared__ BlsConsts k;
  __shared__ coop::FinalExpState<BlsTower> st;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const coop::Group g{static_cast<int>(threadIdx.x), GROUP, false};
  coop::final_exp_group<BlsTower>(g, st, f, B, blockIdx.x, prog, nrows,
                                  cyc_from, k, gt, ok);
}

__global__ void __launch_bounds__(THREADS)
bls_fp_selftest_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       const uint32_t* __restrict__ consts, int n,
                       uint32_t* __restrict__ out) {
  __shared__ BlsConsts k;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    fp_selftest(a + NW * i, b + NW * i, k.r2, k.c_in, k.c_out,
                out + 6 * NW * i);
}

__global__ void __launch_bounds__(THREADS)
bls_tower_selftest_kernel(const uint32_t* __restrict__ cases,
                          const uint32_t* __restrict__ consts, int n,
                          uint32_t* __restrict__ out) {
  __shared__ BlsConsts k;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    tower_selftest(cases + NW * TOWER_IN * i, k, out + NW * TOWER_OUT * i);
}

__global__ void __launch_bounds__(GROUP)
bls_coop_selftest_kernel(const uint32_t* __restrict__ cases,
                         const uint32_t* __restrict__ consts,
                         uint32_t* __restrict__ out) {
  __shared__ BlsConsts k;
  __shared__ CoopState st;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const coop::Group g{static_cast<int>(threadIdx.x), GROUP, false};
  coop_selftest_group(g, st, cases + NW * COOP_IN * blockIdx.x, k,
                      out + (NW * COOP_OUT + COOP_CYCLES) * blockIdx.x);
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// Each enqueues its kernel on `stream` and returns cudaGetLastError(): 0
// when the launch was accepted. None allocates or synchronises.
extern "C" int bls_miller_launch(const void* pts, const void* mask,
                                 const void* consts, void* out, int B,
                                 int bits_lo, int bits_hi, int nbits,
                                 void* stream) {
  if (B <= 0) return 0;
  bls_miller_kernel<<<B, GROUP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pts), static_cast<const uint8_t*>(mask),
      static_cast<const uint32_t*>(consts), static_cast<int*>(out), B,
      static_cast<uint32_t>(bits_lo), static_cast<uint32_t>(bits_hi), nbits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bls_reduce_launch(void* f, const void* consts, void* nodes,
                                 void* cnt, int B, void* stream) {
  if (B < 2 || (B & (B - 1))) return static_cast<int>(cudaErrorInvalidValue);
  bls_reduce_kernel<<<B / 2, GROUP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(f), static_cast<const uint32_t*>(consts),
      static_cast<uint32_t*>(nodes), static_cast<int*>(cnt), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bls_final_exp_launch(const void* f, const void* consts,
                                    const void* prog, int nrows, int cyc_from,
                                    void* gt, void* ok, int B, void* stream) {
  if (B <= 0) return 0;
  bls_final_exp_kernel<<<B, GROUP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(f), static_cast<const uint32_t*>(consts),
      static_cast<const int*>(prog), nrows, cyc_from, static_cast<int*>(gt),
      static_cast<uint8_t*>(ok), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bls_fp_selftest_launch(const void* a, const void* b,
                                      const void* consts, int n, void* out,
                                      void* stream) {
  if (n <= 0) return 0;
  bls_fp_selftest_kernel<<<blocks(n), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(consts), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bls_tower_selftest_launch(const void* cases,
                                         const void* consts, int n, void* out,
                                         void* stream) {
  if (n <= 0) return 0;
  bls_tower_selftest_kernel<<<blocks(n), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cases),
      static_cast<const uint32_t*>(consts), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bls_coop_selftest_launch(const void* cases,
                                        const void* consts, int n, void* out,
                                        void* stream) {
  if (n <= 0) return 0;
  bls_coop_selftest_kernel<<<n, GROUP, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cases),
      static_cast<const uint32_t*>(consts), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bls12_381_pairing_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
