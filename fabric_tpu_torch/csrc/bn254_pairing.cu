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
//     halves (lo, hi) and their count (1..64), the layout (`group`).
//   bn254_final_exp_launch: f (12, T*B, 20) Miller values, consts, the
//     program (rows, 4) int32, its row count and the row from which its
//     squarings are cyclotomic, gt (12, B, 20), ok (B,) bool, T, B, the
//     layout.
//
// The layout is the threads a lane: `group` = 8 (four lanes a warp) or 1
// (one thread a lane, on the serial formulas); any other value is
// cudaErrorInvalidValue. ops/bn254.py picks it by B.
//
// Beside them, on no path, the self-tests of the core, the tower and the
// cooperative layer (ops/bn254.py fp_selftest, tower_selftest,
// coop_selftest; chip_smoke.py field_vs_ints):
//   bn_fp_selftest_launch: a, b (n, 8) 32-bit little-endian words of plain
//     values below 2p, consts -> out (n, 48) uint32: a mod p, a + b,
//     a - b, a * b, a^-1 by Fermat and by the binary Euclid algorithm
//     (canonical words).
//   bn_tower_selftest_launch: cases (n, 288) words of 36 plain values,
//     consts -> out (n, 720) uint32: the 90 canonical values of
//     bn_tower_selftest (bn254_tower.cuh).
//   bn_coop_selftest_launch: cases (n, 336) words of 42 plain values,
//     consts -> out (n, 886) uint32: the 110 canonical values and 6 clock
//     counts of pairing_coop.cuh's selftest_group, a warp a case.
//
// What bounds them on this card: 32-bit integer multiply-adds. A field
// product is 8 x 8 partial products (a low and a high IMAD each) and a
// Montgomery reduction of the same size: 256 IMAD. A Miller lane is 64
// doubling steps (f^2 by the complex method: 12 Fp2 products; the tangent
// step regrouped: 16; f^2 times the sparse D-type line: 13) and 38
// addition steps (36 set bits and the two correction points: the chord
// step 19 and the line product 13): 11,546 Fp products with the domain
// conversions on the cooperative layout, 11,150 on the serial one (an Fp2
// square and a scaling by an Fp value 2 products there). The final
// exponentiation at T = 2: the terms' product (Karatsuba, 54), 1/f (the
// adjoint in Fp6 products, a binary Euclid inverse in Fp), the program's
// 96 products (54 each), 190 cyclotomic squarings (27; 18 serial) and 10
// Frobenius maps (18; 15 serial): 10,698 and 8,991 a lane
// (ops/bn254.py miller_products, final_exp_products). Operands and results
// are ~2 KB a lane, so bytes do not bound them (chip_smoke.py
// pairing_vs_plain, bn_reading).
//
// The design. Each entry has two layouts, both on bn254_tower.cuh's
// formulas. The cooperative one runs a lane over GROUP = 8 threads on
// pairing_coop.cuh (shared with BLS12-381): the lane's Fp12 values in
// shared memory (6.2 KB a Miller lane, 7.3 KB a final-exp lane, so ~36
// lanes an SM), each operation's Fp2 products as rounds of one Fp product
// a thread (three a product), its additions in short rounds of one
// formula each, rounds separated by __syncwarp(); a block is one warp of
// four lanes, all of them on the same bits and program rows in step, a
// pad lane past B running the rounds and storing nothing: a short chain a
// lane, for small batches. The serial one is one thread a lane, its values
// in local memory (hundreds of lanes an SM), the twist steps' temporaries
// in a local array: the throughput of large batches. A warp a lane was
// measured too and dropped (PERF.md). The constants sit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_pairing.cuh"

namespace {

using namespace bn254;

constexpr int THREADS = 64;   // the serial entries: one thread a lane
constexpr int WARP = 32;      // the cooperative entries: a warp a block,
constexpr int GROUP = 8;      // GROUP threads a lane

__global__ void __launch_bounds__(THREADS)
bn254_miller_kernel(const int* __restrict__ pts,
                    const uint32_t* __restrict__ consts, int* __restrict__ out,
                    int B, uint32_t bits_lo, uint32_t bits_hi, int nbits) {
  __shared__ BnConsts k;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  bn_miller_lane(pts, B, lane, bits_lo, bits_hi, nbits, k, out);
}

__global__ void __launch_bounds__(THREADS)
bn254_final_exp_kernel(const int* __restrict__ f,
                       const uint32_t* __restrict__ consts,
                       const int* __restrict__ prog, int nrows, int cyc_from,
                       int* __restrict__ gt, uint8_t* __restrict__ ok,
                       int nterms, int B) {
  __shared__ BnConsts k;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  bn_final_exp_lane(f, nterms, B, lane, prog, nrows, cyc_from, k, gt, ok);
}

// WARP / N lanes a block of one warp, N threads a lane
template <int N>
__global__ void __launch_bounds__(WARP)
bn254_miller_coop_kernel(const int* __restrict__ pts,
                         const uint32_t* __restrict__ consts,
                         int* __restrict__ out, int B, uint32_t bits_lo,
                         uint32_t bits_hi, int nbits) {
  __shared__ BnConsts k;
  __shared__ coop::MillerState<BnTower> st[WARP / N];
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int grp = threadIdx.x / N;
  const coop::Group g{static_cast<int>(threadIdx.x % N), N, false};
  coop::miller_group<BnTower>(g, st[grp], pts, nullptr, B,
                              blockIdx.x * (WARP / N) + grp, bits_lo, bits_hi,
                              nbits, k, out);
}

template <int N>
__global__ void __launch_bounds__(WARP)
bn254_final_exp_coop_kernel(const int* __restrict__ f,
                            const uint32_t* __restrict__ consts,
                            const int* __restrict__ prog, int nrows,
                            int cyc_from, int* __restrict__ gt,
                            uint8_t* __restrict__ ok, int nterms, int B) {
  __shared__ BnConsts k;
  __shared__ coop::FinalExpState<BnTower> st[WARP / N];
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int grp = threadIdx.x / N;
  const coop::Group g{static_cast<int>(threadIdx.x % N), N, false};
  coop::final_exp_group<BnTower>(g, st[grp], f, B,
                                 blockIdx.x * (WARP / N) + grp, prog, nrows,
                                 cyc_from, k, gt, ok, nterms);
}

__global__ void __launch_bounds__(THREADS)
bn_fp_selftest_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b,
                      const uint32_t* __restrict__ consts, int n,
                      uint32_t* __restrict__ out) {
  __shared__ BnConsts k;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bn_fp_selftest(a + 8 * i, b + 8 * i, k.r2, out + 48 * i);
}

__global__ void __launch_bounds__(THREADS)
bn_tower_selftest_kernel(const uint32_t* __restrict__ cases,
                         const uint32_t* __restrict__ consts, int n,
                         uint32_t* __restrict__ out) {
  __shared__ BnConsts k;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    bn_tower_selftest(cases + 8 * BN_TOWER_IN * i, k,
                      out + 8 * BN_TOWER_OUT * i);
}

__global__ void __launch_bounds__(WARP)
bn_coop_selftest_kernel(const uint32_t* __restrict__ cases,
                        const uint32_t* __restrict__ consts,
                        uint32_t* __restrict__ out) {
  __shared__ BnConsts k;
  __shared__ CoopState st;
  consts_load(k, consts, threadIdx.x, blockDim.x);
  __syncthreads();
  const coop::Group g{static_cast<int>(threadIdx.x), WARP, false};
  coop_selftest_group(g, st, cases + NW * COOP_IN * blockIdx.x, k,
                      out + (NW * COOP_OUT + COOP_CYCLES) * blockIdx.x);
}

int blocks(int n, int per) { return (n + per - 1) / per; }

}  // namespace

// Each enqueues its kernel on `stream` and returns cudaGetLastError(): 0
// when the launch was accepted (cudaErrorInvalidValue for a layout it does
// not have). None allocates or synchronises.
extern "C" int bn254_miller_launch(const void* pts, const void* consts,
                                   void* out, int B, int bits_lo,
                                   int bits_hi, int nbits, int group,
                                   void* stream) {
  if (B <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const int*>(pts);
  const auto c = static_cast<const uint32_t*>(consts);
  const auto o = static_cast<int*>(out);
  const auto lo = static_cast<uint32_t>(bits_lo);
  const auto hi = static_cast<uint32_t>(bits_hi);
  if (group == 1)
    bn254_miller_kernel<<<blocks(B, THREADS), THREADS, 0, s>>>(
        p, c, o, B, lo, hi, nbits);
  else if (group == GROUP)
    bn254_miller_coop_kernel<GROUP><<<blocks(B, WARP / GROUP), WARP, 0, s>>>(
        p, c, o, B, lo, hi, nbits);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn254_final_exp_launch(const void* f, const void* consts,
                                      const void* prog, int nrows,
                                      int cyc_from, void* gt, void* ok,
                                      int nterms, int B, int group,
                                      void* stream) {
  if (B <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto fi = static_cast<const int*>(f);
  const auto c = static_cast<const uint32_t*>(consts);
  const auto pr = static_cast<const int*>(prog);
  const auto g = static_cast<int*>(gt);
  const auto o = static_cast<uint8_t*>(ok);
  if (group == 1)
    bn254_final_exp_kernel<<<blocks(B, THREADS), THREADS, 0, s>>>(
        fi, c, pr, nrows, cyc_from, g, o, nterms, B);
  else if (group == GROUP)
    bn254_final_exp_coop_kernel<GROUP>
        <<<blocks(B, WARP / GROUP), WARP, 0, s>>>(fi, c, pr, nrows, cyc_from,
                                                  g, o, nterms, B);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_fp_selftest_launch(const void* a, const void* b,
                                     const void* consts, int n, void* out,
                                     void* stream) {
  if (n <= 0) return 0;
  bn_fp_selftest_kernel<<<blocks(n, THREADS), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(consts), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_tower_selftest_launch(const void* cases,
                                        const void* consts, int n, void* out,
                                        void* stream) {
  if (n <= 0) return 0;
  bn_tower_selftest_kernel<<<blocks(n, THREADS), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cases),
      static_cast<const uint32_t*>(consts), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_coop_selftest_launch(const void* cases, const void* consts,
                                       int n, void* out, void* stream) {
  if (n <= 0) return 0;
  bn_coop_selftest_kernel<<<n, WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cases),
      static_cast<const uint32_t*>(consts), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bn254_pairing_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
