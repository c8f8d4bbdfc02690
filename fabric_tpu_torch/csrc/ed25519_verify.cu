// Batched Ed25519 verification on Hopper: per lane [S]B + [k](-A) == R,
// the policy gates and the challenge k = SHA-512(R || A || M) mod L
// already applied on the host (bccsp/ed25519_host.py prep_verify). Not a
// port of a Pallas kernel: the JAX package runs this as one XLA program,
// fabric_tpu/ops/ed25519.py verify_core (comb_mul_base over the fixed-base
// B table, ladder_mul, the final add and check). In the port its plain
// torch version would be ~100,000 small launches a batch, so the card
// runs it as this one kernel.
//
//   ed25519_verify_launch: s8, k8, anx8, ay8, rx8, ry8 (B, 32) uint8
//     big-endian rows (ops/ed25519.py stage_rows), premask (B,) bool, tab
//     (8192, 3, 8) 32-bit words (ops/ed25519.py kernel_table: the B table
//     in Niels form) -> out (B,) bool. k8 must be below L, as prep_verify
//     reduces it: the signed digits' bias (ed25519.cuh ed_digit_bias)
//     carries out of 256 bits above about 2^254.9, and such a k would
//     give another verdict than verify_core, which walks all 256 bits.
//
// What bounds it on this card: 32-bit integer multiply-adds. A lane does
// 2,556 field products (ed25519.cuh: [k](-A) on signed radix-16 digits
// with its cached table of 0..8 * (-A), [S]B by 32 mixed additions of
// Niels entries, the check), 1,008 of them squarings: a product is 64
// partial products (a low and a high IMAD each) and the fold by 38 (8
// more), a squaring 36 and the same fold; against ~230 bytes of operands
// and 3 KiB of table rows (chip_smoke.py ed25519_bound, which also counts
// the additions of zero digits and windows the data lets a lane skip).
//
// The design: one thread a lane, the field on 32-bit limbs in registers
// with PTX carry chains by columns and a squaring of its own
// (fe25519.cuh: weak reduction by 38, canonical form only for the
// compare), the lane body of ed25519.cuh on ref10's split representations
// (a doubling another doubling follows skips T), the cached table of
// -A's multiples in local memory (indexed by the digits: the 1,280-byte
// stack). The fixed-base table (768 KiB) is read through L1 and L2 with
// 16-byte loads. A premask-off lane returns at once. A lane over 2 or 4
// threads of a warp (each product's rows split, the partials summed by
// shuffles, every other step done by each thread) was measured and
// dropped: 1.9x and 4.7x slower at 32,768 lanes, 1-8% slower at 2,048
// (NVIDIA H100 80GB HBM3 at 700 W, fabric_tpu_torch/ed_timing.py; PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519.cuh"

namespace {

constexpr int THREADS = 64;

// one block of THREADS an SM at least: ptxas may give a thread every
// register it asks for (without the minimum it settled at 128 and spilled)
__global__ void __launch_bounds__(THREADS, 1)
ed25519_verify_kernel(const uint8_t* __restrict__ s8,
                      const uint8_t* __restrict__ k8,
                      const uint8_t* __restrict__ anx8,
                      const uint8_t* __restrict__ ay8,
                      const uint8_t* __restrict__ rx8,
                      const uint8_t* __restrict__ ry8,
                      const uint8_t* __restrict__ premask,
                      const uint32_t* __restrict__ tab,
                      uint8_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  ed25519_lane(static_cast<size_t>(lane), s8, k8, anx8, ay8, rx8, ry8,
               premask, tab, out);
}

}  // namespace

// Enqueues the kernel on `stream` and returns cudaGetLastError(): 0 when
// the launch was accepted. It neither allocates nor synchronises.
extern "C" int ed25519_verify_launch(const void* s8, const void* k8,
                                     const void* anx8, const void* ay8,
                                     const void* rx8, const void* ry8,
                                     const void* premask, const void* tab,
                                     void* out, int B, void* stream) {
  if (B <= 0) return 0;
  ed25519_verify_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(s8), static_cast<const uint8_t*>(k8),
      static_cast<const uint8_t*>(anx8), static_cast<const uint8_t*>(ay8),
      static_cast<const uint8_t*>(rx8), static_cast<const uint8_t*>(ry8),
      static_cast<const uint8_t*>(premask),
      static_cast<const uint32_t*>(tab), static_cast<uint8_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ed25519_verify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
