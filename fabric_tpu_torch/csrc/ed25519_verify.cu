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
//     (8192, 4, 8) 32-bit words (ops/ed25519.py kernel_table) -> out (B,)
//     bool.
//
// What bounds it on this card: 32-bit integer multiply-adds. A lane does
// [S]B's 31 additions (9 products each), [k](-A)'s table (T, a doubling
// and an addition) and 128 steps of two doublings (8 products) and one
// addition, the final addition and the check: 3,508 products of 64
// partial-product IMAD pairs and a fold by 38 (8 more pairs), against
// ~230 bytes of operands and 4 KiB of table rows (chip_smoke.py
// ed25519_bound).
//
// The design, a simple first kernel: one thread per lane, the field on
// 32-bit limbs in registers (fe25519.cuh: weak reduction by 38, canonical
// form only for the compare), the lane body of ed25519.cuh. The fixed-base
// table (1 MiB) is read through L1 and L2 with 16-byte loads; the 4-entry
// ladder table is indexed by the data and sits in local memory. A
// premask-off lane returns at once. Later speed work (ROADMAP queue 2):
// affine or Niels-form table entries, PTX carry chains, several threads a
// lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519.cuh"

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
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
