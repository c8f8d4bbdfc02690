// The generic P-256 verify on Hopper: a batch whose keys have no comb
// tables (more than MaxKeys distinct keys) is verified lane by lane with a
// 2-bit Shamir ladder over each lane's own key. Not a port of a Pallas
// kernel: the JAX package runs this as one XLA program,
// fabric_tpu/bccsp/tpu.py _pipeline (fabric_tpu/ops/verify.py
// verify_pipeline: sha256_blocks, the digest-lane select, then
// fabric_tpu/ops/p256.py verify_core and double_scalar_mul). In the port
// the plain torch version of that program would be ~150,000 small
// launches a batch, so the card runs it as this kernel, one entry:
//
//   ladder_digest_launch (digest lanes: verify_prepared, batches hashed on
//     the host, and message lanes once the digest-only SHA-256 entry of
//     csrc/sha_windows.cu has hashed them, ops/verify.py ladder_verify):
//     per lane u1 = e*w and u2 = r*w mod n from its digest words, R =
//     u1*G + u2*Q, the check.
//
// Inputs: digests (B, 8) 32-bit words, q8 (B, 64) uint8 (the key's x then
// y, big-endian), r8, rpn8, w8 (B, 32) uint8 big-endian rows, premask (B,)
// bool. Output: (B,) bool verdicts.
//
// What bounds it on this card: 32-bit integer multiply-adds. A lane does
// 257 doublings (13 field products each: 256 ladder steps and one table
// entry) and 138 complete additions (14 each: 128 ladder steps and 10
// table entries): 5,275 products of 128 IMAD with the check's two,
// ~680,000 IMAD a lane against ~230 bytes moved (chip_smoke.py
// ladder_bound).
//
// The design: one thread per lane, the field arithmetic of p256_field.cuh
// (32-bit limbs in registers, PTX carry chains, Solinas reduction, RCB15
// Alg. 4 and 6), the mod-n products of modn32.cuh, the ladder from
// ladder.cuh. The G column of the table (infinity, G, 2G, 3G) sits once
// in shared memory for the block; the 12 entries with the lane's key are
// indexed by the data and sit in local memory (1,152 bytes a lane, through
// L1); a premask-off lane (padding, a host-rejected signature) returns at
// once. One thread a lane: at the client block's 30,720 lanes the card
// holds every lane at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ladder.cuh"

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
ladder_digest_kernel(const uint32_t* __restrict__ digests,
                     const uint8_t* __restrict__ q8,
                     const uint8_t* __restrict__ r8,
                     const uint8_t* __restrict__ rpn8,
                     const uint8_t* __restrict__ w8,
                     const uint8_t* __restrict__ premask,
                     uint8_t* __restrict__ out, int B) {
  __shared__ Pt gtab[4];
  if (threadIdx.x < 4) gtab[threadIdx.x] = ladder_g_entry(threadIdx.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  ladder_digest_lane(static_cast<size_t>(lane), gtab, digests, q8, r8, rpn8,
                     w8, premask, out);
}

}  // namespace

// Enqueues the kernel on `stream` and returns cudaGetLastError(): 0 when
// the launch was accepted. It neither allocates nor synchronises.
extern "C" int ladder_digest_launch(const void* digests, const void* q8,
                                    const void* r8, const void* rpn8,
                                    const void* w8, const void* premask,
                                    void* out, int B, void* stream) {
  if (B <= 0) return 0;
  ladder_digest_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(digests), static_cast<const uint8_t*>(q8),
      static_cast<const uint8_t*>(r8), static_cast<const uint8_t*>(rpn8),
      static_cast<const uint8_t*>(w8), static_cast<const uint8_t*>(premask),
      static_cast<uint8_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ladder_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
