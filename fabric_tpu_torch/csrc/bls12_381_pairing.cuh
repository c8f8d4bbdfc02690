// The lane bodies of csrc/bls12_381_pairing.cu. Portable C++ behind CUDA's
// keywords: tests/test_torch_bls12_381_field_host.py builds them with the
// host compiler and holds them to the plain torch versions
// (ops/bls12_381_kernel.py) and to bls12_381_ref.
//
// The Miller loop and the final exponentiation run one lane over a warp,
// on the cooperative layer (pairing_coop.cuh over bls12_381_tower.cuh's
// formulas): coop::miller_group and coop::final_exp_group, instantiated
// for BlsTower by the kernels.
// reduce_lane: one level of fabric_tpu's _product_reduce for lane i < half:
//   f[i] = f[i] * f[i + half] in the (12, B, 30) buffer, canonical; one
//   thread a lane on the serial tower.
// coop_selftest_group: the self-test of the cooperative layer and of the
//   serial formulas it distributes, one case a group (pairing_coop.cuh
//   selftest_group).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381_tower.cuh"
#include "pairing_coop.cuh"

namespace {
namespace bls381 {

__device__ __forceinline__ void reduce_lane(int* f, int B, int i, int half,
                                            const BlsConsts& k) {
  Fp12 a, b;
  f12_load(a, f, B, i, k);
  f12_load(b, f, B, i + half, k);
  f12_mul(a, a, b, k);
  f12_store(f, B, i, a, k);
}

// the cooperative layer's self-test (pairing_coop.cuh selftest_group) on
// this tower: bls12_381_pairing.cu's entry and the host tests
constexpr int COOP_IN = coop::SELFTEST_IN;
constexpr int COOP_OUT = coop::SELFTEST_OUT;
constexpr int COOP_CYCLES = coop::SELFTEST_CYCLES;

using CoopState = coop::FinalExpState<BlsTower>;

__device__ __forceinline__ void coop_selftest_group(const coop::Group& g,
                                                    CoopState& st,
                                                    const uint32_t* in,
                                                    const BlsConsts& k,
                                                    uint32_t* out) {
  coop::selftest_group<BlsTower>(g, st, in, k, out);
}

}  // namespace bls381
}  // namespace
