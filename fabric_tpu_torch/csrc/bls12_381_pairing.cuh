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
//   serial formulas it distributes, one case a group (below).

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

// -- the cooperative layer's self-test (bls12_381_pairing.cu; host tests)
//
// in: 42 plain values as 12 words each: x (Fp12, 12), y (Fp12, 12), a
// line's A, B, C (6) and c (Fp12, 12: an element of the cyclotomic
// subgroup). out: 110 canonical plain values, x^2 by f12_sqr and by the
// group, x * line (C + B v) + (A v) w by f12_mul_line and by the group,
// c^2 by f12_sqr_cyclotomic and by the group, the group's x * y, 1/x and
// x^p, and the inverse of x's first coefficient by fp_inv_binary and by
// fp_inv (0 for 0); then COOP_CYCLES words of clock cycles (0 on the
// host): fp_inv (Fermat) and fp_inv_binary on that coefficient on one
// thread, the group's Fp12 product and cyclotomic squaring (every round
// and barrier), and one thread's f2_mul and f2_add of shared operands
// (each the last of three runs).
constexpr int COOP_IN = 42;
constexpr int COOP_OUT = 9 * 12 + 2;
constexpr int COOP_CYCLES = 6;

using CoopState = coop::FinalExpState<BlsTower>;

__device__ __noinline__ void coop_put(const coop::Group& g,
                                         const Fp12& a, uint32_t* out,
                                         int at) {
  g.each(12, [&](int i) {
    const Fp2& c = f12_slot(a, i / 2);
    const Fp v = fp_to_plain(i & 1 ? c.c1 : c.c0);
    for (int j = 0; j < NW; ++j) out[NW * (at + i) + j] = v.w[j];
  });
  g.sync();
}

__device__ __forceinline__ void coop_selftest_group(const coop::Group& g,
                                                    CoopState& st,
                                                    const uint32_t* in,
                                                    const BlsConsts& k,
                                                    uint32_t* out) {
  Fp12 &x = st.reg[0], &y = st.reg[1], &c = st.reg[2], &r = st.reg[3];
  coop::Scratch<BlsTower>& s = st.s;
  Fp2* line = st.inv.n;                      // A, B, C
  g.each(COOP_IN, [&](int i) {
    Fp a;
    for (int j = 0; j < NW; ++j) a.w[j] = in[NW * i + j];
    const Fp m = fp_mul(a, k.r2);
    Fp2& slot = i < 12 ? f12_slot(x, i / 2)
              : i < 24 ? f12_slot(y, (i - 12) / 2)
              : i < 30 ? line[(i - 24) / 2] : f12_slot(c, (i - 30) / 2);
    (i & 1 ? slot.c1 : slot.c0) = m;
  });
  g.sync();
  g.each(1, [&](int) { f12_sqr(r, x, k); });
  g.sync();
  coop_put(g, r, out, 0);
  coop::sqr<BlsTower>(g, r, x, s, k);
  coop_put(g, r, out, 12);
  g.each(1, [&](int) { f12_mul_line(r, x, line[0], line[1], line[2], k); });
  g.sync();
  coop_put(g, r, out, 24);
  coop::mul_line<BlsTower>(
      g, r, x,
      [&](Fp2& A, Fp2& B, Fp2& C) {
        A = line[0];
        B = line[1];
        C = line[2];
      },
      0, [&](int, Fp2& a, Fp2& b) { a = b = line[0]; },
      [&](int) -> Fp2& { return s.p[0]; }, 0, [](int) {}, s, k);
  coop_put(g, r, out, 36);
  g.each(1, [&](int) { f12_sqr_cyclotomic(r, c, k); });
  g.sync();
  coop_put(g, r, out, 48);
  coop::cyc<BlsTower>(g, r, c, s, k);
  coop_put(g, r, out, 60);
  coop::mul<BlsTower>(g, r, x, y, s, k);
  coop_put(g, r, out, 72);
  coop::inv<BlsTower>(g, r, x, s, st.inv, k);
  coop_put(g, r, out, 84);
  coop::frob<BlsTower>(g, r, x, s, k);
  coop_put(g, r, out, 96);
  g.each(1, [&](int) {
    Fp fermat, binary;
    const long long t0 = clock64();
    fp_inv(fermat, x.d0.c[0].c0);
    const long long t1 = clock64();
    fp_inv_binary(binary, x.d0.c[0].c0, k.r2);
    const long long t2 = clock64();
    const Fp v = fp_to_plain(binary), w = fp_to_plain(fermat);
    for (int j = 0; j < NW; ++j) {
      out[NW * 108 + j] = v.w[j];
      out[NW * 109 + j] = w.w[j];
    }
    out[NW * COOP_OUT] = static_cast<uint32_t>(t1 - t0);
    out[NW * COOP_OUT + 1] = static_cast<uint32_t>(t2 - t1);
  });
  g.sync();
  // the group's clock around one Fp12 product and one cyclotomic
  // squaring (their rounds and barriers), then one thread's around an
  // f2_mul and an f2_add of shared operands: each the third of three runs
  // (the first fetches the code)
  long long t3 = 0, t4 = 0, t5 = 0;
  for (int rep = 0; rep < 3; ++rep) {
    t3 = clock64();
    coop::mul<BlsTower>(g, r, x, y, s, k);
    t4 = clock64();
    coop::cyc<BlsTower>(g, r, c, s, k);
    t5 = clock64();
  }
  g.each(1, [&](int) {
    long long t6 = 0, t7 = 0, t8 = 0;
    for (int rep = 0; rep < 3; ++rep) {
      t6 = clock64();
      s.p[0] = f2_mul(s.p[1], s.p[2]);
      t7 = clock64();
      s.p[3] = f2_add(s.p[4], s.p[5]);
      t8 = clock64();
    }
    out[NW * COOP_OUT + 2] = static_cast<uint32_t>(t4 - t3);
    out[NW * COOP_OUT + 3] = static_cast<uint32_t>(t5 - t4);
    out[NW * COOP_OUT + 4] = static_cast<uint32_t>(t7 - t6);
    out[NW * COOP_OUT + 5] = static_cast<uint32_t>(t8 - t7);
  });
  g.sync();
}

}  // namespace bls381
}  // namespace
