// The lane bodies of csrc/bn254_pairing.cu and csrc/g2_msm.cu on the tower
// of bn254_tower.cuh. Portable C++ behind CUDA's keywords:
// tests/test_torch_bn254_field_host.py builds them with the host compiler
// and holds them to the plain torch versions (ops/bn254.py) and to
// bn254_ref.
//
// The Miller loop and the final exponentiation run one lane over a group
// of threads on the cooperative layer (pairing_coop.cuh over
// bn254_tower.cuh's formulas): coop::miller_group and
// coop::final_exp_group, instantiated for BnTower by the kernels, which
// read:
//   the Miller entry: pts (14, B, 20) limbs: xP, yP, then Q, Q1 = pi_p(Q),
//   nQ2 = -pi_p^2(Q) as x0, x1, y0, y1 each (BnTower's three points). The
//   loop's bits after its leading one arrive msb first as a 64-bit word
//   (lo, hi) and a count: per bit f = f^2 * the tangent line, and where
//   the bit is set f *= the chord line through Q (the bits are the same for
//   every lane, so this branch does not diverge; fabric_tpu computes the
//   addition on every step and selects it, which gives the same value);
//   then the chord lines through Q1 and nQ2. out (12, B, 20): the Miller
//   value, canonical;
//   the final-exp entry: fabric_tpu/ops/bn254.py final_exp_batch on the
//   product of the lane's T Miller values (f (12, T*B, 20), term t at
//   column t*B + lane): registers 0 and 1 = f and 1/f, the rest 0, then
//   the register-machine program (rows of op, dst, a, b: 0 = mul, 1 =
//   conj, 2 = frob; ops/bn254.py _final_exp_program) row by row, its rows
//   the same for every lane, a squaring from row cyc_from on cyclotomic.
//   gt (12, B, 20): register 0, canonical; ok[lane] = gt is the identity.
// bn_msm_thread / bn_msm_lane: per lane sum_t k_t Q_t (fabric_tpu/ops/
//   bn254.py g2_msm_scan's points), one thread a lane: scalars k (B, T, 8)
//   little-endian words, points q (4T, B, 20), any T >= 1; the terms'
//   joint tables (a window of three terms: its 7 subset sums; one window
//   in local memory, more in a scratch buffer the caller gives,
//   MsmTab<0>), then from infinity
//   (0, 1, 0) per bit one complete doubling and per window one complete
//   projective addition of the entry the window's bits index, kept where
//   the index is nonzero; the chain of ops/bn254.py g2_msm_chain, which
//   gives the same projective representative. A warp starts at the
//   highest bit any of its lanes has set and skips an addition none of
//   its lanes needs; an all-zero lane writes infinity at once. out (6, B,
//   20): X, Y, Z, canonical.
// coop_selftest_group: the self-test of the cooperative layer on this
//   tower and of the serial formulas it distributes, one case a group
//   (pairing_coop.cuh selftest_group).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_tower.cuh"
#include "pairing_coop.cuh"

namespace {
namespace bn254 {

// The same two lanes on one thread, on the serial formulas (the serial
// entries: one thread a lane).
__device__ __forceinline__ void bn_miller_lane(const int* pts, int B,
                                               int lane, uint32_t bits_lo,
                                               uint32_t bits_hi, int nbits,
                                               const BnConsts& k, int* out) {
  const Fp xP = fp_load(pts, B, 0, lane, k), yP = fp_load(pts, B, 1, lane, k);
  G2A Q[3];
  for (int i = 0; i < 3; ++i) {
    Q[i].x.c0 = fp_load(pts, B, 2 + 4 * i, lane, k);
    Q[i].x.c1 = fp_load(pts, B, 3 + 4 * i, lane, k);
    Q[i].y.c0 = fp_load(pts, B, 4 + 4 * i, lane, k);
    Q[i].y.c1 = fp_load(pts, B, 5 + 4 * i, lane, k);
  }
  G2P T = {Q[0].x, Q[0].y, f2_one(k)};
  Fp12 f;
  Fp2 la, lb, lc;
  f12_one(f, k);
  for (int i = nbits - 1; i >= 0; --i) {
    const uint32_t bit = i >= 32 ? (bits_hi >> (i - 32)) & 1u
                                 : (bits_lo >> i) & 1u;
    f12_sqr(f, f, k);
    g2_dbl_line(T, la, lb, lc, xP, yP, k);
    f12_mul_line(f, f, la, lb, lc, k);
    if (bit) {
      g2_add_line(T, la, lb, lc, Q[0], xP, yP, k);
      f12_mul_line(f, f, la, lb, lc, k);
    }
  }
  for (int i = 1; i < 3; ++i) {
    g2_add_line(T, la, lb, lc, Q[i], xP, yP, k);
    f12_mul_line(f, f, la, lb, lc, k);
  }
  f12_store(out, B, lane, f, k);
}

__device__ __forceinline__ void bn_final_exp_lane(
    const int* f_in, int nterms, int B, int lane, const int* prog,
    int nrows, int cyc_from, const BnConsts& k, int* gt, uint8_t* ok) {
  Fp12 regs[8], tmp;
  f12_load(regs[0], f_in, nterms * B, lane, k);
  for (int t = 1; t < nterms; ++t) {
    f12_load(tmp, f_in, nterms * B, t * B + lane, k);
    f12_mul(regs[0], regs[0], tmp, k);
  }
  f12_inv(regs[1], regs[0], k);
  for (int r = 2; r < 8; ++r) f12_zero(regs[r]);
  for (int r = 0; r < nrows; ++r) {
    const int op = __ldg(prog + 4 * r), dst = __ldg(prog + 4 * r + 1),
              a = __ldg(prog + 4 * r + 2), b = __ldg(prog + 4 * r + 3);
    if (op == 0) {
      if (a == b && r >= cyc_from) f12_sqr_cyclotomic(regs[dst], regs[a], k);
      else f12_mul(regs[dst], regs[a], regs[b], k);
    } else if (op == 1) {
      f12_conj(tmp, regs[a]);
      regs[dst] = tmp;
    } else {
      f12_frob(regs[dst], regs[a], k);
    }
  }
  f12_store(gt, B, lane, regs[0], k);
  ok[lane] = gt_is_one(regs[0], k) ? 1 : 0;
}

// The MSM's joint tables: the terms in windows of BN_MSM_WINDOW, each
// window's 2^w - 1 subset sums of its points (entry e - 1 holds sum over
// the set bits t of e of Q_t).
constexpr int BN_MSM_WINDOW = 3;
constexpr int BN_MSM_ENTRIES = (1 << BN_MSM_WINDOW) - 1;

__host__ __device__ __forceinline__ constexpr int bn_msm_windows(int nterms) {
  return (nterms + BN_MSM_WINDOW - 1) / BN_MSM_WINDOW;
}

// The scratch a call of B lanes of `nterms` terms needs, in G2P entries:
// none for one window (its table sits in local memory), else every
// window's table of every lane.
__host__ __device__ __forceinline__ constexpr long long bn_msm_scratch_entries(
    int B, int nterms) {
  return nterms <= BN_MSM_WINDOW ? 0
                                 : static_cast<long long>(
                                       bn_msm_windows(nterms)) *
                                       BN_MSM_ENTRIES * B;
}

// A lane's joint tables: NW windows in local memory (NW known to the
// compiler, so its loops unroll; the kernel takes NW = 1), or, for NW =
// 0, any number of windows in a scratch buffer of G2P entries, entry (w,
// e) of lane `lane` at (w * BN_MSM_ENTRIES + e) * B + lane.
template <int NW>
struct MsmTab {
  G2P t[NW][BN_MSM_ENTRIES];
  __device__ __forceinline__ G2P& at(int w, int e) { return t[w][e]; }
};

template <>
struct MsmTab<0> {
  G2P* base;
  int B, lane;
  __device__ __forceinline__ G2P& at(int w, int e) {
    return base[(static_cast<size_t>(w) * BN_MSM_ENTRIES + e) * B + lane];
  }
};

// The highest set bit below nbits of the lane's scalars, -1 if all zero.
__device__ __forceinline__ int bn_msm_top(const uint32_t* kl, int nterms,
                                          int nbits) {
  for (int i = (nbits - 1) >> 5; i >= 0; --i) {
    uint32_t w = 0;
    for (int t = 0; t < nterms; ++t) w |= __ldg(kl + 8 * t + i);
    if (32 * i + 31 >= nbits) w &= 0xFFFFFFFFu >> (32 * i + 32 - nbits);
    if (w) return 32 * i + 31 - __clz(w);
  }
  return -1;
}

// One lane from bit `start` (at or above its top bit) down: the joint
// tables first (a composite entry is the entry without its lowest term
// plus that term, one complete mixed addition: 4 for a window of three),
// then from infinity (0, 1, 0), per bit one complete doubling and, per
// window, the complete projective addition of the entry its bits index,
// kept where the index is nonzero (index 0 is infinity). The bits above a
// lane's top leave (0, 1, 0) as it is, so `start` does not change the
// result. `work` holds the warp's lanes that run this body: a window's
// addition is skipped when none of them needs it, so a warp of lanes with
// one scalar (the subgroup lanes) adds only at its set bits.
template <int NW>
__device__ __forceinline__ void bn_msm_lane(MsmTab<NW>& tab,
                                            const uint32_t* kw,
                                            const int* q, int B, int nterms,
                                            int start, unsigned work,
                                            int lane, const BnConsts& k,
                                            int* out) {
  const int nw = NW ? NW : bn_msm_windows(nterms);
  for (int w = 0; w < nw; ++w) {
    const int lo = w * BN_MSM_WINDOW;
    const int nt = min(BN_MSM_WINDOW, nterms - lo);
    for (int e = 1; e < (1 << nt); ++e) {
      int t = 0;
      while (!((e >> t) & 1)) ++t;
      const G2A Q = {{fp_load(q, B, 4 * (lo + t), lane, k),
                      fp_load(q, B, 4 * (lo + t) + 1, lane, k)},
                     {fp_load(q, B, 4 * (lo + t) + 2, lane, k),
                      fp_load(q, B, 4 * (lo + t) + 3, lane, k)}};
      const int rest = e & (e - 1);
      if (rest == 0) {
        tab.at(w, e - 1) = {Q.x, Q.y, f2_one(k)};
      } else {
        G2P& entry = tab.at(w, e - 1);
        entry = tab.at(w, rest - 1);
        g2_add_mixed(entry, Q, k);
      }
    }
  }
  const uint32_t* kl = kw + static_cast<size_t>(lane) * nterms * 8;
  G2P acc = {f2_zero(), {k.one, fp_zero()}, f2_zero()}, sum;
  for (int i = start; i >= 0; --i) {
    g2_dbl(acc, k);
    for (int w = 0; w < nw; ++w) {
      const int lo = w * BN_MSM_WINDOW;
      const int nt = min(BN_MSM_WINDOW, nterms - lo);
      int idx = 0;
      for (int t = 0; t < nt; ++t)
        idx |= static_cast<int>(
                   (__ldg(kl + 8 * (lo + t) + (i >> 5)) >> (i & 31)) & 1u)
               << t;
      if (!__any_sync(work, idx != 0)) continue;
      g2_add(sum, acc, tab.at(w, max(idx, 1) - 1), k);
      if (idx) acc = sum;
    }
  }
  const Fp* c[6] = {&acc.X.c0, &acc.X.c1, &acc.Y.c0,
                    &acc.Y.c1, &acc.Z.c0, &acc.Z.c1};
  for (int i = 0; i < 6; ++i) fp_store(out, B, i, lane, *c[i], k);
}

// One thread's part of the MSM entry (lanes past B store nothing): every
// thread of the warp takes part in its vote and its reduction, a lane
// whose scalars are all zero writes infinity (0, 1, 0) at once, and the
// others run from the highest top bit among the warp's lanes. NW > 0: the
// tables of up to 3 * NW terms in local memory; NW = 0: any number of
// terms, the tables in `scratch` (bn_msm_scratch_entries(B, nterms)
// entries; unused otherwise).
template <int NW>
__device__ __forceinline__ void bn_msm_thread(const uint32_t* kw,
                                              const int* q, int B,
                                              int nterms, int nbits,
                                              int lane, const BnConsts& k,
                                              int* out,
                                              G2P* scratch = nullptr) {
  const bool live = lane < B;
  const int top = live ? bn_msm_top(kw + static_cast<size_t>(lane) *
                                             nterms * 8,
                                     nterms, nbits)
                       : -1;
  const unsigned work = __ballot_sync(0xFFFFFFFFu, top >= 0);
  const int start = __reduce_max_sync(0xFFFFFFFFu, top);
  if (!live) return;
  if (top < 0) {
    const Fp z = fp_zero();
    const Fp* c[6] = {&z, &z, &k.one, &z, &z, &z};
    for (int i = 0; i < 6; ++i) fp_store(out, B, i, lane, *c[i], k);
    return;
  }
  MsmTab<NW> tab;
  if constexpr (NW == 0) tab = {scratch, B, lane};
  bn_msm_lane<NW>(tab, kw, q, B, nterms, start, work, lane, k, out);
}

// the cooperative layer's self-test on this tower: bn254_pairing.cu's
// entry and the host tests
constexpr int COOP_IN = coop::SELFTEST_IN;
constexpr int COOP_OUT = coop::SELFTEST_OUT;
constexpr int COOP_CYCLES = coop::SELFTEST_CYCLES;

using CoopState = coop::FinalExpState<BnTower>;

__device__ __forceinline__ void coop_selftest_group(const coop::Group& g,
                                                    CoopState& st,
                                                    const uint32_t* in,
                                                    const BnConsts& k,
                                                    uint32_t* out) {
  coop::selftest_group<BnTower>(g, st, in, k, out);
}

}  // namespace bn254
}  // namespace
