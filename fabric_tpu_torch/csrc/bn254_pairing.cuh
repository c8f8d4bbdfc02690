// The lane bodies of csrc/bn254_pairing.cu and csrc/g2_msm.cu, one thread a
// lane, on the tower of bn254_tower.cuh. Portable C++ behind CUDA's
// keywords: tests/test_torch_bn254_field_host.py builds them with the host
// compiler and holds them to the plain torch versions (ops/bn254.py).
//
// bn_miller_lane: fabric_tpu/ops/bn254.py miller_loop_batch for one lane.
//   pts (14, B, 20) limbs: xP, yP, then Q, Q1 = pi_p(Q), nQ2 = -pi_p^2(Q)
//   as x0, x1, y0, y1 each. The loop's bits after its leading one arrive
//   msb first as a 64-bit word (lo, hi) and a count: per bit f = f^2 * the
//   tangent line, and where the bit is set f *= the chord line through Q
//   (the bits are the same for every lane, so this branch does not
//   diverge; fabric_tpu computes the addition on every step and selects
//   it, which gives the same value); then the chord lines through Q1 and
//   nQ2. out (12, B, 20): the Miller value, canonical.
// bn_final_exp_lane: fabric_tpu/ops/bn254.py final_exp_batch on the
//   product of the lane's T Miller values (f (12, T*B, 20), term t at
//   column t*B + lane): registers 0 and 1 = f and 1/f, the rest 0, then
//   the register-machine program (rows of op, dst, a, b: 0 = mul, 1 =
//   conj, 2 = frob; ops/bn254.py _final_exp_program) row by row, its rows
//   the same for every lane. gt (12, B, 20): register 0, canonical; ok[lane]
//   = gt is the identity.
// bn_msm_lane: fabric_tpu/ops/bn254.py g2_msm_scan for one lane: scalars
//   k (B, T, 8) little-endian words, points q (4T, B, 20); from infinity
//   (0, 1, 0), per bit from nbits - 1 down one complete doubling and, for
//   each term whose bit is set, one complete mixed addition (a branch where
//   fabric_tpu selects: the same point). out (6, B, 20): X, Y, Z, canonical.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_tower.cuh"

namespace {

constexpr int BN_MSM_MAX_TERMS = 8;

__device__ __forceinline__ void bn_miller_lane(const int* pts, int B,
                                               int lane, uint32_t bits_lo,
                                               uint32_t bits_hi, int nbits,
                                               const BnConsts& k, int* out) {
  Fp v[14];
  for (int i = 0; i < 14; ++i) v[i] = bn_load(pts, B, i, lane, k);
  const Fp xP = v[0], yP = v[1];
  const G2A Q = {{v[2], v[3]}, {v[4], v[5]}};
  const G2A Q1 = {{v[6], v[7]}, {v[8], v[9]}};
  const G2A nQ2 = {{v[10], v[11]}, {v[12], v[13]}};
  G2P T = {Q.x, Q.y, {k.one, fp_zero()}};
  Fp12 f, l;
  f12_one(f, k);
  for (int i = nbits - 1; i >= 0; --i) {
    const uint32_t bit = i >= 32 ? (bits_hi >> (i - 32)) & 1u
                                 : (bits_lo >> i) & 1u;
    f12_mul(f, f, f, k);
    g2_dbl_line(T, l, xP, yP, k);
    f12_mul(f, f, l, k);
    if (bit) {
      g2_add_line(T, l, Q, xP, yP, k);
      f12_mul(f, f, l, k);
    }
  }
  g2_add_line(T, l, Q1, xP, yP, k);
  f12_mul(f, f, l, k);
  g2_add_line(T, l, nQ2, xP, yP, k);
  f12_mul(f, f, l, k);
  f12_store(out, B, lane, f, k);
}

__device__ __forceinline__ void bn_final_exp_lane(
    const int* f_in, int nterms, int B, int lane, const int* prog,
    int nrows, const BnConsts& k, int* gt, uint8_t* ok) {
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
      f12_mul(tmp, regs[a], regs[b], k);
    } else if (op == 1) {
      f12_conj(tmp, regs[a]);
    } else {
      f12_frob(tmp, regs[a], k);
    }
    regs[dst] = tmp;
  }
  f12_store(gt, B, lane, regs[0], k);
  ok[lane] = gt_is_one(regs[0], k) ? 1 : 0;
}

__device__ __forceinline__ void bn_msm_lane(const uint32_t* kw,
                                            const int* q, int B, int nterms,
                                            int nbits, int lane,
                                            const BnConsts& k, int* out) {
  G2A Q[BN_MSM_MAX_TERMS];
  for (int t = 0; t < nterms; ++t) {
    Q[t].x.c0 = bn_load(q, B, 4 * t, lane, k);
    Q[t].x.c1 = bn_load(q, B, 4 * t + 1, lane, k);
    Q[t].y.c0 = bn_load(q, B, 4 * t + 2, lane, k);
    Q[t].y.c1 = bn_load(q, B, 4 * t + 3, lane, k);
  }
  const uint32_t* kl = kw + static_cast<size_t>(lane) * nterms * 8;
  G2P acc = {f2_zero(), {k.one, fp_zero()}, f2_zero()};
  for (int i = nbits - 1; i >= 0; --i) {
    g2_dbl(acc, k);
    for (int t = 0; t < nterms; ++t)
      if ((__ldg(kl + 8 * t + (i >> 5)) >> (i & 31)) & 1u)
        g2_add_mixed(acc, Q[t], k);
  }
  const Fp* c[6] = {&acc.X.c0, &acc.X.c1, &acc.Y.c0,
                    &acc.Y.c1, &acc.Z.c0, &acc.Z.c1};
  for (int i = 0; i < 6; ++i) bn_store(out, B, i, lane, *c[i], k);
}

}  // namespace
