// The lane bodies of csrc/bls12_381_pairing.cu, one thread a lane, on the
// tower of bls12_381_tower.cuh. Portable C++ behind CUDA's keywords:
// tests/test_torch_bls12_381_field_host.py builds them with the host
// compiler and holds them to the plain torch versions
// (ops/bls12_381_kernel.py) and to bls12_381_ref.
//
// miller_lane: fabric_tpu/ops/bls12_381_kernel.py miller_loop_batch for one
//   lane, then its mask. pts (6, B, 30) limbs: xP, yP, then Q as x0, x1,
//   y0, y1. The loop's bits after its leading one arrive msb first as a
//   64-bit word (lo, hi) and a count: per bit f = f^2 * the tangent line,
//   and where the bit is set f *= the chord line through Q (the bits are
//   the same for every lane, so this branch does not diverge; fabric_tpu
//   computes the addition on every step and selects it, which gives the
//   same value). A lane whose mask is 0 skips the loop and stores Fp12
//   one, as fabric_tpu's pairs_product_is_one selects one for it after the
//   loop. out (12, B, 30): the Miller value, canonical.
// reduce_lane: one level of fabric_tpu's _product_reduce for lane i < half:
//   f[i] = f[i] * f[i + half] in the (12, B, 30) buffer, canonical.
// final_exp_lane: fabric_tpu/ops/bls12_381_kernel.py final_exp_batch for
//   one lane: registers 0 and 1 = f and 1/f, the rest 0, then the
//   register-machine program (rows of op, dst, a, b: 0 = mul, 1 = conj,
//   2 = frob; final_exp_program, the Hayashida-Hayasaka-Teruya chain) row
//   by row. gt (12, B, 30): register 0, canonical; ok[lane] = gt is the
//   identity.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381_tower.cuh"

namespace {
namespace bls381 {

__device__ __forceinline__ void miller_lane(const int* pts,
                                            const uint8_t* mask, int B,
                                            int lane, uint32_t bits_lo,
                                            uint32_t bits_hi, int nbits,
                                            const BlsConsts& k, int* out) {
  Fp12 f, l;
  f12_one(f, k);
  if (mask[lane]) {
    Fp v[6];
    for (int i = 0; i < 6; ++i) v[i] = fp_load(pts, B, i, lane, k);
    const Fp xP = v[0], yP = v[1];
    const G2A Q = {{v[2], v[3]}, {v[4], v[5]}};
    G2P T = {Q.x, Q.y, {k.one, fp_zero()}};
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
  }
  f12_store(out, B, lane, f, k);
}

__device__ __forceinline__ void reduce_lane(int* f, int B, int i, int half,
                                            const BlsConsts& k) {
  Fp12 a, b;
  f12_load(a, f, B, i, k);
  f12_load(b, f, B, i + half, k);
  f12_mul(a, a, b, k);
  f12_store(f, B, i, a, k);
}

__device__ __forceinline__ void final_exp_lane(const int* f_in, int B,
                                               int lane, const int* prog,
                                               int nrows, const BlsConsts& k,
                                               int* gt, uint8_t* ok) {
  Fp12 regs[8], tmp;
  f12_load(regs[0], f_in, B, lane, k);
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

}  // namespace bls381
}  // namespace
