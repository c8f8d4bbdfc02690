// The generic P-256 verify of one lane: u1 and u2 from the mod-n core,
// then R = u1*G + u2*Q by a 2-bit Shamir ladder over the lane's own key,
// and the projective check. The lane body of csrc/ladder.cu's entry, built
// by the host compiler for tests/test_torch_ladder.py; the device half of
// fabric_tpu/ops/p256.py double_scalar_mul and verify_core (message lanes
// are hashed first by the digest-only SHA-256 kernel, ops/verify.py
// ladder_verify).
//
// The ladder, as the JAX package's: a 16-entry table table[i + 4*j] =
// i*G + j*Q, then 128 steps of two doublings (pt_dbl) and one complete
// addition (pt_add) of the entry chosen by bits (254 - 2i, 255 - 2i) of u1
// and u2. Both bits of a step lie in one 32-bit word (254 - 2i is even),
// so the words are walked from the top, two bits a step shifted out of a
// copy; a word is picked by a select chain, not an index, so u1 and u2
// stay in registers. The G column (infinity, G, 2G, 3G) is the same for
// every lane: the kernel keeps one copy in shared memory for its block
// (ladder_g_entry), and each lane's own table in local memory holds only
// the 12 entries with j > 0 (one doubling and ten complete additions,
// 1,152 bytes): a step reads its entry through a generic pointer to one
// or the other.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "modn32.cuh"

namespace {

// word i (little-endian) of k*G's affine coordinate c (0 = x, 1 = y), for
// k = 1, 2, 3: j = 16 * (k - 1) + 8 * c + i
__host__ __device__ __forceinline__ constexpr uint32_t ladder_g_word(int j) {
  switch (j) {
    // 1G.x
    case 0: return 0xD898C296u;
    case 1: return 0xF4A13945u;
    case 2: return 0x2DEB33A0u;
    case 3: return 0x77037D81u;
    case 4: return 0x63A440F2u;
    case 5: return 0xF8BCE6E5u;
    case 6: return 0xE12C4247u;
    case 7: return 0x6B17D1F2u;
    // 1G.y
    case 8: return 0x37BF51F5u;
    case 9: return 0xCBB64068u;
    case 10: return 0x6B315ECEu;
    case 11: return 0x2BCE3357u;
    case 12: return 0x7C0F9E16u;
    case 13: return 0x8EE7EB4Au;
    case 14: return 0xFE1A7F9Bu;
    case 15: return 0x4FE342E2u;
    // 2G.x
    case 16: return 0x47669978u;
    case 17: return 0xA60B48FCu;
    case 18: return 0x77F21B35u;
    case 19: return 0xC08969E2u;
    case 20: return 0x04B51AC3u;
    case 21: return 0x8A523803u;
    case 22: return 0x8D034F7Eu;
    case 23: return 0x7CF27B18u;
    // 2G.y
    case 24: return 0x227873D1u;
    case 25: return 0x9E04B79Du;
    case 26: return 0x3CE98229u;
    case 27: return 0xBA7DADE6u;
    case 28: return 0x9F7430DBu;
    case 29: return 0x293D9AC6u;
    case 30: return 0xDB8ED040u;
    case 31: return 0x07775510u;
    // 3G.x
    case 32: return 0xC6E7FD6Cu;
    case 33: return 0xFB41661Bu;
    case 34: return 0xEFADA985u;
    case 35: return 0xE6C6B721u;
    case 36: return 0x1D4BF165u;
    case 37: return 0xC8F7EF95u;
    case 38: return 0xA6330A44u;
    case 39: return 0x5ECBE4D1u;
    // 3G.y
    case 40: return 0xA27D5032u;
    case 41: return 0x9A79B127u;
    case 42: return 0x384FB83Du;
    case 43: return 0xD82AB036u;
    case 44: return 0x1A64A2ECu;
    case 45: return 0x374B06CEu;
    case 46: return 0x4998FF7Eu;
    case 47: return 0x8734640Cu;
    default: return 0u;
  }
}

// the G column's entry k: infinity (k = 0) or k*G in affine form (Z = 1),
// k = 1, 2, 3
__device__ __forceinline__ Pt ladder_g_entry(int k) {
  if (k == 0) return pt_infinity();
  Pt p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p.X.w[i] = ladder_g_word(16 * (k - 1) + i);
    p.Y.w[i] = ladder_g_word(16 * (k - 1) + 8 + i);
    p.Z.w[i] = i == 0 ? 1u : 0u;
  }
  return p;
}

// word i of a, chosen by a select chain (a stays in registers)
__device__ __forceinline__ uint32_t fe_word(const Fe& a, int i) {
  uint32_t r = a.w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) r = i == k ? a.w[k] : r;
  return r;
}

// premask-free core: accept iff R = u1*G + u2*Q is not at infinity and
// x(R) == r or rpn (mod p), for canonical scalars u1, u2, an affine key
// (qx, qy) and the G column gtab[k] = ladder_g_entry(k)
__device__ __forceinline__ bool ladder_check(const Pt* gtab, const Fe& u1,
                                             const Fe& u2, const Fe& qx,
                                             const Fe& qy, const Fe& r,
                                             const Fe& rpn) {
  Pt tab[12];                       // tab[e - 4] = table[e], e = i + 4j
  tab[0].X = qx;
  tab[0].Y = qy;
  tab[0].Z = fe_zero();
  tab[0].Z.w[0] = 1;
  pt_dbl(tab[4], tab[0]);
  pt_add(tab[8], tab[4], tab[0]);
#pragma unroll 1
  for (int e = 5; e < 16; ++e) {
    if ((e & 3) != 0) pt_add(tab[e - 4], gtab[e & 3], tab[(e & 12) - 4]);
  }
  Pt acc = pt_infinity();
#pragma unroll 1
  for (int wd = 7; wd >= 0; --wd) {
    uint32_t a = fe_word(u1, wd), c = fe_word(u2, wd);
#pragma unroll 1
    for (int s = 0; s < 16; ++s) {
      pt_dbl(acc, acc);
      pt_dbl(acc, acc);
      const uint32_t i = a >> 30, j = c >> 30;
      const Pt* e = j ? &tab[i + 4 * j - 4] : &gtab[i];
      pt_add(acc, acc, *e);
      a <<= 2;
      c <<= 2;
    }
  }
  return pt_check(acc, r, rpn);
}

// The entry's lane body (ladder.cu runs one per thread): digests (B, 8)
// 32-bit big-endian digest words; q8 (B, 64) uint8: the key's x then y,
// 32-byte big-endian each; r8, rpn8, w8 (B, 32) uint8 big-endian rows;
// premask (B,) bool; out (B,) bool; gtab the G column. A lane with premask
// off rejects without computing.
__device__ __forceinline__ void ladder_digest_lane(
    size_t b, const Pt* gtab, const uint32_t* __restrict__ digests,
    const uint8_t* __restrict__ q8, const uint8_t* __restrict__ r8,
    const uint8_t* __restrict__ rpn8, const uint8_t* __restrict__ w8,
    const uint8_t* __restrict__ premask, uint8_t* __restrict__ out) {
  if (!premask[b]) {
    out[b] = 0;
    return;
  }
  uint32_t words[8];
  load_words(words, digests + b * 8);
  const Fe r = fe_load_be(r8 + b * 32);
  Fe u1, u2;
  mn_scalars(fe_from_be_words(words), r, fe_load_be(w8 + b * 32), u1, u2);
  out[b] = ladder_check(gtab, u1, u2, fe_load_be(q8 + b * 64),
                        fe_load_be(q8 + b * 64 + 32), r,
                        fe_load_be(rpn8 + b * 32))
               ? 1
               : 0;
}

}  // namespace
