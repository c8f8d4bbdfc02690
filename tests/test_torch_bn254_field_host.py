"""The BN254 kernels' field core, tower and lane bodies, built by the host
C++ compiler.

fabric_tpu_torch/csrc/bn254_field.cuh (Montgomery arithmetic mod BN254's p
on 8 x 32-bit words), bn254_tower.cuh (Fp2/Fp6/Fp12, Frobenius,
inversions, the RCB15 twist steps and their lines) and bn254_pairing.cuh
(the Miller, final-exp and G2 MSM lane bodies) are portable C++ behind
CUDA's execution-space keywords, so the host compiler builds them here
behind the stand-in tests/cuda_host/cuda_runtime.h, and the per-case
bodies the card's self-test kernel runs (bn_fp_selftest,
bn_tower_selftest) and the kernels' lane bodies are held to Python ints
and to the plain torch versions (ops/bn254.py): the field ops on edge
operands (0, 1, p - 1, p, p + 1, 2p - 1) and seeded random ones below 2p;
Fp2 mul/sqr/inv, Fp12 mul, Frobenius and inverse, the twist doubling and
addition with their lines (points also held to the int group law); the
Miller lane at a truncated loop, the final-exp lane on a short program
with two terms, the MSM lane on 8-bit scalars with Q + Q, Q + (-Q), k = 0
and a sum at infinity. Tolerance: exact words and limbs. The nvcc build is
held to the same on the card (tests/test_torch_cuda.py, chip_smoke.py
field_vs_ints and pairing_vs_plain).
"""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_tpu_torch.ops import bn254 as dev
from fabric_tpu_torch.ops import bn254_ref as ref
from fabric_tpu_torch.ops import tower

P = ref.P
G2 = (ref.G2_X, ref.G2_Y)
SMALL_LOOP = 0b1011010
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "fabric_tpu_torch", "csrc")

HARNESS = r"""
#include "cuda_runtime.h"
#include <string.h>
#include "bn254_pairing.cuh"

static BnConsts consts_of(const uint32_t* w) {
  BnConsts k;
  memcpy(&k, w, sizeof(k));
  return k;
}

extern "C" void h_fp(const uint32_t* a, const uint32_t* b,
                     const uint32_t* c, int n, uint32_t* out) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < n; ++i)
    bn_fp_selftest(a + 8 * i, b + 8 * i, k.r2, out + 40 * i);
}

extern "C" void h_tower(const uint32_t* cases, const uint32_t* c, int n,
                        uint32_t* out) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < n; ++i)
    bn_tower_selftest(cases + 8 * BN_TOWER_IN * i, k,
                      out + 8 * BN_TOWER_OUT * i);
}

extern "C" void h_miller(const int* pts, const uint32_t* c, int* out, int B,
                         int lo, int hi, int nbits) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < B; ++i)
    bn_miller_lane(pts, B, i, (uint32_t)lo, (uint32_t)hi, nbits, k, out);
}

extern "C" void h_final_exp(const int* f, const uint32_t* c, const int* prog,
                            int nrows, int* gt, uint8_t* ok, int nterms,
                            int B) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < B; ++i)
    bn_final_exp_lane(f, nterms, B, i, prog, nrows, k, gt, ok);
}

extern "C" void h_msm(const uint32_t* kw, const int* q, const uint32_t* c,
                      int* out, int B, int nterms, int nbits) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < B; ++i) bn_msm_lane(kw, q, B, nterms, nbits, i, k, out);
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    torch.set_num_threads(1)
    cxx = next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                if c and shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("bn254")
    src, so = d / "harness.cpp", d / "libbn254.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-Wno-unknown-pragmas",
                    "-I", os.path.join(HERE, "cuda_host"), "-I", CSRC,
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


CONSTS = dev.consts_words()


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _call(fn, *args):
    """ints pass as ints, arrays as pointers (kept alive by the caller)."""
    fn(*(ctypes.c_int(a) if isinstance(a, int) else _ptr(a) for a in args))


def _words(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32)


def _ints(row) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(row[j:j + 8]))
            for j in range(0, len(row), 8)]


def test_consts_words_are_the_ints():
    w = _ints(CONSTS[:144])
    R = 1 << 256
    assert w[:4] == [R % P, R * R % P, pow(2, 252, P), pow(2, 260, P)]
    mont = [v * pow(R, -1, P) % P for v in w[4:]]
    assert (mont[0], mont[1]) == dev._B3_TW
    assert [tuple(mont[2 + 2 * k:4 + 2 * k]) for k in range(6)] == dev._GAMMA
    assert CONSTS[144:].tolist() == [9, 1, ref.T_BN & 0xFFFFFFFF,
                                     ref.T_BN >> 32]


EDGES = [0, 1, P - 1, P, P + 1, 2 * P - 1]


def test_field_ops_match_ints(core):
    rng = random.Random(90)
    pairs = [(a, b) for a in EDGES for b in EDGES]
    pairs += [(rng.randrange(2 * P), rng.randrange(2 * P))
              for _ in range(300)]
    a = _words(x for x, _ in pairs)
    b = _words(y for _, y in pairs)
    out = np.zeros((len(pairs), 40), np.uint32)
    _call(core.h_fp, a, b, CONSTS, len(pairs), out)
    want = dev.fp_selftest_plain(torch.from_numpy(a.view(np.int32)),
                                 torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(out.astype(np.int64), want.numpy())
    assert _ints(out[2]) == [0, P - 1, 1, 0, 0]     # a = 0, b = p - 1


def _tower_cases(seed, n):
    rng = random.Random(seed)
    cases = []
    for i in range(n):
        x = [rng.randrange(P) for _ in range(12)]
        y = [rng.randrange(P) for _ in range(12)]
        if i == 0:
            x[2:] = [0] * 10          # x.c0 alone: an Fp2 element
        p = ref.g1_mul_fast(rng.randrange(1, ref.R), ref.G1)
        q = ref.g2_mul_fast(rng.randrange(1, ref.R), G2)
        z = (rng.randrange(1, P), rng.randrange(P))
        # homogeneous projective (X : Y : Z) of q; lane 1 adds q to itself
        t = [ref.f2_mul(q[0], z), ref.f2_mul(q[1], z), z]
        qa = q if i == 1 else ref.g2_mul_fast(rng.randrange(1, ref.R), G2)
        cases.append((x + y + list(p) + [c for f2 in t for c in f2]
                      + [c for f2 in qa for c in f2], q, qa))
    return cases


def _affine(X, Y, Z):
    zi = ref.f2_inv(Z)
    return (ref.f2_mul(X, zi), ref.f2_mul(Y, zi))


def test_tower_matches_plain_and_ints(core):
    cases = _tower_cases(91, 4)
    cw = np.stack([_words(c).reshape(-1) for c, _, _ in cases])
    out = np.zeros((len(cases), 720), np.uint32)
    _call(core.h_tower, cw, CONSTS, len(cases), out)
    want = dev.tower_selftest_plain(torch.from_numpy(cw.view(np.int32)))
    np.testing.assert_array_equal(out.astype(np.int64), want.numpy())
    for row, (vals, q, qa) in zip(out, cases):
        v = _ints(row)
        x = (tuple(tuple(vals[2 * j:2 * j + 2]) for j in range(3)),
             tuple(tuple(vals[6 + 2 * j:8 + 2 * j]) for j in range(3)))
        y = (tuple(tuple(vals[12 + 2 * j:14 + 2 * j]) for j in range(3)),
             tuple(tuple(vals[18 + 2 * j:20 + 2 * j]) for j in range(3)))

        def f12(o):
            return (tuple(tuple(v[o + 2 * j:o + 2 * j + 2]) for j in range(3)),
                    tuple(tuple(v[o + 6 + 2 * j:o + 8 + 2 * j])
                          for j in range(3)))
        assert tuple(v[0:2]) == ref.f2_mul(x[0][0], y[0][0])
        assert tuple(v[2:4]) == ref.f2_mul(x[0][0], x[0][0])
        assert tuple(v[4:6]) == ref.f2_inv(x[0][0])
        assert f12(6) == ref.f12_mul(x, y)
        assert f12(18) == ref.f12_frob(x)
        assert f12(30) == ref.f12_inv(x)
        dbl = ref.g2_add_fast(q, q)
        assert _affine(*(tuple(v[42 + 2 * j:44 + 2 * j])
                         for j in range(3))) == dbl
        assert _affine(*(tuple(v[60 + 2 * j:62 + 2 * j])
                         for j in range(3))) == ref.g2_add_fast(q, qa)
        assert _affine(*(tuple(v[78 + 2 * j:80 + 2 * j])
                         for j in range(3))) == dbl
        assert _affine(*(tuple(v[84 + 2 * j:86 + 2 * j])
                         for j in range(3))) == ref.g2_add_fast(q, qa)


def _staged_points(seed, n):
    rng = random.Random(seed)
    ps = [ref.g1_mul_fast(rng.randrange(2, ref.R), ref.G1) for _ in range(n)]
    qs = [ref.g2_mul_fast(rng.randrange(2, ref.R), G2) for _ in range(n)]
    ps[0], qs[0] = ref.G1, G2
    return dev.to_device(dev.stage_g1(ps) + dev.stage_g2(qs), "cpu")


def test_miller_lane_matches_plain(core):
    st = _staged_points(92, 3)
    plain = dev.miller_loop_batch(*st, loop=SMALL_LOOP)
    pts = np.ascontiguousarray(torch.stack(dev._flat_points(*st)).numpy())
    out = np.zeros((12, 3, 20), np.int32)
    rest = int(bin(SMALL_LOOP)[3:], 2)
    _call(core.h_miller, pts, CONSTS, out, 3, rest, 0,
          len(bin(SMALL_LOOP)) - 3)
    np.testing.assert_array_equal(
        out, dev.F.canonical(tower.flat_from_f12(plain)).numpy())


def test_final_exp_lane_matches_plain(core):
    """Two terms a lane (multiplied first), a short program with every
    op, the identity verdict on a lane whose product is one."""
    A = dev._Asm()
    A.conj(2, 0)
    A.mul(2, 2, 1)
    A.frob(6, 2)
    A.mul(0, 6, 2)
    A.pow_static(3, 0, 7, 0b101)
    A.mul(0, 3, 0)
    prog = A.program()
    rng = random.Random(93)
    # columns t * B + lane, B = 2: lane 1's second term is the inverse of
    # its first, so its product, and its final exponentiation, is one
    f = torch.as_tensor(np.stack([np.stack([
        dev.F.to_mont(rng.randrange(P)) for _ in range(4)])
        for _ in range(12)]))                               # (12, 4, 20)
    f[:, 3] = tower.flat_from_f12(dev._T.f12_inv(
        tower.f12_from_flat(f[:, 1:2])))[:, 0]
    prod = dev.f12_mul(tower.f12_from_flat(f[:, :2]),
                       tower.f12_from_flat(f[:, 2:]))
    plain = dev.final_exp_plain(prod, prog)
    gt = np.zeros((12, 2, 20), np.int32)
    ok = np.zeros(2, np.uint8)
    _call(core.h_final_exp, np.ascontiguousarray(f.numpy()), CONSTS, prog,
          len(prog), gt, ok, 2, 2)
    np.testing.assert_array_equal(
        gt, dev.F.canonical(tower.flat_from_f12(plain)).numpy())
    assert ok.tolist() == [0, 1] == dev.gt_is_one(plain).int().tolist()


def test_msm_lane_matches_plain_and_ints(core):
    rng = random.Random(94)
    T = ref.g2_mul_fast(31337, G2)
    lanes = [[(rng.randrange(1 << 8), G2), (rng.randrange(1 << 8), T),
              (rng.randrange(1 << 8), T)] for _ in range(3)]
    lanes += [[(0, G2), (0, None), (0, G2)],                 # k = 0: inf
              [(9, T), (0, None), (9, ref.g2_neg_tw(T))],   # Q + (-Q)
              [(1, T), (1, T), (0, None)],                  # Q + Q
              [(255, G2), (1, G2), (0, None)]]              # 256 G2
    kw, qf = dev.stage_g2_msm_words(lanes)
    B = len(lanes)
    q = np.ascontiguousarray(np.stack(qf))
    out = np.zeros((6, B, 20), np.int32)
    _call(core.h_msm, np.ascontiguousarray(kw), q, CONSTS, out, B, 3, 8)
    plain = dev.g2_msm(torch.as_tensor(kw.view(np.int32)),
                       *[torch.as_tensor(a) for a in qf], nbits=8)
    flat = torch.stack([c for p in plain for c in p])
    np.testing.assert_array_equal(out, dev.F.canonical(flat).numpy())
    got = dev.read_g2_msm(((out[0], out[1]), (out[2], out[3]),
                           (out[4], out[5])))
    assert got == [ref.g2_msm(lane) for lane in lanes]
    assert got[3] is None and got[4] is None
