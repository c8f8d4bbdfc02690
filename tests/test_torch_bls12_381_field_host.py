"""The BLS12-381 kernels' field core, tower, cooperative layer and lane
bodies, built by the host C++ compiler.

fabric_tpu_torch/csrc/bls12_381_field.cuh (Montgomery arithmetic mod
BLS12-381's p on 12 x 32-bit words), bls12_381_tower.cuh (Fp2/Fp6/Fp12,
Frobenius, inversions, the RCB15 twist steps and their M-type lines, and
the formulas the cooperative layer distributes: the complex squaring, the
sparse line product, the cyclotomic squaring), pairing_coop.cuh (a lane
over a group of threads) and bls12_381_pairing.cuh (the one-launch
reduce's groups and the cooperative self-test) are portable C++ behind
CUDA's execution-space keywords, so the host compiler builds them here
behind the stand-in tests/cuda_host/cuda_runtime.h, as
tests/test_torch_bn254_field_host.py does for BN254. The host runs a
group's rounds on one thread, each round's jobs first to last and last
to first (`rev`): both orders must give the plain
values, which a round reading another job's output of the same round
would not. Held to Python ints and to the plain torch versions
(ops/bls12_381_kernel.py): the field ops on edge operands (0, 1, p - 1, p,
p + 1, 2p - 1) and seeded random ones below 2p, and the 13-bit layout's
round trip; Fp2 mul/sqr/inv, Fp12 mul, Frobenius and inverse, the twist
doubling and addition with their lines (points also held to the int
group law); the serial formulas and the group's Fp12 squaring, sparse
line product, cyclotomic squaring, product, inverse and Frobenius, and
the binary Euclid inverse on the edge operands; the Miller body at a
truncated loop against the plain version and, over the full |x|, against
bls12_381_ref.miller_loop up to an Fp2 * w^(3k) monomial; the reduce's
groups (groups and jobs in both orders) against the plain halving product
at 2, 4 and 8 lanes; the final-exp body on the FULL program
against bls12_381_ref.final_exponentiation_chain, with its identity
verdict on a product that is one. Tolerance: exact words and limbs. The
nvcc build is held to the same on the card (tests/test_torch_cuda.py,
chip_smoke.py field_vs_ints and bls_vs_plain).
"""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_tpu_torch.ops import bls12_381_kernel as dev
from fabric_tpu_torch.ops import bls12_381_ref as ref
from fabric_tpu_torch.ops import limb, tower

P = ref.P
G2 = (ref.G2_X, ref.G2_Y)
NW = dev.NW
SMALL_LOOP = 0b1011010
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "fabric_tpu_torch", "csrc")

HARNESS = r"""
#include "cuda_runtime.h"
#include <string.h>
#include "bls12_381_pairing.cuh"

using namespace bls381;

static BlsConsts consts_of(const uint32_t* w) {
  BlsConsts k;
  memcpy(&k, w, 4 * CONST_WORDS);
  return k;
}

extern "C" void h_fp(const uint32_t* a, const uint32_t* b,
                     const uint32_t* c, int n, uint32_t* out) {
  const BlsConsts k = consts_of(c);
  for (int i = 0; i < n; ++i)
    fp_selftest(a + NW * i, b + NW * i, k.r2, k.c_in, k.c_out,
                out + 6 * NW * i);
}

extern "C" void h_tower(const uint32_t* cases, const uint32_t* c, int n,
                        uint32_t* out) {
  const BlsConsts k = consts_of(c);
  for (int i = 0; i < n; ++i)
    tower_selftest(cases + NW * TOWER_IN * i, k, out + NW * TOWER_OUT * i);
}

// the cooperative bodies: one host thread runs each round's jobs, first
// to last or (rev) last to first
extern "C" void h_miller(const int* pts, const uint8_t* mask,
                         const uint32_t* c, int* out, int B, int lo, int hi,
                         int nbits, int rev) {
  const BlsConsts k = consts_of(c);
  static coop::MillerState<BlsTower> st;
  const coop::Group g{0, 1, rev != 0};
  for (int i = 0; i < B; ++i)
    coop::miller_group<BlsTower>(g, st, pts, mask, B, i, (uint32_t)lo,
                                 (uint32_t)hi, nbits, k, out);
}

extern "C" void h_coop(const uint32_t* cases, const uint32_t* c, int n,
                       uint32_t* out, int rev) {
  const BlsConsts k = consts_of(c);
  static CoopState st;
  const coop::Group g{0, 1, rev != 0};
  for (int i = 0; i < n; ++i)
    coop_selftest_group(g, st, cases + NW * COOP_IN * i, k,
                        out + (NW * COOP_OUT + COOP_CYCLES) * i);
}

// the reduce entry's B / 2 groups one after another, first to last or
// (order) last to first; each round's jobs in the order rev gives; cnt
// the caller's B counters
extern "C" void h_reduce(int* f, const uint32_t* c, int* cnt, int B, int rev,
                         int order) {
  const BlsConsts k = consts_of(c);
  static ReduceState st;
  const coop::Group g{0, 1, rev != 0};
  uint32_t* nodes = new uint32_t[(B - 1) * 12 * NW];
  for (int i = 0; i < B / 2; ++i)
    reduce_group(g, st, f, nodes, cnt, B, order ? B / 2 - 1 - i : i, k);
  delete[] nodes;
}

extern "C" void h_final_exp(const int* f, const uint32_t* c, const int* prog,
                            int nrows, int cyc_from, int* gt, uint8_t* ok,
                            int B, int rev) {
  const BlsConsts k = consts_of(c);
  static coop::FinalExpState<BlsTower> st;
  const coop::Group g{0, 1, rev != 0};
  for (int i = 0; i < B; ++i)
    coop::final_exp_group<BlsTower>(g, st, f, B, i, prog, nrows, cyc_from, k,
                                    gt, ok);
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    torch.set_num_threads(1)
    cxx = next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                if c and shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("bls12_381")
    src, so = d / "harness.cpp", d / "libbls.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-Wno-unknown-pragmas",
                    "-I", os.path.join(HERE, "cuda_host"), "-I", CSRC,
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(so))


CONSTS = dev.consts_words()


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _call(fn, *args):
    """ints pass as ints, arrays as pointers (kept alive by the caller)."""
    fn(*(ctypes.c_int(a) if isinstance(a, int) else _ptr(a) for a in args))


def _words(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(NW)]
                     for v in vals], dtype=np.uint32)


def _ints(row) -> list[int]:
    return limb.words_to_ints(row, NW)


def test_consts_words_are_the_ints():
    w = _ints(CONSTS[:NW * 18])
    R = 1 << 384
    assert w[:4] == [R % P, R * R % P, pow(2, 378, P), pow(2, 390, P)]
    mont = [v * pow(R, -1, P) % P for v in w[4:]]
    assert (mont[0], mont[1]) == dev._B3_TW == (12, 12)
    assert [tuple(mont[2 + 2 * k:4 + 2 * k]) for k in range(6)] == dev._GAMMA
    assert CONSTS[NW * 18:].tolist() == [1, 1]


EDGES = [0, 1, P - 1, P, P + 1, 2 * P - 1]


def test_field_ops_match_ints(core):
    rng = random.Random(380)
    pairs = [(a, b) for a in EDGES for b in EDGES]
    pairs += [(rng.randrange(2 * P), rng.randrange(2 * P))
              for _ in range(300)]
    a = _words(x for x, _ in pairs)
    b = _words(y for _, y in pairs)
    out = np.zeros((len(pairs), dev.FP_OUT), np.uint32)
    _call(core.h_fp, a, b, CONSTS, len(pairs), out)
    want = dev.fp_selftest_plain(torch.from_numpy(a.view(np.int32)),
                                 torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(out.astype(np.int64), want.numpy())
    assert _ints(out[2]) == [0, P - 1, 1, 0, 0, 0]   # a = 0, b = p - 1


def _tower_cases(seed, n):
    rng = random.Random(seed)
    cases = []
    for i in range(n):
        x = [rng.randrange(P) for _ in range(12)]
        y = [rng.randrange(P) for _ in range(12)]
        if i == 0:
            x[2:] = [0] * 10          # x.c0 alone: an Fp2 element
        p = ref.g1_mul(rng.randrange(1, ref.R), ref.G1)
        q = ref.g2_mul(rng.randrange(1, ref.R), G2)
        z = (rng.randrange(1, P), rng.randrange(P))
        # homogeneous projective (X : Y : Z) of q; case 1 adds q to itself
        t = [ref.f2_mul(q[0], z), ref.f2_mul(q[1], z), z]
        qa = q if i == 1 else ref.g2_mul(rng.randrange(1, ref.R), G2)
        cases.append((x + y + list(p) + [c for f2 in t for c in f2]
                      + [c for f2 in qa for c in f2], q, qa))
    return cases


def _affine(X, Y, Z):
    zi = ref.f2_inv(Z)
    return (ref.f2_mul(X, zi), ref.f2_mul(Y, zi))


def _f12(v, o):
    return (tuple(tuple(v[o + 2 * j:o + 2 * j + 2]) for j in range(3)),
            tuple(tuple(v[o + 6 + 2 * j:o + 8 + 2 * j]) for j in range(3)))


def test_tower_matches_plain_and_ints(core):
    cases = _tower_cases(381, 3)
    cw = np.stack([_words(c).reshape(-1) for c, _, _ in cases])
    out = np.zeros((len(cases), NW * dev.TOWER_OUT), np.uint32)
    _call(core.h_tower, cw, CONSTS, len(cases), out)
    want = dev.tower_selftest_plain(torch.from_numpy(cw.view(np.int32)))
    np.testing.assert_array_equal(out.astype(np.int64), want.numpy())
    for row, (vals, q, qa) in zip(out, cases):
        v = _ints(row)
        x, y = _f12(vals, 0), _f12(vals, 12)
        assert tuple(v[0:2]) == ref.f2_mul(x[0][0], y[0][0])
        assert tuple(v[2:4]) == ref.f2_mul(x[0][0], x[0][0])
        assert tuple(v[4:6]) == ref.f2_inv(x[0][0])
        assert _f12(v, 6) == ref.f12_mul(x, y)
        assert _f12(v, 18) == ref.f12_frob(x)
        assert _f12(v, 30) == ref.f12_inv(x)
        dbl, add = ref.g2_add(q, q), ref.g2_add(q, qa)
        for off, want_pt in ((42, dbl), (60, add), (78, dbl), (84, add)):
            assert _affine(*(tuple(v[off + 2 * j:off + 2 * j + 2])
                             for j in range(3))) == want_pt, off


def _pairs(seed, n):
    """n pairs: (G1, G2) first, then random multiples."""
    rng = random.Random(seed)
    out = [(ref.G1, G2)]
    for _ in range(n - 1):
        out.append((ref.g1_mul(rng.randrange(2, ref.R), ref.G1),
                    ref.g2_mul(rng.randrange(2, ref.R), G2)))
    return out


def _run_miller(core, staged, loop, rev=0):
    pts = np.ascontiguousarray(np.stack(staged[:6]))
    mask = np.ascontiguousarray(staged[6].astype(np.uint8))
    B = pts.shape[1]
    out = np.zeros((12, B, dev.L), np.int32)
    bits = bin(loop)[3:]
    rest = int(bits, 2)
    _call(core.h_miller, pts, mask, CONSTS, out, B, rest & 0xFFFFFFFF,
          rest >> 32, len(bits), rev)
    return out


def test_miller_lane_matches_plain_and_mask(core):
    _check_miller_lane(core, 0)


def _check_miller_lane(core, rev):
    staged = dev.stage_pairs(_pairs(382, 3))          # 4 lanes, 1 masked
    out = _run_miller(core, staged, SMALL_LOOP, rev)
    st = dev.to_device(staged, "cpu")
    plain = dev.miller_loop_batch(st[0], st[1], ((st[2], st[3]),
                                                 (st[4], st[5])),
                                  loop=SMALL_LOOP, mask=st[6])
    np.testing.assert_array_equal(
        out, dev.F.canonical(tower.flat_from_f12(plain)).numpy())
    assert dev.f12_from_device(tower.f12_from_flat(
        torch.as_tensor(out[:, 3:])))[0] == ref.F12_ONE


def _is_monomial_3k(el) -> bool:
    """A single nonzero Fp2 coefficient, on w^0 or w^3 (flat slots 0 and
    4 of (d0.c0, d0.c1, d0.c2, d1.c0, d1.c1, d1.c2))."""
    coeffs = [c for half in el for c in half]
    nz = [i for i, c in enumerate(coeffs) if c != ref.F2_ZERO]
    return len(nz) == 1 and nz[0] in (0, 4)


def test_full_miller_lane_matches_ref_up_to_monomial(core):
    _check_full_miller(core, 0)


def _check_full_miller(core, rev):
    pairs = _pairs(383, 2)
    out = _run_miller(core, dev.stage_pairs(pairs), ref.X_BLS, rev)
    got = dev.f12_from_device(tower.f12_from_flat(torch.as_tensor(out)))
    for i, (p, q) in enumerate(pairs):
        ratio = ref.f12_mul(got[i], ref.f12_inv(ref.miller_loop(q, p)))
        assert _is_monomial_3k(ratio), i


def test_reduce_lane_matches_plain(core):
    """The one-launch reduce's groups on 8 lanes against the plain halving
    product, limb for limb after canonical."""
    _check_reduce(core, 8, 0, 0)


@pytest.mark.parametrize("B", [2, 4, 8])
@pytest.mark.parametrize("rev,order", [(0, 0), (1, 1)])
def test_reduce_groups_in_any_order(core, B, rev, order):
    """The one-launch reduce's groups (a node of the product tree each, the
    second to reach a node carrying on) against the plain halving product,
    limb for limb after canonical: groups first to last with each round's
    jobs in order, and groups last to first with the jobs reversed; the
    arrival counters are zero again afterwards, ready for the next call."""
    _check_reduce(core, B, rev, order)


def _check_reduce(core, B, rev, order):
    rng = random.Random(384 + B)
    f = np.stack([np.stack([dev.F.to_mont(rng.randrange(P))
                            for _ in range(B)]) for _ in range(12)])
    buf = np.ascontiguousarray(f.astype(np.int32))
    cnt = np.zeros(B, np.int32)
    _call(core.h_reduce, buf, CONSTS, cnt, B, rev, order)
    plain = dev.product_reduce(tower.f12_from_flat(torch.as_tensor(f)))
    np.testing.assert_array_equal(
        buf[:, :1], dev.F.canonical(tower.flat_from_f12(plain)).numpy())
    assert not cnt.any()            # left zero for the next launch


def test_final_exp_lane_full_program_matches_chain(core):
    """The full HHT program on two lanes, through the cooperative body
    with its squarings cyclotomic from the easy part on: a random Fp12
    (GT value equal to final_exponentiation_chain exactly) and a pairing
    product that is one (e(sig, -G2) e(H(m), pk): verdict true)."""
    _check_final_exp(core, 0)


@pytest.mark.parametrize("body", ["miller", "full_miller", "final_exp"])
def test_coop_bodies_in_reverse_job_order(core, body):
    """The three tests above with every round's jobs run last to first:
    the same values, so no job of a round reads what another job of it
    writes."""
    {"miller": _check_miller_lane, "full_miller": _check_full_miller,
     "final_exp": _check_final_exp}[body](core, 1)


def _check_final_exp(core, rev):
    rng = random.Random(385)
    sk, pk = ref.bls_keygen(b"host lane")
    sig = ref.bls_sign(sk, b"m")
    one = ref.f12_mul(ref.miller_loop(ref.g2_neg(G2), sig),
                      ref.miller_loop(pk, ref.hash_to_g1(b"m")))
    rnd = tuple(tuple((rng.randrange(P), rng.randrange(P))
                      for _ in range(3)) for _ in range(2))
    vals = [rnd, one]
    f = np.stack([np.stack([dev.F.to_mont(c) for c in
                            [x for half in v for f2 in half for x in f2]])
                  for v in vals], axis=1)                    # (12, 2, L)
    prog = dev._FINAL_EXP_PROGRAM
    gt = np.zeros((12, 2, dev.L), np.int32)
    ok = np.zeros(2, np.uint8)
    _call(core.h_final_exp, np.ascontiguousarray(f), CONSTS,
          np.ascontiguousarray(prog), len(prog), dev.cyclotomic_row(prog),
          gt, ok, 2, rev)
    got = dev.f12_from_device(tower.f12_from_flat(torch.as_tensor(gt)))
    assert got[0] == ref.final_exponentiation_chain(rnd)
    assert got[1] == ref.F12_ONE
    assert ok.tolist() == [0, 1]


def _cyclotomic(f):
    """f^((p^6 - 1)(p^2 + 1)): the easy part, into the cyclotomic
    subgroup."""
    m = ref.f12_mul(ref.f12_conj(f), ref.f12_inv(f))
    return ref.f12_mul(ref._frob2(m), m)


def _flat(el):
    return [x for half in el for f2 in half for x in f2]


def _coop_cases(seed):
    """Cooperative self-test cases: x's first coefficient runs over the
    edge operands (0 too: its inverse is 0), the rest seeded random."""
    rng = random.Random(seed)
    cases = []
    for e in EDGES:
        x = [e % P] + [rng.randrange(P) for _ in range(11)]
        y = [rng.randrange(P) for _ in range(12)]
        line = [rng.randrange(P) for _ in range(6)]
        c = _cyclotomic(_f12([rng.randrange(P) for _ in range(12)], 0))
        cases.append(x + y + line + _flat(c))
    return cases


@pytest.fixture(scope="module")
def coop_cases():
    """The cases, their words and the plain tower's rows (shared by both
    orders)."""
    cases = _coop_cases(386)
    cw = np.stack([_words(c).reshape(-1) for c in cases])
    return cases, cw, dev.coop_selftest_plain(
        torch.from_numpy(cw.view(np.int32))).numpy()


@pytest.mark.parametrize("rev", [0, 1])
def test_coop_formulas_match_plain_and_ints(core, coop_cases, rev):
    """The serial formulas (f12_sqr, f12_mul_line, f12_sqr_cyclotomic) and
    the group's squaring, sparse line product, cyclotomic squaring,
    product, inverse and Frobenius against the plain tower and the int
    tower's dense product, inverse and Frobenius; the binary Euclid
    inverse of x's first coefficient against Fermat's and pow(a, p - 2)
    on the edge operands."""
    cases, cw, want = coop_cases
    out = np.zeros((len(cases), NW * dev.COOP_OUT + dev.COOP_CYCLES),
                   np.uint32)
    _call(core.h_coop, cw, CONSTS, len(cases), out, rev)
    np.testing.assert_array_equal(out.astype(np.int64), want)
    for row, vals in zip(out, cases):
        v = _ints(row[:NW * dev.COOP_OUT])
        x, y, c = _f12(vals, 0), _f12(vals, 12), _f12(vals, 30)
        A, B, C = (tuple(vals[24 + 2 * i:26 + 2 * i]) for i in range(3))
        line = ((C, B, ref.F2_ZERO), (ref.F2_ZERO, A, ref.F2_ZERO))
        x2, xl, c2 = (ref.f12_mul(x, x), ref.f12_mul(x, line),
                      ref.f12_mul(c, c))
        for off, want_el in ((0, x2), (12, x2), (24, xl), (36, xl),
                             (48, c2), (60, c2), (72, ref.f12_mul(x, y)),
                             (84, ref.f12_inv(x)), (96, ref.f12_frob(x))):
            assert _f12(v, off) == want_el, off
        a = vals[0] % P
        assert v[108] == v[109] == pow(a, P - 2, P)
