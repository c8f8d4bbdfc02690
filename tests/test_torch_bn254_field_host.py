"""The BN254 kernels' field core, tower, cooperative bodies and lane
bodies, built by the host C++ compiler.

fabric_tpu_torch/csrc/bn254_field.cuh (Montgomery arithmetic mod BN254's p
on 8 x 32-bit words, Fermat's and the binary Euclid inverse),
bn254_tower.cuh (Fp2/Fp6/Fp12, Frobenius, inversions, the RCB15 twist
steps and their D-type lines, and the formulas the cooperative layer
distributes: the Karatsuba product, the complex squaring, the sparse line
product, the cyclotomic squaring), pairing_coop.cuh (a lane over a group
of threads, instantiated for BnTower) and bn254_pairing.cuh (the serial
lanes, the G2 MSM lane and the cooperative self-test) are portable C++
behind CUDA's execution-space keywords, so the host compiler builds them
here behind the stand-in tests/cuda_host/cuda_runtime.h. The host runs a
group's rounds on one thread, each round's jobs first to last and last to
first (`rev`): both orders must give the plain values, which a round
reading another job's output of the same round would not; it also runs
one pad lane past B, which must store nothing. Held to Python ints and to
the plain torch versions (ops/bn254.py): the field ops on edge operands
(0, 1, p - 1, p, p + 1, 2p - 1) and seeded random ones below 2p, the
binary Euclid inverse among them; Fp2 mul/sqr/inv, Fp12 mul, Frobenius
and inverse, the twist doubling and addition with their lines (points
also held to the int group law); the serial formulas and the group's
squaring, sparse line product, cyclotomic squaring, product, inverse and
Frobenius; the cooperative Miller body at a truncated loop against the
plain version and over the full loop against bn254_ref (the same pairing
after the final exponentiation); the cooperative final-exp body on a
short program with two terms against the plain version and on the full
program against bn254_ref.final_exponentiation_chain, with its identity
verdict on a product that is one; the serial lanes on the same inputs;
the MSM threads (joint tables, one projective addition a bit and window)
on 8-bit scalars with Q + Q, Q + (-Q), k = 0, an all-zero lane and a sum
at infinity, with three and five terms, word for word against the plain
chain (ops/bn254.py g2_msm_chain), and on full-width scalars with the
subgroup lane's 127-bit 6x^2 against the int MSM. Tolerance: exact words and limbs. The nvcc build is held to the
same on the card (tests/test_torch_cuda.py, chip_smoke.py field_vs_ints
and pairing_vs_plain).
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

using namespace bn254;

static BnConsts consts_of(const uint32_t* w) {
  BnConsts k;
  memcpy(&k, w, sizeof(k));
  return k;
}

extern "C" void h_fp(const uint32_t* a, const uint32_t* b,
                     const uint32_t* c, int n, uint32_t* out) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < n; ++i)
    bn_fp_selftest(a + 8 * i, b + 8 * i, k.r2, out + 48 * i);
}

extern "C" void h_tower(const uint32_t* cases, const uint32_t* c, int n,
                        uint32_t* out) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < n; ++i)
    bn_tower_selftest(cases + 8 * BN_TOWER_IN * i, k,
                      out + 8 * BN_TOWER_OUT * i);
}

// the cooperative bodies: one host thread runs each round's jobs, first
// to last or (rev) last to first, for lanes 0..B (lane B a pad lane)
extern "C" void h_miller(const int* pts, const uint32_t* c, int* out, int B,
                         int lo, int hi, int nbits, int rev) {
  const BnConsts k = consts_of(c);
  static coop::MillerState<BnTower> st;
  const coop::Group g{0, 1, rev != 0};
  for (int i = 0; i <= B; ++i)
    coop::miller_group<BnTower>(g, st, pts, nullptr, B, i, (uint32_t)lo,
                                (uint32_t)hi, nbits, k, out);
}

extern "C" void h_final_exp(const int* f, const uint32_t* c, const int* prog,
                            int nrows, int cyc_from, int* gt, uint8_t* ok,
                            int nterms, int B, int rev) {
  const BnConsts k = consts_of(c);
  static coop::FinalExpState<BnTower> st;
  const coop::Group g{0, 1, rev != 0};
  for (int i = 0; i <= B; ++i)
    coop::final_exp_group<BnTower>(g, st, f, B, i, prog, nrows, cyc_from, k,
                                   gt, ok, nterms);
}

extern "C" void h_coop(const uint32_t* cases, const uint32_t* c, int n,
                       uint32_t* out, int rev) {
  const BnConsts k = consts_of(c);
  static CoopState st;
  const coop::Group g{0, 1, rev != 0};
  for (int i = 0; i < n; ++i)
    coop_selftest_group(g, st, cases + NW * COOP_IN * i, k,
                        out + (NW * COOP_OUT + COOP_CYCLES) * i);
}

// the serial lanes (the serial entries' bodies)
extern "C" void h_miller_serial(const int* pts, const uint32_t* c, int* out,
                                int B, int lo, int hi, int nbits) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < B; ++i)
    bn_miller_lane(pts, B, i, (uint32_t)lo, (uint32_t)hi, nbits, k, out);
}

extern "C" void h_final_exp_serial(const int* f, const uint32_t* c,
                                   const int* prog, int nrows, int cyc_from,
                                   int* gt, uint8_t* ok, int nterms, int B) {
  const BnConsts k = consts_of(c);
  for (int i = 0; i < B; ++i)
    bn_final_exp_lane(f, nterms, B, i, prog, nrows, cyc_from, k, gt, ok);
}

// the MSM entry's threads for lanes 0..B (lane B a pad lane), each lane
// a warp of its own (it starts at its own top bit), on the kernel's two
// instances: up to three terms the table in local memory, more in a
// scratch buffer of bn_msm_scratch_entries(B, T) entries
extern "C" void h_msm(const uint32_t* kw, const int* q, const uint32_t* c,
                      int* out, int B, int nterms, int nbits) {
  const BnConsts k = consts_of(c);
  G2P* scratch = new G2P[bn_msm_scratch_entries(B, nterms)];
  for (int i = 0; i <= B; ++i) {
    if (nterms <= BN_MSM_WINDOW)
      bn_msm_thread<1>(kw, q, B, nterms, nbits, i, k, out);
    else
      bn_msm_thread<0>(kw, q, B, nterms, nbits, i, k, out, scratch);
  }
  delete[] scratch;
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
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall",
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
    out = np.zeros((len(pairs), dev.FP_OUT), np.uint32)
    _call(core.h_fp, a, b, CONSTS, len(pairs), out)
    want = dev.fp_selftest_plain(torch.from_numpy(a.view(np.int32)),
                                 torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(out.astype(np.int64), want.numpy())
    assert _ints(out[2]) == [0, P - 1, 1, 0, 0, 0]  # a = 0, b = p - 1
    # the binary Euclid inverse (and Fermat's) at 1 and p - 1: 1, p - 1
    assert _ints(out[6 * 1])[4:] == [1, 1]
    assert _ints(out[6 * 2])[4:] == [P - 1, P - 1]


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


def _miller_out(B):
    """An out buffer of (12, B, 20) limbs and, past it, one lane's worth
    of zeros that a pad lane's store would reach first."""
    buf = np.zeros(12 * B * 20 + 20, np.int32)
    return buf, buf[:-20].reshape(12, B, 20)


def _run_miller(core, st, loop, rev=0, serial=False):
    pts = np.ascontiguousarray(torch.stack(dev._flat_points(*st)).numpy())
    B = pts.shape[1]
    buf, out = _miller_out(B)
    bits = bin(loop)[3:]
    rest = int(bits, 2)
    if serial:
        _call(core.h_miller_serial, pts, CONSTS, out, B, rest & 0xFFFFFFFF,
              rest >> 32, len(bits))
    else:
        _call(core.h_miller, pts, CONSTS, buf, B, rest & 0xFFFFFFFF,
              rest >> 32, len(bits), rev)
        assert not buf[-20:].any()                   # the pad lane
    return out


def test_miller_lane_matches_plain(core):
    _check_miller_lane(core, 0)


def _check_miller_lane(core, rev, serial=False):
    st = _staged_points(92, 3)
    plain = dev.miller_loop_batch(*st, loop=SMALL_LOOP)
    out = _run_miller(core, st, SMALL_LOOP, rev, serial)
    np.testing.assert_array_equal(
        out, dev.F.canonical(tower.flat_from_f12(plain)).numpy())


def test_full_miller_lane_matches_ref(core):
    """The full loop with its correction steps: the same pairing as
    bn254_ref's after the final exponentiation."""
    _check_full_miller(core, 0)


def _check_full_miller(core, rev, serial=False):
    rng = random.Random(95)
    ps = [ref.G1, ref.g1_mul_fast(rng.randrange(2, ref.R), ref.G1)]
    qs = [G2, ref.g2_mul_fast(rng.randrange(2, ref.R), G2)]
    st = dev.to_device(dev.stage_g1(ps) + dev.stage_g2(qs), "cpu")
    out = _run_miller(core, st, ref.ATE_LOOP, rev, serial)
    got = dev.f12_from_device(tower.f12_from_flat(torch.as_tensor(out)))
    for i in range(2):
        assert ref.final_exponentiation_chain(got[i]) == ref.pairing(
            qs[i], ps[i]), i


def _short_program():
    A = dev._Asm()
    A.conj(2, 0)
    A.mul(2, 2, 1)
    A.frob(6, 2)
    A.frob(6, 6)
    A.mul(2, 6, 2)
    A.pow_static(3, 2, 7, 0b101)
    A.mul(0, 3, 2)
    return A.program()


def _run_final_exp(core, f, prog, nterms, rev=0, serial=False):
    B = f.shape[1] // nterms
    gbuf = np.zeros(12 * B * 20 + 20, np.int32)
    gt = gbuf[:-20].reshape(12, B, 20)
    okbuf = np.zeros(B + 1, np.uint8)
    args = (np.ascontiguousarray(f), CONSTS, np.ascontiguousarray(prog),
            len(prog), dev.cyclotomic_row(prog))
    if serial:
        _call(core.h_final_exp_serial, *args, gt, okbuf, nterms, B)
    else:
        _call(core.h_final_exp, *args, gbuf, okbuf, nterms, B, rev)
    assert not gbuf[-20:].any() and okbuf[B] == 0   # the pad lane
    return gt, okbuf[:B]


def test_final_exp_lane_matches_plain(core):
    """Two terms a lane (multiplied first), a short program with every
    op and cyclotomic squarings after its easy part, the identity verdict
    on a lane whose product is one."""
    _check_final_exp(core, 0)


def _check_final_exp(core, rev, serial=False):
    prog = _short_program()
    assert dev.cyclotomic_row(prog) == 5
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
    gt, ok = _run_final_exp(core, f.numpy(), prog, 2, rev, serial)
    np.testing.assert_array_equal(
        gt, dev.F.canonical(tower.flat_from_f12(plain)).numpy())
    assert ok.tolist() == [0, 1] == dev.gt_is_one(plain).int().tolist()


def test_final_exp_lane_full_program_matches_chain(core):
    """The full program on two lanes of two terms, squarings cyclotomic
    from the easy part on: a random product (GT value equal to
    final_exponentiation_chain exactly) and a pairing product that is one
    (e(P, Q) e(P, -Q): verdict true)."""
    _check_full_final_exp(core, 0)


def _check_full_final_exp(core, rev, serial=False):
    rng = random.Random(96)
    p = ref.g1_mul_fast(rng.randrange(2, ref.R), ref.G1)
    q = ref.g2_mul_fast(rng.randrange(2, ref.R), G2)
    rnd = [tuple(tuple((rng.randrange(P), rng.randrange(P))
                       for _ in range(3)) for _ in range(2))
           for _ in range(2)]
    one = [ref.miller_loop(q, p), ref.miller_loop(ref.g2_neg_tw(q), p)]
    terms = [rnd[0], one[0], rnd[1], one[1]]           # column t * 2 + lane
    f = np.stack([np.stack([dev.F.to_mont(c) for c in
                            [x for half in v for f2 in half for x in f2]])
                  for v in terms], axis=1)                  # (12, 4, L)
    gt, ok = _run_final_exp(core, f, dev._FINAL_EXP_PROGRAM, 2, rev, serial)
    got = dev.f12_from_device(tower.f12_from_flat(torch.as_tensor(gt)))
    assert got[0] == ref.final_exponentiation_chain(
        ref.f12_mul(rnd[0], rnd[1]))
    assert got[1] == ref.F12_ONE
    assert ok.tolist() == [0, 1]


@pytest.mark.parametrize("body", ["miller", "full_miller", "final_exp",
                                  "full_final_exp"])
def test_coop_bodies_in_reverse_job_order(core, body):
    """The cooperative bodies' tests above with every round's jobs run
    last to first: the same values, so no job of a round reads what
    another job of it writes."""
    _BODIES[body](core, 1)


@pytest.mark.parametrize("body", ["miller", "full_miller", "final_exp",
                                  "full_final_exp"])
def test_serial_lanes_match(core, body):
    """The serial entries' lanes (one thread a lane) on the same inputs."""
    _BODIES[body](core, 0, serial=True)


_BODIES = {"miller": _check_miller_lane, "full_miller": _check_full_miller,
           "final_exp": _check_final_exp,
           "full_final_exp": _check_full_final_exp}


def _cyclotomic(f):
    """f^((p^6 - 1)(p^2 + 1)): the easy part, into the cyclotomic
    subgroup."""
    m = ref.f12_mul(ref.f12_conj(f), ref.f12_inv(f))
    return ref.f12_mul(ref.f12_frob(ref.f12_frob(m)), m)


def _f12(v, o):
    return (tuple(tuple(v[o + 2 * j:o + 2 * j + 2]) for j in range(3)),
            tuple(tuple(v[o + 6 + 2 * j:o + 8 + 2 * j]) for j in range(3)))


def _flat(el):
    return [x for half in el for f2 in half for x in f2]


@pytest.fixture(scope="module")
def coop_cases():
    """Cooperative self-test cases (x's first coefficient over the edge
    operands, 0 too: its inverse is 0; the rest seeded random), their
    words and the plain tower's rows (shared by both orders)."""
    rng = random.Random(97)
    cases = []
    for e in EDGES:
        x = [e % P] + [rng.randrange(P) for _ in range(11)]
        y = [rng.randrange(P) for _ in range(12)]
        line = [rng.randrange(P) for _ in range(6)]
        c = _cyclotomic(_f12([rng.randrange(P) for _ in range(12)], 0))
        cases.append(x + y + line + _flat(c))
    cw = np.stack([_words(c).reshape(-1) for c in cases])
    return cases, cw, dev.coop_selftest_plain(
        torch.from_numpy(cw.view(np.int32))).numpy()


@pytest.mark.parametrize("rev", [0, 1])
def test_coop_formulas_match_plain_and_ints(core, coop_cases, rev):
    """The serial formulas (f12_sqr by the complex method, f12_mul_line on
    the D-type line, f12_sqr_cyclotomic) and the group's squaring, sparse
    line product, cyclotomic squaring, Karatsuba product, inverse and
    Frobenius against the plain tower and the int tower's dense product,
    inverse and Frobenius; the binary Euclid inverse of x's first
    coefficient against Fermat's and pow(a, p - 2) on the edge
    operands."""
    cases, cw, want = coop_cases
    out = np.zeros((len(cases), 8 * dev.COOP_OUT + dev.COOP_CYCLES),
                   np.uint32)
    _call(core.h_coop, cw, CONSTS, len(cases), out, rev)
    np.testing.assert_array_equal(out.astype(np.int64), want)
    for row, vals in zip(out, cases):
        v = _ints(row[:8 * dev.COOP_OUT])
        x, y, c = _f12(vals, 0), _f12(vals, 12), _f12(vals, 30)
        A, B, C = (tuple(vals[24 + 2 * i:26 + 2 * i]) for i in range(3))
        line = ((A, ref.F2_ZERO, ref.F2_ZERO), (B, C, ref.F2_ZERO))
        x2, xl, c2 = (ref.f12_mul(x, x), ref.f12_mul(x, line),
                      ref.f12_mul(c, c))
        for off, want_el in ((0, x2), (12, x2), (24, xl), (36, xl),
                             (48, c2), (60, c2), (72, ref.f12_mul(x, y)),
                             (84, ref.f12_inv(x)), (96, ref.f12_frob(x))):
            assert _f12(v, off) == want_el, off
        a = vals[0] % P
        assert v[108] == v[109] == pow(a, P - 2, P)


def _msm_host(core, lanes, nbits):
    """The host-built MSM threads on staged lanes: (6, B, 20) limbs."""
    kw, qf = dev.stage_g2_msm_words(lanes)
    B, T = len(lanes), len(lanes[0])
    q = np.ascontiguousarray(np.stack(qf))
    out = np.zeros((6, B, 20), np.int32)
    _call(core.h_msm, np.ascontiguousarray(kw), q, CONSTS, out, B, T, nbits)
    return kw, qf, out


def _msm_points(out):
    return dev.read_g2_msm(((out[0], out[1]), (out[2], out[3]),
                            (out[4], out[5])))


def test_msm_lane_matches_plain_and_ints(core):
    """The MSM thread word for word against the plain chain
    (dev.g2_msm on the CPU: g2_msm_chain) on 8-bit scalars, and its
    points against the int MSM: k = 0 lanes, Q + (-Q) (a joint-table
    entry at infinity), Q + Q (an entry that doubles), a sum at infinity
    and an all-zero lane."""
    rng = random.Random(94)
    T = ref.g2_mul_fast(31337, G2)
    lanes = [[(rng.randrange(1 << 8), G2), (rng.randrange(1 << 8), T),
              (rng.randrange(1 << 8), T)] for _ in range(3)]
    lanes += [[(0, G2), (0, None), (0, G2)],                 # k = 0: inf
              [(9, T), (0, None), (9, ref.g2_neg_tw(T))],   # Q + (-Q)
              [(1, T), (1, T), (0, None)],                  # Q + Q
              [(255, G2), (1, G2), (0, None)],              # 256 G2
              [(0, T), (1, G2), (0, None)],                 # k0
              [(0, None), (0, None), (0, None)]]            # all zero
    kw, qf, out = _msm_host(core, lanes, 8)
    plain = dev.g2_msm(torch.as_tensor(kw.view(np.int32)),
                       *[torch.as_tensor(a) for a in qf], nbits=8)
    flat = torch.stack([c for p in plain for c in p])
    np.testing.assert_array_equal(out, dev.F.canonical(flat).numpy())
    got = _msm_points(out)
    assert got == [ref.g2_msm(lane) for lane in lanes]
    assert got[3] is None and got[4] is None and got[8] is None


@pytest.mark.parametrize("nterms", [9, 17])
def test_msm_lane_beyond_local_tables(core, nterms):
    """Lanes of more terms than the kernel's local joint tables hold (the
    scratch-table instance): word for word against the plain chain and
    as points against bn254_ref.g2_msm on 8-bit scalars, with an entry
    at infinity (Q + (-Q) in one window) and an all-zero lane."""
    rng = random.Random(96 + nterms)
    T = ref.g2_mul_fast(2718, G2)
    pts = [G2, T, ref.g2_neg_tw(T)]
    lanes = [[(rng.randrange(1 << 8), pts[t % 3]) for t in range(nterms)]
             for _ in range(2)]
    lanes.append([(7, T), (7, ref.g2_neg_tw(T))]
                 + [(0, None)] * (nterms - 3) + [(1, G2)])
    lanes.append([(0, None)] * nterms)
    kw, qf, out = _msm_host(core, lanes, 8)
    plain = dev.g2_msm(torch.as_tensor(kw.view(np.int32)),
                       *[torch.as_tensor(a) for a in qf], nbits=8)
    flat = torch.stack([c for p in plain for c in p])
    np.testing.assert_array_equal(out, dev.F.canonical(flat).numpy())
    got = _msm_points(out)
    assert got == [ref.g2_msm(lane) for lane in lanes]
    assert got[2] == G2 and got[3] is None


def test_msm_lane_two_windows_and_subgroup(core):
    """Five terms (two joint tables) on 8-bit scalars word for word
    against the plain chain and the int MSM, one window's entries at
    infinity; then the subgroup lane [6x^2]T~ (127 bits, one scalar)
    beside a 254-bit three-term lane, against the int MSM and psi(T~)."""
    rng = random.Random(95)
    T = ref.g2_mul_fast(4711, G2)
    nT = ref.g2_neg_tw(T)
    lanes = [[(rng.randrange(1 << 8), q) for q in (G2, T, nT, G2, T)]
             for _ in range(2)]
    lanes += [[(0, None), (0, None), (0, None), (5, T), (5, nT)],
              [(3, T), (0, None), (0, None), (0, None), (1, G2)]]
    kw, qf, out = _msm_host(core, lanes, 8)
    plain = dev.g2_msm(torch.as_tensor(kw.view(np.int32)),
                       *[torch.as_tensor(a) for a in qf], nbits=8)
    flat = torch.stack([c for p in plain for c in p])
    np.testing.assert_array_equal(out, dev.F.canonical(flat).numpy())
    got = _msm_points(out)
    assert got == [ref.g2_msm(lane) for lane in lanes]
    assert got[2] is None
    full = [[(6 * ref.T_BN ** 2, T), (0, None), (0, None)],
            [(rng.randrange(ref.R), G2), (rng.randrange(ref.R), T),
             (ref.R - 1, T)]]
    _, _, out = _msm_host(core, full, dev.NBITS_R)
    got = _msm_points(out)
    assert got == [ref.g2_msm(lane) for lane in full]
    assert got[0] == ref.g2_frobenius_fast(T)