"""The CUDA kernels' P-256 field core, built by the host C++ compiler.

fabric_tpu_torch/csrc/p256_field.cuh is portable C++ behind CUDA's
execution-space keywords, so the host compiler builds it here behind the
stand-in tests/cuda_host/cuda_runtime.h, and the same per-case bodies the
card's self-test kernel runs (fe_selftest_ops, fe_selftest_add) are held
to Python ints: mul, add, sub and the conversion from the port's 13-bit
semi-reduced limbs on edge operands (0, 1, p - 1, p, p + 1, 2^256 - 1,
2^256 + 2^243 - 1, every 32-bit word boundary, limbs at 2^13) and seeded
random ones, and RCB15 Alg. 4 against p256.cadd_int on P + P, P + (-P),
P + inf and inf + inf, and the ladder's doubling (pt_dbl, RCB15 Alg. 6)
against p256.cdbl_int on G, -G, inf, a point with Y = 0 and seeded random
points; every pair of the carry-edge operands (ptree.CARRY_EDGES), where
the card's PTX carry chains carry through every word. Tolerance: exact
words. The nvcc build of the same
header is held to the same ints on the card (tests/test_torch_cuda.py,
chip_smoke.py field_vs_ints).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_tpu_torch.ops import limb, p256, ptree

P = p256.P
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "fabric_tpu_torch", "csrc")

HARNESS = r"""
#include "cuda_runtime.h"
#include "p256_field.cuh"

extern "C" void field_ops(const int* a13, const int* b13, int n,
                          uint32_t* out) {
  for (int i = 0; i < n; ++i)
    fe_selftest_ops(a13 + 20 * i, b13 + 20 * i, out + 32 * i);
}

extern "C" void field_add(const int* p13, const int* q13, int n,
                          uint32_t* out) {
  for (int i = 0; i < n; ++i)
    fe_selftest_add(p13 + 60 * i, q13 + 60 * i, out + 24 * i);
}

extern "C" void field_dbl(const int* p13, const int* unused, int n,
                          uint32_t* out) {
  for (int i = 0; i < n; ++i) fe_selftest_dbl(p13 + 60 * i, out + 24 * i);
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """The header built into a shared library by the host compiler."""
    cxx = next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                if c and shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("p256_field")
    src, so = d / "harness.cpp", d / "libp256_field.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    "-I", os.path.join(HERE, "cuda_host"), "-I", CSRC,
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    for fn in (lib.field_ops, lib.field_add, lib.field_dbl):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = None
    return lib


def _run(fn, x13, y13, width):
    x13 = np.ascontiguousarray(x13, np.int32)
    y13 = np.ascontiguousarray(y13, np.int32)
    out = np.zeros((len(x13), width), np.uint32)
    fn(x13.ctypes.data, y13.ctypes.data, len(x13), out.ctypes.data)
    return out


def _ints(words) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(words[k:k + 8]))
            for k in range(0, len(words), 8)]


def _semi(x: int, rng) -> np.ndarray:
    """A 13-bit semi-reduced form of x: canonical limbs with some limbs
    raised to 2^13 + v by borrowing one from the next limb."""
    lm = limb.int_to_limbs(x).astype(np.int64)
    for i in range(limb.L - 1):
        if lm[i + 1] > 0 and lm[i] == 0 and rng.random() < 0.5:
            lm[i + 1] -= 1
            lm[i] += 1 << limb.W
    assert limb.limbs_to_int(lm) == x and lm.max() <= 1 << limb.W
    return lm.astype(np.int32)


EDGES = [0, 1, P - 1, P, P + 1, (1 << 256) - 1, (1 << 256) + (1 << 243) - 1,
         (1 << 256) - P, P - (1 << 32), 1 << 255]
EDGES += [(1 << (32 * k)) + d for k in range(1, 8) for d in (-1, 0)]


def test_ops_match_ints(core):
    rng = np.random.default_rng(2026)
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(300)]
    rand += [int.from_bytes(rng.bytes(32), "big") % P for _ in range(100)]
    pairs = [(a, b) for a in EDGES for b in EDGES]
    pairs += list(zip(rand, rand[::-1]))
    a13 = np.stack([_semi(a, rng) for a, _ in pairs])
    b13 = limb.ints_to_limbs([b for _, b in pairs])
    out = _run(core.field_ops, a13, b13, 32)
    for (a, b), row in zip(pairs, out):
        got = _ints(row)
        want = [a % P, (a + b) % P, (a - b) % P, a * b % P]
        assert got == want, (hex(a), hex(b))
    # the self-test's plain version is the same Python ints
    plain_ops, _ = ptree.field_selftest_plain(
        torch.as_tensor(a13), torch.as_tensor(b13),
        torch.zeros((0, 60), dtype=torch.int32),
        torch.zeros((0, 60), dtype=torch.int32))
    np.testing.assert_array_equal(plain_ops.numpy(), out.astype(np.int64))


def test_carry_edges_match_ints(core):
    """Every pair of ptree.CARRY_EDGES (words of all ones at each
    position, all ones above each word boundary, p - 1, 2^256 - 1, d and
    its small multiples), the operands where the card's PTX carry chains
    carry or borrow through every word: mod p, add, sub and mul against
    Python ints and the self-test's plain version."""
    edges = ptree.CARRY_EDGES
    pairs = [(a, b) for a in edges for b in edges]
    a13 = limb.ints_to_limbs([a for a, _ in pairs])
    b13 = limb.ints_to_limbs([b for _, b in pairs])
    out = _run(core.field_ops, a13, b13, 32)
    for (a, b), row in zip(pairs, out):
        assert _ints(row) == [a % P, (a + b) % P, (a - b) % P, a * b % P], (
            hex(a), hex(b))
    plain_ops, _ = ptree.field_selftest_plain(
        torch.as_tensor(a13), torch.as_tensor(b13),
        torch.zeros((0, 60), dtype=torch.int32),
        torch.zeros((0, 60), dtype=torch.int32))
    np.testing.assert_array_equal(plain_ops.numpy(), out.astype(np.int64))


def test_conversion_takes_every_limb_at_2_13(core):
    """Limbs of exactly 2^13 at every position, up to the largest
    semi-reduced value: the carry into the next limb lands right."""
    forms = []
    for i in range(limb.L - 1):
        lm = np.zeros(limb.L, np.int32)
        lm[i] = 1 << limb.W
        forms.append(lm)
    top = np.full(limb.L, (1 << limb.W) - 1, np.int32)
    top[18], top[19] = 511, 512                 # 2^256 + 2^243 - 1
    forms.append(top)
    a13 = np.stack(forms)
    one = limb.ints_to_limbs([1] * len(forms))
    out = _run(core.field_ops, a13, one, 32)
    for lm, row in zip(a13, out):
        a = limb.limbs_to_int(lm)
        assert _ints(row)[0] == a % P and _ints(row)[3] == a % P


def _rows(points) -> np.ndarray:
    return np.stack([np.concatenate([limb.int_to_limbs(c % P) for c in q])
                     for q in points])


def test_alg4_add_matches_group_law(core):
    g = (p256.GX, p256.GY, 1)
    inf, neg_g = (0, 1, 0), (p256.GX, P - p256.GY, 1)
    pts = [p256.scalar_mul_int(k, g) for k in (2, 3, 7, 12345, p256.N - 1)]
    rng = np.random.default_rng(7)
    s = int.from_bytes(rng.bytes(32), "big") % P
    scaled = tuple(c * s % P for c in pts[2])      # another representative
    cases = [(g, g), (g, neg_g), (g, inf), (inf, g), (inf, inf),
             (scaled, pts[2]), (scaled, (pts[2][0], P - pts[2][1], pts[2][2]))]
    cases += [(a, b) for a in pts for b in pts]
    out = _run(core.field_add, _rows(a for a, _ in cases),
               _rows(b for _, b in cases), 24)
    for (a, b), row in zip(cases, out):
        got = tuple(_ints(row))
        assert got == p256.cadd4_int(tuple(c % P for c in a),
                                     tuple(c % P for c in b))
        assert p256.to_affine_int(got) == p256.to_affine_int(
            p256.cadd_int(a, b))
    # P + (-P) and inf + inf land at infinity: Z = 0, Y != 0
    for k in (1, 4, 6):
        assert _ints(out[k])[2] == 0 and _ints(out[k])[1] != 0


def test_alg6_dbl_matches_cdbl_int(core):
    """pt_dbl, step for step cdbl_int: canonical words equal on G, -G,
    inf, (x, 0, 1) (2-torsion shape), another representative of a point
    and seeded random points; the affine doubling equals cadd_int(P, P)."""
    from fabric_tpu_torch.ops import verify

    g = (p256.GX, p256.GY, 1)
    rng = np.random.default_rng(8)
    s = int.from_bytes(rng.bytes(32), "big") % P
    pts = [g, (p256.GX, P - p256.GY, 1), (0, 1, 0), (p256.GX, 0, 1),
           tuple(c * s % P for c in g)]
    pts += [p256.scalar_mul_int(int(k), g)
            for k in rng.integers(1, 1 << 62, size=24)]
    p13 = _rows(pts)
    out = _run(core.field_dbl, p13, p13, 24)
    for pt, row in zip(pts, out):
        got = tuple(_ints(row))
        assert got == p256.cdbl_int(tuple(c % P for c in pt))
        assert p256.to_affine_int(got) == p256.to_affine_int(
            p256.cadd_int(pt, pt))
    plain = verify.dbl_selftest_plain(torch.as_tensor(p13))
    np.testing.assert_array_equal(plain.numpy(), out.astype(np.int64))
