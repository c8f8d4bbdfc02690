"""The Ed25519 kernel's field, group law and lane body, built by the host
C++ compiler.

fabric_tpu_torch/csrc/fe25519.cuh (the field mod 2^255 - 19 on 32-bit
limbs, its squaring, and ref10's point representations: the P2 doubling,
the cached and the Niels mixed additions) and ed25519.cuh (the kernel's
lane body: [k](-A) on signed radix-16 digits, [S]B by Niels entries) are
portable C++ behind CUDA's execution-space keywords, so the host compiler
builds them here behind the stand-in tests/cuda_host/cuda_runtime.h, and
the same per-case bodies the card's self-test kernel runs
(f25_selftest_ops, ed_selftest) are held to Python ints: add, sub, mul,
sqr and the canonical form on edge operands (0, 1, p - 1, p, p + 1,
2^255 - 1, 2^256 - 1, 2p, 2p + 37 and every 32-bit word boundary) and
seeded random ones; the group law word for word against ops/ed25519.py's
int mirror of the formulas and as points against ed25519_host on B, the
identity, a small-order point, P + P, P + (-P) and random points; [k]P by
the signed digits against ed25519_host.scalar_mult on edge scalars (0,
1, digits of -8 and of 7, a top digit that a carry reaches, L - 1); the
lane body against ed25519_host.verify on signed, tampered and edge lanes
(S = 0, k = 0, RFC 8032 test 1, dead lanes, those edge scalars, an
identity R). Tolerance: exact words. The nvcc build is held to the same
ints on the card (tests/test_torch_cuda.py, chip_smoke.py field_vs_ints).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_tpu_torch.bccsp import ed25519_host as edh
from fabric_tpu_torch.ops import ed25519

P = edh.P
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "fabric_tpu_torch", "csrc")

HARNESS = r"""
#include "cuda_runtime.h"
#include "ed25519.cuh"

extern "C" void h_f25(const uint32_t* a, const uint32_t* b, int n,
                      uint32_t* out) {
  for (int i = 0; i < n; ++i)
    f25_selftest_ops(a + 8 * i, b + 8 * i, out + F25_SELFTEST_OUT * i);
}

extern "C" void h_ed(const uint32_t* p, const uint32_t* q, int n,
                     uint32_t* out) {
  for (int i = 0; i < n; ++i)
    ed_selftest(p + 32 * i, q + 32 * i, out + ED_SELFTEST_OUT * i);
}

extern "C" void h_mul_digits(const uint32_t* k, const uint32_t* x,
                             const uint32_t* y, int n, uint32_t* out) {
  for (int i = 0; i < n; ++i)
    ed_mul_digits_words(k + 8 * i, x + 8 * i, y + 8 * i, out + 32 * i);
}

extern "C" void h_verify(const uint8_t* s8, const uint8_t* k8,
                         const uint8_t* anx8, const uint8_t* ay8,
                         const uint8_t* rx8, const uint8_t* ry8,
                         const uint8_t* premask, const uint32_t* tab,
                         uint8_t* out, int B) {
  for (int b = 0; b < B; ++b)
    ed25519_lane(b, s8, k8, anx8, ay8, rx8, ry8, premask, tab, out);
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    cxx = next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                if c and shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("fe25519")
    src, so = d / "harness.cpp", d / "libfe25519.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-Wno-unknown-pragmas",
                    "-I", os.path.join(HERE, "cuda_host"), "-I", CSRC,
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _words(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32)


def _call(fn, *arrays, n, width):
    out = np.zeros((n, width), np.uint32)
    fn(*(ctypes.c_void_p(np.ascontiguousarray(a).ctypes.data)
         for a in arrays), ctypes.c_int(n), ctypes.c_void_p(out.ctypes.data))
    return out


EDGES = [0, 1, P - 1, P, P + 1, (1 << 255) - 1, (1 << 256) - 1, 2 * P,
         2 * P + 37, 38, (1 << 256) - 38]
EDGES += [(1 << (32 * k)) + d for k in range(1, 8) for d in (-1, 0)]


def test_field_ops_match_ints(core):
    rng = np.random.default_rng(2025)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(300)]
    pairs = [(a, b) for a in EDGES for b in EDGES]
    pairs += list(zip(rand, rand[::-1]))
    a, b = _words(x for x, _ in pairs), _words(y for _, y in pairs)
    out = _call(core.h_f25, a, b, n=len(pairs), width=40)
    want = ed25519.f25_selftest_plain(torch.from_numpy(a.view(np.int32)),
                                      torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(out.astype(np.int64), want.numpy())
    # the plain version is the Python ints it claims
    got0 = [sum(int(w) << (32 * i) for i, w in enumerate(out[0][8 * k:
                                                                8 * k + 8]))
            for k in range(5)]
    assert got0 == [0, 0, 0, 0, 0]


def _pt_words(points) -> np.ndarray:
    return np.concatenate([_words([c % P for c in p]).reshape(1, 32)
                           for p in points])


def _affine(p):
    return edh.from_affine(*edh.to_affine(p))


def _ints(row, n):
    return [sum(int(w) << (32 * i) for i, w in enumerate(row[8 * k:
                                                              8 * k + 8]))
            for k in range(n)]


def test_group_law_matches_host(core):
    """The cached addition, the P2 doubling, the Niels mixed addition and
    the subtraction word for word against the int mirror of the kernel's
    formulas, and as points against ed25519_host's group law (p in any
    projective representative, q affine)."""
    rng = np.random.default_rng(3)
    Bp = edh.from_affine(edh.BX, edh.BY)
    Q = _affine(edh.scalar_mult(31337, Bp))
    negQ = ((P - Q[0]) % P, Q[1], Q[2], (P - Q[3]) % P)
    small = (0, P - 1, 1, 0)
    s = int.from_bytes(rng.bytes(32), "little") % P
    scaled = tuple(c * s % P for c in Q)       # another representative
    rand = [edh.scalar_mult(int(k), Bp)
            for k in rng.integers(1, 1 << 62, size=16)]
    cases = [(Bp, Q), (Q, Q), (Q, negQ), (Bp, edh._IDENT), (small, Bp),
             (small, small), (edh._IDENT, edh._IDENT), (scaled, Q),
             (scaled, negQ)]
    cases += [(p, _affine(q)) for p, q in zip(rand, rand[::-1])]
    pw = _pt_words(p for p, _ in cases)
    qw = _pt_words(q for _, q in cases)
    out = _call(core.h_ed, pw, qw, n=len(cases), width=128)
    want = ed25519.ed_selftest_plain(torch.from_numpy(pw.view(np.int32)),
                                     torch.from_numpy(qw.view(np.int32)))
    np.testing.assert_array_equal(out.astype(np.int64), want.numpy())
    for (p, q), row in zip(cases, out):
        got = _ints(row, 16)
        neg = ((P - q[0]) % P, q[1], q[2], (P - q[3]) % P)
        for k, pt in enumerate((edh.pt_add(p, q), edh.pt_double(p),
                                edh.pt_add(p, q), edh.pt_add(p, neg))):
            assert edh.pt_equal(tuple(got[4 * k:4 * k + 4]), pt), k
            assert got[4 * k + 3] * got[4 * k + 2] % P \
                == got[4 * k] * got[4 * k + 1] % P            # T = XY/Z


# scalars whose signed digits (k + 0x88...8, nibble by nibble, less 8) hit
# the edges: 0 (every digit -8 but the carried ones), 1, 8 (digit 0 is -8),
# 0x0808...08 (digits -8 and 1 alternating: the table's 8 * P), 0x0F0F...0F
# (digits 7 and 1), 2^252 - 1 (every carry reaches the top digit, 1) and
# L - 1
EDGE_K = [0, 1, 8, int("08" * 31, 16), int("0F" * 31, 16), (1 << 252) - 1,
          edh.L - 1]


def test_signed_digit_mul_matches_ints(core):
    """[k]P by the lane's signed radix-16 digits and cached table against
    ed25519_host.scalar_mult, on the edge scalars and seeded random ones
    below L, for B, a small-order point and a random point."""
    rng = np.random.default_rng(5)
    Bp = edh.from_affine(edh.BX, edh.BY)
    pts = [edh.to_affine(Bp), (0, P - 1),
           edh.to_affine(edh.scalar_mult(987654321, Bp))]
    ks = EDGE_K + [int.from_bytes(rng.bytes(32), "little") % edh.L
                   for _ in range(4)]
    cases = [(k, pt) for pt in pts for k in ks]
    out = _call(core.h_mul_digits, _words(k for k, _ in cases),
                _words(pt[0] for _, pt in cases),
                _words(pt[1] for _, pt in cases), n=len(cases), width=32)
    for (k, pt), row in zip(cases, out):
        want = edh.scalar_mult(k, edh.from_affine(*pt))
        assert edh.pt_equal(tuple(_ints(row, 4)), want), (k, pt)


def test_lane_body_matches_host_verify(core):
    """The kernel's lane body on the kernel's table layout: signed and
    tampered lanes, S = 0 and k = 0 with R made to match, RFC 8032 test
    1, all-identity operands, a dead lane, R off by one point, the signed
    digits' edge scalars as k, and an identity R."""
    rng = np.random.default_rng(4)
    Bp = edh.from_affine(edh.BX, edh.BY)
    seeds = [rng.bytes(32) for _ in range(3)]
    ops, want = [], []
    for i in range(9):
        msg = rng.bytes(int(rng.integers(0, 200)))
        pk = edh.public_from_seed(seeds[i % 3])
        sig = edh.sign(seeds[i % 3], msg)
        if i % 4 == 1:
            msg += b"x"
        ops.append(edh.prep_verify(pk, sig, msg))
        want.append(edh.verify(pk, sig, msg))
    seed = bytes.fromhex("9d61b19deffd5a60ba844af492ec2cc4"
                         "4449c5697b326919703bac031cae7f60")
    pk = edh.public_from_seed(seed)
    ops.append(edh.prep_verify(pk, edh.sign(seed, b""), b""))
    want.append(True)
    a = edh.to_affine(edh.scalar_mult(99, Bp))
    neg_a = ((P - a[0]) % P, a[1])
    k, s = 12345678901234567890, 98765432109876543210
    r = edh.to_affine(edh.scalar_mult(k, edh.from_affine(*neg_a)))
    ops.append((0, k, *neg_a, *r))
    r = edh.to_affine(edh.scalar_mult(s, Bp))
    ops.append((s, 0, *neg_a, *r))
    ops.append((0, 0, 0, 1, 0, 1))
    r = edh.to_affine(edh.pt_add(edh.scalar_mult(s, Bp), Bp))
    ops.append((s, 0, *neg_a, *r))
    want += [True, True, True, False]
    ops.append(None)                            # dead: identity, premask off
    want.append(False)
    # the signed digits' edge scalars as k, R made to match, and one lane
    # off by B; an identity R: S = k * a, so [S]B + [k](-A) is the identity
    for ke in EDGE_K:
        re = edh.pt_add(edh.scalar_mult(s, Bp), edh.scalar_mult(
            ke, edh.from_affine(*neg_a)))
        ops.append((s, ke, *neg_a, *edh.to_affine(re)))
        want.append(True)
    ops.append((s, EDGE_K[-1], *neg_a, *edh.to_affine(edh.pt_add(re, Bp))))
    want.append(False)
    ops.append((k * 99 % edh.L, k, *neg_a, 0, 1))
    want.append(True)
    n = 32
    rows = [np.ascontiguousarray(x) for x in ed25519.stage_rows(ops, n)]
    rows[6] = rows[6].astype(np.uint8)
    tab = ed25519.kernel_table(torch.as_tensor(ed25519.b_tables())).numpy()
    out = np.zeros(n, np.uint8)
    core.h_verify(*(ctypes.c_void_p(x.ctypes.data) for x in (*rows, tab,
                                                             out)),
                  ctypes.c_int(n))
    assert out.astype(bool).tolist() == want + [False] * (n - len(want))
