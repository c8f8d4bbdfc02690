"""Stage A's CUDA core, built by the host C++ compiler.

fabric_tpu_torch/csrc/modn32.cuh (the mod-n Montgomery core), sha256.cuh
and stage_a.cuh are portable C++ behind CUDA's execution-space keywords,
so the host compiler builds them here behind the stand-in
tests/cuda_host/cuda_runtime.h, and the same lane bodies the card's
kernels run (sha_windows_lane, digest_windows_lane, sha256_digest_lane,
mn_selftest) are held to hashlib, Python ints and the plain torch
versions: the mod-n products on edge operands (e = 0, n - 1, n, n + 1,
2^256 - 1; w = 1, n - 1; r = 1) and seeded random ones, the Montgomery
bound (below 2n before the one subtraction) on the extremes, SHA-256 at
the edge message lengths 0, 1, 55, 56, 63, 64, 119, 120 and 503 with
garbage past every lane's count, and the windows at 8 and 16 bits.
Tolerance: exact. The nvcc build of the same headers is held to the same
ints on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_tpu_torch.ops import fused_verify, p256, sha256

N = p256.N
R = 1 << 256
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "fabric_tpu_torch", "csrc")
EDGE_LENS = (0, 1, 55, 56, 63, 64, 119, 120, 503)

HARNESS = r"""
#include "cuda_runtime.h"
#include "stage_a.cuh"

extern "C" void h_sha_windows(const uint32_t* blocks, const int* nblocks,
                              const uint32_t* digests,
                              const uint8_t* has_digest, const uint8_t* r8,
                              const uint8_t* w8, int* w1, int* w2,
                              int64_t* words, int B, int NB, int wb) {
  for (int b = 0; b < B; ++b) {
    if (wb == 8)
      sha_windows_lane<8, 8>(b, blocks, NB, nblocks, digests, has_digest, r8,
                             w8, w1, w2, words);
    else
      sha_windows_lane<16, 16>(b, blocks, NB, nblocks, digests, has_digest,
                               r8, w8, w1, w2, words);
  }
}

extern "C" void h_digest_windows(const uint32_t* digests, const uint8_t* r8,
                                 const uint8_t* w8, int* w1, int* w2, int B,
                                 int wb) {
  for (int b = 0; b < B; ++b) {
    if (wb == 8)
      digest_windows_lane<8, 8>(b, digests, r8, w8, w1, w2);
    else
      digest_windows_lane<16, 16>(b, digests, r8, w8, w1, w2);
  }
}

extern "C" void h_sha256_digest(const uint32_t* blocks, const int* nblocks,
                                int64_t* words, int B, int NB) {
  for (int b = 0; b < B; ++b)
    sha256_digest_lane(b, blocks, NB, nblocks, words);
}

extern "C" void h_modn(const uint32_t* e, const uint8_t* r8,
                       const uint8_t* w8, int n, uint32_t* out) {
  for (int i = 0; i < n; ++i)
    mn_selftest(e + 8 * i, r8 + 32 * i, w8 + 32 * i, out + 16 * i);
}

// the CIOS loop alone: out[0:8] t, out[8] top
extern "C" void h_cios(const uint32_t* a, const uint32_t* b, int n,
                       uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    Fe x, y, t;
    for (int k = 0; k < 8; ++k) {
      x.w[k] = a[8 * i + k];
      y.w[k] = b[8 * i + k];
    }
    out[9 * i + 8] = mn_cios(t, x, y);
    for (int k = 0; k < 8; ++k) out[9 * i + k] = t.w[k];
  }
}

extern "C" void h_sha_consts(uint32_t* out) {
  for (int t = 0; t < 64; ++t) out[t] = sha_k(t);
  for (int i = 0; i < 8; ++i) out[64 + i] = sha_h0(i);
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGS = {"h_sha_windows": [_P] * 9 + [_I] * 3,
        "h_digest_windows": [_P] * 5 + [_I] * 2,
        "h_sha256_digest": [_P] * 3 + [_I] * 2,
        "h_modn": [_P] * 3 + [_I, _P],
        "h_cios": [_P, _P, _I, _P],
        "h_sha_consts": [_P]}


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """The headers built into a shared library by the host compiler."""
    cxx = next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                if c and shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("stage_a")
    src, so = d / "harness.cpp", d / "libstage_a.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    "-I", os.path.join(HERE, "cuda_host"), "-I", CSRC,
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in SIGS.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags["C_CONTIGUOUS"] and a.ctypes.data % 16 == 0
    return a.ctypes.data


def _aligned(shape, dtype) -> np.ndarray:
    """A zeroed C-contiguous array on a 16-byte boundary (the headers
    read rows as 16-byte vectors)."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    raw = np.zeros(n + 16, np.uint8)
    off = -raw.ctypes.data % 16
    return raw[off:off + n].view(dtype).reshape(shape)


def _put(a, dtype=None) -> np.ndarray:
    a = np.asarray(a, dtype=dtype)
    out = _aligned(a.shape, a.dtype)
    out[...] = a
    return out


def _be32(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(32, "big"), np.uint8)


def _be_words(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(32, "big"), ">u4").astype(np.uint32)


def _le_words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _int_le(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def _windows(u: int, wb: int) -> list[int]:
    return [(u >> (wb * k)) & ((1 << wb) - 1) for k in range(256 // wb)]


def test_sha_constants_match(core):
    out = _aligned((72,), np.uint32)
    core.h_sha_consts(_ptr(out))
    np.testing.assert_array_equal(out, sha256.sha_consts().reshape(72))


E_EDGES = [0, 1, N - 1, N, N + 1, R - 1, 1 << 255]
W_EDGES = [1, N - 1, 2, (N + 1) // 2]


def test_modn_matches_ints(core):
    """u1 = e*w and u2 = r*w mod n: every edge e against every edge w
    with r = 1, n - 1 and random r; seeded random triples; held to
    Python ints and to the self-test's plain version."""
    rng = np.random.default_rng(404)
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(60)]
    cases = [(e, r, w) for e in E_EDGES for w in W_EDGES
             for r in (1, N - 1, rand[0] % N)]
    cases += [(rand[i], rand[i + 1] % N, rand[i + 2] % N)
              for i in range(0, 57, 3)]
    e = _put(np.stack([_be_words(c[0]) for c in cases]))
    r8 = _put(np.stack([_be32(c[1]) for c in cases]))
    w8 = _put(np.stack([_be32(c[2]) for c in cases]))
    out = _aligned((len(cases), 16), np.uint32)
    core.h_modn(_ptr(e), _ptr(r8), _ptr(w8), len(cases), _ptr(out))
    for (ev, rv, wv), row in zip(cases, out):
        assert _int_le(row[:8]) == ev * wv % N, (hex(ev), hex(wv))
        assert _int_le(row[8:]) == rv * wv % N, (hex(rv), hex(wv))
    plain = fused_verify.modn_selftest_plain(
        torch.from_numpy(e.view(np.int32)), torch.from_numpy(r8),
        torch.from_numpy(w8))
    np.testing.assert_array_equal(plain.numpy(), out.astype(np.int64))


def test_montgomery_bound_below_2n(core):
    """The CIOS loop alone, a < 2^256 and b < n: t + top * 2^256 is
    a * b * R^-1 mod n and below 2n, so one subtraction suffices; the
    extremes of both operands, R^2 mod n among them."""
    rng = np.random.default_rng(405)
    aa = [0, 1, N - 1, N, R - 1, R - 2, 1 << 255] + [
        int.from_bytes(rng.bytes(32), "big") for _ in range(8)]
    bb = [0, 1, N - 1, N - 2, pow(2, 512, N), (N + 1) // 2] + [
        int.from_bytes(rng.bytes(32), "big") % N for _ in range(4)]
    pairs = [(x, y) for x in aa for y in bb]
    a = _put(np.array([_le_words(x) for x, _ in pairs], np.uint32))
    b = _put(np.array([_le_words(y) for _, y in pairs], np.uint32))
    out = _aligned((len(pairs), 9), np.uint32)
    core.h_cios(_ptr(a), _ptr(b), len(pairs), _ptr(out))
    rinv = pow(R, -1, N)
    top_seen = 0
    for (x, y), row in zip(pairs, out):
        t = _int_le(row[:8]) + (int(row[8]) << 256)
        assert t < 2 * N and row[8] <= 1, (hex(x), hex(y))
        assert t % N == x * y * rinv % N
        top_seen = max(top_seen, t)
    assert top_seen >= N                    # the subtraction is exercised


@pytest.fixture(scope="module")
def lanes():
    """B = 40 lanes at NB = 8: the edge message lengths, random ones,
    garbage past every count; digest lanes (has_digest) with digest 0,
    all-ones, n and a random one; w = 1, w = n - 1, r = 1."""
    rng = np.random.default_rng(406)
    B, nb = 40, 8
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 504, size=B)]
    for j, n in enumerate(EDGE_LENS):
        msgs[j] = rng.bytes(n)
    blocks, counts = sha256.pack_messages(msgs, nb)
    past = np.arange(nb)[None, :] >= counts[:, None]
    blocks[past] = rng.integers(0, 1 << 32, size=(int(past.sum()), 16),
                                dtype=np.uint32)
    has = np.zeros(B, bool)
    dig = np.zeros((B, 8), np.uint32)
    for i, d in ((9, 0), (10, R - 1), (11, N),
                 (12, int.from_bytes(rng.bytes(32), "big"))):
        has[i] = True
        dig[i] = _be_words(d)
    rs = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(B)]
    ws = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(B)]
    ws[13], ws[14], rs[15] = 1, N - 1, 1
    words = np.stack([np.frombuffer(hashlib.sha256(m).digest(), ">u4")
                      for m in msgs]).astype(np.uint32)
    words[has] = dig[has]
    return dict(B=B, nb=nb, blocks=_put(blocks), counts=_put(counts),
                nblocks=_put(np.where(has, 0, counts).astype(np.int32)),
                has=_put(has.astype(np.uint8)), dig=_put(dig), rs=rs,
                ws=ws, r8=_put(np.stack([_be32(x) for x in rs])),
                w8=_put(np.stack([_be32(x) for x in ws])), words=words,
                hashed=np.stack([np.frombuffer(hashlib.sha256(m).digest(),
                                               ">u4") for m in msgs]))


def _check_windows(w1, w2, words, rs, ws, wb):
    for i in range(len(rs)):
        e = int.from_bytes(words[i].astype(">u4").tobytes(), "big")
        assert w1[i].tolist() == _windows(e * ws[i] % N, wb), i
        assert w2[i].tolist() == _windows(rs[i] * ws[i] % N, wb), i


@pytest.mark.parametrize("wb", [8, 16])
def test_message_lane_matches_hashlib_and_ints(core, lanes, wb):
    """sha_windows_lane: words = hashlib's digest (or the lane's digest),
    windows = Python ints, all three = the plain torch version."""
    B, nb = lanes["B"], lanes["nb"]
    w1 = _aligned((B, 256 // wb), np.int32)
    w2 = _aligned((B, 256 // wb), np.int32)
    words = _aligned((B, 8), np.int64)
    core.h_sha_windows(*(_ptr(lanes[k]) for k in (
        "blocks", "nblocks", "dig", "has", "r8", "w8")), _ptr(w1), _ptr(w2),
        _ptr(words), B, nb, wb)
    np.testing.assert_array_equal(words, lanes["words"].astype(np.int64))
    _check_windows(w1, w2, lanes["words"], lanes["rs"], lanes["ws"], wb)
    t = torch.from_numpy
    plain = fused_verify.sha_windows_plain(
        t(lanes["blocks"].view(np.int32)), t(lanes["nblocks"]),
        t(lanes["dig"].view(np.int32)), t(lanes["has"].astype(bool)),
        t(lanes["r8"]), t(lanes["w8"]), wb, wb)
    for got, want in zip((w1, w2, words), plain):
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("wb", [8, 16])
def test_digest_lane_matches_ints(core, lanes, wb):
    """digest_windows_lane: every lane takes its digest (the message
    lanes' hashlib words, the edge digests 0, 2^256 - 1 and n)."""
    B = lanes["B"]
    dig = _put(lanes["words"])
    w1 = _aligned((B, 256 // wb), np.int32)
    w2 = _aligned((B, 256 // wb), np.int32)
    core.h_digest_windows(_ptr(dig), _ptr(lanes["r8"]), _ptr(lanes["w8"]),
                          _ptr(w1), _ptr(w2), B, wb)
    _check_windows(w1, w2, lanes["words"], lanes["rs"], lanes["ws"], wb)
    assert not w1[11].any()                         # e = n: u1 = 0
    plain = fused_verify.digest_windows_plain(
        torch.from_numpy(dig.view(np.int32)), torch.from_numpy(lanes["r8"]),
        torch.from_numpy(lanes["w8"]), wb, wb)
    for got, want in zip((w1, w2), plain):
        np.testing.assert_array_equal(got, want.numpy())


def test_digest_only_lane_matches_hashlib(core, lanes):
    """sha256_digest_lane: every lane hashed at its own count, a lane
    with no live block giving the initial state."""
    B, nb = lanes["B"], lanes["nb"]
    counts = lanes["counts"].copy()
    counts[16] = 0
    counts = _put(counts)
    words = _aligned((B, 8), np.int64)
    core.h_sha256_digest(_ptr(lanes["blocks"]), _ptr(counts), _ptr(words),
                         B, nb)
    want = lanes["hashed"].astype(np.int64)
    want[16] = sha256.sha_consts().reshape(72)[64:]
    np.testing.assert_array_equal(words, want)
