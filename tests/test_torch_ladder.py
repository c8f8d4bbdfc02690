"""fabric_tpu_torch.ops.verify and the ladder route: batches over MaxKeys.

The plain torch Shamir ladder (`p256.double_scalar_mul`, `verify_core`,
`verify.verify_pipeline`) is held to Python ints (`cadd_int`,
`scalar_mul_int`) and to the port's sw provider; the provider's routing
by distinct key count is told apart by its stats; the kernel's lane
body (csrc/ladder.cuh), built by the host compiler behind
tests/cuda_host/cuda_runtime.h, is held to the sw provider and Python
ints, message lanes hashed first as the card's message entry hashes
them. Tolerance: exact (verdicts, affine points). Batches stay at 8 lanes
or fewer a ladder call: the plain ladder is ~5 s of eager torch a call on
one CPU thread. The JAX package's jitted `verify_core` is the `slow`
oracle.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import factory, sw
from fabric_tpu_torch.bccsp.cuda import host_prep_scalars
from fabric_tpu_torch.ops import limb, p256, sha256, verify

N, P = p256.N, p256.P
G = (p256.GX, p256.GY, 1)
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "fabric_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _be(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(32, "big"), np.uint8)


def test_double_scalar_mul_matches_ints():
    """u1*G + u2*Q on 4 lanes: u1 = 0, R at infinity (Q = G, u2 = -u1),
    Q = -G (table entries at infinity) and a random lane."""
    rng = np.random.default_rng(1)
    rnd = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(6)]
    q = p256.to_affine_int(p256.scalar_mul_int(rnd[0], G))
    lanes = [(0, rnd[1], q), (rnd[2], N - rnd[2], (p256.GX, p256.GY)),
             (rnd[3], rnd[4], (p256.GX, P - p256.GY)), (rnd[5], 7, q)]
    X, Y, Z = p256.double_scalar_mul(
        *(_t(limb.ints_to_limbs([ln[k] for ln in lanes])) for k in (0, 1)),
        _t(limb.ints_to_limbs([ln[2][0] for ln in lanes])),
        _t(limb.ints_to_limbs([ln[2][1] for ln in lanes])))
    for i, (u1, u2, (qx, qy)) in enumerate(lanes):
        want = p256.cadd_int(p256.scalar_mul_int(u1, G),
                             p256.scalar_mul_int(u2, (qx, qy, 1)))
        got = tuple(limb.limbs_to_int(c[i]) % P for c in (X, Y, Z))
        assert p256.to_affine_int(got) == p256.to_affine_int(want), i
    assert limb.limbs_to_int(Z[1]) % P == 0          # R at infinity


@pytest.fixture(scope="module")
def signed():
    """8 lanes over 8 keys: valid and tampered, message and digest
    lanes, a high-S signature the host gates away."""
    rng = np.random.default_rng(2)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int.from_bytes(rng.bytes(32), "big")
                                % (N - 1) + 1) for _ in range(8)]
    items = []
    for i in range(8):
        msg = rng.bytes(int(rng.integers(0, 130)))
        sig = csp.sign(privs[i], hashlib.sha256(msg).digest())
        if i in (2, 5):
            msg = msg + b"!"
        digest = hashlib.sha256(msg).digest() if i % 2 else None
        items.append(api.VerifyItem(key=privs[i].public_key(),
                                    signature=sig,
                                    message=None if digest else msg,
                                    digest=digest))
    return items, csp.verify_batch(items)


def test_verify_pipeline_matches_sw(signed):
    """The plain pipeline on message lanes (SHA-256 of the blocks) and
    digest lanes (has_digest) in one call, against the sw provider."""
    items, want = signed
    B = len(items)
    msgs = [it.message or b"" for it in items]
    blocks, nblocks = sha256.pack_messages(msgs, 4)
    has = np.array([it.digest is not None for it in items])
    dig = np.zeros((B, 8), np.uint32)
    for i, it in enumerate(items):
        if it.digest is not None:
            dig[i] = np.frombuffer(it.digest, ">u4")
    prep = [host_prep_scalars(it.key, it.signature) for it in items]
    r, rpn, w = (limb.be_bytes_to_limbs_np(np.stack(
        [np.frombuffer(p[c], np.uint8) for p in prep])) for c in range(3))
    qx = limb.ints_to_limbs([it.key.x for it in items])
    qy = limb.ints_to_limbs([it.key.y for it in items])
    got = verify.verify_pipeline(
        _t(blocks.view(np.int32)), _t(nblocks.astype(np.int32)), _t(qx),
        _t(qy), _t(r), _t(rpn), _t(w), torch.ones(B, dtype=torch.bool),
        _t(dig.view(np.int32)), _t(has))
    assert got.tolist() == want
    assert want.count(False) == 2


def _ladder_items(n_keys: int, seed: int):
    rng = np.random.default_rng(seed)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int.from_bytes(rng.bytes(32), "big")
                                % (N - 1) + 1) for _ in range(n_keys)]
    items = []
    for i in range(n_keys):
        msg = rng.bytes(40)
        sig = csp.sign(privs[i], hashlib.sha256(msg).digest())
        if i == 3:
            msg = msg + b"!"
        items.append(api.VerifyItem(key=privs[i].public_key(),
                                    signature=sig, message=msg))
    return privs, items, csp.verify_batch(items)


def _prepared(items, pubs):
    prep = [host_prep_scalars(it.key, it.signature) for it in items]
    return dict(
        digests=np.stack([np.frombuffer(hashlib.sha256(it.message).digest(),
                                        np.uint8) for it in items]),
        r=np.stack([np.frombuffer(p[0], np.uint8) for p in prep]),
        rpn=np.stack([np.frombuffer(p[1], np.uint8) for p in prep]),
        w=np.stack([np.frombuffer(p[2], np.uint8) for p in prep]),
        der_ok=np.ones(len(items), bool),
        key_idx=np.array([pubs.index(it.key) for it in items]), keys=pubs,
        get_sig=lambda i: items[i].signature)


def test_provider_routes_by_key_count(monkeypatch):
    """17 distinct keys take the ladder on both the item path and the
    prepared path (`ladder_batches`), with verdicts equal to the sw
    provider's; 16 keys go to the comb (its dispatch stubbed here:
    tests/test_torch_provider.py holds the comb's verdicts)."""
    privs, items, want = _ladder_items(17, seed=3)
    pubs = [k.public_key() for k in privs]
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4}})
    assert prov.verify_batch(items) == want
    assert prov.stats["ladder_batches"] == 1
    assert prov.stats["comb_batches"] == 0
    assert prov.stats["host_hashed_lanes"] == 17
    assert prov.verify_prepared(**_prepared(items, pubs)) == want
    assert prov.stats["ladder_batches"] == 2
    assert prov.stats["comb_batches"] == 0

    comb_keys = []

    def comb(bucket, key_map, *_):
        comb_keys.append(len(key_map))
        return lambda: np.array(want[:16] + [False] * (bucket - 16))
    prov16 = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4}})
    monkeypatch.setattr(prov16, "_dispatch_comb_digest", comb)
    assert prov16.verify_batch(items[:16]) == want[:16]
    assert prov16.verify_prepared(**_prepared(items[:16], pubs[:16])) \
        == want[:16]
    assert comb_keys == [16, 16]
    assert prov16.stats["ladder_batches"] == 0


HARNESS = r"""
#include "cuda_runtime.h"
#include "ladder.cuh"

// the lane body over lanes 0..B-1, with the G column the kernel keeps in
// shared memory
extern "C" void h_ladder_digest(const uint32_t* digests, const uint8_t* q8,
                                const uint8_t* r8, const uint8_t* rpn8,
                                const uint8_t* w8, const uint8_t* premask,
                                uint8_t* out, int B) {
  Pt gtab[4];
  for (int k = 0; k < 4; ++k) gtab[k] = ladder_g_entry(k);
  for (int b = 0; b < B; ++b)
    ladder_digest_lane(b, gtab, digests, q8, r8, rpn8, w8, premask, out);
}
"""


@pytest.fixture(scope="module")
def lanes_lib(tmp_path_factory):
    """csrc/ladder.cuh's lane bodies built by the host compiler."""
    cxx = next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                if c and shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("ladder")
    src, so = d / "harness.cpp", d / "libladder.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-Wno-unknown-pragmas",
                    "-I", os.path.join(HERE, "cuda_host"), "-I", CSRC,
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so))


def _construct(q, u1, u2):
    """(e, r, rpn, w) of a lane that accepts with R = u1*G + u2*Q."""
    R = p256.cadd_int(p256.scalar_mul_int(u1, G),
                      p256.scalar_mul_int(u2, (*q, 1)))
    r = p256.to_affine_int(R)[0] % N
    w = u2 * pow(r, -1, N) % N
    e = u1 * pow(w, -1, N) % N if u1 else N
    return e, r, r + N if r + N < P else r, w


def test_lane_bodies_match_plain_and_ints(lanes_lib, signed):
    """The kernel's lane body on 8 signed lanes (message lanes hashed
    first by `verify.message_digests`, as the card's message entry does,
    and digest lanes) and 6 edge lanes: u1 = 0 (digest n), R at infinity
    (Q = G, u2 = -u1), x(R) given as rpn beside a wrong r, Q = -G and
    Q = G (table entries at infinity and doublings), premask off.
    Verdicts equal the sw provider's and Python ints (the plain version is
    held to the same sw verdicts above); the hashed words equal hashlib's."""
    items, want = signed
    rng = np.random.default_rng(4)

    def rnd():
        return int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
    q = p256.to_affine_int(p256.scalar_mul_int(rnd(), G))
    negG, Gq = (p256.GX, P - p256.GY), (p256.GX, p256.GY)
    e, r, w = rnd(), rnd(), rnd()
    R = p256.cadd_int(p256.scalar_mul_int(e * w % N, G),
                      p256.scalar_mul_int(r * w % N, (*q, 1)))
    edges = [(*_construct(q, 0, rnd()), q, True, True),
             (e, N - e, 2 * N - e if 2 * N - e < P else N - e, w, Gq, True,
              False),
             (e, r, p256.to_affine_int(R)[0], w, q, True, True),
             (*_construct(negG, rnd(), rnd()), negG, True, True),
             (*_construct(Gq, rnd(), rnd()), Gq, True, True),
             (*_construct(q, rnd(), rnd()), q, False, False)]
    B = len(items) + len(edges)
    msgs = [it.message or b"" for it in items] + [b""] * len(edges)
    blocks, nblocks = sha256.pack_messages(msgs, 4)
    has = np.zeros(B, np.uint8)
    dig = np.zeros((B, 8), np.uint32)
    q8 = np.zeros((B, 64), np.uint8)
    r8, rpn8, w8 = (np.zeros((B, 32), np.uint8) for _ in range(3))
    premask = np.zeros(B, np.uint8)
    for i, it in enumerate(items):
        rs = host_prep_scalars(it.key, it.signature)
        r8[i], rpn8[i], w8[i] = (np.frombuffer(x, np.uint8) for x in rs)
        q8[i] = np.concatenate([_be(it.key.x), _be(it.key.y)])
        premask[i] = 1
        if it.digest is not None:
            dig[i] = np.frombuffer(it.digest, ">u4")
            has[i] = 1
    for j, (e, r, rpn, w, (qx, qy), pm, _) in enumerate(edges):
        i = len(items) + j
        dig[i] = np.frombuffer(e.to_bytes(32, "big"), ">u4")
        has[i], premask[i] = 1, pm
        r8[i], rpn8[i], w8[i] = _be(r), _be(rpn), _be(w)
        q8[i] = np.concatenate([_be(qx), _be(qy)])
    want_all = want + [ok for *_, ok in edges]
    nblocks = np.where(has, 0, nblocks).astype(np.int32)
    rows = [np.ascontiguousarray(a) for a in (q8, r8, rpn8, w8, premask)]
    # message lanes: hashed first, as the card's message entry does (the
    # SHA kernel's plain version here), a lane's own digest where it has
    # one; then the lane body on the digests
    words = verify.message_digests(
        _t(blocks.view(np.int32)), _t(nblocks), _t(dig.view(np.int32)),
        _t(has.astype(bool))).numpy()
    out = np.zeros(B, np.uint8)
    lanes_lib.h_ladder_digest(*(ctypes.c_void_p(a.ctypes.data) for a in (
        np.ascontiguousarray(words), *rows, out)), ctypes.c_int(B))
    assert out.astype(bool).tolist() == want_all
    # the digest lanes as the host hashes them: the same words
    dg = dig.copy()
    for i, it in enumerate(items):
        if it.digest is None:
            dg[i] = np.frombuffer(hashlib.sha256(it.message).digest(), ">u4")
    np.testing.assert_array_equal(words.view(np.uint32), dg)
    out_d = np.zeros(B, np.uint8)
    lanes_lib.h_ladder_digest(*(ctypes.c_void_p(a.ctypes.data) for a in (
        dg, *rows, out_d)), ctypes.c_int(B))
    assert out_d.astype(bool).tolist() == want_all


@pytest.mark.slow
def test_verify_core_matches_jax(signed):
    """The port's verify_core against the JAX package's jitted one on the
    signed lanes' digests."""
    import jax.numpy as jnp

    from fabric_tpu.ops import p256 as jp256

    items, want = signed
    digests = np.stack([np.frombuffer(
        it.digest or hashlib.sha256(it.message).digest(), ">u4")
        for it in items]).astype(np.uint32)
    prep = [host_prep_scalars(it.key, it.signature) for it in items]
    r, rpn, w = (limb.be_bytes_to_limbs_np(np.stack(
        [np.frombuffer(p[c], np.uint8) for p in prep])) for c in range(3))
    qx = limb.ints_to_limbs([it.key.x for it in items])
    qy = limb.ints_to_limbs([it.key.y for it in items])
    premask = np.ones(len(items), bool)
    jout = np.asarray(jp256.verify_core(
        jnp.asarray(digests), *(jnp.asarray(a) for a in (qx, qy, r, rpn, w,
                                                          premask))))
    tout = p256.verify_core(_t(digests.view(np.int32)), *(
        _t(a) for a in (qx, qy, r, rpn, w, premask)))
    assert tout.numpy().tolist() == jout.tolist() == want
