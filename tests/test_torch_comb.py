"""fabric_tpu_torch.ops.p256 and ops.comb against fabric_tpu.

Seeded numpy inputs go through both packages on the CPU; the tables
and gathered points must match and the verdicts bit for bit (integer
arithmetic: tolerance 0). Jitting the JAX package's limb-level table
builds costs about a minute on the CPU (8 more for G16/Q16), so tier-1
holds the 8-bit Q table to its Python-int group law value for value,
and the limb-for-limb parity with jax.jit is marked slow; chip_smoke.py
covers the tables on the card.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.ops import comb as jcomb
from fabric_tpu.ops import limb as jlimb
from fabric_tpu.ops import p256 as jp256

from fabric_tpu_torch.bccsp import p256_host, utils
from fabric_tpu_torch.bccsp.cuda import host_prep_scalars
from fabric_tpu_torch.bccsp.sw import ECDSAPublicKey
from fabric_tpu_torch.ops import comb as tcomb
from fabric_tpu_torch.ops import fused_verify as tfv
from fabric_tpu_torch.ops import limb as tlimb
from fabric_tpu_torch.ops import p256 as tp256

L = jlimb.L
P, N = jp256.P, jp256.N
NWIN, NENT, WBITS = jcomb.NWIN, jcomb.NENT, jcomb.WBITS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _point(k: int):
    return jp256.scalar_mul_int(k, (jp256.GX, jp256.GY, 1))


def _coords(pts, c):
    return torch.as_tensor(jlimb.ints_to_limbs([p[c] % P for p in pts]))


def test_cadd_cdbl_match_int_reference():
    rng = np.random.default_rng(21)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(6)]
    a = [_point(k) for k in ks] + [(0, 1, 0), _point(9), (0, 1, 0)]
    b = [_point(k + 7) for k in ks] + [_point(3), (0, 1, 0), (0, 1, 0)]
    b[1] = a[1]                                        # P + P
    b[2] = (a[2][0], (P - a[2][1]) % P, a[2][2])       # P + (-P)
    pa = tuple(_coords(a, c) for c in range(3))
    pb = tuple(_coords(b, c) for c in range(3))
    got = [tp256.FP.canonical(c).numpy() for c in tp256.cadd(pa, pb)]
    dbl = [tp256.FP.canonical(c).numpy() for c in tp256.cdbl(pa)]
    for i in range(len(a)):
        assert tuple(jlimb.limbs_to_int(g[i]) for g in got) == \
            jp256.cadd_int(a[i], b[i]), i
        assert tuple(jlimb.limbs_to_int(d[i]) for d in dbl) == \
            jp256.cdbl_int(a[i]), i
    assert tp256.to_affine_int(jp256.cadd_int(a[2], b[2])) is None


def test_g_tables_bytes_match_jax(tmp_path, monkeypatch):
    jpath, tpath = tmp_path / "jax" / "g.npy", tmp_path / "torch" / "g.npy"
    monkeypatch.setenv("FABRIC_TPU_GTAB_CACHE", str(jpath))
    monkeypatch.setenv(tcomb.GTAB_CACHE_ENV, str(tpath))
    monkeypatch.setattr(tcomb, "_g8", [])
    jcomb.g_tables.cache_clear()
    try:
        want = jcomb.g_tables()
    finally:
        jcomb.g_tables.cache_clear()
    got = tcomb.g_tables()
    np.testing.assert_array_equal(got, want)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert tcomb.verify_digest_sidecar(str(tpath)) is True
    # a corrupted cache file is rebuilt, never trusted
    tpath.write_bytes(b"\x00" * 64)
    monkeypatch.setattr(tcomb, "_g8", [])
    np.testing.assert_array_equal(tcomb.g_tables(), want)


@pytest.mark.parametrize("wbits", [8, 16])
def test_windows_match_jax(wbits):
    rng = np.random.default_rng(wbits)
    us = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(10)]
    u = jlimb.ints_to_limbs(us + [0, N - 1])
    np.testing.assert_array_equal(
        tcomb._windows(torch.as_tensor(u), wbits).numpy(),
        np.asarray(jcomb._windows(jnp.asarray(u), wbits)))


# -- tables and verdicts held against the JAX package --

D_KEYS = (0x1D3A5, 0x7E57C0FFEE)


@pytest.fixture(scope="module")
def keys():
    return [jp256.to_affine_int(_point(d)) for d in D_KEYS]


def _q8_ints(keys) -> np.ndarray:
    """The 8-bit Q table over the JAX package's Python-int group law, by
    build_q_tables' own chain (bases by 8 doublings, entry 1 the base,
    entry j+1 = entry j + base), in canonical limbs."""
    out = np.zeros((NWIN, len(keys), NENT, 3, L), np.int32)
    out[:, :, 0, 1, 0] = 1                          # entry 0: (0 : 1 : 0)
    for k, (x, y) in enumerate(keys):
        base = (x, y, 1)
        for i in range(NWIN):
            acc = base
            ents = [acc]
            for _ in range(2, NENT):
                acc = jp256.cadd_int(acc, base)
                ents.append(acc)
            out[i, k, 1:] = jlimb.ints_to_limbs(
                [c % P for e in ents for c in e]).reshape(NENT - 1, 3, L)
            for _ in range(WBITS):
                base = jp256.cdbl_int(base)
    return out.reshape(NWIN * len(keys) * NENT, 3, L)


@pytest.fixture(scope="module")
def jax_q8(keys):
    """The JAX package's K = 2 table in canonical limbs (int reference:
    jitting its limb build costs about a minute on the CPU)."""
    return _q8_ints(keys)


@pytest.fixture(scope="module")
def port_q8(keys):
    return tcomb.build_q_tables(
        torch.as_tensor(tlimb.ints_to_limbs([k[0] for k in keys])),
        torch.as_tensor(tlimb.ints_to_limbs([k[1] for k in keys])))


@pytest.fixture(scope="module")
def tables(jax_q8):
    return tcomb.tables_from_numpy(jcomb.g_tables(), jax_q8,
                                   device="cpu")


def test_q8_tables_k2_match_jax(port_q8, jax_q8):
    """Every entry's value (the semi-reduced limbs, made canonical)."""
    assert port_q8.shape == jax_q8.shape
    np.testing.assert_array_equal(tp256.FP.canonical(port_q8).numpy(),
                                  jax_q8)


@pytest.mark.slow
def test_q8_tables_k2_limbs_match_jax_jit(keys, port_q8):
    """Limb for limb against jax.jit(build_q_tables): slow on the CPU."""
    qx = jnp.asarray(jlimb.ints_to_limbs([k[0] for k in keys]))
    qy = jnp.asarray(jlimb.ints_to_limbs([k[1] for k in keys]))
    np.testing.assert_array_equal(
        port_q8.numpy(), np.asarray(jax.jit(jcomb.build_q_tables)(qx, qy)))


def _lanes(keys, B: int, seed: int):
    """B signed lanes over the two keys: valid, tampered digest, wrong
    key, high-S (premask off), r >= n; with the sw verdicts."""
    rng = np.random.default_rng(seed)
    pubs = [ECDSAPublicKey(*k) for k in keys]
    r8, rpn8, w8 = (np.zeros((B, 32), np.uint8) for _ in range(3))
    digests = np.zeros((B, 32), np.uint8)
    key_idx = np.zeros(B, np.int32)
    premask = np.zeros(B, bool)
    want = []
    for i in range(B):
        k = int(rng.integers(2))
        digest = hashlib.sha256(rng.bytes(64)).digest()
        r, s = p256_host.sign(D_KEYS[k], digest)
        s = utils.to_low_s(s)
        kind = i % 6
        if kind == 1:
            digest = bytes([digest[0] ^ 1]) + digest[1:]
        elif kind == 2:
            k = 1 - k
        elif kind == 3:
            s = N - s
        elif kind == 4:
            r = r + N
        sig = utils.marshal_signature(r, s)
        prep = host_prep_scalars(pubs[k], sig)
        if prep is not None:
            premask[i] = True
            r8[i], rpn8[i], w8[i] = (np.frombuffer(b, np.uint8)
                                     for b in prep)
        digests[i] = np.frombuffer(digest, np.uint8)
        key_idx[i] = k
        want.append(p256_host.verify(*keys[k], digest, r, s)
                    and utils.is_low_s(s))
    words = digests.view(">u4").astype(np.uint32)
    limbs = [jlimb.be_bytes_to_limbs(a) for a in (r8, rpn8, w8)]
    return words, key_idx, limbs, premask, np.array(want)


def test_gather_matches_jax(keys, jax_q8, tables):
    g8, q8, _ = tables
    rng = np.random.default_rng(4)
    u1, u2 = (jlimb.ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "big") % N for _ in range(6)])
        for _ in range(2))
    kidx = np.array([0, 1, 1, 0, 1, 0], np.int32)
    want = np.asarray(jcomb.comb_gather_points(
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(kidx),
        jnp.asarray(jcomb.g_tables()), jnp.asarray(jax_q8), 2))
    got = tcomb.comb_gather_points(
        torch.as_tensor(u1), torch.as_tensor(u2), torch.as_tensor(kidx),
        g8, q8, 2).numpy()
    assert got.shape == (6, 64, 3, L)
    np.testing.assert_array_equal(got, want)


def _verify_args(words, kidx, r, rpn, w, premask):
    return (torch.as_tensor(words.astype(np.int64)), torch.as_tensor(kidx),
            torch.as_tensor(r), torch.as_tensor(rpn), torch.as_tensor(w),
            torch.as_tensor(premask))


def test_comb_verify_q8_matches_jax(keys, jax_q8, tables):
    """The JAX package's scalar stage and gather (eager, limb for limb)
    and its Python-int group law for the sum; the whole JAX function
    is held to the port in the slow test below."""
    g8, q8, _ = tables
    words, kidx, (r, rpn, w), premask, want_sw = _lanes(keys, 30, seed=9)
    e = jlimb.words_be_to_limbs(jnp.asarray(words))
    u1 = jcomb.FN.canonical(jcomb.FN.mulmod(e, jnp.asarray(w)))
    u2 = jcomb.FN.canonical(jcomb.FN.mulmod(jnp.asarray(r), jnp.asarray(w)))
    jpts = np.asarray(jcomb.comb_gather_points(
        u1, u2, jnp.asarray(kidx), jnp.asarray(jcomb.g_tables()),
        jnp.asarray(jax_q8), 2))
    words_t, kidx_t, r_t, rpn_t, w_t, pm_t = _verify_args(
        words, kidx, r, rpn, w, premask)
    pts = tcomb.comb_points(words_t, kidx_t, q8, r_t, w_t, g_flat=g8)
    np.testing.assert_array_equal(pts.numpy(), jpts)
    want = []
    for b in range(len(words)):
        acc = (0, 1, 0)
        for m in range(jpts.shape[1]):
            acc = jp256.cadd_int(acc, tuple(
                jlimb.limbs_to_int(jpts[b, m, c]) for c in range(3)))
        aff = jp256.to_affine_int(acc)
        want.append(bool(premask[b]) and aff is not None and aff[0] in (
            jlimb.limbs_to_int(r[b]), jlimb.limbs_to_int(rpn[b])))
    want = np.array(want)
    got = tcomb.comb_verify_with_tables(words_t, kidx_t, q8, r_t, rpn_t,
                                        w_t, pm_t, g_flat=g8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the twin of the JAX package's XLA tree gives the same verdicts
    X, _, Z = tcomb._tree_reduce(pts[:, :, 0], pts[:, :, 1], pts[:, :, 2])
    np.testing.assert_array_equal(
        tp256.projective_check(X, Z, r_t, rpn_t, pm_t).numpy(), want)
    np.testing.assert_array_equal(want, want_sw)
    assert want.any() and not want.all()


def _bytes(limbs) -> torch.Tensor:
    """Canonical limbs -> (B, 32) uint8 big-endian rows, over ints."""
    return torch.as_tensor(np.stack([np.frombuffer(
        jlimb.limbs_to_int(x).to_bytes(32, "big"), np.uint8)
        for x in limbs]))


def test_digest_verify_bytes_q8_matches_jax(keys, jax_q8, tables):
    """The commit path's byte-taking function (plain on the CPU: stage
    A's digest-lanes plain version, the tree's windows entry) against the
    JAX package's eager scalar stage and gather (limb for limb, through
    the points) and its Python-int group law for the sum, over the same
    seeded lanes as test_comb_verify_q8_matches_jax."""
    g8, q8, _ = tables
    words, kidx, (r, rpn, w), premask, want_sw = _lanes(keys, 30, seed=9)
    e = jlimb.words_be_to_limbs(jnp.asarray(words))
    u1 = jcomb.FN.canonical(jcomb.FN.mulmod(e, jnp.asarray(w)))
    u2 = jcomb.FN.canonical(jcomb.FN.mulmod(jnp.asarray(r), jnp.asarray(w)))
    jw1, jw2 = (np.asarray(jcomb._windows(u)) for u in (u1, u2))
    jpts = np.asarray(jcomb.comb_gather_points(
        u1, u2, jnp.asarray(kidx), jnp.asarray(jcomb.g_tables()),
        jnp.asarray(jax_q8), 2))
    want = []
    for b in range(len(words)):
        acc = (0, 1, 0)
        for m in range(jpts.shape[1]):
            acc = jp256.cadd_int(acc, tuple(
                jlimb.limbs_to_int(jpts[b, m, c]) for c in range(3)))
        aff = jp256.to_affine_int(acc)
        want.append(bool(premask[b]) and aff is not None and aff[0] in (
            jlimb.limbs_to_int(r[b]), jlimb.limbs_to_int(rpn[b])))
    r8, rpn8, w8 = (_bytes(x) for x in (r, rpn, w))
    digests = torch.as_tensor(words.view(np.int32))
    w1, w2 = tfv.digest_windows(digests, r8, w8)
    np.testing.assert_array_equal(w1.numpy(), jw1)
    np.testing.assert_array_equal(w2.numpy(), jw2)
    got = tfv.digest_verify_with_tables(digests, torch.as_tensor(kidx), q8,
                                        r8, rpn8, w8,
                                        torch.as_tensor(premask), g_flat=g8)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    np.testing.assert_array_equal(got.numpy(), want_sw)
    assert got.any() and not got.all()


@pytest.mark.slow
def test_digest_verify_bytes_q8_matches_jax_function(keys, jax_q8, tables):
    """The JAX package's comb_verify_with_tables itself on the limbs of
    the same rows (its eager XLA tree costs ~20 s on the CPU)."""
    g8, q8, _ = tables
    words, kidx, (r, rpn, w), premask, want_sw = _lanes(keys, 30, seed=9)
    want = np.asarray(jcomb.comb_verify_with_tables(
        jnp.asarray(words), jnp.asarray(kidx), jnp.asarray(jax_q8),
        jnp.asarray(r), jnp.asarray(rpn), jnp.asarray(w),
        jnp.asarray(premask)))
    got = tfv.digest_verify_with_tables(
        torch.as_tensor(words.view(np.int32)), torch.as_tensor(kidx), q8,
        *(_bytes(x) for x in (r, rpn, w)), torch.as_tensor(premask),
        g_flat=g8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, want_sw)


@pytest.mark.slow
def test_comb_verify_q8_matches_jax_function(keys, jax_q8, tables):
    """The JAX package's comb_verify_with_tables itself (its eager XLA
    tree costs ~20 s on the CPU)."""
    g8, q8, _ = tables
    words, kidx, (r, rpn, w), premask, want_sw = _lanes(keys, 30, seed=9)
    want = np.asarray(jcomb.comb_verify_with_tables(
        jnp.asarray(words), jnp.asarray(kidx), jnp.asarray(jax_q8),
        jnp.asarray(r), jnp.asarray(rpn), jnp.asarray(w),
        jnp.asarray(premask)))
    words_t, kidx_t, r_t, rpn_t, w_t, pm_t = _verify_args(
        words, kidx, r, rpn, w, premask)
    got = tcomb.comb_verify_with_tables(words_t, kidx_t, q8, r_t, rpn_t,
                                        w_t, pm_t, g_flat=g8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, want_sw)


@pytest.mark.slow
def test_g16_q16_tables_match_jax(port_q8):
    """The 16-bit tables (~1M point adds each): slow on the CPU."""
    np.testing.assert_array_equal(
        tcomb.g16_tables("cpu").numpy(), np.asarray(jcomb.g16_tables()))
    want = np.asarray(jax.jit(jcomb.build_q16_tables, static_argnums=1)(
        jnp.asarray(port_q8.numpy()), 2))
    got = tcomb.build_q16_tables(port_q8, 2)
    np.testing.assert_array_equal(got.numpy(), want)
