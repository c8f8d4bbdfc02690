"""fabric_tpu_torch's Ed25519 path on the CPU: MontMod, the group law, the
B table, the plain verify core and the scheme router.

Held to the JAX package limb for limb (`MontMod` eagerly, on edge and
seeded random operands, redundant limbs included; the B table byte for
byte, both caches pointed at a tmpdir), to Python ints
(`ed25519_host`'s group law; the kernel's table layout on every entry)
and to the port's sw provider (the router on a mixed P-256/Ed25519
batch, the `Ed25519: false` knob, sub-batches under MinBatch). Tolerance:
exact. The plain verify core is ~6 s of eager torch a call on one CPU
thread, so it runs twice here, on 4 lanes; the JAX package's jitted
`verify_core` is the `slow` oracle.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.ops import mont as jmont

from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import ed25519_host as edh
from fabric_tpu_torch.bccsp import factory, sw
from fabric_tpu_torch.ops import ed25519, limb
from fabric_tpu_torch.ops.mont import MontMod
from tests.test_torch_comb import _q8_ints

P = edh.P
RFC_SEED = bytes.fromhex(
    "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
RFC_PK = bytes.fromhex(
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
RFC_SIG = bytes.fromhex(
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555"
    "fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redundant(x: int, rng) -> np.ndarray:
    """A 13-bit form of x with some limbs raised to 2^13 + v by borrowing
    one from the next limb (the redundant inputs MontMod takes)."""
    lm = limb.int_to_limbs(x).astype(np.int64)
    for i in range(limb.L - 1):
        if lm[i + 1] > 0 and lm[i] == 0 and rng.random() < 0.5:
            lm[i + 1] -= 1
            lm[i] += 1 << limb.W
    return lm.astype(np.int32)


# 2^255 - 19 and BN254's base field prime (the next user of MontMod)
BN254_P = int("218882428718392752222464057452572750886963111572978236626"
              "89037894645226208583")


@pytest.mark.parametrize("m", [P, BN254_P])
def test_montmod_matches_jax_limb_for_limb(m):
    """mul, add, sub and canonical on values below 2m: 0, 1, m - 1, m,
    m + 1, 2m - 1, limbs at 2^13, and seeded random ones."""
    jm, tm = jmont.MontMod(m), MontMod(m)
    rng = np.random.default_rng(m % 1000)
    vals = [0, 1, m - 1, m, m + 1, 2 * m - 1, 1 << 13, (1 << 253) - 1]
    vals += [int.from_bytes(rng.bytes(33), "big") % (2 * m)
             for _ in range(48)]
    a = np.stack([_redundant(v, rng) for v in vals])
    b = np.stack([_redundant(v, rng) for v in vals[::-1]])
    for op in ("mul", "add", "sub"):
        want = np.asarray(getattr(jm, op)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(tm, op)(torch.as_tensor(a), torch.as_tensor(b))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=op)
    want = np.asarray(jm.canonical(jnp.asarray(a)))
    np.testing.assert_array_equal(tm.canonical(torch.as_tensor(a)).numpy(),
                                  want)
    assert [limb.limbs_to_int(r) for r in want] == [v % m for v in vals]
    assert tm.from_limbs(tm.to_mont(12345)) == 12345


def test_b_tables_byte_identical_to_jax(tmp_path, monkeypatch):
    """Both packages build the B table into their own cache in a tmpdir;
    the bytes are equal, the sidecars verify, a corrupted cache is
    rebuilt."""
    from fabric_tpu.ops import ed25519 as jed

    jpath, tpath = tmp_path / "j.npy", tmp_path / "t.npy"
    monkeypatch.setenv("FABRIC_TPU_EDTAB_CACHE", str(jpath))
    monkeypatch.setenv(ed25519.EDTAB_CACHE_ENV, str(tpath))
    monkeypatch.setattr(ed25519, "_btab", [])
    jed.b_tables.cache_clear()
    try:
        jt = jed.b_tables()
    finally:
        jed.b_tables.cache_clear()
    tt = ed25519.b_tables()
    assert tt.dtype == np.int32 and tt.tobytes() == jt.tobytes()
    assert tpath.read_bytes() == jpath.read_bytes()
    # a corrupted cache fails its sidecar and is rebuilt, not used
    raw = bytearray(tpath.read_bytes())
    raw[-1] ^= 1
    tpath.write_bytes(bytes(raw))
    monkeypatch.setattr(ed25519, "_btab", [])
    assert ed25519.b_tables().tobytes() == jt.tobytes()


def test_kernel_table_matches_ints():
    """The kernel's layout: every entry (x, y) of the B table in Niels form
    (y + x, y - x, 2dxy) of the B table's affine values (mont^-1 of its
    limbs), as 8 little-endian 32-bit words a coordinate."""
    tab = ed25519.b_tables()
    kt = ed25519.kernel_table(torch.as_tensor(tab)).numpy()
    assert kt.shape == (8192, 3, 8) and kt.dtype == np.int32
    rinv = pow(ed25519.FED.R, -1, P)
    words = kt.astype(np.int64) & 0xFFFFFFFF
    weights = [1 << (32 * i) for i in range(8)]
    for e in range(tab.shape[0]):
        x, y = (limb.limbs_to_int(tab[e, c]) * rinv % P for c in (0, 1))
        want = ((y + x) % P, (y - x) % P, 2 * edh.D * x * y % P)
        for c in range(3):
            assert sum(int(w) * s for w, s in zip(words[e, c], weights)) \
                == want[c], (e, c)
    # entry (i, j) is j * 2^(8i) * B; entry 0 the identity (1, 1, 0)
    x, y = edh.to_affine(edh.scalar_mult(5 << 16, edh.from_affine(
        edh.BX, edh.BY)))
    got = [[sum(int(w) << (32 * i) for i, w in enumerate(words[e, c]))
            for c in range(3)] for e in (2 * 256 + 5, 0)]
    assert got == [[(y + x) % P, (y - x) % P, 2 * edh.D * x * y % P],
                   [1, 1, 0]]


def _mont(pt):
    return tuple(torch.as_tensor(ed25519.FED.to_mont(c))[None] for c in pt)


def _plain(pt):
    return tuple(ed25519.FED.from_limbs(c[0]) for c in pt)


def test_group_law_matches_host_ints():
    """ed_add and ed_double in the Montgomery domain against
    ed25519_host.pt_add and pt_double: B, the identity, a small-order
    point, P + P and P + (-P)."""
    Bp = edh.from_affine(edh.BX, edh.BY)
    Q = edh.scalar_mult(987654321, Bp)
    negQ = ((P - Q[0]) % P, Q[1], Q[2], (P - Q[3]) % P)
    small = (0, P - 1, 1, 0)
    for p, q in ((Bp, Q), (Q, Q), (Q, negQ), (Bp, edh._IDENT),
                 (small, Bp), (edh._IDENT, edh._IDENT)):
        got = _plain(ed25519.ed_add(_mont(p), _mont(q)))
        assert got == tuple(c % P for c in edh.pt_add(p, q))
        got = _plain(ed25519.ed_double(_mont(p)))
        assert got == tuple(c % P for c in edh.pt_double(p))


def test_verify_core_matches_host():
    """The plain verify core on 4 lanes: RFC 8032 test 1, a valid lane, a
    tampered message, a host-rejected lane (identity operands, premask
    off); against ed25519_host.verify."""
    assert edh.public_from_seed(RFC_SEED) == RFC_PK
    assert edh.sign(RFC_SEED, b"") == RFC_SIG
    rng = np.random.default_rng(5)
    seed = rng.bytes(32)
    pk = edh.public_from_seed(seed)
    msg = rng.bytes(77)
    sig = edh.sign(seed, msg)
    lanes = [(RFC_PK, RFC_SIG, b""), (pk, sig, msg), (pk, sig, msg + b"x"),
             (pk, sig[:32] + (int.from_bytes(sig[32:], "little") + edh.L)
              .to_bytes(32, "little"), msg)]
    prep = [edh.prep_verify(*ln) for ln in lanes]
    assert prep[3] is None
    rows = [torch.from_numpy(a) for a in ed25519.stage_rows(prep, 4)]
    got = ed25519.ed25519_verify(torch.as_tensor(ed25519.b_tables()), *rows)
    assert got.tolist() == [edh.verify(*ln) for ln in lanes] == [
        True, True, False, False]


@pytest.fixture(scope="module")
def mixed():
    """16 P-256 lanes over 3 keys and 8 Ed25519 lanes over 2 keys,
    interleaved, some tampered."""
    rng = np.random.default_rng(6)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int.from_bytes(rng.bytes(32), "big")
                                % (sw.p256_host.N - 1) + 1)
             for _ in range(3)]
    eds = [sw.Ed25519PrivateKey(rng.bytes(32)) for _ in range(2)]
    items = []
    for i in range(24):
        msg = rng.bytes(60)
        if i % 3 == 1:
            k = eds[i % 2]
            sig = csp.sign(k, msg)
        else:
            k = privs[(i // 3) % 3]
            sig = csp.sign(k, hashlib.sha256(msg).digest())
        if i % 5 == 4:
            msg = msg + b"!"
        items.append(api.VerifyItem(key=k.public_key(), signature=sig,
                                    message=msg))
    keys = sorted((p.public_key() for p in privs),
                  key=lambda p: p.x_bytes().tobytes() + p.y_bytes().tobytes())
    q8 = _q8_ints([(p.x, p.y) for p in keys] + [(keys[0].x, keys[0].y)])
    order = tuple(p.x_bytes().tobytes() + p.y_bytes().tobytes()
                  for p in keys)
    return items, csp.verify_batch(items), (order, torch.as_tensor(q8))


def _provider(q8_seed, **cuda):
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, **cuda}})
    prov._q8_cache[q8_seed[0]] = q8_seed[1]
    return prov


def test_router_splits_a_mixed_batch(mixed):
    """The scheme router on the CPU provider: P-256 lanes take the comb,
    Ed25519 lanes the plain verify core; the bitmap equals the sw
    provider's bit for bit."""
    items, want, q8_seed = mixed
    assert want.count(False) >= 3
    prov = _provider(q8_seed)
    assert prov.verify_batch(items) == want
    assert prov.stats["ed25519_batches"] == 1
    assert prov.stats["comb_batches"] == 1
    assert prov.stats["ed25519_sw_lanes"] == 0
    assert prov.stats["q8_builds"] == 0


def test_router_sw_paths(mixed):
    """`Ed25519: false` serves the Ed25519 lanes on the sw provider, as
    does a sub-batch under MinBatch on either scheme; verdicts stay
    equal."""
    items, want, q8_seed = mixed
    ed = [i for i in range(len(items)) if i % 3 == 1]
    off = _provider(q8_seed, Ed25519=False)
    assert off.verify_batch([items[i] for i in ed]) == [want[i] for i in ed]
    assert off.stats["ed25519_batches"] == 0
    assert off.stats["ed25519_sw_lanes"] == 8
    few = items[:6]                  # 2 Ed25519 + 4 P-256 lanes, MinBatch 5
    small = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 5}})
    assert small.verify_batch(few) == want[:6]
    assert small.stats["ed25519_batches"] == 0
    assert small.stats["ed25519_sw_lanes"] == 2
    assert small.stats["comb_batches"] == 0


def test_sw_provider_ed25519_keys():
    """The port's sw provider generates, imports, signs (the message
    itself) and verifies Ed25519 keys."""
    csp = sw.SWProvider()
    k = csp.key_gen(api.Ed25519KeyGenOpts())
    pub = csp.key_import(k.public_key().bytes(),
                         api.Ed25519PublicKeyImportOpts())
    assert csp.get_key(k.ski()) is k
    sig = csp.sign(k, b"message")
    assert csp.verify(pub, sig, b"message")
    assert not csp.verify(pub, sig, b"messagf")
    with pytest.raises(ValueError):
        sw.Ed25519PublicKey((P + 1).to_bytes(32, "little"))


@pytest.mark.slow
def test_verify_core_matches_jax():
    """The port's plain verify core against the JAX package's jitted one
    on signed and tampered lanes."""
    from fabric_tpu.ops import ed25519 as jed

    rng = np.random.default_rng(7)
    seeds = [rng.bytes(32) for _ in range(2)]
    lanes = []
    for i in range(4):
        msg = rng.bytes(40)
        sig = edh.sign(seeds[i % 2], msg)
        lanes.append((edh.public_from_seed(seeds[i % 2]), sig,
                       msg + (b"x" if i == 3 else b"")))
    rows = ed25519.stage_rows([edh.prep_verify(*ln) for ln in lanes], 4)
    jout = np.asarray(jed.verify_core(jnp.asarray(jed.b_tables()),
                                      *(jnp.asarray(a) for a in rows)))
    tout = ed25519.verify_core(torch.as_tensor(ed25519.b_tables()),
                               *(torch.from_numpy(a) for a in rows))
    assert tout.tolist() == jout.tolist() == [True, True, True, False]
