"""fabric_tpu_torch.ops.ptree (the tree kernel's module) against
fabric_tpu.ops.ptree.

On the CPU the port's wrapper runs its plain version; the JAX side runs
`tree_body` eagerly and `tree_verify_points` in Pallas interpret mode,
as tests/test_ptree.py does. Inputs are seeded numpy arrays of real
comb-table points (semi-reduced); tolerance: exact equality. The CUDA
kernel itself is held to the plain version by tests/test_torch_cuda.py
on the card, and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.ops import comb as jcomb
from fabric_tpu.ops import limb as jlimb
from fabric_tpu.ops import p256 as jp256
from fabric_tpu.ops import ptree as jptree

from fabric_tpu_torch.ops import ptree as tptree

L = jlimb.L


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g8():
    return jcomb.g_tables()


def _lanes(g8, B, M, seed):
    """(B, M, 3, L) gathered G-table points with edge lanes: all
    infinity, P + P, P + (-P), half infinity; plus r/rpn/premask with
    accepting, wrong-r and rpn-hit lanes (from Python-int sums)."""
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 256, size=(B, M))
    idx = (np.arange(M) % 32) * 256 + win
    pts = g8[idx.reshape(-1)].reshape(B, M, 3, L).copy()
    pts[0] = 0
    pts[0, :, 1, 0] = 1
    if M > 1:
        pts[1, 1] = pts[1, 0]
        pts[2, 1] = pts[2, 0]
        y = jlimb.limbs_to_int(pts[2, 0, 1]) % jp256.P
        pts[2, 1, 1] = jlimb.int_to_limbs((jp256.P - y) % jp256.P)
    pts[3, ::2] = 0
    pts[3, ::2, 1, 0] = 1
    r, rpn = [], []
    for b in range(B):
        acc = (0, 1, 0)
        for m in range(M):
            acc = jp256.cadd_int(acc, tuple(
                jlimb.limbs_to_int(pts[b, m, c]) for c in range(3)))
        aff = jp256.to_affine_int(acc)
        x = aff[0] if aff else 1
        rv = x % jp256.N
        if b % 5 == 4:
            rv = (rv + 1) % jp256.N              # wrong r
        r.append(rv)
        rpn.append(x if b % 10 == 9 else
                   (rv + jp256.N if rv + jp256.N < jp256.P else rv))
    premask = np.ones(B, bool)
    premask[6] = False
    return (pts, jlimb.ints_to_limbs(r), jlimb.ints_to_limbs(rpn), premask)


def test_pack_consts_match_jax():
    np.testing.assert_array_equal(tptree._fpk().pack_consts(),
                                  jptree._fpk().pack_consts())
    assert tptree.KMod.NCONST == jptree.KMod.NCONST


@pytest.mark.parametrize("M", [1, 3, 5, 64])
def test_plain_tree_matches_int_sums(g8, M):
    """Odd counts (infinity padding) and the q8 route's M = 64: the
    plain version against Python-int sums."""
    B = 12
    pts, r, rpn, premask = _lanes(g8, B, M, seed=100 + M)
    got = tptree.tree_verify_points(
        torch.as_tensor(pts), torch.as_tensor(r), torch.as_tensor(rpn),
        torch.as_tensor(premask)).numpy()
    want = []
    for b in range(B):
        acc = (0, 1, 0)
        for m in range(M):
            acc = jp256.cadd_int(acc, tuple(
                jlimb.limbs_to_int(pts[b, m, c]) for c in range(3)))
        aff = jp256.to_affine_int(acc)
        want.append(bool(premask[b]) and aff is not None and aff[0] in (
            jlimb.limbs_to_int(r[b]), jlimb.limbs_to_int(rpn[b])))
    np.testing.assert_array_equal(got, np.array(want))


def test_wrapper_rejects_bad_inputs(g8):
    pts, r, rpn, premask = map(torch.as_tensor, _lanes(g8, 8, 2, seed=3))
    before = tptree.launches
    with pytest.raises(ValueError):
        tptree.tree_verify_points(pts[..., :19], r, rpn, premask)
    with pytest.raises(ValueError):
        tptree.tree_verify_points(pts.repeat(1, 33, 1, 1), r, rpn, premask)
    with pytest.raises(ValueError):
        tptree.tree_verify_points(pts, r[:3], rpn, premask)
    with pytest.raises(TypeError):
        tptree.tree_verify_points(pts.to(torch.int64), r, rpn, premask)
    with pytest.raises(TypeError):
        tptree.tree_verify_points(pts, r, rpn, premask.to(torch.int32))
    with pytest.raises(ValueError):
        tptree.tree_verify_points(pts.to("meta"), r.to("meta"),
                                  rpn.to("meta"), premask.to("meta"))
    # the plain version is not a launch
    tptree.tree_verify_points(pts, r, rpn, premask)
    assert tptree.launches == before


# -- held against the JAX package (its eager and interpret runs are the
#    slow part of this file, so they come last; eager JAX compiles once
#    per shape, so the larger tree runs first and the smaller ones and
#    cadd_k reuse its levels) --

# M = 32 (the q16 route's count) adds only levels to M = 8, and three
# more eager JAX levels cost ~10 s on the CPU: slow; chip_smoke.py runs
# the kernel against the plain version at M = 32 and 64 on the card
@pytest.mark.parametrize(
    "M", [8, 4, pytest.param(32, marks=pytest.mark.slow)])
def test_tree_body_matches_jax(g8, M):
    B = 8
    pts, r, rpn, premask = _lanes(g8, B, M, seed=M)
    lead = np.transpose(pts, (2, 3, 1, 0))           # (3, L, M, B)
    args = (lead[0], lead[1], lead[2], r.T[:, None, :], rpn.T[:, None, :],
            premask[None, :].astype(np.int32))
    want = np.asarray(jptree.tree_body(*map(jnp.asarray, args)))
    got = tptree.tree_body(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.shape == (1, B) and want.any() and not want.all()


def test_cadd_k_matches_jax_limb_for_limb(g8):
    pts, *_ = _lanes(g8, 8, 2, seed=1)
    lead = np.transpose(pts, (2, 3, 1, 0))           # (3, L, 2, B)
    p1 = tuple(lead[c][:, :1] for c in range(3))
    p2 = tuple(lead[c][:, 1:] for c in range(3))
    want = jptree.cadd_k(tuple(map(jnp.asarray, p1)),
                         tuple(map(jnp.asarray, p2)))
    got = tptree.cadd_k(tuple(map(torch.as_tensor, p1)),
                        tuple(map(torch.as_tensor, p2)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.slow
def test_tree_verify_points_matches_jax_interpret(g8):
    """The TPU kernel itself in interpret mode (about half a minute to
    trace and compile on the CPU); the eager tree_body parity above holds
    its body in tier-1."""
    B, M = 128, 4
    pts, r, rpn, premask = _lanes(g8, B, M, seed=7)
    want = np.asarray(jptree.tree_verify_points(
        jnp.asarray(pts), jnp.asarray(r), jnp.asarray(rpn),
        jnp.asarray(premask), interpret=True))
    got = tptree.tree_verify_points(
        torch.as_tensor(pts), torch.as_tensor(r), torch.as_tensor(rpn),
        torch.as_tensor(premask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


# -- the windows entry (the card's route gathers inside the kernel) --

def _q8_ints(keys) -> np.ndarray:
    """The 8-bit Q table of `keys`, (32 * K * 256, 3, L) canonical limbs,
    over Python ints: T[(i*K + k)*256 + j] = j * 2^(8i) * Q_k."""
    out = np.zeros((32, len(keys), 256, 3, L), np.int32)
    out[:, :, 0, 1, 0] = 1
    for k, (x, y) in enumerate(keys):
        base = (x, y, 1)
        for i in range(32):
            acc, ents = base, [base]
            for _ in range(2, 256):
                acc = jp256.cadd_int(acc, base)
                ents.append(acc)
            out[i, k, 1:] = jlimb.ints_to_limbs(
                [c % jp256.P for e in ents for c in e]).reshape(255, 3, L)
            for _ in range(8):
                base = jp256.cdbl_int(base)
    return out.reshape(-1, 3, L)


@pytest.fixture(scope="module")
def windows_case(g8):
    """48 lanes of windows over the g8 table and a K = 2 q8 table: u1, u2
    random 256-bit scalars (their 8-bit windows), lane 0 all zero
    (infinity), lane 1 half zero, lane 2 windows above 8 bits, key slots
    2 and -1 (out of range), lane 5 premasked off; r = x(R) on every third
    lane (Python-int sums), wrong elsewhere."""
    B, K = 48, 2
    keys = [jp256.to_affine_int(jp256.scalar_mul_int(
        d, (jp256.GX, jp256.GY, 1))) for d in (3, 5)]
    q8 = _q8_ints(keys)
    rng = np.random.default_rng(21)
    u1, u2 = ([int.from_bytes(rng.bytes(32), "big") for _ in range(B)]
              for _ in range(2))
    u1[0] = u2[0] = 0
    u1_l, u2_l = jlimb.ints_to_limbs(u1), jlimb.ints_to_limbs(u2)
    key = rng.integers(0, K, B).astype(np.int32)
    # the JAX package's eager gather, on in-range slots
    pts = np.array(jcomb.comb_gather_points(
        jnp.asarray(u1_l), jnp.asarray(u2_l), jnp.asarray(key), g8, q8, K))
    w1 = np.array(jcomb._windows(jnp.asarray(u1_l)), dtype=np.int32)
    w2 = np.array(jcomb._windows(jnp.asarray(u2_l)), dtype=np.int32)
    w1[1, ::2] = w2[1, ::2] = 0
    pts[1, 0::2] = 0
    pts[1, 0::2, 1, 0] = 1
    w1[2] += 256 * 5
    key[3], key[4] = 2, -1
    xs = []
    for b in range(B):
        acc = (0, 1, 0)
        for m in range(64):
            acc = jp256.cadd_int(acc, tuple(
                jlimb.limbs_to_int(pts[b, m, c]) for c in range(3)))
        aff = jp256.to_affine_int(acc)
        xs.append(aff[0] if aff else None)
    rs = [((x or 1) + (b % 3 != 0)) % jp256.N for b, x in enumerate(xs)]
    r = jlimb.ints_to_limbs(rs)
    r8 = np.stack([np.frombuffer(v.to_bytes(32, "big"), np.uint8)
                   for v in rs])
    premask = np.ones(B, bool)
    premask[5] = False
    want = np.array([b % 3 == 0 and premask[b] and 0 <= key[b] < K
                     and x is not None and x < jp256.N
                     for b, x in enumerate(xs)])
    args = [torch.as_tensor(a) for a in (w1, w2, key, g8, q8)]
    return dict(args=(*args[:5], K, 8, 8), pts=pts, r=torch.as_tensor(r),
                r8=torch.as_tensor(r8), premask=torch.as_tensor(premask),
                want=want, key=key)


def test_windows_entry_matches_points_entry_and_ints(windows_case):
    c = windows_case
    before = tptree.launches
    got = tptree.tree_verify_windows(*c["args"], c["r8"], c["r8"],
                                     c["premask"]).numpy()
    assert tptree.launches == before               # the plain version
    np.testing.assert_array_equal(got, c["want"])
    assert 10 <= got.sum() < len(got)
    # the port's gather = the JAX package's eager gather on in-range slots
    w1, w2 = c["args"][:2]
    gathered = tptree.gather_rows(w1 & 255, w2, torch.as_tensor(
        c["key"]).clamp(0, 1), *c["args"][3:])
    ok = (c["key"] >= 0) & (c["key"] < 2)
    np.testing.assert_array_equal(gathered.numpy()[ok], c["pts"][ok])
    pts_got = tptree.tree_verify_points(
        torch.as_tensor(c["pts"]), c["r"], c["r"],
        c["premask"] & torch.as_tensor(ok)).numpy()
    np.testing.assert_array_equal(got, pts_got)


def test_windows_wrapper_rejects_bad_inputs(windows_case):
    w1, w2, key, g8, q8, K, wg, wq = windows_case["args"]
    r, r8, pm = (windows_case[k] for k in ("r", "r8", "premask"))

    def call(*a, **k):
        base = dict(zip(("w1", "w2", "key", "g", "q", "K", "wg", "wq"),
                        (w1, w2, key, g8, q8, K, wg, wq)))
        base.update(k)
        return tptree.tree_verify_windows(*base.values(), r8, r8, pm, *a)

    with pytest.raises(ValueError):
        call(w1=w1[:, :31])                        # width != 256 / wbits_g
    with pytest.raises(ValueError):
        call(q=q8[:-1])                            # not K slots of 8 bits
    with pytest.raises(ValueError):
        call(K=0)
    with pytest.raises(ValueError):
        call(wg=3)                                 # not a window width
    with pytest.raises(ValueError):
        call(wg=4)                                 # M = 64 + 32 > 64
    with pytest.raises(TypeError):
        call(w2=w2.to(torch.int64))
    with pytest.raises(TypeError):
        call(key=key.to(torch.int64))
    with pytest.raises(ValueError):
        call(g=g8.to("meta"))
    with pytest.raises((ValueError, TypeError)):
        tptree.tree_verify_windows(w1, w2, key, g8, q8, K, wg, wq, r, r, pm)
    with pytest.raises(ValueError):
        tptree.tree_verify_windows(w1, w2, key, g8, q8, K, wg, wq, r8, r8,
                                   pm, threads_per_lane=3)
    with pytest.raises(ValueError):
        tptree.tree_verify_points(windows_case["args"][3][None, :2], r[:1],
                                  r[:1], pm[:1], threads_per_lane=16)


@pytest.mark.slow
def test_windows_entry_matches_jax_tree(windows_case):
    """The JAX package's eager tree_body on the same gathered points (its
    64-point levels cost ~15 s eagerly on the CPU)."""
    c = windows_case
    ok = (c["key"] >= 0) & (c["key"] < 2)
    lead = np.transpose(c["pts"], (2, 3, 1, 0))
    r = c["r"].numpy()
    pm = (c["premask"].numpy() & ok)[None, :].astype(np.int32)
    want = np.asarray(jptree.tree_body(*map(jnp.asarray, (
        lead[0], lead[1], lead[2], r.T[:, None, :], r.T[:, None, :], pm))))
    got = tptree.tree_verify_windows(*c["args"], c["r8"], c["r8"],
                                     c["premask"]).numpy()
    np.testing.assert_array_equal(got, want[0])
