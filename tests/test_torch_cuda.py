"""The port's CUDA kernels and provider on the card.

Card-only: every test is marked `cuda` and skips where CUDA is absent
(a CUDA kernel has no CPU mode). The file imports neither jax nor
fabric_tpu, so it also runs on the card's machine, which has neither
(from the repo root, without tests/conftest.py, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held to its plain torch version on the same inputs (the
tree kernel also to Python-int sums, the SHA kernels to hashlib, the
field and mod-n cores to Python ints, the BN254 and BLS12-381 pairing
kernels at truncated loops, and in full to bn254_ref and bls12_381_ref):
exact equality. The provider, on every message route, on the commit path
and on the BLS12-381 aggregate path, to its sw provider.
"""

import hashlib

import numpy as np
import pytest
import torch

from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import factory, sw, utils
from fabric_tpu_torch.ops import comb, fused_verify, limb, p256, ptree
from fabric_tpu_torch.ops import sha256

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _be32(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(32, "big"), np.uint8)


def _lanes(B, M, seed):
    """Random G-table points with infinity, P + P and P + (-P) lanes;
    r from Python-int sums, every fifth lane wrong, every tenth an rpn
    hit; one lane premasked off."""
    rng = np.random.default_rng(seed)
    g8 = comb.g_tables()
    idx = (np.arange(M) % 32) * 256 + rng.integers(0, 256, size=(B, M))
    pts = g8[idx.reshape(-1)].reshape(B, M, 3, limb.L).copy()
    pts[0] = 0
    pts[0, :, 1, 0] = 1
    if M > 1:
        pts[1, 1] = pts[1, 0]
        pts[2, 1] = pts[2, 0]
        y = limb.limbs_to_int(pts[2, 0, 1]) % p256.P
        pts[2, 1, 1] = limb.int_to_limbs((p256.P - y) % p256.P)
    r, rpn, want = [], [], []
    premask = np.ones(B, bool)
    premask[3] = False
    for b in range(B):
        acc = (0, 1, 0)
        for m in range(M):
            acc = p256.cadd_int(acc, tuple(
                limb.limbs_to_int(pts[b, m, c]) for c in range(3)))
        aff = p256.to_affine_int(acc)
        x = aff[0] if aff else 1
        rv = (x + (b % 5 == 4)) % p256.N
        rp = x if b % 10 == 9 else (
            rv + p256.N if rv + p256.N < p256.P else rv)
        r.append(rv)
        rpn.append(rp)
        want.append(bool(premask[b]) and aff is not None and x in (rv, rp))
    return (pts, limb.ints_to_limbs(r), limb.ints_to_limbs(rpn), premask,
            np.array(want))


@pytest.mark.parametrize("M", [1, 5, 32, 64])
def test_kernel_matches_plain_and_ints(dev, M):
    pts, r, rpn, premask, want = _lanes(40, M, seed=M)
    args = [torch.as_tensor(a, device=dev) for a in (pts, r, rpn, premask)]
    before = ptree.launches
    got = ptree.tree_verify_points(*args)
    assert ptree.launches == before + 1
    plain = ptree.tree_verify_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_points_entry_every_t(dev, T):
    """Every threads-per-lane count, at the routes' M = 32 and 64 and at
    counts T does not divide (M < T included)."""
    for M in (3, 32, 64):
        pts, r, rpn, premask, want = _lanes(40, M, seed=100 + M)
        args = [torch.as_tensor(a, device=dev)
                for a in (pts, r, rpn, premask)]
        got = ptree.tree_verify_points(*args, threads_per_lane=T)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def _window_case(dev, B, seed):
    """Windows over the g8 table and a q8 table of keys 3 and 5 (K = 2):
    all-zero windows (infinity), windows above 8 bits, a key slot out of
    range on each side, one lane premasked off; r from Python-int sums on
    every third lane."""
    rng = np.random.default_rng(seed)
    keys = [p256.to_affine_int(p256.scalar_mul_int(
        d, (p256.GX, p256.GY, 1))) for d in (3, 5)]
    g8 = comb.g_tables_on(dev)
    q8 = torch.as_tensor(_q8_ints(keys), device=dev)
    w1 = rng.integers(0, 256, (B, 32)).astype(np.int32)
    w2 = rng.integers(0, 256, (B, 32)).astype(np.int32)
    w1[0] = w2[0] = 0
    w1[1, ::2] = 0
    w1[2] += 256 * 3
    key = rng.integers(0, 2, B).astype(np.int32)
    key[3], key[4] = 2, -1
    t = {k: torch.as_tensor(v, device=dev)
         for k, v in (("w1", w1), ("w2", w2), ("key", key))}
    pts = ptree.gather_rows(t["w1"] & 255, t["w2"], t["key"].clamp(0, 1),
                            g8, q8, 2, 8, 8).cpu().numpy()
    xs = []
    for b in range(B):
        acc = (0, 1, 0)
        for m in range(64):
            acc = p256.cadd_int(acc, tuple(
                limb.limbs_to_int(pts[b, m, c]) for c in range(3)))
        aff = p256.to_affine_int(acc)
        xs.append(aff[0] if aff else None)
    r8 = np.stack([_be32(((x or 1) + (b % 3 != 0)) % p256.N)
                   for b, x in enumerate(xs)])
    premask = np.ones(B, bool)
    premask[5] = False
    want = np.array([b % 3 == 0 and premask[b] and 0 <= key[b] < 2
                     and x is not None and x < p256.N
                     for b, x in enumerate(xs)])
    r_t = torch.as_tensor(r8, device=dev)
    return (t["w1"], t["w2"], t["key"], g8, q8, 2, 8, 8, r_t, r_t,
            torch.as_tensor(premask, device=dev)), want


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_windows_entry_matches_plain_and_ints(dev, T):
    args, want = _window_case(dev, 48, seed=5)
    before = ptree.launches
    got = ptree.tree_verify_windows(*args, threads_per_lane=T)
    assert ptree.launches == before + 1
    plain = ptree.tree_verify_windows_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert want.sum() >= 10


def test_field_core_matches_ints(dev):
    """The nvcc build of csrc/p256_field.cuh (its PTX carry chains) on
    the edge operands of the host test and the carry edges: mul, add,
    sub, the 13-bit conversion and Alg. 4's add."""
    P = p256.P
    edges = [0, 1, P - 1, P, P + 1, (1 << 256) - 1,
             (1 << 256) + (1 << 243) - 1] + ptree.CARRY_EDGES
    a = limb.ints_to_limbs([x for x in edges for _ in edges])
    b = limb.ints_to_limbs([y for _ in edges for y in edges])
    g = (p256.GX, p256.GY, 1)
    pts = [g, (p256.GX, P - p256.GY, 1), (0, 1, 0),
           p256.scalar_mul_int(7, g)]

    def rows(ps):
        return np.stack([np.concatenate([limb.int_to_limbs(c) for c in q])
                         for q in ps])
    p13 = rows([pts[0], pts[0], pts[0], pts[2], pts[3]])
    q13 = rows([pts[0], pts[1], pts[2], pts[2], pts[0]])
    cpu = [torch.as_tensor(x) for x in (a, b, p13, q13)]
    got = ptree.field_selftest(*(x.to(dev) for x in cpu))
    want = ptree.field_selftest_plain(*cpu)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.cpu(), w_)


def test_modn_core_matches_ints(dev):
    """The nvcc build of csrc/modn32.cuh: u1 = e*w and u2 = r*w mod n on
    e = 0, n - 1, n, n + 1, 2^256 - 1 against w = 1, n - 1 and r = 1."""
    N = p256.N
    es = [0, N - 1, N, N + 1, (1 << 256) - 1]
    cases = [(e, r, w) for e in es for w in (1, N - 1, 12345)
             for r in (1, N - 1)]
    e = np.stack([np.frombuffer(c[0].to_bytes(32, "big"), ">u4")
                  for c in cases]).astype(np.uint32).view(np.int32)
    r8 = np.stack([_be32(c[1]) for c in cases])
    w8 = np.stack([_be32(c[2]) for c in cases])
    cpu = [torch.as_tensor(x) for x in (e, r8, w8)]
    got = fused_verify.modn_selftest(*(x.to(dev) for x in cpu))
    assert torch.equal(got.cpu(), fused_verify.modn_selftest_plain(*cpu))


def test_kernel_rejects_non_contiguous(dev):
    pts, r, rpn, premask, _ = _lanes(8, 4, seed=1)
    args = [torch.as_tensor(a, device=dev) for a in (pts, r, rpn, premask)]
    with pytest.raises(ValueError):
        ptree.tree_verify_points(args[0].transpose(0, 1).contiguous()
                                 .transpose(0, 1), *args[1:])


def test_provider_on_the_card_matches_sw(dev, monkeypatch):
    """Message lanes down every route on the card: the fused tier on the
    q16 and q8 routes, the resident kernel, SHA-256 on the card with the
    fused tier off; each route's kernels launch once."""
    monkeypatch.delenv("FTPU_FUSED", raising=False)
    monkeypatch.delenv("FTPU_FUSED_RESIDENT", raising=False)
    rng = np.random.default_rng(11)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int(rng.integers(1, 1 << 62)))
             for _ in range(3)]
    items, want = [], []
    for i in range(96):
        k = i % 3
        msg = rng.bytes(100)
        sig = csp.sign(privs[k], hashlib.sha256(msg).digest())
        if i % 7 == 3:
            msg = msg + b"x"
        if i % 11 == 5:
            r, s = utils.unmarshal_signature(sig)
            sig = utils.marshal_signature(r, utils.P256_N - s)
        items.append(api.VerifyItem(key=privs[k].public_key(),
                                    signature=sig, message=msg))
    want = csp.verify_batch(items)
    kernels = ("tree_kernel_launches", "sha_windows_launches",
               "sha256_launches", "resident_launches")
    for cfg, resident, launched in (
            ({}, False, {"tree_kernel_launches", "sha_windows_launches"}),
            ({"UseG16": False}, False,
             {"tree_kernel_launches", "sha_windows_launches"}),
            ({"UseG16": False}, True, {"resident_launches"}),
            ({"UseG16": False, "HashOnHost": False, "FusedVerify": False},
             False, {"tree_kernel_launches", "sha256_launches",
                     "sha_windows_launches"})):
        if resident:
            monkeypatch.setenv("FTPU_FUSED_RESIDENT", "1")
        prov = factory.new_bccsp({"Default": "CUDA", "CUDA": cfg})
        assert prov.device.type == "cuda"
        got = prov.verify_batch(items)
        assert got == want
        assert {k: prov.stats[k] for k in kernels} == {
            k: int(k in launched) for k in kernels}
        assert prov.stats["host_hashed_lanes"] == 0
        monkeypatch.delenv("FTPU_FUSED_RESIDENT", raising=False)


def test_commit_path_one_stage_a_launch(dev):
    """verify_prepared (digest lanes, the commit path) on the q8 route:
    per chunk one stage-A launch (the digest-lanes entry) and one tree
    launch, no other kernel of the port; verdicts equal the sw
    provider's."""
    from fabric_tpu_torch.bccsp.cuda import host_prep_scalars

    rng = np.random.default_rng(12)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int(rng.integers(1, 1 << 62)))
             for _ in range(3)]
    pubs = [k.public_key() for k in privs]
    n = 80
    key_idx = np.arange(n) % 3
    digests = np.zeros((n, 32), np.uint8)
    r8, rpn8, w8 = (np.zeros((n, 32), np.uint8) for _ in range(3))
    der_ok = np.zeros(n, bool)
    sigs = []
    for i in range(n):
        d = hashlib.sha256(rng.bytes(64)).digest()
        sig = csp.sign(privs[key_idx[i]], d)
        if i % 9 == 4:
            d = bytes([d[0] ^ 1]) + d[1:]
        sigs.append(sig)
        digests[i] = np.frombuffer(d, np.uint8)
        prep = host_prep_scalars(pubs[key_idx[i]], sig)
        if prep is not None:
            der_ok[i] = True
            r8[i], rpn8[i], w8[i] = (np.frombuffer(x, np.uint8) for x in prep)
    want = [csp.verify(pubs[key_idx[i]], sigs[i], bytes(digests[i]))
            for i in range(n)]
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "UseG16": False, "Chunk": 64}})
    got = prov.verify_prepared(digests, r8, rpn8, w8, der_ok, key_idx, pubs,
                               sigs.__getitem__)
    assert got == want and not all(want)
    chunks = prov._bucket(n) // 64
    assert {k: prov.stats[k] for k in (
        "tree_kernel_launches", "sha_windows_launches", "sha256_launches",
        "resident_launches")} == {
        "tree_kernel_launches": chunks, "sha_windows_launches": chunks,
        "sha256_launches": 0, "resident_launches": 0}


def test_telemetry_on_the_card(dev):
    """The provider's telemetry on the commit path: verify_prepared on
    256 lanes adds busy seconds (CUDA events) above 0 and at most the
    call's wall, books one build event per library it loads, records its
    spans; device_memory() gives the card's one row and health() reads
    "device"."""
    import time

    from fabric_tpu_torch import native
    from fabric_tpu_torch.common import devicecost, tracing

    rng = np.random.default_rng(13)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int(rng.integers(1, 1 << 62)))
             for _ in range(3)]
    pubs = [k.public_key() for k in privs]
    n = 256
    key_idx = np.arange(n) % 3
    digests = np.stack([np.frombuffer(hashlib.sha256(rng.bytes(64)).digest(),
                                      np.uint8) for _ in range(n)])
    sigs = [csp.sign(privs[key_idx[i]], bytes(digests[i])) for i in range(n)]
    digests[5, 0] ^= 1
    der_ok, r8, rpn8, w8 = native.batch_prep(sigs)
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "UseG16": False, "Chunk": 128}})
    tracing.reset()
    t0 = time.perf_counter()
    got = prov.verify_prepared(digests, r8, rpn8, w8, der_ok, key_idx, pubs,
                               sigs.__getitem__)
    wall = time.perf_counter() - t0
    assert got == [i != 5 for i in range(n)]
    busy = prov.device_cost.busy.totals()
    assert set(busy) == {0} and 0 < busy[0] <= wall
    assert sorted(e["kind"] for e in prov.device_cost.events) == [
        "ptree", "sha_windows"]
    assert prov.stats["compile_total"] == 2 and prov.device_cost.steady
    assert [e[1] for e in tracing.snapshot()
            if e[1].startswith("tpu.")][-3:] == [
        "tpu.dispatch", "tpu.verify", "tpu.verify"]
    rows = devicecost.device_memory()
    assert len(rows) == torch.cuda.device_count()
    assert rows[0]["kind"] == torch.cuda.get_device_name(0)
    assert 0 < rows[0]["bytes_in_use"] <= rows[0]["peak_bytes_in_use"] \
        <= rows[0]["bytes_limit"]
    assert prov.health() == "device"


def test_table_copies_round_trip_on_the_card(dev):
    """The Q tables' persist and restore copies: device to pinned host
    memory on a side stream after the build's event, and back on a side
    stream; the bytes unchanged both ways."""
    from fabric_tpu_torch.bccsp.cuda import CUDAProvider

    prov = CUDAProvider(device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    table = torch.randint(-2**31, 2**31 - 1, (4096, 3, limb.L),
                          dtype=torch.int32, device=dev, generator=g)
    ready = torch.cuda.Event()
    ready.record()
    host = prov._table_to_host(table, ready)
    assert host.dtype == np.int32 and np.array_equal(host,
                                                     table.cpu().numpy())
    back = prov._table_to_device(host.copy())
    assert back.device == table.device and torch.equal(back, table)


def test_warm_dir_restore_on_the_card(dev, tmp_path, monkeypatch):
    """A Q16 table built on the card persists through the persist thread
    and a fresh provider's prewarm restores it bit for bit, without a
    build (the table builds stubbed to seeded tensors on the card)."""
    from fabric_tpu_torch.bccsp.cuda import CUDAProvider

    g = torch.Generator(device=dev).manual_seed(6)
    q8 = torch.randint(0, 1 << 13, (512, 3, limb.L), dtype=torch.int32,
                       device=dev, generator=g)
    q16 = torch.randint(0, 1 << 13, (2048, 3, limb.L), dtype=torch.int32,
                        device=dev, generator=g)
    monkeypatch.setattr(comb, "build_q_tables", lambda qx, qy: q8.clone())
    monkeypatch.setattr(comb, "build_q16_tables", lambda t, K: q16.clone())
    monkeypatch.setattr(comb, "g16_tables", lambda device: None)
    monkeypatch.setattr(CUDAProvider, "_q16_est_bytes",
                        lambda self, K: q16.numel() * 4)
    key = (bytes(range(64)),)
    qk = np.frombuffer(key[0], np.uint8).reshape(1, 64).copy()
    warm = str(tmp_path / "warm")
    p1 = CUDAProvider(device=dev, table_cache_bytes=1 << 20,
                      warm_keys_dir=warm)
    assert torch.equal(p1._q16_cached(key, 1, qk), q16)
    p1.flush_warm_tables()
    p2 = CUDAProvider(device=dev, table_cache_bytes=1 << 20,
                      warm_keys_dir=warm)
    p2.prewarm(wait_restore=True)
    assert p2.stats["q16_disk_loads"] == 1 and p2.stats["q16_builds"] == 0
    assert torch.equal(p2._q16_cached(key, 1, qk), q16)


# -- the fused tier's kernels --

EDGE_LENS = (0, 1, 55, 56, 63, 64, 119, 120, 503)


def _stage(B, seed):
    """B lanes at NB = 8: the edge lengths, random ones, garbage past
    every count; digest lanes with digest 0 and all-ones; w = 1,
    w = n - 1, r = 1; key slots in [0, 4) with one out of range."""
    rng = np.random.default_rng(seed)
    N = p256.N
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 504, size=B)]
    for j, n in enumerate(EDGE_LENS):
        msgs[j] = rng.bytes(n)
    blocks, counts = sha256.pack_messages(msgs, 8)
    past = np.arange(8)[None, :] >= counts[:, None]
    blocks[past] = rng.integers(0, 1 << 32, size=(int(past.sum()), 16),
                                dtype=np.uint32)
    has = np.zeros(B, bool)
    has[[9, 10]] = True
    dig = np.zeros((B, 8), np.uint32)
    dig[10] = 0xFFFFFFFF
    rs = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(B)]
    ws = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(B)]
    ws[11], ws[12], rs[13] = 1, N - 1, 1
    key_idx = rng.integers(0, 4, size=B).astype(np.int32)
    key_idx[14] = 4
    return dict(msgs=msgs, blocks=blocks, counts=counts, has=has, dig=dig,
                nblocks=np.where(has, 0, counts).astype(np.int32),
                r8=np.stack([_be32(x) for x in rs]),
                w8=np.stack([_be32(x) for x in ws]),
                key_idx=key_idx, premask=rng.random(B) < 0.9)


def _on(dev, st, *names):
    return [torch.as_tensor(st[n]).to(dev) for n in names]


def test_sha256_kernel_matches_plain_and_hashlib(dev):
    st = _stage(300, seed=1)
    blocks, counts = _on(dev, st, "blocks", "counts")
    before = sha256.launches
    got = sha256.sha256_blocks(blocks, counts)
    assert sha256.launches == before + 1
    plain = sha256.sha256_plain(blocks, counts)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    want = np.stack([np.frombuffer(hashlib.sha256(m).digest(), ">u4")
                     for m in st["msgs"]]).astype(np.int64)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("wbits", [(8, 8), (16, 16)])
def test_sha_windows_kernel_matches_plain(dev, wbits):
    st = _stage(300, seed=2)
    args = _on(dev, st, "blocks", "nblocks", "dig", "has", "r8", "w8")
    before = fused_verify.sha_windows_launches
    got = fused_verify.sha_windows(*args, wbits_g=wbits[0], wbits_q=wbits[1])
    assert fused_verify.sha_windows_launches == before + 1
    plain = fused_verify.sha_windows_plain(*args, *wbits)
    torch.cuda.synchronize()
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


@pytest.mark.parametrize("wbits", [(8, 8), (16, 16)])
def test_digest_windows_kernel_matches_plain(dev, wbits):
    """The digest-lanes entry: every lane's hashlib digest, with the
    digests 0, 2^256 - 1 and n written into lanes 9-11."""
    st = _stage(300, seed=4)
    words = np.stack([np.frombuffer(hashlib.sha256(m).digest(), ">u4")
                      for m in st["msgs"]]).astype(np.uint32)
    words[9] = 0
    words[10] = 0xFFFFFFFF
    words[11] = np.frombuffer(p256.N.to_bytes(32, "big"), ">u4")
    args = [torch.as_tensor(words.view(np.int32)).to(dev),
            *_on(dev, st, "r8", "w8")]
    before = fused_verify.sha_windows_launches
    got = fused_verify.digest_windows(*args, wbits_g=wbits[0],
                                      wbits_q=wbits[1])
    assert fused_verify.sha_windows_launches == before + 1
    plain = fused_verify.digest_windows_plain(*args, *wbits)
    torch.cuda.synchronize()
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def _q8_ints(keys) -> np.ndarray:
    """The 8-bit Q table of `keys` over Python ints (build_q_tables'
    chain), canonical limbs: seconds, where the eager build on the card
    takes ~15 s of launches."""
    nwin, nent = comb.NWIN, comb.NENT
    out = np.zeros((nwin, len(keys), nent, 3, limb.L), np.int32)
    out[:, :, 0, 1, 0] = 1
    for k, (x, y) in enumerate(keys):
        base = (x, y, 1)
        for i in range(nwin):
            acc, ents = base, [base]
            for _ in range(2, nent):
                acc = p256.cadd_int(acc, base)
                ents.append(acc)
            out[i, k, 1:] = limb.ints_to_limbs(
                [c % p256.P for e in ents for c in e]).reshape(
                    nent - 1, 3, limb.L)
            for _ in range(comb.WBITS):
                base = p256.cdbl_int(base)
    return out.reshape(nwin * len(keys) * nent, 3, limb.L)


def test_resident_kernel_matches_plain_and_tiered(dev):
    """Random scalars give rejects on almost every lane; the stage-A,
    gather and tree parts are held separately above, so here the point
    is the kernel = its plain version = the tiered kernels, lane by
    lane, an out-of-range key slot rejecting."""
    st = _stage(160, seed=3)
    keys = [p256.to_affine_int(p256.scalar_mul_int(
        d, (p256.GX, p256.GY, 1))) for d in (3, 5, 7, 11)]
    q8 = torch.as_tensor(_q8_ints(keys), device=dev)
    blocks, nblocks, key_idx, dig, has, premask, r8_t, w8_t = _on(
        dev, st, "blocks", "nblocks", "key_idx", "dig", "has", "premask",
        "r8", "w8")
    args = (blocks, nblocks, key_idx, q8, r8_t, r8_t, w8_t, premask, dig,
            has)
    before = fused_verify.resident_launches
    got = fused_verify.fused_verify_resident(*args)
    assert fused_verify.resident_launches == before + 1
    plain = fused_verify.resident_plain(
        blocks, nblocks, key_idx, q8, r8_t, r8_t, w8_t, premask, dig, has,
        comb.g_tables_on(dev))
    ok = (key_idx >= 0) & (key_idx < 4)
    tiered = fused_verify.fused_verify_with_tables(
        blocks, nblocks, key_idx.clamp(0, 3), q8, r8_t, r8_t, w8_t,
        premask & ok, dig, has)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(got, tiered)
    assert not bool(got[14])
    for T in (1, 2, 8):
        again = fused_verify.fused_verify_resident(*args, threads_per_lane=T)
        torch.cuda.synchronize()
        assert torch.equal(again, plain)


# -- the Shamir ladder and Ed25519 (csrc/ladder.cu, ed25519_verify.cu) --

class _InProcess:
    """chip_smoke's pool helpers, run in this process."""

    @staticmethod
    def map(fn, chunks):
        return [fn(c) for c in chunks]


def test_dbl_and_f25_cores_match_ints(dev):
    """The nvcc builds of pt_dbl (p256_field.cuh) against cdbl_int on G,
    -G, infinity, a 2-torsion-like input and random points; of the
    2^255 - 19 core and ed_add/ed_dbl (fe25519.cuh) against Python ints
    on edge operands, B, the identity, a small-order point and random
    points."""
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    from fabric_tpu_torch.ops import ed25519, verify

    P = p256.P
    g = (p256.GX, p256.GY, 1)
    pts = [g, (p256.GX, P - p256.GY, 1), (0, 1, 0), (p256.GX, 0, 1)] + [
        p256.scalar_mul_int(k, g) for k in (2, 3, 12345, p256.N - 1)]
    p13 = torch.as_tensor(np.stack([np.concatenate(
        [limb.int_to_limbs(c % P) for c in q]) for q in pts]))
    got = verify.dbl_selftest(p13.to(dev))
    assert torch.equal(got.cpu(), verify.dbl_selftest_plain(p13))

    PE = ed25519.P_ED
    vals = [0, 1, PE - 1, PE, PE + 1, (1 << 255) - 1, (1 << 256) - 1]

    def words(rows):
        return torch.as_tensor(np.array(
            [[(v >> (32 * i)) & 0xFFFFFFFF for v in row for i in range(8)]
             for row in rows], dtype=np.uint32).view(np.int32))
    a = words([[x] for x in vals for _ in vals])
    b = words([[y] for _ in vals for y in vals])
    got = ed25519.f25_selftest(a.to(dev), b.to(dev))
    assert torch.equal(got.cpu(), ed25519.f25_selftest_plain(a, b))
    Bp = edh.from_affine(edh.BX, edh.BY)
    eps = [Bp, edh._IDENT, (0, PE - 1, 1, 0),
           edh.from_affine(*edh.to_affine(edh.scalar_mult(77, Bp)))]
    cases = [(p, q) for p in eps for q in eps]
    ep = words([[c % PE for c in p] for p, _ in cases])
    eq = words([[c % PE for c in q] for _, q in cases])
    got = ed25519.ed_selftest(ep.to(dev), eq.to(dev))
    assert torch.equal(got.cpu(), ed25519.ed_selftest_plain(ep, eq))


def test_ladder_kernel_matches_plain_and_ints(dev):
    """Both ladder entries (digest lanes; message lanes: the SHA kernel
    then the digest entry) on chip_smoke's edge lanes (u1 = 0, R at
    infinity, the rpn candidate, table entries at infinity and doublings,
    premask off, message lengths 0 to 503) and a small block over 23
    keys: kernel = plain version on every lane, = Python ints on the
    edge lanes, = the expected bitmap beyond."""
    import chip_smoke as cs

    from fabric_tpu_torch.ops import verify

    pool = _InProcess()
    blk = cs.make_block(5, 16, pool, 1, clients=20)
    edges = cs.ladder_edges(blk, np.random.default_rng(6))
    h = cs.ladder_lanes(blk, 64, 8, edges)
    t = cs._ladder_tensors(h, dev)
    before = verify.launches, sha256.launches
    got = {"digests": verify.ladder_verify_digests(*t["digests"]),
           "message": verify.ladder_verify(*t["message"])}
    # the message entry: the SHA kernel, then the ladder on the digests
    assert (verify.launches, sha256.launches) == (before[0] + 2,
                                                  before[1] + 1)
    plain = {"digests": verify.ladder_digests_plain(*t["digests"]),
             "message": verify.ladder_plain(*t["message"])}
    torch.cuda.synchronize()
    E = len(edges)
    want = []
    for kind, e, r, rpn, w, q, pm, msg in edges:
        if msg is not None:
            e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
        want.append(cs._ladder_int(e, r, rpn, w, q, pm))
    for entry in got:
        assert torch.equal(got[entry], plain[entry]), entry
        kh = got[entry].cpu().numpy()
        assert kh[:E].tolist() == want, entry
        n = min(blk["n"], 64)
        np.testing.assert_array_equal(kh[E:n], blk["expected"][E:n])


def test_ed25519_kernel_matches_plain_and_ints(dev):
    """The Ed25519 kernel on chip_smoke's edge rows (S = 0, k = 0, RFC
    8032 test 1, identity operands, a dead lane, R off by one point, k
    whose signed digits hit -8, 7 and a carried top digit, an identity
    R) and signed lanes: kernel = ed25519.verify_core on every lane =
    Python ints / ed25519_host.verify."""
    import chip_smoke as cs

    from fabric_tpu_torch.bccsp import ed25519_host as edh
    from fabric_tpu_torch.ops import ed25519

    rng = np.random.default_rng(9)
    edges = cs.ed25519_edges(rng)
    seeds = [rng.bytes(32) for _ in range(4)]
    signed = []
    for i in range(20):
        msg = rng.bytes(int(rng.integers(0, 300)))
        sig = edh.sign(seeds[i % 4], msg)
        pk = edh.public_from_seed(seeds[i % 4])
        if i % 5 == 2:
            msg = msg + b"x"
        signed.append((edh.prep_verify(pk, sig, msg),
                       edh.verify(pk, sig, msg)))
    ops = [op for _, op, _ in edges] + [p for p, _ in signed]
    n = 64
    rows = ed25519.stage_rows(ops, n)
    rows[6][:len(edges)] = [pm for _, _, pm in edges]
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in rows]
    ktab = ed25519.device_table(dev)
    ptab = torch.as_tensor(ed25519.b_tables(), device=dev)
    before = ed25519.launches
    got = ed25519.ed25519_verify(ktab, *t)
    assert ed25519.launches == before + 1
    plain = ed25519.verify_core(ptab, *t)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    want = [cs._ed_int(*op, pm) for _, op, pm in edges] + [
        v for _, v in signed] + [False] * (n - len(ops))
    assert got.cpu().numpy().tolist() == want


def test_provider_ladder_and_ed25519_on_the_card(dev):
    """17 distinct P-256 keys take the ladder on the card (verify_batch
    with SHA-256 in the kernel, verify_prepared on digest lanes), and a
    batch mixed with Ed25519 lanes splits across the ladder and the
    Ed25519 kernel; verdicts equal the sw provider's."""
    from fabric_tpu_torch.bccsp.cuda import host_prep_scalars

    rng = np.random.default_rng(13)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int(rng.integers(1, 1 << 62)))
             for _ in range(17)]
    eds = [csp.key_gen(api.Ed25519KeyGenOpts()) for _ in range(3)]
    items = []
    for i in range(48):
        msg = rng.bytes(120)
        if i % 3 == 2:
            k = eds[i % 3]
            sig = csp.sign(k, msg)
        else:
            k = privs[i % 17]
            sig = csp.sign(k, hashlib.sha256(msg).digest())
        if i % 7 == 3:
            msg = msg + b"x"
        items.append(api.VerifyItem(key=k.public_key(), signature=sig,
                                    message=msg))
    want = csp.verify_batch(items)
    prov = factory.new_bccsp({"Default": "CUDA"})
    assert prov.verify_batch(items) == want
    assert prov.stats["ladder_batches"] == 1
    assert prov.stats["ladder_launches"] == 1
    assert prov.stats["sha256_launches"] == 1
    assert prov.stats["ed25519_launches"] == 1
    assert prov.stats["tree_kernel_launches"] == 0
    p_items = [it for i, it in enumerate(items) if i % 3 != 2]
    pubs = [k.public_key() for k in privs]
    slot = {id(p): j for j, p in enumerate(pubs)}
    prep = [host_prep_scalars(it.key, it.signature) for it in p_items]
    rows = [np.stack([np.frombuffer(p[c], np.uint8) for p in prep])
            for c in range(3)]
    got = prov.verify_prepared(
        np.stack([np.frombuffer(hashlib.sha256(it.message).digest(),
                                np.uint8) for it in p_items]),
        *rows, np.ones(len(p_items), bool),
        np.array([slot[id(it.key)] for it in p_items]), pubs,
        lambda i: p_items[i].signature)
    assert got == [w for i, w in enumerate(want) if i % 3 != 2]
    assert prov.stats["ladder_launches"] == 2


# -- BN254 (the idemix pairings) --

def _bn_points(seed, n):
    import random

    from fabric_tpu_torch.ops import bn254_ref as bref
    rng = random.Random(seed)
    g2 = (bref.G2_X, bref.G2_Y)
    ps = [bref.g1_mul_fast(rng.randrange(2, bref.R), bref.G1)
          for _ in range(n)]
    qs = [bref.g2_mul_fast(rng.randrange(2, bref.R), g2) for _ in range(n)]
    ps[0], qs[0] = bref.G1, g2
    return ps, qs


def test_bn254_core_and_tower_match_ints(dev):
    """csrc/bn254_field.cuh and bn254_tower.cuh (nvcc, bn254_pairing.cu)
    against Python ints and the plain tower: words equal."""
    import random

    from fabric_tpu_torch.ops import bn254
    from fabric_tpu_torch.ops import bn254_ref as bref
    P = bref.P
    rng = random.Random(95)
    edges = [0, 1, P - 1, P, P + 1]
    pairs = [(a, b) for a in edges for b in edges] + [
        (rng.randrange(2 * P), rng.randrange(2 * P)) for _ in range(64)]

    def words(vals):
        return torch.as_tensor(np.array(
            [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
             for v in vals], dtype=np.uint32).view(np.int32))
    a, b = words(x for x, _ in pairs), words(y for _, y in pairs)
    got = bn254.fp_selftest(a.to(dev), b.to(dev)).cpu()
    assert torch.equal(got, bn254.fp_selftest_plain(a, b))
    cases = words(rng.randrange(P) for _ in range(36 * 3)).reshape(3, -1)
    got = bn254.tower_selftest(cases.to(dev)).cpu()
    assert torch.equal(got, bn254.tower_selftest_plain(cases))


def test_bn254_miller_and_final_exp_match_plain(dev):
    """In every layout the entries build (bn254.LAYOUTS, threads a lane):
    the Miller entry at a truncated loop on 6 lanes (pad lanes past B in
    the groups of a warp) and the final-exp entry on a short two-term
    program (squarings cyclotomic after its easy part) against their
    plain versions on the card (canonical limbs equal); the full loop and
    program on two lanes against bn254_ref.pairing."""
    from fabric_tpu_torch.ops import bn254, tower
    from fabric_tpu_torch.ops import bn254_ref as bref
    ps, qs = _bn_points(96, 6)
    st = bn254.to_device(bn254.stage_g1(ps) + bn254.stage_g2(qs), dev)
    loop = 0b1011010
    plain = tower.flat_from_f12(bn254.miller_loop_plain(*st, loop=loop))
    A = bn254._Asm()
    A.conj(2, 0)
    A.mul(2, 2, 1)
    A.frob(6, 2)
    A.frob(6, 6)
    A.mul(2, 6, 2)
    A.pow_static(3, 2, 7, 0b1101)
    A.mul(0, 3, 2)
    assert bn254.cyclotomic_row(A.program()) == 5
    full_st = bn254.to_device(bn254.stage_g1(ps[:2]) + bn254.stage_g2(qs[:2]),
                              dev)
    for group in bn254.LAYOUTS:
        m0, f0 = bn254.miller_launches, bn254.final_exp_launches
        got = tower.flat_from_f12(bn254.miller_loop_batch(
            *st, loop=loop, group=group))
        assert bn254.miller_launches == m0 + 1
        assert torch.equal(got, bn254.F.canonical(plain)), group
        gt, ok = bn254._final_exp_kernel(got, 2, 3, A.program(), group=group)
        assert bn254.final_exp_launches == f0 + 1
        prod = bn254.f12_mul(tower.f12_from_flat(got[:, :3]),
                             tower.f12_from_flat(got[:, 3:]))
        want = bn254.final_exp_plain(prod, A.program())
        assert torch.equal(gt, bn254.F.canonical(tower.flat_from_f12(want)))
        assert torch.equal(ok, bn254.gt_is_one(want))
        f = tower.flat_from_f12(bn254.miller_loop_batch(*full_st,
                                                        group=group))
        full, _ = bn254._final_exp_kernel(f, 1, 2, bn254._FINAL_EXP_PROGRAM,
                                          group=group)
        assert bn254.f12_from_device(tower.f12_from_flat(full)) == [
            bref.pairing(qs[i], ps[i]) for i in range(2)], group


def test_bn254_coop_selftest_matches_plain(dev):
    """csrc/pairing_coop.cuh on BN254's tower (a warp a case): the group's
    and the serial formulas against the plain tower, the binary Euclid
    inverse against Fermat's, on cases whose x starts with 0, 1 and p - 1;
    the clock words are counts."""
    import random

    from fabric_tpu_torch.ops import bn254
    from fabric_tpu_torch.ops import bn254_ref as bref
    P = bref.P
    rng = random.Random(98)
    vals = [[e] + [rng.randrange(P) for _ in range(29)] for e in (0, 1, P - 1)]
    for v in vals:           # c: a value past the easy part (cyclotomic)
        x = (tuple(tuple(v[2 * j:2 * j + 2]) for j in range(3)),
             tuple(tuple(v[6 + 2 * j:8 + 2 * j]) for j in range(3)))
        m = bref.f12_mul(bref.f12_conj(x), bref.f12_inv(x))
        c = bref.f12_mul(bref.f12_frob(bref.f12_frob(m)), m)
        v += [z for h in c for f2 in h for z in f2]
    cases = torch.as_tensor(np.array(
        [[(x >> (32 * i)) & 0xFFFFFFFF for x in v for i in range(8)]
         for v in vals], dtype=np.uint32).view(np.int32))
    got = bn254.coop_selftest(cases.to(dev)).cpu()
    want = bn254.coop_selftest_plain(cases)
    nw = 8 * bn254.COOP_OUT
    assert torch.equal(got[:, :nw], want[:, :nw])
    assert (got[:, nw:] > 0).all()


def test_bn254_msm_matches_plain_and_ints(dev):
    """The MSM entry on 8-bit scalars (k = 0, Q + (-Q), Q + Q lanes)
    against its plain version (the chain, g2_msm_chain) on the card limb
    for limb and the host MSM; full-width scalars (r - 1, the subgroup
    lane's 6x^2) against the host MSM."""
    import random

    from fabric_tpu_torch.ops import bn254
    from fabric_tpu_torch.ops import bn254_ref as bref
    rng = random.Random(97)
    g2 = (bref.G2_X, bref.G2_Y)
    T = bref.g2_mul_fast(4242, g2)
    lanes = [[(rng.randrange(1 << 8), g2), (rng.randrange(1 << 8), T),
              (rng.randrange(1 << 8), T)] for _ in range(5)]
    lanes += [[(0, g2), (0, None), (0, g2)],
              [(7, T), (0, None), (7, bref.g2_neg_tw(T))],
              [(1, T), (1, T), (0, None)]]
    kw, qf = bn254.stage_g2_msm_words(lanes)
    kw = torch.as_tensor(kw.view(np.int32))
    q = [torch.as_tensor(a) for a in qf]
    before = bn254.msm_launches
    got = bn254.g2_msm(kw.to(dev), *[a.to(dev) for a in q], nbits=8)
    assert bn254.msm_launches == before + 1
    plain = bn254.g2_msm_chain(bn254.words_to_bits(kw.to(dev), 8),
                               *[a.to(dev) for a in q])
    for (ga, gb), (pa, pb) in zip(got, plain):
        assert torch.equal(ga, bn254.F.canonical(pa))
        assert torch.equal(gb, bn254.F.canonical(pb))
    assert bn254.read_g2_msm(got) == [bref.g2_msm(lane) for lane in lanes]
    full = [[(rng.randrange(bref.R), g2), (rng.randrange(bref.R), T),
             (bref.R - 1, T)], [(6 * bref.T_BN ** 2, T), (0, None),
                                (0, None)]]
    kw, qf = bn254.stage_g2_msm_words(full)
    out = bn254.g2_msm(torch.as_tensor(kw.view(np.int32)).to(dev),
                       *[torch.as_tensor(a).to(dev) for a in qf])
    assert bn254.read_g2_msm(out) == [bref.g2_msm(lane) for lane in full]


@pytest.mark.parametrize("nterms", [9, 17])
def test_provider_g2_msm_beyond_local_tables(dev, nterms):
    """CUDAProvider.g2_msm_batch on lanes of more terms than the kernel's
    local joint tables hold (its scratch-table instance) against
    bn254_ref.g2_msm, full-width scalars, with an entry at infinity and
    an all-zero lane; and the entry itself limb for limb against the
    plain chain on 8-bit scalars."""
    import random

    from fabric_tpu_torch.ops import bn254
    from fabric_tpu_torch.ops import bn254_ref as bref
    rng = random.Random(99 + nterms)
    g2 = (bref.G2_X, bref.G2_Y)
    T = bref.g2_mul_fast(4243, g2)
    pts = [g2, T, bref.g2_neg_tw(T)]
    lanes = [[(rng.randrange(bref.R), pts[t % 3]) for t in range(nterms)]
             for _ in range(3)]
    lanes.append([(5, T), (5, bref.g2_neg_tw(T))]
                 + [(0, None)] * (nterms - 3) + [(1, g2)])
    lanes.append([(0, None)] * nterms)
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {"MinBatch": 4}})
    assert prov.g2_msm_batch(lanes) == [bref.g2_msm(lane) for lane in lanes]
    assert prov.stats["g2_msm_launches"] == 1
    small = [[(rng.randrange(1 << 8), pts[t % 3]) for t in range(nterms)]
             for _ in range(40)]
    kw, qf = bn254.stage_g2_msm_words(small)
    kt = torch.as_tensor(kw.view(np.int32)).to(dev)
    qt = [torch.as_tensor(a).to(dev) for a in qf]
    got = bn254.g2_msm(kt, *qt, nbits=8)
    plain = bn254.g2_msm_chain(bn254.words_to_bits(kt, 8), *qt)
    for g_, p_ in zip(got, plain):
        for a, b in zip(g_, p_):
            assert torch.equal(a, bn254.F.canonical(b))
    assert bn254.read_g2_msm(got) == [bref.g2_msm(lane) for lane in small]


def test_bn254_msm_warps_match_chain(dev):
    """Warps of mixed lanes (three scalars, one scalar of each length,
    all zero) in a random order and in the provider's class order
    (bn254.msm_order), 8-bit scalars over 200 lanes and five terms over
    70 (two joint tables): a warp starts at its longest lane and skips
    the additions none of its lanes needs, and each lane still equals the
    plain chain limb for limb (its leading steps keep infinity as it
    is)."""
    import random

    from fabric_tpu_torch.ops import bn254
    from fabric_tpu_torch.ops import bn254_ref as bref
    rng = random.Random(98)
    g2 = (bref.G2_X, bref.G2_Y)
    pts = [bref.g2_mul_fast(rng.randrange(2, 1 << 30), g2) for _ in range(4)]
    def scalars(kind, nterms):
        if kind == 0:                               # every term
            return [rng.randrange(1 << 8) for _ in range(nterms)]
        if kind == 1:                               # one, of any length
            return [rng.randrange(1 << rng.randrange(1, 9))] + [0] * (
                nterms - 1)
        if kind == 2:                               # all zero
            return [0] * nterms
        return [0, rng.randrange(1 << 4)] + [0] * (nterms - 2)

    for nterms, n in ((3, 200), (5, 70)):
        lanes = [[(k, pts[(i + t) % 4]) for t, k in enumerate(
            scalars(rng.randrange(4), nterms))] for i in range(n)]
        for order in (np.arange(n), None):
            kw, qf = bn254.stage_g2_msm_words(lanes)
            if order is None:
                order = bn254.msm_order(kw)
            kt = torch.as_tensor(np.ascontiguousarray(kw[order]).view(
                np.int32)).to(dev)
            qt = [torch.as_tensor(np.ascontiguousarray(a[order])).to(dev)
                  for a in qf]
            got = bn254.g2_msm(kt, *qt, nbits=8)
            plain = bn254.g2_msm_chain(bn254.words_to_bits(kt, 8), *qt)
            for g_, p_ in zip(got, plain):
                for a, b in zip(g_, p_):
                    assert torch.equal(bn254.F.canonical(a),
                                       bn254.F.canonical(b))
        want = [bref.g2_msm(lanes[i]) for i in order.tolist()]
        assert bn254.read_g2_msm(got) == want


def test_provider_pairing_methods_match_sw(dev):
    """CUDAProvider's pairing_check_batch, bls_verify_batch and
    g2_msm_batch on the card against the port's sw provider and the host
    MSM; one Miller and one final-exp launch per chunk."""
    from fabric_tpu_torch.ops import bn254_ref as bref
    ps, qs = _bn_points(98, 5)
    prods = []
    for i, (p, q) in enumerate(zip(ps, qs)):
        q2 = qs[(i + 1) % 5] if i in (1, 3) else q
        prods.append([(p, q), (p, bref.g2_neg_tw(q2))])
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {"MinBatch": 4}})
    csp = sw.SWProvider()
    got = prov.pairing_check_batch(prods)
    assert got == csp.pairing_check_batch(prods) == [
        True, False, True, False, True]
    assert prov.stats["miller_launches"] == 1
    assert prov.stats["final_exp_launches"] == 1
    assert prov.stats["pairing_pairs"] == 10
    sk, pk = bref.bls_keygen(b"card")
    msgs = [b"a", b"b", b"c", b"d"]
    sigs = [bref.g1_mul_fast(sk, bref.hash_to_g1(m)) for m in msgs]
    sigs[1] = bref.g1_mul_fast(sk, bref.hash_to_g1(b"other"))
    sigs[2] = None
    assert prov.bls_verify_batch(pk, msgs, sigs) == \
        csp.bls_verify_batch(pk, msgs, sigs) == [True, False, False, True]
    lanes = [[(7, qs[1]), (11, qs[2]), (bref.R - 3, qs[3])],
             [(6 * bref.T_BN ** 2, qs[4]), (0, None), (0, None)],
             [(5, qs[0]), (0, None), (5, bref.g2_neg_tw(qs[0]))]]
    assert prov.g2_msm_batch(lanes) == [bref.g2_msm(lane) for lane in lanes]
    assert prov.stats["g2_msm_launches"] == 1


# -- BLS12-381 (the orderer's aggregate verify) --

def _bls_pairs(seed, n):
    import random

    from fabric_tpu_torch.ops import bls12_381_ref as lref
    rng = random.Random(seed)
    g2 = (lref.G2_X, lref.G2_Y)
    return [(lref.G1, g2)] + [
        (lref.g1_mul(rng.randrange(2, lref.R), lref.G1),
         lref.g2_mul(rng.randrange(2, lref.R), g2)) for _ in range(n - 1)]


def test_bls12_381_core_and_tower_match_ints(dev):
    """csrc/bls12_381_field.cuh and bls12_381_tower.cuh (nvcc,
    bls12_381_pairing.cu) against Python ints and the plain tower."""
    import random

    from fabric_tpu_torch.ops import bls12_381_kernel as blsk
    P = blsk.ref.P
    rng = random.Random(99)
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    pairs = [(a, b) for a in edges for b in edges] + [
        (rng.randrange(2 * P), rng.randrange(2 * P)) for _ in range(64)]

    def words(vals):
        return torch.as_tensor(np.array(
            [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
             for v in vals], dtype=np.uint32).view(np.int32))
    a, b = words(x for x, _ in pairs), words(y for _, y in pairs)
    got = blsk.fp_selftest(a.to(dev), b.to(dev)).cpu()
    assert torch.equal(got, blsk.fp_selftest_plain(a, b))
    cases = words(rng.randrange(P) for _ in range(36 * 2)).reshape(2, -1)
    got = blsk.tower_selftest(cases.to(dev)).cpu()
    assert torch.equal(got, blsk.tower_selftest_plain(cases))


def test_bls12_381_coop_layer_matches_plain(dev):
    """csrc/pairing_coop.cuh (a warp a case) and the serial formulas it
    distributes: Fp12 squaring, the sparse line product, the cyclotomic
    squaring (on a value past the easy part), the product, inverse and
    Frobenius, and the binary Euclid inverse on 0, 1 and p - 1, against
    the plain tower and Python ints."""
    import random

    from fabric_tpu_torch.ops import bls12_381_kernel as blsk
    lref = blsk.ref
    P = lref.P
    rng = random.Random(98)

    def f12():
        return tuple(tuple((rng.randrange(P), rng.randrange(P))
                           for _ in range(3)) for _ in range(2))

    def flat(el):
        return [x for half in el for f2 in half for x in f2]
    vals = []
    for e in (0, 1, P - 1, rng.randrange(P)):
        m = f12()
        m = lref.f12_mul(lref.f12_conj(m), lref.f12_inv(m))
        c = lref.f12_mul(lref._frob2(m), m)
        vals.append([e] + flat(f12())[1:] + flat(f12())
                    + flat(f12())[:6] + flat(c))
    cases = torch.as_tensor(np.array(
        [[(v >> (32 * i)) & 0xFFFFFFFF for v in row for i in range(12)]
         for row in vals], dtype=np.uint32).view(np.int32))
    got = blsk.coop_selftest(cases.to(dev)).cpu()
    want = blsk.coop_selftest_plain(cases)
    n = 12 * blsk.COOP_OUT
    assert torch.equal(got[:, :n], want[:, :n])
    assert bool((got[:, n:] > 0).all())            # both inverses' cycles


def test_bls12_381_entries_match_plain(dev):
    """The Miller entry at a truncated loop (a masked lane among them),
    the reduce and the final-exp entry on a short program against their
    plain versions on the card (canonical limbs equal), each one launch;
    the full Miller loop, reduce and program
    against bls12_381_ref on a product that is one."""
    from fabric_tpu_torch.ops import bls12_381 as blsagg
    from fabric_tpu_torch.ops import bls12_381_kernel as blsk
    from fabric_tpu_torch.ops import tower
    lref = blsk.ref
    st = blsk.to_device(blsk.stage_pairs(_bls_pairs(100, 7)), dev)
    Q = ((st[2], st[3]), (st[4], st[5]))
    loop = 0b1011010
    m0, r0, f0 = (blsk.miller_launches, blsk.reduce_launches,
                  blsk.final_exp_launches)
    got = tower.flat_from_f12(blsk.miller_loop_batch(st[0], st[1], Q,
                                                     loop=loop, mask=st[6]))
    plain = blsk.miller_loop_plain(st[0], st[1], Q, loop=loop)
    plain = tower.select_f12(st[6], plain, blsk.f12_one_like(st[0]))
    assert torch.equal(got, blsk.F.canonical(tower.flat_from_f12(plain)))
    red = tower.flat_from_f12(blsk.product_reduce(tower.f12_from_flat(got)))
    want = tower.flat_from_f12(blsk.product_reduce_plain(plain))
    assert torch.equal(red, blsk.F.canonical(want))
    A = tower.Asm()
    A.conj(2, 0)
    A.mul(2, 2, 1)
    A.frob(6, 2)
    A.mul(0, 6, 2)
    A.pow_static(3, 0, 7, 0b1101)
    A.mul(0, 3, 0)
    gt = tower.flat_from_f12(blsk.final_exp_batch(
        tower.f12_from_flat(red), program=A.program()))
    want = blsk.final_exp_plain(tower.f12_from_flat(want), A.program())
    assert torch.equal(gt, blsk.F.canonical(tower.flat_from_f12(want)))
    assert (blsk.miller_launches - m0, blsk.reduce_launches - r0,
            blsk.final_exp_launches - f0) == (1, 1, 1)
    sk, pk = lref.bls_keygen(b"card")
    msgs = [b"x", b"y", b"z"]
    agg = lref.bls_aggregate([lref.bls_sign(sk, m) for m in msgs])
    pairs = blsagg.stage_pairs([pk] * 3, msgs, agg)
    assert blsk.verify_pairs(pairs, device=dev) is True
    pairs[2] = (lref.hash_to_g1(b"forged"), pk)
    assert blsk.verify_pairs(pairs, device=dev) is False


def test_bls12_381_reduce_one_launch(dev):
    """The reduce entry at 2 ... 1,024 lanes: one launch a call, limb for
    limb the plain halving product (canonical), on seeded random Fp12
    lanes."""
    from fabric_tpu_torch.ops import bls12_381_kernel as blsk
    from fabric_tpu_torch.ops import tower
    import random
    rng = random.Random(101)
    for B in (2, 4, 8, 64, 1024):
        f = torch.as_tensor(np.stack([np.stack([
            blsk.F.to_mont(rng.randrange(blsk.ref.P)) for _ in range(B)])
            for _ in range(12)])).to(dev)
        before = blsk.reduce_launches
        got = tower.flat_from_f12(blsk.product_reduce(tower.f12_from_flat(f)))
        assert blsk.reduce_launches == before + 1
        want = tower.flat_from_f12(blsk.product_reduce_plain(
            tower.f12_from_flat(f)))
        assert torch.equal(got, blsk.F.canonical(want)), B


def test_provider_verify_aggregate_on_the_card(dev):
    """A valid 7-key aggregate and a forged one through CUDAProvider on the
    card, against the sw provider; one Miller, one reduce and one
    final-exp launch a call."""
    from fabric_tpu_torch.bccsp import bccsp as api
    csp = sw.SWProvider()
    keys = [csp.key_gen(api.BLSKeyGenOpts(ephemeral=True)) for _ in range(7)]
    msgs = [b"block %d" % i for i in range(7)]
    agg = sw.bls_aggregate_signatures([csp.sign(k, m)
                                       for k, m in zip(keys, msgs)])
    pubs = [k.public_key() for k in keys]
    prov = factory.new_bccsp({"Default": "CUDA"})
    forged = msgs[:3] + [b"forged"] + msgs[4:]
    for m, want in ((msgs, True), (forged, False)):
        assert prov.verify_aggregate(pubs, m, agg) is want
        assert csp.verify_aggregate(pubs, m, agg) is want
    assert (prov.stats["bls_miller_launches"],
            prov.stats["bls_reduce_launches"],
            prov.stats["bls_final_exp_launches"]) == (2, 2, 2)
    assert prov.stats["pairing_pairs"] == 16
