"""fabric_tpu_torch.bccsp: the CUDA provider's batch paths on the CPU.

The provider is built as a user would (`new_bccsp`) with Device "cpu",
so every kernel wrapper runs its plain version. Its bitmaps are held
against fabric_tpu.bccsp.sw.SWProvider (the JAX package's oracle, here
on its OpenSSL or pure-Python backend) and against the expected bitmap
known by construction: exact equality. Each provider finds its key set's
8-bit Q table already cached, built from Python ints (its own eager
build costs ~12 s on the CPU; tests/test_torch_comb.py holds that build
to the same ints). The message routes (fused tier, resident kernel,
device SHA, host hashing, the MaxBlocks cutoff) are told apart by the
provider's stats.
"""

import hashlib

import numpy as np
import pytest
import torch

from fabric_tpu.bccsp import bccsp as japi
from fabric_tpu.bccsp import sw as jsw

from fabric_tpu_torch import native
from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import cuda, factory, sw, utils
from fabric_tpu_torch.bccsp.cuda import CUDAProvider, host_prep_scalars
from fabric_tpu_torch.common import torchenv
from fabric_tpu_torch.ops import fused_verify, ptree
from tests.test_torch_comb import _q8_ints

N = utils.P256_N


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _DeadKey(api.Key):
    """A key that is not ECDSA: its lanes must reject."""

    def bytes(self):
        return b""

    def ski(self):
        return b"dead"

    def symmetric(self):
        return False

    def private(self):
        return False

    def public_key(self):
        return self


@pytest.fixture(scope="module")
def block():
    """64 mixed lanes over 3 keys: digest and message lanes; tampered,
    high-S, bad-DER, r >= n and dead-key lanes."""
    rng = np.random.default_rng(2026)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int.from_bytes(rng.bytes(32), "big")
                                % (N - 1) + 1) for _ in range(3)]
    pubs = [k.public_key() for k in privs]
    jsp = jsw.SWProvider()
    jpubs = [jsp.key_import(p.bytes(), japi.ECDSAPublicKeyImportOpts(
        ephemeral=True)) for p in pubs]
    lanes = []
    for i in range(64):
        k = i % 3
        msg = rng.bytes(int(rng.integers(0, 300)))
        digest = hashlib.sha256(msg).digest()
        sig = csp.sign(privs[k], digest)
        kind = ("ok", "tampered", "high_s", "bad_der", "r_ge_n", "ok",
                "dead", "wrong_key")[i % 8]
        r, s = utils.unmarshal_signature(sig)
        if kind == "tampered":
            msg = msg + b"!"
            digest = hashlib.sha256(msg).digest()
        elif kind == "high_s":
            sig = utils.marshal_signature(r, N - s)
        elif kind == "bad_der":
            sig = sig[:-1]
        elif kind == "r_ge_n":
            sig = utils.marshal_signature(r + N, s)
        elif kind == "wrong_key":
            k = (k + 1) % 3
        lanes.append(dict(k=k, msg=msg, digest=digest, sig=sig, kind=kind,
                          as_digest=bool(i % 2)))
    expected = np.array([ln["kind"] == "ok" for ln in lanes])
    return dict(pubs=pubs, jpubs=jpubs, lanes=lanes, expected=expected)


def _items(block, api_mod, pubs, dead):
    out = []
    for ln in block["lanes"]:
        key = dead if ln["kind"] == "dead" else pubs[ln["k"]]
        if ln["as_digest"]:
            out.append(api_mod.VerifyItem(key=key, signature=ln["sig"],
                                          digest=ln["digest"]))
        else:
            out.append(api_mod.VerifyItem(key=key, signature=ln["sig"],
                                          message=ln["msg"]))
    return out


@pytest.fixture(scope="module")
def q8_seed(block):
    """(cache key, 8-bit Q table) for the block's key set, K = 4 (slot 3
    repeats slot 0), in the provider's canonical key order."""
    order = sorted(p.x_bytes().tobytes() + p.y_bytes().tobytes()
                   for p in block["pubs"])
    keys = [(int.from_bytes(kb[:32], "big"), int.from_bytes(kb[32:], "big"))
            for kb in order]
    return tuple(order), torch.as_tensor(_q8_ints(keys + keys[:1]))


def _seeded(q8_seed, **cuda):
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, **cuda}})
    key, table = q8_seed
    prov._q8_cache[key] = table
    return prov


@pytest.fixture(scope="module")
def provider(q8_seed):
    return _seeded(q8_seed)


def test_factory_builds_the_configured_providers():
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 8, "MaxKeys": 4, "Chunk": 64,
        "UseG16": False, "TableCacheMB": 512, "HashOnHost": False,
        "FusedVerify": True, "MaxBlocks": 4}})
    assert isinstance(prov, CUDAProvider)
    assert prov.device == torch.device("cpu")
    assert (prov._min_batch, prov._max_keys, prov._chunk) == (8, 4, 64)
    assert prov._use_g16 is False
    assert prov._table_cache_bytes == 512 << 20
    assert (prov._hash_on_host, prov._fused_verify, prov._max_blocks) == (
        False, True, 4)
    # the TpuOpts names and defaults
    dflt = factory.FactoryOpts.from_config({"Default": "CUDA"}).cuda
    assert (dflt.hash_on_host, dflt.fused_verify, dflt.max_blocks) == (
        True, None, 64)
    assert isinstance(factory.new_bccsp({"Default": "SW"}), sw.SWProvider)
    with pytest.raises(ValueError):
        factory.new_bccsp({"Default": "TPU"})


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        torchenv.resolve_device()
    with pytest.raises(RuntimeError):
        factory.new_bccsp({"Default": "CUDA"})
    with pytest.raises(RuntimeError):
        torchenv.resolve_device("cuda")
    assert torchenv.resolve_device("cpu") == torch.device("cpu")


def test_non_p256_key_raises(provider, block):
    """Until the port had ECDSA on every curve, a P-384 key raised
    NotImplementedError on every path, and the constructor took any point
    off P-256 (`ECDSAPublicKey(1, 2, curve="P-384")`). Now a point off
    its curve raises ValueError on every curve, and a key off P-256
    raises rather than reach the card's 32-byte key packing; the paths
    themselves verify such keys on sw (test_non_p256_lanes_match_jax_sw)."""
    for curve in ("P-224", "P-384", "P-521"):
        with pytest.raises(ValueError):
            sw.ECDSAPublicKey(1, 2, curve=curve)
    with pytest.raises(ValueError):
        sw.ECDSAPublicKey(1, 2, curve="P-192")
    p384 = sw.ECDSAPrivateKey(12345, curve="P-384").public_key()
    with pytest.raises(TypeError):
        p384.x_bytes()
    with pytest.raises(TypeError):
        p384.y_bytes()
    assert block["pubs"][0].x_bytes().shape == (32,)


@pytest.fixture(scope="module")
def mixed(block):
    """The block's 64 P-256 lanes with 15 lanes on P-224, P-384 and P-521
    keys spliced in (digest lanes of 32, 48 and 64 bytes and message
    lanes; tampered, high-S and wrong-key lanes among them), the keys'
    JAX twins (OpenSSL) beside them."""
    from cryptography.hazmat.primitives.asymmetric import ec

    rng = np.random.default_rng(384)
    csp = sw.SWProvider()
    curves = {"P-224": (ec.SECP224R1(), 32), "P-384": (ec.SECP384R1(), 48),
              "P-521": (ec.SECP521R1(), 64)}
    extra = []
    for curve, (ocurve, dlen) in curves.items():
        n = utils.CURVE_ORDERS[curve]
        ds = [int.from_bytes(rng.bytes(72), "big") % (n - 1) + 1
              for _ in range(2)]
        privs = [sw.ECDSAPrivateKey(d, curve=curve) for d in ds]
        jpubs = [jsw.ECDSAPrivateKey(ec.derive_private_key(d, ocurve))
                 .public_key() for d in ds]
        for kind in ("ok", "ok_msg", "tampered", "high_s", "wrong_key"):
            msg = rng.bytes(int(rng.integers(1, 200)))
            digest = None if kind == "ok_msg" else \
                hashlib.sha512(msg).digest()[:dlen]
            sig = csp.sign(privs[0], digest or hashlib.sha256(msg).digest())
            k = 1 if kind == "wrong_key" else 0
            if kind == "tampered":
                digest = hashlib.sha512(msg + b"!").digest()[:dlen]
            elif kind == "high_s":
                r, s_ = utils.unmarshal_signature(sig)
                sig = utils.marshal_signature(r, n - s_)
            extra.append(dict(pub=privs[k].public_key(), jpub=jpubs[k],
                              msg=msg, digest=digest, sig=sig,
                              ok=kind.startswith("ok")))
    base = _items(block, api, block["pubs"], _DeadKey())
    jbase = _items(block, japi, block["jpubs"], None)
    items, jitems, expected, where = [], [], [], []
    for i in range(len(base)):
        items.append(base[i])
        jitems.append(None if block["lanes"][i]["kind"] == "dead"
                      else jbase[i])
        expected.append(bool(block["expected"][i]))
        if i % 4 == 1 and extra:
            e = extra.pop()
            where.append(len(items))
            items.append(api.VerifyItem(key=e["pub"], signature=e["sig"],
                                        digest=e["digest"], message=e["msg"]
                                        if e["digest"] is None else None))
            jitems.append(japi.VerifyItem(key=e["jpub"], signature=e["sig"],
                                          digest=e["digest"],
                                          message=e["msg"]
                                          if e["digest"] is None else None))
            expected.append(e["ok"])
    assert not extra and len(where) == 15
    return dict(items=items, jitems=jitems, expected=np.array(expected),
                where=where)


def test_non_p256_lanes_match_jax_sw(provider, block, mixed):
    """P-224, P-384 and P-521 lanes of a batch verify on sw beside the
    P-256 lanes on the comb: verify_batch, verify and
    verify_prepared_start give the JAX package's sw verdicts, the P-256
    lanes those of the P-256-only batch, and a P-384 key in `keys` that
    no lane uses raises nothing."""
    items, where = mixed["items"], mixed["where"]
    before = dict(provider.stats)
    got = provider.verify_batch(items)
    np.testing.assert_array_equal(got, mixed["expected"])
    live = [i for i, it in enumerate(mixed["jitems"]) if it is not None]
    want = jsw.SWProvider().verify_batch([mixed["jitems"][i] for i in live])
    np.testing.assert_array_equal(np.array(got)[live], want)
    assert provider.stats["comb_batches"] == before["comb_batches"] + 1
    assert provider.stats["nonp256_sw_lanes"] == \
        before["nonp256_sw_lanes"] + len(where)
    p256 = [i for i in range(len(items)) if i not in where]
    assert [got[i] for i in p256] == block["expected"].tolist()
    jsp = jsw.SWProvider()
    for i in where:
        it, jt = items[i], mixed["jitems"][i]
        data = it.digest if it.digest is not None else \
            hashlib.sha256(it.message).digest()
        assert provider.verify(it.key, it.signature, data) == \
            jsp.verify(jt.key, jt.signature, data) == got[i]

    # the prepared path over 32-byte digests: P-256 lanes on the card,
    # the rest on sw, an unused P-384 key in `keys`
    n = len(items)
    keys, key_idx = [], np.zeros(n, np.int64)
    for i, it in enumerate(items):
        if it.key not in keys:
            keys.append(it.key)
        key_idx[i] = keys.index(it.key)
    unused = sw.ECDSAPrivateKey(99, curve="P-384").public_key()
    digests = np.frombuffer(b"".join(
        it.digest if it.digest is not None and len(it.digest) == 32
        else hashlib.sha256(it.message or it.digest).digest()
        for it in items), np.uint8).reshape(n, 32)
    ok, r8, rpn8, w8 = native.batch_prep([it.signature for it in items])
    sigs = [it.signature for it in items]
    want_prepared = [
        isinstance(it.key, sw.ECDSAPublicKey) and jsp.verify(
            mixed["jitems"][i].key, it.signature, digests[i].tobytes())
        for i, it in enumerate(items)]
    for extra_keys in ([], [unused]):
        got_p = provider.verify_prepared_start(
            digests, r8, rpn8, w8, ok, key_idx, keys + extra_keys,
            sigs.__getitem__)()
        assert got_p == want_prepared


def test_verify_batch_preps_natively_once(provider, block, monkeypatch):
    """`_verify_batch_p256` preps its lanes in one `native.batch_prep`
    call and never calls `host_prep_scalars`; the comb gets the premask,
    rows and key slots that per-lane `host_prep_scalars` staging gives."""
    items = _items(block, api, block["pubs"], _DeadKey())
    calls = []
    prep = native.batch_prep
    monkeypatch.setattr(native, "batch_prep",
                        lambda sigs: calls.append(len(sigs)) or prep(sigs))

    def no_plain(*a):
        raise AssertionError("the main path called host_prep_scalars")
    monkeypatch.setattr(cuda, "host_prep_scalars", no_plain)
    seen = {}
    dispatch = provider._dispatch_comb_digest
    monkeypatch.setattr(provider, "_dispatch_comb_digest", lambda *a: (
        seen.update(zip(("key_idx", "r", "rpn", "w", "premask"), a[2:7]))
        or dispatch(*a)))
    got = provider.verify_batch(items)
    np.testing.assert_array_equal(got, block["expected"])
    assert calls == [len(items)]
    bucket = provider._bucket(len(items))
    key_map: dict = {}
    want = dict(key_idx=np.zeros(bucket, np.int32),
                premask=np.zeros(bucket, bool),
                **{k: np.zeros((bucket, 32), np.uint8)
                   for k in ("r", "rpn", "w")})
    for i, it in enumerate(items):
        pub = it.key.public_key()
        rows = (host_prep_scalars(pub, it.signature)
                if isinstance(pub, sw.ECDSAPublicKey) else None)
        if rows is None:
            continue
        want["premask"][i] = True
        for k, row in zip(("r", "rpn", "w"), rows):
            want[k][i] = np.frombuffer(row, np.uint8)
        kb = pub.x_bytes().tobytes() + pub.y_bytes().tobytes()
        want["key_idx"][i] = key_map.setdefault(kb, len(key_map))
    for k, v in want.items():
        np.testing.assert_array_equal(seen[k], v, err_msg=k)


def test_host_prep_scalars_gates(block):
    pub = block["pubs"][0]
    ln = next(x for x in block["lanes"] if x["kind"] == "ok")
    r, s = utils.unmarshal_signature(ln["sig"])
    pub = block["pubs"][ln["k"]]
    r8, rpn8, w8 = host_prep_scalars(pub, ln["sig"])
    assert int.from_bytes(r8, "big") == r
    assert int.from_bytes(w8, "big") * s % N == 1
    rpn = int.from_bytes(rpn8, "big")
    assert rpn == (r + N if r + N < (1 << 256) - (1 << 224) + (1 << 192)
                   + (1 << 96) - 1 else r)
    for kind in ("high_s", "bad_der", "r_ge_n"):
        bad = next(x for x in block["lanes"] if x["kind"] == kind)
        assert host_prep_scalars(pub, bad["sig"]) is None


def test_verify_batch_matches_jax_sw(provider, block):
    dead = _DeadKey()
    got = provider.verify_batch(_items(block, api, block["pubs"], dead))
    np.testing.assert_array_equal(got, block["expected"])
    live = [i for i, ln in enumerate(block["lanes"]) if ln["kind"] != "dead"]
    jitems = _items(block, japi, block["jpubs"], None)
    want = jsw.SWProvider().verify_batch([jitems[i] for i in live])
    np.testing.assert_array_equal(np.array(got)[live], want)
    ports_sw = provider._sw.verify_batch(
        [_items(block, api, block["pubs"], dead)[i] for i in live])
    np.testing.assert_array_equal(ports_sw, want)
    assert provider.stats["comb_batches"] >= 1
    assert provider.stats["host_hashed_lanes"] > 0
    # the plain version on the CPU is not a kernel launch
    assert provider.stats["tree_kernel_launches"] == 0


def test_verify_prepared_matches_verify_batch(provider, block):
    lanes = block["lanes"]
    n = len(lanes)
    keys = block["pubs"] + [_DeadKey()]
    key_idx = np.array([3 if ln["kind"] == "dead" else ln["k"]
                        for ln in lanes], np.int64)
    digests = np.frombuffer(b"".join(ln["digest"] for ln in lanes),
                            np.uint8).reshape(n, 32)
    r8, rpn8, w8 = (np.zeros((n, 32), np.uint8) for _ in range(3))
    der_ok = np.zeros(n, bool)
    for i, ln in enumerate(lanes):
        prep = host_prep_scalars(block["pubs"][ln["k"]], ln["sig"])
        if prep is not None:
            der_ok[i] = True
            r8[i], rpn8[i], w8[i] = (np.frombuffer(b, np.uint8)
                                     for b in prep)
    sigs = [ln["sig"] for ln in lanes]
    before = ptree.launches
    resolve = provider.verify_prepared_start(
        digests, r8, rpn8, w8, der_ok, key_idx, keys, sigs.__getitem__)
    got = resolve()
    np.testing.assert_array_equal(got, block["expected"])
    np.testing.assert_array_equal(
        provider.verify_prepared(digests, r8, rpn8, w8, der_ok, key_idx,
                                 keys, sigs.__getitem__), got)
    assert ptree.launches == before
    # under MinBatch the lanes verify on the sw path, with equal verdicts
    small = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 1000}})
    np.testing.assert_array_equal(
        small.verify_prepared(digests, r8, rpn8, w8, der_ok, key_idx, keys,
                              sigs.__getitem__), got)


def test_chunks_match_one_launch(provider, block, monkeypatch):
    """A bucket split over several chunks gives the one-chunk verdicts."""
    items = _items(block, api, block["pubs"], _DeadKey())
    monkeypatch.setattr(provider, "_chunk", 16)
    batches = provider.stats["comb_batches"]
    np.testing.assert_array_equal(provider.verify_batch(items),
                                  block["expected"])
    assert provider.stats["comb_batches"] == batches + 1


def test_over_max_keys_raises(block):
    """A batch over MaxKeys distinct keys raised NotImplementedError
    until the port had the Shamir ladder; now the whole batch takes the
    ladder (`ladder_batches`, no comb) and nothing raises: the verdicts
    equal the expected bitmap."""
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, "MaxKeys": 2}})
    got = prov.verify_batch(_items(block, api, block["pubs"], _DeadKey()))
    assert got == block["expected"].tolist()
    assert prov.stats["ladder_batches"] == 1
    assert prov.stats["comb_batches"] == 0


def test_fused_knob_resolution(monkeypatch):
    """FTPU_FUSED first, then FusedVerify, then on for a CUDA device and
    off for the CPU (fabric_tpu's _fused_enabled)."""
    monkeypatch.delenv("FTPU_FUSED", raising=False)
    auto = factory.new_bccsp({"Default": "CUDA", "CUDA": {"Device": "cpu"}})
    off = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "FusedVerify": False}})
    on = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "FusedVerify": True}})
    assert (auto._fused_enabled(), off._fused_enabled(),
            on._fused_enabled()) == (False, False, True)
    monkeypatch.setattr(auto, "device", torch.device("cuda", 0))
    monkeypatch.setattr(off, "device", torch.device("cuda", 0))
    assert auto._fused_enabled() and not off._fused_enabled()
    monkeypatch.setenv("FTPU_FUSED", "0")
    assert not auto._fused_enabled() and not on._fused_enabled()
    monkeypatch.setenv("FTPU_FUSED", "1")
    assert off._fused_enabled()
    monkeypatch.delenv("FTPU_FUSED_RESIDENT", raising=False)
    assert not CUDAProvider._fused_resident_enabled()
    monkeypatch.setenv("FTPU_FUSED_RESIDENT", "1")
    assert CUDAProvider._fused_resident_enabled()


# route -> (CUDA knobs, environment, resident budget or None)
ROUTES = {
    "host_hash": ({}, {}, None),
    "fused": ({"FusedVerify": True}, {}, None),
    "fused_env": ({}, {"FTPU_FUSED": "1"}, None),
    "fused_env_off": ({"FusedVerify": True}, {"FTPU_FUSED": "0"}, None),
    "resident": ({"FusedVerify": True}, {"FTPU_FUSED_RESIDENT": "1"}, None),
    "resident_over_budget": ({"FusedVerify": True},
                             {"FTPU_FUSED_RESIDENT": "1"}, 0),
    "device_sha": ({"HashOnHost": False, "FusedVerify": False}, {}, None),
    "over_max_blocks": ({"FusedVerify": True, "MaxBlocks": 2}, {}, None),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_message_routes(route, block, q8_seed, monkeypatch):
    """The block's mixed digest and message lanes down every message
    route: the same verdicts, and stats that show which route ran."""
    cfg, env, budget = ROUTES[route]
    for name in ("FTPU_FUSED", "FTPU_FUSED_RESIDENT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if budget is not None:
        monkeypatch.setattr(fused_verify, "RESIDENT_TABLE_BUDGET", budget)
    resident_calls = []
    orig = fused_verify.fused_verify_resident
    monkeypatch.setattr(fused_verify, "fused_verify_resident",
                        lambda *a, **k: resident_calls.append(1)
                        or orig(*a, **k))
    prov = _seeded(q8_seed, **cfg)
    got = prov.verify_batch(_items(block, api, block["pubs"], _DeadKey()))
    np.testing.assert_array_equal(got, block["expected"])
    msg_lanes = sum(not ln["as_digest"] and ln["kind"] in (
        "ok", "tampered", "wrong_key") for ln in block["lanes"])
    fused = route.startswith(("fused", "resident")) and route != \
        "fused_env_off"
    host = route in ("host_hash", "fused_env_off", "over_max_blocks")
    st = prov.stats
    assert st["fused_batches"] == int(fused)
    assert st["fused_lanes"] == (msg_lanes if fused else 0)
    assert st["comb_batches"] == int(not fused)
    assert st["host_hashed_lanes"] == (msg_lanes if host else 0)
    assert st["host_hash_fallbacks"] == int(route == "over_max_blocks")
    assert len(resident_calls) == int(route == "resident")
    # the plain versions on the CPU are not kernel launches
    assert all(st[k] == 0 for k in (
        "tree_kernel_launches", "sha_windows_launches", "sha256_launches",
        "resident_launches"))
