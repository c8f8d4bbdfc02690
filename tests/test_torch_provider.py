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

from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import factory, sw, utils
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
    p384 = sw.ECDSAPublicKey(1, 2, curve="P-384")
    ln = block["lanes"][0]
    items = _items(block, api, block["pubs"], _DeadKey())
    items[5] = api.VerifyItem(key=p384, signature=ln["sig"],
                              digest=ln["digest"])
    with pytest.raises(NotImplementedError):
        provider.verify_batch(items)
    with pytest.raises(NotImplementedError):
        provider.verify(p384, ln["sig"], ln["digest"])
    with pytest.raises(NotImplementedError):
        provider.verify_prepared_start(
            np.zeros((4, 32), np.uint8), *(np.zeros((4, 32), np.uint8),) * 3,
            np.ones(4, bool), np.zeros(4, np.int64), [p384], lambda i: b"")


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
