"""fabric_tpu_torch.parallel and the CUDA provider's batch mesh on the CPU.

Providers on meshes of CPU positions (`["cpu"] * 2`, and `["cpu"] * 3`,
whose size the power-of-two buckets do not divide) verify the same
lanes as the single-device port provider, the JAX package's sw provider
(fabric_tpu.bccsp.sw) and the bitmap known by construction, bit for
bit, on every route the reference shards that the CPU provider takes:
the comb digest (`verify_prepared`), the host-hash `verify_batch`, the
Shamir ladder over `MaxKeys` keys and Ed25519. Each route's kernel
wrapper is recorded, so the split itself is checked: one call a
position, each on its contiguous slice, in lane order.

The ladder's and Ed25519's plain torch versions cost ~4-5 s a call on
this CPU whatever the lane count (launch-bound eager torch), and a mesh
calls them once a position; here their wrappers are replaced by a
per-lane check over Python ints (bccsp/p256_host.py, ed25519_host.py)
of the operands the provider stages, memoized by the lane's operand
bytes, so a lane sent to the wrong slice or position still decides
wrong. The plain versions themselves are held to the JAX package in
tests/test_torch_ladder.py and test_torch_ed25519.py, and the kernels
on a two-position mesh on the card in tests/test_torch_cuda.py.

Then the fail-in-place drill: an armed `tpu.device_lost` on position 1
fails that batch with DeviceLostError and never calls sw; health() reads
the degraded mesh, the next batch runs on the survivors, and a probe
after the cooldown (a fake clock) restores the mesh. No JAX mesh and no
device forcing: the split is host logic over device lists.
"""

import hashlib
import logging
import types

import numpy as np
import pytest
import torch

from fabric_tpu.bccsp import bccsp as japi
from fabric_tpu.bccsp import factory as jfactory
from fabric_tpu.bccsp import sw as jsw

from fabric_tpu_torch import native, parallel
from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import factory, p256_host, sw
from fabric_tpu_torch.bccsp import ed25519_host as edh
from fabric_tpu_torch.bccsp.cuda import CUDAProvider
from fabric_tpu_torch.common import faults, metrics, profiling, tracing
from fabric_tpu_torch.common.devicehealth import (
    DeviceHealthConfig,
    DeviceLostError,
    MeshUnavailableError,
)
from fabric_tpu_torch.ops import ed25519, fused_verify, limb, verify
from tests.test_torch_provider import (  # noqa: F401 (fixtures)
    _DeadKey,
    _items,
    block,
    q8_seed,
)

N = p256_host.N


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    """No flight-recorder dump files from the drill's quarantines, and no
    fault left armed across tests."""
    monkeypatch.setattr(tracing._state, "enabled", False)
    faults.clear()
    yield
    faults.clear()


def _provider(q8_seed, mesh=None, **kw):
    """A CPU provider (on `mesh`, or the single device) with the block's
    8-bit Q table already cached."""
    prov = CUDAProvider(device=None if mesh else "cpu", mesh=mesh,
                        min_batch=4, **kw)
    prov._q8_cache[q8_seed[0]] = q8_seed[1]
    return prov


@pytest.fixture(scope="module")
def lanes(block):
    """The block's items, its prepared operands (`verify_prepared`), the
    JAX sw provider's verdicts on every live lane and the expected
    bitmap."""
    items = _items(block, api, block["pubs"], _DeadKey())
    n = len(items)
    keys, key_idx = [], np.zeros(n, np.int64)
    for i, it in enumerate(items):
        if it.key not in keys:
            keys.append(it.key)
        key_idx[i] = keys.index(it.key)
    digests = np.frombuffer(b"".join(
        it.digest if it.digest is not None
        else hashlib.sha256(it.message).digest() for it in items),
        np.uint8).reshape(n, 32)
    sigs = [it.signature for it in items]
    ok, r8, rpn8, w8 = native.batch_prep(sigs)
    jitems = _items(block, japi, block["jpubs"], None)
    live = [i for i, ln in enumerate(block["lanes"]) if ln["kind"] != "dead"]
    jbits = jsw.SWProvider().verify_batch([jitems[i] for i in live])
    return dict(items=items, expected=block["expected"].tolist(),
                live=live, jbits=jbits,
                prepared=dict(digests=digests, r=r8, rpn=rpn8, w=w8,
                              der_ok=ok, key_idx=key_idx, keys=keys,
                              get_sig=sigs.__getitem__))


def _check(got, lanes):
    assert got == lanes["expected"]
    assert [got[i] for i in lanes["live"]] == lanes["jbits"]


def _record(monkeypatch, mod, name, calls, fn=None, lanes_arg=0):
    """Wrap `mod.name` (a kernel wrapper the provider calls): append the
    lane count of each call (its argument `lanes_arg`'s rows) to `calls`,
    then run `fn` or the original."""
    orig = getattr(mod, name)

    def wrapped(*a, **k):
        calls.append(int(a[lanes_arg].shape[0]))
        return (fn or orig)(*a, **k)
    monkeypatch.setattr(mod, name, wrapped)


@pytest.fixture(scope="module")
def single_bits(q8_seed, lanes):
    """The single-device port provider's verdicts on both comb paths."""
    prov = _provider(q8_seed)
    return (prov.verify_prepared(**lanes["prepared"]),
            prov.verify_batch(lanes["items"]))


@pytest.mark.parametrize("size", [2, 3])
def test_comb_routes_on_mesh_match(size, q8_seed, lanes, single_bits,
                                   monkeypatch):
    """The comb digest (verify_prepared) and the host-hash verify_batch on
    a mesh of `size` CPU positions: the single-device provider's bits,
    the JAX sw provider's and the expected ones; one stage-A-and-tree
    call a position on bucket / size lanes; the bucket a multiple of the
    size; the shard stats and the stats keys of the reference."""
    prov = _provider(q8_seed, mesh=["cpu"] * size)
    calls = []
    _record(monkeypatch, fused_verify, "digest_verify_with_tables", calls)
    n = len(lanes["items"])
    bucket = prov._bucket(n)
    assert bucket % size == 0 and bucket >= n
    got_p = prov.verify_prepared(**lanes["prepared"])
    got_b = prov.verify_batch(lanes["items"])
    for got, single in zip((got_p, got_b), single_bits):
        _check(got, lanes)
        assert got == single
    assert calls == [bucket // size] * size * 2
    st = prov.stats
    assert (st["comb_batches"], st["shard_dispatches"], st["shard_devices"],
            st["mesh_devices_full"], st["mesh_rebuilds"]) == (
        2, 2, size, size, 0)
    assert prov.shard_stats["lanes"] == [bucket // size] * size
    assert len(prov.shard_stats["transfer_s"]) == size
    assert all(r >= 0 for r in prov.shard_stats["ready_s"])
    assert st["shard_skew_s"] >= 0
    assert prov.health() == "device"
    assert prov.device_stats == {"state": [0] * size, "trips": [0] * size,
                                 "quarantines": [0] * size,
                                 "readmits": [0] * size}
    ref = {"shard_devices", "shard_dispatches", "shard_skew_s",
           "mesh_devices_full", "mesh_rebuilds", "device_quarantines",
           "device_readmits", "device_straggler_strikes"}
    assert ref <= set(st)


def _ladder_ints(memo):
    """ladder_verify_digests over Python ints, lane by lane: x(u1 G +
    u2 Q) in {r, rpn} with u1 = e w, u2 = r w (mod n)."""
    def run(digests, q8, r8, rpn8, w8, premask):
        out = []
        for row in zip(*(t.numpy() for t in (digests, q8, r8, rpn8, w8,
                                              premask))):
            key = b"".join(np.ascontiguousarray(v).tobytes() for v in row)
            if key not in memo:
                d, q, r, rpn, w, live = row
                e = int.from_bytes(d.astype(">u4").tobytes(), "big")
                r_, rpn_, w_ = (int.from_bytes(v.tobytes(), "big")
                                for v in (r, rpn, w))
                qxy = (int.from_bytes(q[:32].tobytes(), "big"),
                       int.from_bytes(q[32:].tobytes(), "big"))
                ok = False
                if live and p256_host.on_curve(*qxy):
                    pt = p256_host._double_mult(e * w_ % N, r_ * w_ % N,
                                                qxy)
                    ok = pt is not None and pt[0] in (r_, rpn_)
                memo[key] = ok
            out.append(memo[key])
        return torch.tensor(out, dtype=torch.bool)
    return run


def _ed_ints(memo):
    """ed25519_verify over Python ints, lane by lane: [S]B + [k](-A) ==
    R."""
    B = edh.from_affine(edh.BX, edh.BY)

    def run(tab, *rows):
        out = []
        for row in zip(*(t.numpy() for t in rows)):
            key = b"".join(np.ascontiguousarray(v).tobytes() for v in row)
            if key not in memo:
                s, k, anx, ay, rx, ry = (int.from_bytes(v.tobytes(), "big")
                                         for v in row[:6])
                lhs = edh.pt_add(edh.scalar_mult(s, B), edh.scalar_mult(
                    k, edh.from_affine(anx, ay)))
                memo[key] = bool(row[6]) and edh.pt_equal(
                    lhs, edh.from_affine(rx, ry))
            out.append(memo[key])
        return torch.tensor(out, dtype=torch.bool)
    return run


@pytest.mark.parametrize("size", [2, 3])
def test_ladder_on_mesh_matches(size, q8_seed, lanes, monkeypatch):
    """More keys than MaxKeys take the ladder: on the mesh one ladder call
    a position on bucket / size lanes, the verdicts those of the single
    device, the expected bitmap and the JAX sw provider, on both the
    prepared and the host-hash paths."""
    memo: dict = {}
    calls = []
    _record(monkeypatch, verify, "ladder_verify_digests", calls,
            _ladder_ints(memo))
    single = _provider(q8_seed, max_keys=2)
    prov = _provider(q8_seed, mesh=["cpu"] * size, max_keys=2)
    n = len(lanes["items"])
    for call in (lambda p: p.verify_prepared(**lanes["prepared"]),
                 lambda p: p.verify_batch(lanes["items"])):
        want = call(single)
        _check(want, lanes)
        assert call(prov) == want
    bucket = prov._bucket(n)
    assert calls == ([single._bucket(n)] + [bucket // size] * size) * 2
    assert (prov.stats["ladder_batches"], prov.stats["comb_batches"],
            prov.stats["shard_dispatches"]) == (2, 0, 2)


@pytest.fixture(scope="module")
def ed_items():
    """16 Ed25519 lanes over 2 keys, every fifth message tampered, as
    the port's and the JAX package's items, and the JAX sw verdicts."""
    rng = np.random.default_rng(25519)
    csp = sw.SWProvider()
    privs = [sw.Ed25519PrivateKey(rng.bytes(32)) for _ in range(2)]
    items, jitems = [], []
    for i in range(16):
        k = privs[i % 2]
        msg = rng.bytes(40)
        sig = csp.sign(k, msg)
        if i % 5 == 4:
            msg += b"!"
        items.append(api.VerifyItem(key=k.public_key(), signature=sig,
                                    message=msg))
        jitems.append(japi.VerifyItem(
            key=jsw.Ed25519PublicKey(k.public_key().bytes()),
            signature=sig, message=msg))
    want = [i % 5 != 4 for i in range(16)]
    assert jsw.SWProvider().verify_batch(jitems) == want
    return items, want


@pytest.mark.parametrize("size", [2, 3])
def test_ed25519_on_mesh_matches(size, q8_seed, ed_items, monkeypatch):
    """The Ed25519 sub-batch on the mesh: one kernel call a position on
    bucket / size lanes, against the provider's B table on each device;
    verdicts those of the single device, the JAX sw provider and the
    expected bitmap."""
    items, want = ed_items
    memo: dict = {}
    calls, tabs = [], []
    ints = _ed_ints(memo)
    _record(monkeypatch, ed25519, "ed25519_verify", calls,
            lambda tab, *rows: tabs.append(tab) or ints(tab, *rows),
            lanes_arg=1)
    single = _provider(q8_seed)
    prov = _provider(q8_seed, mesh=["cpu"] * size)
    for p in (single, prov):
        # the stand-in verifies over ints; the table is passed through
        p._ed_tab = torch.zeros(1)
    assert single.verify_batch(items) == want
    assert prov.verify_batch(items) == want
    bucket = prov._bucket(len(items))
    assert calls == [single._bucket(len(items))] + [bucket // size] * size
    assert all(t is prov._ed_tab for t in tabs[1:])
    assert prov.stats["ed25519_batches"] == 1
    assert prov.stats["shard_dispatches"] == 1


def test_sharded_comb_verify_matches_single(q8_seed, lanes, single_bits):
    """parallel.sharded_comb_verify on a 3-position CPU mesh (the
    counterpart of shardmap_comb_verify) gives the single-device
    provider's commit-path verdicts on limb operands."""
    pr = lanes["prepared"]
    n = len(pr["der_ok"])
    order, table = q8_seed
    slot = {kb: j for j, kb in enumerate(order)}
    key_idx = np.array([
        slot.get(k.x_bytes().tobytes() + k.y_bytes().tobytes(), 0)
        if isinstance(k, sw.ECDSAPublicKey) else 0
        for k in (pr["keys"][j] for j in pr["key_idx"])], np.int32)
    premask = np.asarray(pr["der_ok"]) & np.array(
        [isinstance(pr["keys"][j], sw.ECDSAPublicKey)
         for j in pr["key_idx"]])
    words = torch.from_numpy(pr["digests"].view(">u4").astype(np.int64)
                             .reshape(n, 8))

    def limbs(a):
        return limb.be_bytes_to_limbs(torch.from_numpy(a))
    mesh = parallel.batch_mesh(devices=["cpu"] * 3)
    assert [s.stop - s.start for s in parallel.shard_slices(n, mesh)] == \
        [22, 22, 20]
    got = parallel.sharded_comb_verify(
        mesh, words, torch.from_numpy(key_idx), table, limbs(pr["r"]),
        limbs(pr["rpn"]), limbs(pr["w"]), torch.from_numpy(premask))
    assert got.tolist() == single_bits[0]
    assert list(parallel.replicate(table, mesh)) == [torch.device("cpu")]


def test_drill_quarantine_rebuild_probe_readmit(q8_seed, lanes,
                                                monkeypatch, caplog):
    """Fail in place on a 3-position mesh: `tpu.device_lost` armed on
    position 1 fails that batch with DeviceLostError (sw never called);
    the next batch runs on the 2 survivors, bit-identical; after the
    cooldown the next admission probes position 1 and the one after it
    serves on all 3 again. With every position quarantined a batch
    raises at once, naming them."""
    class Clock:
        t = 100.0

        def __call__(self):
            return self.t
    clock = Clock()
    prov = _provider(q8_seed, mesh=["cpu"] * 3,
                     device_health=DeviceHealthConfig(cooldown_s=30.0))
    prov._devhealth.set_clock(clock)

    def no_sw(items):
        raise AssertionError("the mesh served sw")
    monkeypatch.setattr(prov._sw, "verify_batch", no_sw)
    items = lanes["items"]
    faults.arm("tpu.device_lost", mode="error", count=1, arg=1)
    with caplog.at_level(logging.WARNING):
        with pytest.raises(DeviceLostError) as ei:
            prov.verify_batch(items)
    assert ei.value.device == 1
    assert isinstance(ei.value.cause, faults.FaultInjected)
    assert faults.fires("tpu.device_lost") == 1
    assert prov.health() == "device;degraded_mesh:2/3"
    assert prov.device_stats["state"] == [0, 2, 0]
    assert prov.stats["device_quarantines"] == 1
    assert prov.stats["mesh_rebuilds"] == 1
    assert prov._mesh.size == 2 and prov._mesh_pos == [0, 2]
    # the survivors serve the next batch, bit for bit
    _check(prov.verify_batch(items), lanes)
    assert prov.shard_stats["lanes"] == [prov._bucket(len(items)) // 2] * 2
    assert prov.stats["shard_devices"] == 2
    # cooldown: the admission starts the probe; the next one grows back
    clock.t += 30.5
    _check(prov.verify_batch(items), lanes)
    for t in list(prov._probe_threads.values()):
        t.join(10)
    assert prov.device_stats["readmits"] == [0, 1, 0]
    _check(prov.verify_batch(items), lanes)
    assert prov.health() == "device"
    assert prov._mesh is prov._mesh_full
    assert (prov.stats["mesh_rebuilds"], prov.stats["device_readmits"],
            prov.stats["shard_devices"]) == (2, 1, 3)
    # the gauges: shard and device rows by position, the totals
    reg = metrics.PrometheusProvider()
    profiling.provider_stats_tick(reg, prov)()
    text = reg.render()
    for want in ('bccsp_shard_transfer_s{device="2"} ',
                 'bccsp_shard_lanes{device="0"} ',
                 'bccsp_device_readmits{device="1"} 1',
                 "bccsp_device_quarantines_total 1",
                 "bccsp_shard_devices 3", "bccsp_mesh_rebuilds 2"):
        assert any(ln.startswith(want) for ln in text.splitlines()), want
    # total loss raises, naming every position
    for d in range(3):
        prov._devhealth.force_state(d, "degraded")
    with pytest.raises(MeshUnavailableError) as ei:
        prov.verify_prepared(**lanes["prepared"])
    assert ei.value.quarantined == [0, 1, 2]


def test_straggler_strikes_quarantine(q8_seed, lanes):
    """`tpu.device_straggler` (delay) on position 1 slows its copies past
    the skew budget: the batch still verifies, the strike quarantines the
    position (one strike allowed here), and the next admission serves on
    position 0 alone."""
    prov = _provider(q8_seed, mesh=["cpu"] * 2,
                     device_health=DeviceHealthConfig(
                         straggler_skew_s=0.05, straggler_strikes=1))
    faults.arm("tpu.device_straggler", mode="delay", delay_s=0.02, arg=1)
    _check(prov.verify_prepared(**lanes["prepared"]), lanes)
    faults.clear()
    t = prov.shard_stats["transfer_s"]
    assert t[1] - t[0] > 0.05, t
    assert prov.device_stats["state"] == [0, 2]
    assert prov.stats["device_straggler_strikes"] == 1
    _check(prov.verify_prepared(**lanes["prepared"]), lanes)
    assert prov.health() == "device;degraded_mesh:1/2"
    assert prov.shard_stats["lanes"] == [prov._bucket(len(lanes["items"]))]


def test_device_named_error_quarantines(q8_seed, lanes, monkeypatch):
    """A runtime error that names a CUDA device quarantines the
    positions on it and raises as DeviceLostError; an error naming no
    device raises as it is and strikes nothing."""
    prov = _provider(q8_seed, mesh=["cpu"] * 2)
    # the attribution by name applies to CUDA positions: the configured
    # mesh names the cards of a two-card host, the serving one (and any
    # rebuild) stays on the CPU
    prov._mesh_full = types.SimpleNamespace(
        devices=(torch.device("cuda", 0), torch.device("cuda", 1)), size=2)
    cpu_mesh = parallel.BatchMesh
    monkeypatch.setattr(parallel, "BatchMesh",
                        lambda devs: cpu_mesh(["cpu"] * len(devs)))
    fail = {"msg": "CUDA error: an illegal memory access was encountered "
                   "on cuda:1"}

    def boom(*a, **k):
        raise RuntimeError(fail["msg"])
    monkeypatch.setattr(fused_verify, "digest_verify_with_tables", boom)
    fail["msg"] = "out of memory"
    with pytest.raises(RuntimeError, match="out of memory") as ei:
        prov.verify_prepared(**lanes["prepared"])
    assert not isinstance(ei.value, DeviceLostError)
    assert prov.device_stats["state"] == [0, 0]
    fail["msg"] = "CUDA error: an illegal memory access on cuda:1"
    with pytest.raises(DeviceLostError) as ei:
        prov.verify_prepared(**lanes["prepared"])
    assert ei.value.device == 1
    assert prov.device_stats["state"] == [0, 2]
    assert prov.health() == "device;degraded_mesh:1/2"


def test_one_device_builds_no_mesh(monkeypatch):
    """CUDA.Devices: 1, a one-position mesh and a named Device build no
    mesh object; Devices over 1 with a named Device is an error; Devices
    unset or 0 takes every visible card, an over-ask clamps, and a
    failed enumeration serves without a mesh and says so in health()."""
    for cfg in ({"Device": "cpu", "Devices": 1}, {"Device": "cpu"},
                {"Device": "cpu", "Devices": 0}):
        prov = factory.new_bccsp({"Default": "CUDA", "CUDA": cfg})
        assert prov._mesh is None and prov._devhealth is None
        assert prov.health() == "device"
        assert prov.shard_stats == {"transfer_s": [], "ready_s": [],
                                    "lanes": []}
        assert prov.stats["shard_devices"] == 1
    assert CUDAProvider(mesh=["cpu"])._mesh is None
    with pytest.raises(ValueError):
        factory.new_bccsp({"Default": "CUDA", "CUDA": {
            "Device": "cpu", "Devices": 2}})
    with pytest.raises(ValueError):
        CUDAProvider(device="cpu", mesh=[torch.device("meta")] * 2)
    # a host of 4 visible cards, stood in for by CPU positions
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(parallel, "batch_mesh", lambda n: parallel.BatchMesh(
        ["cpu"] * n))
    for ask, size in ((None, 4), (0, 4), (3, 3), (8, 4)):
        prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
            "Devices": ask}})
        assert prov._mesh.size == size, ask
        assert prov.health() == "device"
    assert factory._resolve_mesh(None, 1) == (None, None)

    def broken():
        raise RuntimeError("enumeration failed")
    monkeypatch.setattr(torch.cuda, "device_count", broken)
    assert factory._resolve_mesh(None, 4) == (None, 4)
    assert factory._resolve_mesh(None, None) == (None, "all")
    assert CUDAProvider(device="cpu", mesh_requested=4).health() == \
        "device;degraded_mesh:1/4"


def test_factory_mesh_options_match_reference():
    """CUDA.Devices and CUDA.DeviceHealth parse as the reference's
    TPU.Devices and TPU.DeviceHealth."""
    for block_cfg in ({}, {"Devices": 4}, {"Devices": 0}, {
            "Devices": "2", "DeviceHealth": {
                "TripThreshold": 3, "CooldownS": "1.5",
                "StragglerSkewS": 0, "StragglerStrikes": 5,
                "ProbeTimeoutS": 2}}):
        mine = factory.FactoryOpts.from_config({"CUDA": block_cfg}).cuda
        ref = jfactory.FactoryOpts.from_config({"TPU": block_cfg}).tpu
        assert mine.n_devices == ref.n_devices
        assert vars(mine.device_health) == vars(ref.device_health)
