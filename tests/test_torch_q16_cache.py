"""The Q tables' lifecycle in the port (bccsp/cuda.py) against the
reference (fabric_tpu/bccsp/tpu.py): the byte-bounded Q16 cache with its
adaptive residency, the in-flight marker of a build or restore, warm-dir
persistence of key sets and table bytes, and the restore at prewarm.

`test_lifecycle_matches_reference` runs each scenario of the reference's
own tests (tests/test_q16_cache.py, tests/test_warm_restart.py), one
step at a time, on a TPUProvider and on a CPU CUDAProvider, both with
their table builds stubbed to arrays of EST bytes as those tests stub
them (no jit, no real table build). After every step it compares what
the step returned (a table's shape or None), the shared stats, and each
side's warm dir: `warm_keysets.json` and its file names, read after the
persist threads are joined (so the comparison does not race them).

The rest holds the port alone where the reference has nothing to compare
(the Q8 route's concurrent miss, device errors in the background
threads) or runs real bytes: one real Q8 build on the CPU, persisted and
restored by a fresh provider.
"""

import hashlib
import json
import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu.bccsp.tpu import TPUProvider

from fabric_tpu_torch import native
from fabric_tpu_torch.bccsp import factory, sw, utils
from fabric_tpu_torch.bccsp.cuda import CUDAProvider
from fabric_tpu_torch.ops import comb

EST = 1000                  # pretended bytes per Q16 table (stubs match)
_QX = np.zeros((1, 20), dtype=np.int32)     # the reference's key limbs
_QK = np.zeros((1, 64), dtype=np.uint8)     # the port's key bytes

SHARED_STATS = ("q16_builds", "q16_evictions", "q16_oversize_skips",
                "q16_adaptive_skips", "q16_loading_skips", "q16_cache_bytes",
                "q16_resident_sets", "q16_disk_loads", "q8_disk_loads",
                "warm_table_persist_failures")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(i: int) -> tuple:
    return (bytes([i]) * 64,)


# -- the stubs: each side's table builders and sizes, the same way --

def _stub(monkeypatch, q8=(2,), q16=(EST // 4,), est=EST, q8_est=None,
          q8_fill=None, warm_max=None, build_hook=None):
    """Stub both packages' Q8 and Q16 builds to int32 arrays of the given
    shapes (Q8 filled with arange(n) by q8_fill="arange"), their Q16 size
    estimate to `est` (None: the real one) and Q8's to `q8_est`;
    `build_hook()` runs inside each Q16 build."""
    q8_arr = (np.arange(int(np.prod(q8)), dtype=np.int32).reshape(q8)
              if q8_fill == "arange" else np.zeros(q8, np.int32))
    q16_arr = np.zeros(q16, np.int32)

    def hooked(make):
        def build(*_):
            if build_hook is not None:
                build_hook()
            return make()
        return build

    monkeypatch.setattr(TPUProvider, "_qtab_fn", lambda self, K: (
        lambda qx, qy: jnp.asarray(q8_arr)))
    monkeypatch.setattr(TPUProvider, "_q16_fn", lambda self, K: hooked(
        lambda: jnp.asarray(q16_arr)))
    monkeypatch.setattr(comb, "build_q_tables",
                        lambda qx, qy: torch.from_numpy(q8_arr.copy()))
    monkeypatch.setattr(comb, "build_q16_tables", hooked(
        lambda: torch.from_numpy(q16_arr.copy())))
    for cls in (TPUProvider, CUDAProvider):
        if est is not None:
            monkeypatch.setattr(cls, "_q16_est_bytes", lambda self, K: est)
        if q8_est is not None:
            monkeypatch.setattr(cls, "_q8_est_bytes",
                                lambda self, K: q8_est)
        if warm_max is not None:
            monkeypatch.setattr(cls, "_WARM_MAX_SETS", warm_max)


class _Side:
    """One package's providers over its own warm dir."""

    def __init__(self, kind: str, root: str):
        self.kind = kind
        self.warm = os.path.join(root, kind, "warm")
        self.provs: dict = {}

    def new(self, name, g16=True, budget=None, warm=False):
        kw = dict(use_g16=g16, warm_keys_dir=self.warm if warm else None)
        if budget is not None:
            kw["table_cache_bytes"] = budget
        self.provs[name] = (TPUProvider(**kw) if self.kind == "ref"
                            else CUDAProvider(device="cpu", **kw))

    def lookup(self, prov, i, prewarm=False):
        if self.kind == "ref":
            return prov._q16_cached(_key(i), 1, _QX, _QX, prewarm=prewarm)
        return prov._q16_cached(_key(i), 1, _QK, prewarm=prewarm)

    def resident(self, prov):
        return prov._qflat_cache if self.kind == "ref" else prov._q16_cache

    def cache_bytes(self, prov):
        return (prov._qflat_cache_bytes if self.kind == "ref"
                else prov._q16_bytes)

    def warm_state(self):
        """(warm_keysets.json, sorted file names), the writers joined."""
        for p in self.provs.values():
            p.flush_warm_tables()
        if not os.path.isdir(self.warm):
            return None, []
        path = os.path.join(self.warm, "warm_keysets.json")
        text = open(path).read() if os.path.exists(path) else None
        return text, sorted(os.listdir(self.warm))

    def run(self, step):
        op, *args = step
        if op == "new":
            self.new(args[0], **args[1])
            return None
        prov = self.provs.get(args[0]) if args else None
        if op == "q16":
            out = self.lookup(prov, args[1])
            return None if out is None else tuple(out.shape)
        if op == "q16_until":
            # the first of args[2] lookups of set args[1] to get a table
            for n in args[2]:
                if self.lookup(prov, args[1]) is not None:
                    return n
            return None
        if op == "prewarm_tables":
            return prov._prewarm_tables()
        if op == "prewarm":
            # the restore step stubbed: does prewarm reach it?
            called = []
            prov._prewarm_tables = lambda *a: called.append(True) or 0
            if self.kind == "ref":
                from fabric_tpu.ops import comb as jcomb
                saved, jcomb.g16_tables = jcomb.g16_tables, lambda: None
                try:
                    prov.prewarm(buckets=(), key_counts=(),
                                 wait_restore=True)
                finally:
                    jcomb.g16_tables = saved
            else:
                saved, comb.g16_tables = comb.g16_tables, lambda dev: None
                try:
                    prov.prewarm(wait_restore=True)
                finally:
                    comb.g16_tables = saved
            return called
        if op == "flush":
            prov.flush_warm_tables()
            return None
        if op == "age":
            prov._q16_batch_no += args[1]
            return None
        if op == "loading":
            (prov._q16_loading.add if args[2]
             else prov._q16_loading.discard)(_key(args[1]))
            return None
        if op == "resolve":
            out = prov._resolve_tables({_key(args[1])[0]: 0},
                                       np.zeros(4, dtype=np.int32))
            return bool(out[4])
        if op == "warm_keys":
            return prov._load_warm_keys()
        if op == "exists":
            return os.path.exists(prov._table_path(_key(args[1]), *args[2:]))
        if op == "in_cache":
            return _key(args[1]) in self.resident(prov)
        if op == "junk":
            # overwrite set args[1]'s Q16 file with junk bytes
            with open(prov._table_path(_key(args[1])), "wb") as f:
                f.write(b"\x93NUMPY junk")
            return None
        if op == "flip":
            # flip one byte of set args[1]'s Q16 file (its sidecar stays)
            path = prov._table_path(_key(args[1]))
            with open(path, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                b = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([b[0] ^ 0x01]))
            return None
        if op == "junk_warm_file":
            os.makedirs(self.warm, exist_ok=True)
            with open(os.path.join(self.warm, "warm_keysets.json"), "w") as f:
                f.write("{not json")
            return None
        raise ValueError(op)


def _q16(name, *keys):
    return [("q16", name, i) for i in keys]


B3 = dict(budget=3 * EST)
B3W = dict(budget=3 * EST, warm=True)

# name -> (stub arguments, steps, {provider: expected stats at the end});
# the steps retrace the reference test of the same name
SCENARIOS = {
    "working_set_larger_than_budget_pins_residents": (
        {}, [("new", "p", B3)] + _q16("p", *range(8)) * 4,
        {"p": dict(q16_builds=3, q16_evictions=0, q16_adaptive_skips=20,
                   q16_cache_bytes=3 * EST)}),
    "cold_tables_still_evict": (
        {}, [("new", "p", dict(budget=EST)), ("q16", "p", 0)]
        + [("q16_until", "p", i, [i]) for i in range(1, 20)],
        {"p": dict(q16_evictions=1, q16_builds=2, q16_cache_bytes=EST)}),
    "prewarm_poisoning_fresh_set_reaches_q16": (
        {}, [("new", "p1", B3W)] + _q16("p1", 0, 1, 2) + [
            ("flush", "p1"), ("new", "p2", B3W), ("prewarm_tables", "p2"),
            ("q16", "p2", 7), ("warm_keys", "p2")],
        {"p2": dict(q16_evictions=1, q16_adaptive_skips=0)}),
    "prewarmed_set_claimed_by_live_use_is_protected": (
        {}, [("new", "p1", dict(budget=EST, warm=True)), ("q16", "p1", 0),
             ("flush", "p1"), ("new", "p2", dict(budget=EST, warm=True)),
             ("prewarm_tables", "p2"), ("q16", "p2", 0), ("q16", "p2", 5)],
        {"p2": dict(q16_builds=0, q16_adaptive_skips=1, q16_evictions=0)}),
    "denied_set_reearns_q16_when_residents_cool": (
        {}, [("new", "p", dict(budget=EST)), ("q16", "p", 0),
             ("q16", "p", 1), ("q16_until", "p", 1, list(range(2, 64)))],
        {"p": dict(q16_evictions=1)}),
    "table_bytes_persist_and_preload": (
        {}, [("new", "p1", B3W), ("q16", "p1", 1), ("flush", "p1"),
             ("exists", "p1", 1), ("new", "p2", B3W),
             ("prewarm_tables", "p2"), ("q16", "p2", 1), ("junk", "p2", 1),
             ("new", "p3", B3W), ("prewarm_tables", "p3")],
        {"p2": dict(q16_disk_loads=1, q16_builds=0),
         "p3": dict(q16_disk_loads=0, q16_builds=1)}),
    "stale_table_bytes_removed_with_warm_set": (
        {}, [("new", "p1", dict(budget=EST, warm=True)), ("q16", "p1", 1),
             ("flush", "p1"), ("exists", "p1", 1),
             ("new", "p2", dict(budget=EST, warm=True)),
             ("prewarm_tables", "p2"), ("q16", "p2", 2), ("exists", "p2", 1),
             ("warm_keys", "p2")],
        {"p2": dict(q16_evictions=1)}),
    "prewarm_stops_at_budget_without_deleting_disk": (
        {}, [("new", "p1", dict(budget=5 * EST, warm=True))]
        + _q16("p1", *range(5)) + [
            ("flush", "p1"), ("warm_keys", "p1"), ("new", "p2", B3W),
            ("prewarm_tables", "p2"), ("warm_keys", "p2")]
        + [("exists", "p2", i) for i in range(5)]
        + [("in_cache", "p2", i) for i in range(5)],
        {"p2": dict(q16_evictions=0, q16_resident_sets=3)}),
    "live_miss_streams_from_disk_not_rebuild": (
        {}, [("new", "p", dict(budget=EST, warm=True)), ("q16", "p", 1),
             ("flush", "p"), ("age", "p", 20), ("q16", "p", 2),
             ("flush", "p"), ("age", "p", 20), ("q16", "p", 1)],
        {"p": dict(q16_builds=2, q16_evictions=2, q16_disk_loads=1)}),
    "mru_trim_reclaims_displaced_table_bytes": (
        dict(warm_max=3), [("new", "p", dict(budget=100 * EST, warm=True))]
        + _q16("p", *range(5)) + [("flush", "p"), ("warm_keys", "p")]
        + [("exists", "p", i) for i in range(5)],
        {"p": dict(q16_builds=5)}),
    "live_batch_rides_q8_while_restore_streams": (
        {}, [("new", "p1", B3W), ("q16", "p1", 1), ("flush", "p1"),
             ("new", "p2", B3W), ("loading", "p2", 1, True),
             ("q16", "p2", 1), ("loading", "p2", 1, False),
             ("q16", "p2", 1)],
        {"p2": dict(q16_loading_skips=1, q16_disk_loads=1, q16_builds=0)}),
    "oversize_set_never_builds": (
        dict(est=10 * EST), [("new", "p", B3), ("q16", "p", 0)],
        {"p": dict(q16_oversize_skips=1, q16_builds=0)}),
    "loading_set_never_evicts_residents": (
        {}, [("new", "p", dict(budget=EST)), ("q16", "p", 0),
             ("age", "p", 100), ("loading", "p", 1, True), ("q16", "p", 1),
             ("in_cache", "p", 0)],
        {"p": dict(q16_loading_skips=1, q16_evictions=0)}),
    "q8_tables_persist_without_g16": (
        dict(q8_fill="arange", q8_est=8),
        [("new", "p1", dict(g16=False, warm=True)), ("resolve", "p1", 1),
         ("flush", "p1"), ("exists", "p1", 1, "qtab8"),
         ("warm_keys", "p1"), ("new", "p2", dict(g16=False, warm=True)),
         ("resolve", "p2", 1)],
        {"p2": dict(q8_disk_loads=1)}),
    # tests/test_warm_restart.py: the stub tables fail the real size
    # check, so the fresh provider rebuilds
    "build_persists_and_fresh_provider_prewarms": (
        dict(q8=(2, 3, 20), q16=(4, 3, 20), est=None),
        [("new", "p", dict(warm=True)), ("q16", "p", 9), ("flush", "p"),
         ("warm_keys", "p"), ("new", "p2", dict(warm=True)),
         ("prewarm_tables", "p2"), ("q16", "p2", 9)],
        {"p2": dict(q16_builds=1)}),
    "prewarm_invokes_table_rebuild": (
        {}, [("new", "p", {}), ("prewarm", "p")], {}),
    "corrupt_warm_file_ignored": (
        {}, [("junk_warm_file",), ("new", "p", dict(warm=True)),
             ("warm_keys", "p"), ("prewarm_tables", "p")], {}),
    # one flipped byte fails the sha256 sidecar: rebuild, counted
    "flipped_byte_rebuilds": (
        {}, [("new", "p1", B3W), ("q16", "p1", 1), ("flush", "p1"),
             ("flip", "p1", 1), ("new", "p2", B3W), ("prewarm_tables", "p2")],
        {"p2": dict(q16_disk_loads=0, q16_builds=1)}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_lifecycle_matches_reference(name, monkeypatch, tmp_path):
    stub, steps, expect = SCENARIOS[name]
    _stub(monkeypatch, **stub)
    ref, port = _Side("ref", str(tmp_path)), _Side("port", str(tmp_path))
    for n, step in enumerate(steps):
        got_ref, got_port = ref.run(step), port.run(step)
        where = f"step {n} {step}"
        assert got_port == got_ref, where
        if len(step) > 1 and step[1] in port.provs:
            pr, pp = ref.provs[step[1]], port.provs[step[1]]
            assert ({k: pp.stats[k] for k in SHARED_STATS}
                    == {k: pr.stats[k] for k in SHARED_STATS}), where
            assert port.cache_bytes(pp) == ref.cache_bytes(pr), where
        assert port.warm_state() == ref.warm_state(), where
    for pname, want in expect.items():
        stats = port.provs[pname].stats
        assert {k: stats[k] for k in want} == want
    if name == "prewarm_invokes_table_rebuild":
        assert got_port == [True]


def test_concurrent_miss_builds_once(monkeypatch):
    """Two threads miss one key set at once: one builds, the other rides
    the 8-bit route (None) at once, and the table's bytes count once.
    Before the in-flight marker the port built twice and counted the
    bytes twice; the reference gives these counts on the same stub."""
    entered = threading.Event()

    def slow_build():
        entered.set()
        time.sleep(0.3)

    _stub(monkeypatch, build_hook=slow_build)
    got = {}
    for kind in ("ref", "port"):
        side = _Side(kind, "")
        side.new("p", **B3)
        prov = side.provs["p"]
        entered.clear()
        out = [None, None]

        def lookup(j):
            out[j] = side.lookup(prov, 1)

        first = threading.Thread(target=lookup, args=(0,))
        first.start()
        assert entered.wait(10)
        second = threading.Thread(target=lookup, args=(1,))
        second.start()
        for t in (first, second):
            t.join(10)
            assert not t.is_alive()
        got[kind] = ([o is not None for o in out],
                     {k: prov.stats[k] for k in SHARED_STATS},
                     side.cache_bytes(prov))
    assert got["port"] == got["ref"]
    shown, stats, nbytes = got["port"]
    assert shown == [True, False]
    assert stats["q16_builds"] == 1 and stats["q16_loading_skips"] == 1
    assert stats["q16_cache_bytes"] == nbytes == EST


def test_concurrent_q8_miss_builds_once(monkeypatch):
    """The 8-bit route: a second miss for a set whose Q8 build is in
    flight waits for it instead of building again."""
    entered = threading.Event()
    table = torch.arange(8, dtype=torch.int32)

    def slow(qx, qy):
        entered.set()
        time.sleep(0.3)
        return table

    monkeypatch.setattr(comb, "build_q_tables", slow)
    prov = CUDAProvider(device="cpu", use_g16=False)
    out = [None, None]

    def lookup(j):
        out[j] = prov._q8_cached(_key(1), 1, _QK)

    first = threading.Thread(target=lookup, args=(0,))
    first.start()
    assert entered.wait(10)
    second = threading.Thread(target=lookup, args=(1,))
    second.start()
    for t in (first, second):
        t.join(10)
        assert not t.is_alive()
    assert out[0] is table and out[1] is table
    assert prov.stats["q8_builds"] == 1
    assert not prov._q8_loading


def test_concurrent_lookups_keep_accounting_consistent(monkeypatch):
    """Live batches and a restore hammer the Q16 cache together (more
    threads than this test's one torch thread, a short switch interval):
    the byte count ends equal to the resident tables' bytes."""
    _stub(monkeypatch)
    prov = CUDAProvider(device="cpu", use_g16=True, table_cache_bytes=4 * EST)
    errs = []

    def hammer(tid):
        try:
            for n in range(60):
                prov._q16_cached(_key(n % 6), 1, _QK,
                                 prewarm=(tid == 3 and n % 2 == 0))
        except Exception as e:          # noqa: BLE001
            errs.append(e)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    assert not errs
    with prov._q16_lock:
        expect = sum(v.numel() * 4 for v in prov._q16_cache.values())
        assert prov._q16_bytes == expect == prov.stats["q16_cache_bytes"]
        assert not prov._q16_loading


CUDA_ERROR = "CUDA error: an illegal memory access was encountered"


def test_persist_device_error_is_raised(monkeypatch, tmp_path):
    """A device error in the persist thread's copy is neither a disk
    failure nor a log line: flush_warm_tables raises it, and so does the
    set's next lookup."""
    _stub(monkeypatch)

    def copy_fails(self, table, ready):
        raise RuntimeError(CUDA_ERROR)

    monkeypatch.setattr(CUDAProvider, "_table_to_host", copy_fails)
    prov = CUDAProvider(device="cpu", use_g16=True, table_cache_bytes=3 * EST,
                        warm_keys_dir=str(tmp_path / "warm"))
    assert prov._q16_cached(_key(1), 1, _QK) is not None
    with pytest.raises(RuntimeError, match="illegal memory access"):
        prov.flush_warm_tables()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        prov._q16_cached(_key(1), 1, _QK)
    assert prov.stats["warm_table_persist_failures"] == 0
    assert prov._q16_cached(_key(1), 1, _QK) is not None


def test_restore_device_error_is_raised(monkeypatch, tmp_path):
    """The restore thread's device copy fails: prewarm(wait_restore=True)
    raises it, the set's next lookup raises it, and the set does not stay
    marked as loading."""
    _stub(monkeypatch)
    warm = str(tmp_path / "warm")
    p1 = CUDAProvider(device="cpu", use_g16=True, table_cache_bytes=3 * EST,
                      warm_keys_dir=warm)
    assert p1._q16_cached(_key(1), 1, _QK) is not None
    p1.flush_warm_tables()

    def copy_fails(self, arr):
        raise RuntimeError(CUDA_ERROR)

    monkeypatch.setattr(CUDAProvider, "_table_to_device", copy_fails)
    monkeypatch.setattr(comb, "g16_tables", lambda dev: None)
    p2 = CUDAProvider(device="cpu", use_g16=True, table_cache_bytes=3 * EST,
                      warm_keys_dir=warm)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        p2.prewarm(wait_restore=True)
    assert not p2._q16_loading
    with pytest.raises(RuntimeError, match="illegal memory access"):
        p2._q16_cached(_key(1), 1, _QK)
    assert p2.stats["q16_disk_loads"] == 0 and p2.stats["q16_builds"] == 0


def test_disk_failure_is_counted_not_raised(monkeypatch, tmp_path):
    _stub(monkeypatch)

    def no_disk(path, blk=1 << 20):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(comb, "file_sha256", no_disk)
    prov = CUDAProvider(device="cpu", use_g16=True, table_cache_bytes=3 * EST,
                        warm_keys_dir=str(tmp_path / "warm"))
    assert prov._q16_cached(_key(1), 1, _QK) is not None
    prov.flush_warm_tables()
    # the Q16 table's and its Q8 table's writes
    assert prov.stats["warm_table_persist_failures"] == 2


def test_factory_passes_warm_keys_dir(tmp_path):
    warm = str(tmp_path / "warm")
    cfg = {"Default": "CUDA", "CUDA": {"Device": "cpu", "WarmKeysDir": warm}}
    opts = factory.FactoryOpts.from_config(cfg)
    assert opts.cuda.warm_keys_dir == warm
    assert factory.new_bccsp(opts)._warm_keys_dir == warm
    # unset stays disabled
    assert factory.FactoryOpts.from_config(
        {"Default": "CUDA"}).cuda.warm_keys_dir is None


def test_q8_bytes_restore_on_the_cpu(tmp_path):
    """Real bytes: one verify_prepared on one key pays one real Q8 build
    (UseG16 false: the Q8 file is the warm state), persists it; a fresh
    provider on the same dir restores the table bit for bit, builds
    nothing and gives the sw provider's verdicts."""
    rng = np.random.default_rng(11)
    csp = sw.SWProvider()
    priv = sw.ECDSAPrivateKey(int.from_bytes(rng.bytes(32), "big")
                              % (utils.P256_N - 1) + 1)
    pub = priv.public_key()
    digests = [hashlib.sha256(rng.bytes(64)).digest() for _ in range(16)]
    sigs = [csp.sign(priv, d) for d in digests]
    digests[3] = hashlib.sha256(b"tampered").digest()
    r, s = utils.unmarshal_signature(sigs[7])
    sigs[7] = utils.marshal_signature(r, utils.P256_N - s)      # high-S
    der_ok, r8, rpn8, w8 = native.batch_prep(sigs)
    prepared = dict(digests=np.frombuffer(b"".join(digests), np.uint8)
                    .reshape(16, 32), r=r8, rpn=rpn8, w=w8, der_ok=der_ok,
                    key_idx=np.zeros(16, np.int64), keys=[pub],
                    get_sig=sigs.__getitem__)
    want = [csp.verify(pub, sig, d) for sig, d in zip(sigs, digests)]
    assert want.count(False) == 2
    cfg = {"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, "UseG16": False,
        "WarmKeysDir": str(tmp_path / "warm")}}

    p1 = factory.new_bccsp(cfg)
    assert p1.verify_prepared(**prepared) == want
    p1.flush_warm_tables()
    assert p1.stats["q8_builds"] == 1 and p1.stats["q8_disk_loads"] == 0
    (cache_key, built), = p1._q8_cache.items()
    assert os.path.exists(p1._table_path(cache_key, "qtab8"))
    assert json.load(open(tmp_path / "warm" / "warm_keysets.json")) == [
        [kb.hex() for kb in cache_key]]

    p2 = factory.new_bccsp(cfg)
    p2.prewarm(wait_restore=True)
    assert p2.verify_prepared(**prepared) == want
    assert p2.stats["q8_disk_loads"] == 1 and p2.stats["q8_builds"] == 0
    assert torch.equal(p2._q8_cache[cache_key], built)
