"""fabric_tpu_torch.common.devicecost against fabric_tpu.common.devicecost,
the provider's build seam, and its health surface.

The recorders of both packages get the same calls on the same injected
clocks and build directories: `DeviceBusy` totals and ratios, and
`CompileRecorder` stats and events (a cache-dir entry delta marks a call
cold, a fast call that writes nothing is a hit, the wall-time threshold
decides without a directory, a raising build books a failure and
re-raises, the event history is capped, a cold build emits the
`compile.cold` instant and in steady state an auto dump) must be equal,
apart from the events' `cost`, which the port never fills. The health
strings and device rows of a CPU `CUDAProvider` equal the reference
`TPUProvider`'s on the same memory rows. The build seam books the first
load of a library through a provider once: cold when the compiler ran,
a hit when the library was reused, a failure (and the error) when the
build raised; a prewarm on a card passes every kernel library through
the seam (a stand-in nvcc here).
"""

import os
import shlex
import shutil
import subprocess

import pytest
import torch

from fabric_tpu.common import devicecost as jdc
from fabric_tpu.common import tracing as jtr

from fabric_tpu_torch import kernels, native
from fabric_tpu_torch.bccsp import factory
from fabric_tpu_torch.common import devicecost as dc
from fabric_tpu_torch.common import torchenv
from fabric_tpu_torch.common import tracing as tr


class _Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture()
def traces(tmp_path):
    """Both packages' recorders on, small rings, instant dumps into
    tmp_path/<package>; the defaults restored afterwards."""
    for name, mod in (("port", tr), ("ref", jtr)):
        mod.configure(enabled=True, ring_size=256, sample_every=1,
                      dump_dir=str(tmp_path / "dumps" / name),
                      dump_min_interval_s=0.0)
        mod.reset()
    yield tmp_path / "dumps"
    for mod in (tr, jtr):
        mod.wait_dumps()
        mod.configure(enabled=True, ring_size=4096, sample_every=1,
                      dump_dir="", dump_min_interval_s=10.0)
        mod.reset()


def _fake_rows(used, limit, device=0):
    return [{"device": device, "kind": "fake", "bytes_in_use": used,
             "peak_bytes_in_use": used, "bytes_limit": limit}]


# -- DeviceBusy --

def test_device_busy_matches_reference():
    """Notes on two devices, a non-positive note, windows with and
    without traffic, a zero-length window and a clamped ratio."""
    steps = [("note", 0, 0.25), ("note", 1, 0.5), ("note", 0, 0.0),
             ("note", 1, -1.0), ("advance", 1.0), ("ratios",),
             ("advance", 2.0), ("ratios",), ("note", 0, 5.0),
             ("advance", 1.0), ("ratios",), ("ratios",), ("note", 1, 0.125),
             ("advance", 0.5), ("ratios",)]
    got = []
    for mod in (dc, jdc):
        clock = _Clock(10.0)
        busy = mod.DeviceBusy(clock)
        seen = []
        for st in steps:
            if st[0] == "note":
                busy.note(st[1], st[2])
            elif st[0] == "advance":
                clock.advance(st[1])
            else:
                seen.append(busy.ratios())
        seen.append(busy.totals())
        got.append(seen)
    assert got[0] == got[1]
    assert got[0][0] == {0: 0.25, 1: 0.5}
    assert got[0][2][0] == 1.0          # clamped
    assert got[0][3] == {}              # zero-length window


class _Event:
    """A stand-in CUDA event: `t` ms on the card's clock, done or not."""

    def __init__(self, t: float, done: bool = True):
        self.t, self.done = t, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end) -> float:
        assert self.done and end.done
        return end.t - self.t


def test_device_busy_event_pairs_book_once_completed():
    """A noted event pair is booked by the first drain after its end
    completes (totals and ratios drain first), once, with `then` called
    on the pair and its seconds; an unfinished pair stays pending and
    keeps its place before later pairs."""
    clock = _Clock(0.0)
    busy = dc.DeviceBusy(clock)
    booked = []

    def then(start, end, s):
        booked.append((start.t, end.t, s))

    late = _Event(30.0, done=False)
    busy.note_events(0, _Event(0.0), _Event(250.0), then)
    busy.note_events(1, _Event(10.0), late, then)
    busy.note_events(0, _Event(300.0), _Event(550.0), then)
    assert booked == []
    assert busy.totals() == {0: 0.5}
    assert booked == [(0.0, 250.0, 0.25), (300.0, 550.0, 0.25)]
    busy.drain()
    assert len(booked) == 2             # nothing booked twice
    late.done = True
    clock.advance(2.0)
    assert busy.ratios() == {0: 0.25, 1: 0.01}
    assert booked[-1] == (10.0, 30.0, 0.02)
    assert busy.totals() == {0: 0.5, 1: 0.02}


# -- CompileRecorder --

def _run_sequence(mod, cache_dir, clock, steps, threshold=5.0):
    """Drive one recorder through `steps`: ("build", kind, seconds,
    writes, fails) runs run_compile on a thunk that advances the clock,
    optionally writes an entry into the cache dir and optionally raises;
    ("steady",) marks steady state."""
    rec = mod.CompileRecorder(clock=clock, cache_dir=cache_dir,
                              cold_threshold_s=threshold)
    errors = []
    for i, st in enumerate(steps):
        if st[0] == "steady":
            rec.mark_steady()
            continue
        _, kind, secs, writes, fails = st

        def thunk(secs=secs, writes=writes, fails=fails, i=i):
            clock.advance(secs)
            if writes:
                with open(os.path.join(cache_dir, f"lib{i}.so"), "w") as f:
                    f.write("x")
            if fails:
                raise RuntimeError(f"build {kind} failed")
            return kind

        try:
            assert rec.run_compile(kind, None, thunk) == kind
        except RuntimeError as e:
            errors.append(str(e))
    return rec, errors


def _both(tmp_path, steps, threshold=5.0, with_dir=True):
    out = []
    for name, mod in (("port", dc), ("ref", jdc)):
        d = tmp_path / name
        d.mkdir()
        rec, errors = _run_sequence(mod, str(d) if with_dir else None,
                                    _Clock(), steps, threshold)
        out.append((rec, errors))
    return out


def _events(rec):
    return [{k: v for k, v in ev.items() if k != "cost"}
            for ev in rec.events]


@pytest.mark.parametrize("case", ["delta_cold", "fast_hit", "threshold",
                                  "failure"])
def test_compile_recorder_matches_reference(tmp_path, traces, case):
    steps = {
        # a build that writes its library is cold however fast it is
        "delta_cold": [("build", "ptree", 0.5, True, False),
                       ("build", "sha_windows", 0.01, True, False)],
        # a fast load that writes nothing is a hit
        "fast_hit": [("build", "ptree", 0.01, False, False),
                     ("build", "batchprep", 0.002, False, False)],
        # without a directory to probe, the wall time decides
        "threshold": [("build", "ptree", 6.0, False, False),
                      ("build", "ladder", 0.1, False, False)],
        "failure": [("build", "ptree", 0.3, False, True),
                    ("build", "ptree", 0.2, True, False)],
    }[case]
    (mine, my_err), (ref, ref_err) = _both(
        tmp_path, steps, with_dir=case != "threshold")
    assert mine.stats == ref.stats
    assert _events(mine) == _events(ref)
    assert all(ev["cost"] is None for ev in mine.events)
    assert my_err == ref_err
    if case == "failure":
        assert mine.stats["compile_failures"] == 1 and my_err
    # the tpu.compile spans (kind, error status) and instants agree
    assert [(e[0], e[1], e[8], e[9] is not None) for e in tr.snapshot()] \
        == [(e[0], e[1], e[8], e[9] is not None) for e in jtr.snapshot()]


def test_cold_build_instant_and_steady_dump(tmp_path, traces):
    """A cold build before steady state emits compile.cold only; after
    mark_steady it also auto-dumps the flight recorder, in both
    packages."""
    steps = [("build", "ptree", 7.0, True, False), ("steady",),
             ("build", "ladder", 8.0, True, False)]
    (mine, _), (ref, _) = _both(tmp_path, steps)
    assert _events(mine) == _events(ref)
    assert [e["steady"] for e in mine.events] == [False, True]
    for mod in (tr, jtr):
        mod.wait_dumps()
        colds = [e for e in mod.snapshot() if e[1] == "compile.cold"]
        assert [(e[0], e[8]["kind"], e[8]["steady"]) for e in colds] == [
            ("i", "ptree", False), ("i", "ladder", True)]
    for name in ("port", "ref"):
        dumps = [p.name for p in (traces / name).glob("ftpu_trace_*.json")]
        assert len(dumps) == 1 and "cold_compile" in dumps[0], name


def test_event_history_capped(tmp_path):
    (mine, _), (ref, _) = _both(
        tmp_path, [("build", f"k{i}", 0.001, False, False)
                   for i in range(dc._EVENT_CAP + 9)])
    assert len(mine.events) == dc._EVENT_CAP == len(ref.events)
    assert _events(mine) == _events(ref)
    assert mine.stats == ref.stats


# -- memory rows --

def test_hbm_substate_and_peak_match_reference():
    rows = _fake_rows(used=950, limit=1000) + \
        _fake_rows(used=100, limit=1000, device=1)
    cases = [(rows, 0.10), (rows, 0.01), ([], 0.5),
             (_fake_rows(used=5, limit=0), 0.5),
             (_fake_rows(used=1200, limit=1000), 0.1)]
    for r, frac in cases:
        assert dc.hbm_substate(r, headroom_frac=frac) == \
            jdc.hbm_substate(r, headroom_frac=frac)
        assert dc.peak_memory_bytes(r) == jdc.peak_memory_bytes(r)
    assert dc.hbm_substate(rows, headroom_frac=0.10) == "hbm_low:d0:5%free"
    assert dc.peak_memory_bytes(rows) == 950


def test_device_memory_empty_without_cuda():
    """No CUDA here (or none initialised): no rows, no context made."""
    assert dc.device_memory() == []
    assert dc.peak_memory_bytes() == 0
    assert dc.hbm_substate() is None


# -- the provider's health surface --

@pytest.fixture(scope="module")
def providers():
    from fabric_tpu.bccsp.tpu import TPUProvider
    mine = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, "UseG16": False}})
    return mine, TPUProvider(min_batch=4, use_g16=False)


def test_health_and_device_stats_match_reference(providers, monkeypatch):
    mine, ref = providers
    assert mine.health() == ref.health() == "device"
    assert mine.device_stats == ref.device_stats
    monkeypatch.setattr(dc, "device_memory",
                        lambda: _fake_rows(used=990, limit=1000))
    monkeypatch.setattr(jdc, "device_memory",
                        lambda: _fake_rows(used=990, limit=1000))
    assert mine.health() == ref.health() == "device;hbm_low:d0:1%free"


def test_health_survives_a_failing_probe(providers, monkeypatch):
    mine, _ = providers

    def boom():
        raise RuntimeError("probe failed")
    monkeypatch.setattr(dc, "device_memory", boom)
    assert mine.health() == "device"


def test_compile_stats_present_from_construction(providers):
    mine, ref = providers
    keys = ("compile_total", "compile_cache_hits", "compile_cold_total",
            "compile_failures", "compile_seconds")
    assert {k: mine.stats[k] for k in keys} == {k: 0 for k in keys}
    assert set(keys) <= set(ref.stats)
    assert mine.device_cost.stats is mine.stats


# -- the build seam --

@pytest.fixture()
def fresh_build_dir(tmp_path, monkeypatch):
    """An empty build directory, and a stand-in compiler that copies the
    batch prep library the test session already built (no second
    build): a load there runs "the compiler" and writes a new library."""
    built = native.build()
    cxx = tmp_path / "cxx.sh"
    cxx.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                   f'cp "{built}" "$2"\n')
    d = tmp_path / "build"
    monkeypatch.setattr(torchenv, "BUILD_DIR", str(d))
    # run by sh, so a temporary directory mounted noexec does not matter
    monkeypatch.setenv("CXX", f"sh {shlex.quote(str(cxx))}")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _provider():
    return factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, "UseG16": False}})


def test_first_load_books_cold_then_hit(fresh_build_dir, traces):
    first = _provider()
    first.prewarm()
    assert [(e["kind"], e["cold"], e["cache_hit"])
            for e in first.device_cost.events] == [("batchprep", True,
                                                     False)]
    assert first.stats["compile_cold_total"] == 1
    assert first.stats["compile_seconds"] > 0
    assert os.listdir(fresh_build_dir)
    first.prewarm()                     # seen: books nothing more
    assert len(first.device_cost.events) == 1
    second = _provider()
    second.prewarm()
    assert [(e["kind"], e["cache_hit"])
            for e in second.device_cost.events] == [("batchprep", True)]
    assert second.stats["compile_cache_hits"] == 1
    spans = [e for e in tr.snapshot() if e[1] == "tpu.compile"]
    assert [s[8]["kind"] for s in spans] == ["batchprep", "batchprep"]
    assert [e[8]["kind"] for e in tr.snapshot()
            if e[1] == "compile.cold"] == ["batchprep"]


def test_failed_build_books_failure_and_raises(fresh_build_dir, traces,
                                               monkeypatch):
    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}")
    monkeypatch.setattr(kernels, "_start", broken)
    prov = _provider()
    with dc.recording(prov.device_cost):
        with pytest.raises(RuntimeError, match="nvcc failed for ptree"):
            kernels.load("ptree")
    assert prov.stats["compile_failures"] == 1
    assert prov.stats["compile_total"] == 0
    assert prov.device_cost.events[0]["error"] is not None
    span = [e for e in tr.snapshot() if e[1] == "tpu.compile"][-1]
    assert span[8]["kind"] == "ptree" and "nvcc failed" in span[9]
    # a retry books again: the failed library was not claimed
    with dc.recording(prov.device_cost):
        with pytest.raises(RuntimeError):
            kernels.load("ptree")
    assert prov.stats["compile_failures"] == 2


def test_loads_outside_a_provider_book_nothing(fresh_build_dir):
    prov = _provider()
    native.load()
    assert prov.device_cost.events == []


# -- the build seam on a prewarm: every kernel library, nvcc stood in --

@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    """A library exporting every C function of every kernel library, each
    a stub: what the stand-in nvcc "builds"."""
    d = tmp_path_factory.mktemp("stub")
    src = d / "stub.cpp"
    src.write_text("".join(f'extern "C" int {fn}(void) {{ return 0; }}\n'
                           for _, fns in kernels.KERNELS.values()
                           for fn in fns))
    cxx = shlex.split(os.environ.get("CXX") or "g++")
    subprocess.run([*cxx, "-shared", "-fPIC", "-o", str(d / "stub.so"),
                    str(src)], check=True, timeout=120)
    return d / "stub.so"


def _stand_in_nvcc(tmp_path, monkeypatch, body):
    """nvcc stood in by `sh script`, the script's body given; nothing
    the seam loads leaks out of the test."""
    script = tmp_path / "nvcc.sh"
    script.write_text("#!/bin/sh\n" + body)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: shutil.which("sh"))
    monkeypatch.setattr(kernels, "NVCC_FLAGS", [str(script)])
    monkeypatch.setattr(kernels, "_loaded", {})


def _card_provider():
    """A provider whose prewarm takes the card's branch (the kernel
    libraries); UseG16 off, so it builds no table."""
    prov = _provider()
    prov.device = torch.device("cuda")
    return prov


def test_prewarm_books_every_kernel_library(fresh_build_dir, stub_lib,
                                            traces, tmp_path, monkeypatch):
    _stand_in_nvcc(tmp_path, monkeypatch,
                   'while [ "$1" != "-o" ]; do shift; done\n'
                   f'cp "{stub_lib}" "$2"\n')
    libs = {"batchprep", *kernels.KERNELS}
    first = _card_provider()
    first.prewarm()
    evs = first.device_cost.events
    assert sorted(e["kind"] for e in evs) == sorted(libs)
    assert all(e["cold"] and not e["cache_hit"] and e["error"] is None
               for e in evs)
    assert first.stats["compile_cold_total"] == len(libs)
    assert first.stats["compile_failures"] == 0
    assert first.stats["compile_seconds"] > 0
    assert sorted(e[8]["kind"] for e in tr.snapshot()
                  if e[1] == "compile.cold") == sorted(libs)
    assert sorted(e[8]["kind"] for e in tr.snapshot()
                  if e[1] == "tpu.compile") == sorted(libs)
    for name in kernels.KERNELS:
        assert os.path.exists(kernels.library_path(name))
    second = _card_provider()
    second.prewarm()
    assert sorted((e["kind"], e["cache_hit"])
                  for e in second.device_cost.events) == sorted(
                      (k, True) for k in libs)
    assert second.stats["compile_cold_total"] == 0
    # with no provider's recorder, build_all books into one of its own
    built = kernels.build_all()
    assert sorted(built) == sorted(kernels.KERNELS)
    assert all(not v["cold"] and v["seconds"] >= 0 for v in built.values())


def test_prewarm_failed_nvcc_books_failures_and_raises(
        fresh_build_dir, stub_lib, traces, tmp_path, monkeypatch):
    _stand_in_nvcc(tmp_path, monkeypatch,
                   'echo "stand-in: error"\nexit 1\n')
    prov = _card_provider()
    with pytest.raises(RuntimeError, match="nvcc failed for"):
        prov.prewarm()
    assert prov.stats["compile_failures"] == len(kernels.KERNELS)
    assert prov.stats["compile_total"] == 1          # the batch prep
    failed = [e for e in prov.device_cost.events if e["error"]]
    assert sorted(e["kind"] for e in failed) == sorted(kernels.KERNELS)
    spans = [e for e in tr.snapshot() if e[1] == "tpu.compile"
             and e[8]["kind"] in kernels.KERNELS]
    assert len(spans) == len(kernels.KERNELS)
    assert all("nvcc failed" in s[9] for s in spans)
