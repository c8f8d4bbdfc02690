"""fabric_tpu_torch.common.profiling against fabric_tpu.common.profiling:
the provider and device-cost gauges, and the torch trace capture.

One tick of `devicecost_tick` and of the provider-stats publisher, on the
same fake provider (a stats dict, device rows, busy notes on the same
clock) and the same memory rows (each package's `device_memory`
monkeypatched), renders the same Prometheus text in both packages'
providers. The reference's publisher also declares its admission-wait
gauge whatever the provider has; the port has no admission window, so
that one family is left out of the comparison. The reference's poller is
kept from starting: its `_spawn_poller` is replaced by one that hands
back the tick. The torch trace capture keeps the newest `keep`
directories, refuses a concurrent capture without leaking a directory,
and refuses CUDA on a host without it.
"""

import os

import pytest
import torch

from fabric_tpu.common import devicecost as jdc
from fabric_tpu.common import metrics as jmetrics
from fabric_tpu.common import profiling as jprof

from fabric_tpu_torch.common import devicecost as dc
from fabric_tpu_torch.common import metrics, profiling


class _Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


ROWS = [{"device": 0, "kind": "NVIDIA H100 80GB HBM3",
         "bytes_in_use": 1_200_000_000, "peak_bytes_in_use": 2_500_000_000,
         "bytes_limit": 85_029_158_912}]


class _Csp:
    """A provider as the publishers see it."""

    def __init__(self, mod, clock):
        self.stats = {"compile_total": 3, "compile_cache_hits": 2,
                      "compile_cold_total": 1, "compile_failures": 0,
                      "compile_seconds": 41.25, "fused_batches": 2,
                      "fused_lanes": 61440, "pairing_pairs": 2048,
                      "pairing_batches": 2, "tree_kernel_launches": 5,
                      "table_build_s": 13.5}
        self.device_stats = {"state": [0], "trips": [1],
                             "quarantines": [0], "readmits": [2]}

        class _Rec:
            busy = mod.DeviceBusy(clock)
        self.device_cost = _Rec()


def _render(prov, mod_metrics_prefix_drop=()):
    lines = prov.render().splitlines()
    return [ln for ln in lines if not any(
        ln.replace("# HELP ", "").replace("# TYPE ", "").startswith(p)
        for p in mod_metrics_prefix_drop)]


def test_gauges_render_like_reference(monkeypatch):
    monkeypatch.setattr(dc, "device_memory", lambda: [dict(r) for r in ROWS])
    monkeypatch.setattr(jdc, "device_memory", lambda: [dict(r) for r in ROWS])
    monkeypatch.setattr(jprof, "_spawn_poller",
                        lambda name, poll_s, tick: tick)
    out = []
    for mmod, dmod, tick_of in (
            (metrics, dc, profiling.provider_stats_tick),
            (jmetrics, jdc, jprof.publish_provider_stats)):
        clock = _Clock(100.0)
        csp = _Csp(dmod, clock)
        prov = mmod.PrometheusProvider()
        stats_tick = tick_of(prov, csp)
        dev_tick = (profiling if mmod is metrics else jprof).devicecost_tick(
            prov, csp)
        csp.device_cost.busy.note(0, 0.5)
        clock.advance(2.0)
        stats_tick()
        dev_tick()
        out.append(_render(prov, ("bccsp_admission_wait_s",)))
    assert out[0] == out[1]
    text = "\n".join(out[0])
    for want in ('bccsp_device_mem_used_bytes{device="0"} 1200000000',
                 'bccsp_device_mem_limit_bytes{device="0"} 85029158912',
                 'bccsp_device_busy_ratio{device="0"} 0.25',
                 "bccsp_compile_total 3", "bccsp_compile_cold_total 1",
                 "bccsp_tree_kernel_launches 5",
                 'bccsp_device_readmits{device="0"} 2'):
        assert want in text, want


def test_publishers_spawn_daemon_pollers(monkeypatch):
    monkeypatch.setattr(dc, "device_memory", lambda: [])
    csp = _Csp(dc, _Clock())
    prov = metrics.PrometheusProvider()
    for t in (profiling.publish_provider_stats(prov, csp, poll_s=3600.0),
              profiling.publish_devicecost_stats(prov, csp, poll_s=3600.0)):
        assert t is not None and t.daemon and t.is_alive()
    assert profiling.publish_provider_stats(prov, object()) is None


def test_cpu_provider_gauges():
    """A CPU provider publishes its stats and an empty device table."""
    from fabric_tpu_torch.bccsp import factory

    csp = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, "UseG16": False}})
    prov = metrics.PrometheusProvider()
    profiling.provider_stats_tick(prov, csp)()
    profiling.devicecost_tick(prov, csp)()
    text = prov.render()
    assert "bccsp_compile_total 0" in text
    assert "bccsp_tree_kernel_launches 0" in text
    assert 'bccsp_device_mem_used_bytes{' not in text


# -- the torch trace capture --

def test_bounded_capture_keeps_newest(tmp_path):
    kept = [profiling.capture_torch_trace_bounded(
        0.02, parent_dir=str(tmp_path), keep=2, device="cpu")
        for _ in range(3)]
    left = sorted(os.listdir(tmp_path))
    assert left == sorted(os.path.basename(k) for k in kept[1:])
    assert os.path.exists(os.path.join(kept[-1], "trace.json"))


def test_concurrent_capture_refused_without_leak(tmp_path):
    """While a capture holds the profiler, another is refused at once
    and leaves no directory; once it ends, captures run again."""
    with profiling._trace_lock:
        with pytest.raises(profiling.ProfilerBusyError):
            profiling.capture_torch_trace_bounded(
                0.01, parent_dir=str(tmp_path / "bounded"), device="cpu")
        with pytest.raises(profiling.ProfilerBusyError):
            profiling.capture_torch_trace(str(tmp_path / "direct"), 0.01,
                                          "cpu")
    assert os.listdir(tmp_path / "bounded") == []
    profiling.capture_torch_trace(str(tmp_path / "after"), 0.01, "cpu")
    assert os.path.exists(tmp_path / "after" / "trace.json")


def test_cuda_capture_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is absent"):
        profiling.capture_torch_trace(str(tmp_path), 0.01)
    with pytest.raises(RuntimeError, match="CUDA is absent"):
        profiling.capture_torch_trace_bounded(0.01, parent_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []
