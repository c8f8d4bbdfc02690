"""Profiling and gauge surfaces: the port's copy of the parts of
fabric_tpu/common/profiling.py the provider's telemetry uses.

  * `capture_torch_trace(out_dir, seconds, device)` — the counterpart of
    the reference's `capture_jax_trace`: a torch.profiler capture (CUDA
    activity on a CUDA device, CPU activity on the CPU) of whatever runs
    during the window, written as a Chrome trace into `out_dir`.
    `capture_torch_trace_bounded` keeps the newest captures under one
    parent directory (`FTPU_JAX_TRACE_KEEP` of them, the reference's
    knob, read here for the torch captures).
  * `publish_provider_stats` — the provider's `stats` counters as
    `bccsp_<stat>` gauges (the canonical opts where the reference has
    them), its `shard_stats` lists as the device-labeled
    `bccsp_shard_{transfer_s,ready_s,lanes}` gauges and its
    `device_stats` rows as the device-labeled
    `bccsp_device_{state,trips,quarantines,readmits}` gauges (label: the
    full-mesh position).
  * `publish_devicecost_stats` — the card's memory rows and busy ratio as
    `bccsp_device_mem_{used,peak,limit}_bytes` and
    `bccsp_device_busy_ratio`.

Each publisher spawns one daemon poller; `provider_stats_tick` and
`devicecost_tick` build the gauges and return the refresh callable alone,
for one deterministic tick. Nothing starts a thread at import. The
reference's breaker, scheme and admission gauges are not ported: the
port's provider has none of those surfaces.
"""

from __future__ import annotations

import itertools
import logging
import os
import shutil
import tempfile
import threading
import time

from fabric_tpu_torch.common import devicecost as dc
from fabric_tpu_torch.common import metrics as metrics_mod

logger = logging.getLogger("fabric_tpu_torch.common.profiling")

_poller_seq = itertools.count()


def _spawn_poller(name: str, poll_s: float, tick) -> threading.Thread:
    """One daemon poll loop, with a process-unique thread name and a
    deterministic per-poller interval jitter (+3% per poller sequence:
    strictly distinct periods, so stacked pollers never wake in
    phase)."""
    seq = next(_poller_seq)
    interval = poll_s * (1.0 + 0.03 * seq)

    def loop():
        while True:
            tick()
            time.sleep(interval)

    t = threading.Thread(target=loop, name=f"{name}-{seq}",
                         daemon=True)
    t.start()
    return t


_trace_lock = threading.Lock()

# bounded trace output: captures beyond this many are pruned
# oldest-first from the managed parent directory
JAX_TRACE_KEEP = int(os.environ.get("FTPU_JAX_TRACE_KEEP", "5"))


class ProfilerBusyError(RuntimeError):
    """A trace capture is already running. The profiler supports one
    live session per process; a second request is REFUSED at once
    instead of waiting for the whole capture window."""


def capture_torch_trace(out_dir: str, seconds: float = 3.0,
                        device=None) -> str:
    """Capture a torch.profiler trace of `seconds` into `out_dir`
    (`trace.json`, Chrome-trace format); returns the directory. On a
    CUDA `device` (the card when None) the profiler records the card's
    activity too, and raises when CUDA is absent; on the CPU it records
    the host's. One live session per process: a concurrent call raises
    ProfilerBusyError at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda" if device is None else device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"trace capture on {dev} requested but "
                               f"CUDA is absent")
        activities.append(ProfilerActivity.CUDA)
    if not _trace_lock.acquire(blocking=False):
        raise ProfilerBusyError(
            "a trace capture is already running; retry after its "
            "window ends")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            time.sleep(seconds)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    finally:
        _trace_lock.release()
    return out_dir


def capture_torch_trace_bounded(seconds: float = 3.0,
                                parent_dir: str | None = None,
                                keep: int | None = None,
                                device=None) -> str:
    """A fresh per-capture directory under ONE managed parent, pruned
    to the newest `keep` captures after each run. Raises
    ProfilerBusyError like capture_torch_trace, leaving no directory
    behind."""
    parent = parent_dir or os.path.join(tempfile.gettempdir(),
                                        "ftpu_torch_trace")
    os.makedirs(parent, exist_ok=True)
    out = tempfile.mkdtemp(prefix="torch_trace_", dir=parent)
    try:
        capture_torch_trace(out, seconds, device)
    except BaseException:
        shutil.rmtree(out, ignore_errors=True)  # never leak the dir
        raise
    _prune_trace_dirs(parent, JAX_TRACE_KEEP if keep is None
                      else max(1, int(keep)))
    return out


def _prune_trace_dirs(parent: str, keep: int) -> None:
    """Delete all but the newest `keep` capture directories under
    `parent` (best-effort — a prune failure never fails the capture
    that triggered it)."""
    try:
        entries = [e for e in os.scandir(parent) if e.is_dir()]
    except OSError:
        return
    entries.sort(key=lambda e: e.stat().st_mtime, reverse=True)
    for e in entries[max(1, keep):]:
        shutil.rmtree(e.path, ignore_errors=True)


def publish_provider_stats(metrics_provider, csp, poll_s: float = 5.0):
    """Expose a provider's `stats` counters as gauges (`bccsp_<name>`)
    and its `device_stats` rows as device-labeled gauges, refreshed by a
    daemon poller. Returns the poller thread (daemon, running), or None
    when the provider keeps no stats dict."""
    tick = provider_stats_tick(metrics_provider, csp)
    if tick is None:
        return None
    return _spawn_poller("bccsp-stats", poll_s, tick)


def provider_stats_tick(metrics_provider, csp):
    """Build publish_provider_stats' gauges and return its refresh
    callable (None when the provider keeps no stats dict), for one
    deterministic tick."""
    stats = getattr(csp, "stats", None)
    if not isinstance(stats, dict):
        return None
    # the keys with canonical declarations (help text) in the
    # reference's metrics; every other stats key gets a generic gauge
    # named after it
    canonical = {
        "compile_total": metrics_mod.BCCSP_COMPILE_TOTAL_OPTS,
        "compile_cache_hits":
            metrics_mod.BCCSP_COMPILE_CACHE_HITS_OPTS,
        "compile_seconds": metrics_mod.BCCSP_COMPILE_SECONDS_OPTS,
        "fused_batches": metrics_mod.BCCSP_FUSED_BATCHES_OPTS,
        "fused_lanes": metrics_mod.BCCSP_FUSED_LANES_OPTS,
        "pairing_pairs": metrics_mod.BCCSP_PAIRING_PAIRS_OPTS,
        "pairing_batches": metrics_mod.BCCSP_PAIRING_BATCHES_OPTS,
        # the mesh's scalars share their fqnames with the canonical
        # bccsp_shard_* declarations; the quarantine and readmit totals
        # share their stats key with the labeled bccsp_device_* series
        "shard_devices": metrics_mod.BCCSP_SHARD_DEVICES_OPTS,
        "shard_dispatches": metrics_mod.BCCSP_SHARD_DISPATCHES_OPTS,
        "shard_skew_s": metrics_mod.BCCSP_SHARD_SKEW_SECONDS_OPTS,
        "device_quarantines":
            metrics_mod.BCCSP_DEVICE_QUARANTINES_TOTAL_OPTS,
        "device_readmits": metrics_mod.BCCSP_DEVICE_READMITS_TOTAL_OPTS,
    }
    gauges = {
        name: metrics_provider.new_gauge(canonical.get(
            name, metrics_mod.GaugeOpts(
                namespace="bccsp", name=name,
                help="BCCSP provider runtime counter "
                     "(TPUProvider.stats)"))).with_labels()
        for name in stats
    }
    # per-position gauges (device label = the full-mesh position), read
    # fresh per poll from the provider's shard_stats lists (replaced
    # wholesale each sharded batch) and device_stats rows (so a cooldown's
    # quarantined -> probing shows without a dispatch)
    labeled = {}
    for attr, prefix, opts in (
            ("shard_stats", "shard_", {
                "transfer_s": metrics_mod.BCCSP_SHARD_TRANSFER_SECONDS_OPTS,
                "ready_s": metrics_mod.BCCSP_SHARD_READY_SECONDS_OPTS,
                "lanes": metrics_mod.BCCSP_SHARD_LANES_OPTS}),
            ("device_stats", "device_", {
                "state": metrics_mod.BCCSP_DEVICE_STATE_OPTS,
                "trips": metrics_mod.BCCSP_DEVICE_TRIPS_OPTS,
                "quarantines": metrics_mod.BCCSP_DEVICE_QUARANTINES_OPTS,
                "readmits": metrics_mod.BCCSP_DEVICE_READMITS_OPTS})):
        if isinstance(getattr(csp, attr, None), dict):
            try:
                labeled[attr] = (prefix, {
                    name: metrics_provider.new_gauge(o)
                    for name, o in opts.items()})
            except Exception:
                pass

    warned: set = set()         # once per gauge, not once per poll

    def tick():
        for name, g in gauges.items():
            try:
                g.set(float(stats.get(name, 0)))
            except Exception as e:
                if name not in warned:
                    warned.add(name)
                    logger.warning("bccsp stats gauge %r publish "
                                   "failed (suppressing repeats): "
                                   "%s", name, e)
        for attr, (prefix, gs) in labeled.items():
            cur = getattr(csp, attr, None)
            if not isinstance(cur, dict):
                continue
            for name, g in gs.items():
                try:
                    for d, v in enumerate(cur.get(name) or ()):
                        g.with_labels("device", str(d)).set(float(v))
                except Exception as e:
                    if (prefix + name) not in warned:
                        warned.add(prefix + name)
                        logger.warning(
                            "bccsp %s gauge %r publish failed "
                            "(suppressing repeats): %s", prefix[:-1],
                            name, e)

    return tick


def publish_devicecost_stats(metrics_provider, csp,
                             poll_s: float = 5.0):
    """Expose the device-cost readings as gauges, refreshed by a daemon
    poller: per-device memory occupancy
    (`bccsp_device_mem_{used,peak,limit}_bytes`, from
    devicecost.device_memory — a host without CUDA publishes nothing)
    and per-device busy ratios (`bccsp_device_busy_ratio`, device-time
    over wall-time in the poll window, fed by the provider's
    CompileRecorder.busy accumulator). The build counters ride
    publish_provider_stats (they live in the provider's stats dict).
    Returns the poller thread, or None when the gauges cannot be
    declared."""
    tick = devicecost_tick(metrics_provider, csp)
    if tick is None:
        return None
    return _spawn_poller("devicecost-stats", poll_s, tick)


def devicecost_tick(metrics_provider, csp):
    """Build the devicecost gauges and return the refresh callable
    (None when the gauges cannot be declared), for one deterministic
    tick."""
    try:
        mem_used = metrics_provider.new_gauge(
            metrics_mod.BCCSP_DEVICE_MEM_USED_BYTES_OPTS)
        mem_peak = metrics_provider.new_gauge(
            metrics_mod.BCCSP_DEVICE_MEM_PEAK_BYTES_OPTS)
        mem_limit = metrics_provider.new_gauge(
            metrics_mod.BCCSP_DEVICE_MEM_LIMIT_BYTES_OPTS)
        busy_g = metrics_provider.new_gauge(
            metrics_mod.BCCSP_DEVICE_BUSY_RATIO_OPTS)
    except Exception:
        logger.warning("devicecost gauges unavailable", exc_info=True)
        return None

    warned: set = set()

    def tick():
        try:
            rows = dc.device_memory()
        except Exception as e:      # noqa: BLE001
            rows = []
            if "mem" not in warned:
                warned.add("mem")
                logger.warning("device memory probe failed "
                               "(suppressing repeats): %s", e)
        for r in rows:
            try:
                lbl = ("device", str(r["device"]))
                mem_used.with_labels(*lbl).set(
                    float(r["bytes_in_use"]))
                mem_peak.with_labels(*lbl).set(
                    float(r["peak_bytes_in_use"]))
                mem_limit.with_labels(*lbl).set(
                    float(r["bytes_limit"]))
            except Exception as e:  # noqa: BLE001
                if "mem_gauge" not in warned:
                    warned.add("mem_gauge")
                    logger.warning("device memory gauge publish "
                                   "failed (suppressing repeats): "
                                   "%s", e)
        rec = getattr(csp, "device_cost", None)
        if rec is not None:
            try:
                for d, ratio in rec.busy.ratios().items():
                    busy_g.with_labels("device", str(d)).set(
                        float(ratio))
            except Exception as e:  # noqa: BLE001
                if "busy" not in warned:
                    warned.add("busy")
                    logger.warning("device busy-ratio publish failed "
                                   "(suppressing repeats): %s", e)

    return tick
