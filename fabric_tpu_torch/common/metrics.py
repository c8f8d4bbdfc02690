"""Metrics provider API: Counter / Gauge / Histogram with label currying.

The port's copy of fabric_tpu/common/metrics.py, cut to what the port
publishes: the instruments, `PrometheusProvider` (an in-process registry
rendered as Prometheus text exposition) and `DisabledProvider` (no-ops),
and the opts of the gauges the provider's telemetry feeds
(common/profiling.py) plus the `trace_stage_seconds` histogram the
tracing layer binds (common/tracing.py). Every fqname, field and help
text is the reference's word for word, so one dashboard reads both
packages; in the port a "compile" is the build or load of a kernel
library (common/devicecost.py). The statsd backend is not ported.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

@dataclass(frozen=True)
class CounterOpts:
    namespace: str = ""
    subsystem: str = ""
    name: str = ""
    help: str = ""
    label_names: tuple[str, ...] = ()


@dataclass(frozen=True)
class GaugeOpts:
    namespace: str = ""
    subsystem: str = ""
    name: str = ""
    help: str = ""
    label_names: tuple[str, ...] = ()


@dataclass(frozen=True)
class HistogramOpts:
    namespace: str = ""
    subsystem: str = ""
    name: str = ""
    help: str = ""
    label_names: tuple[str, ...] = ()
    buckets: tuple[float, ...] = (
        0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
    )


def _fqname(opts) -> str:
    return "_".join(p for p in (opts.namespace, opts.subsystem, opts.name) if p)


def _label_key(
    names: tuple[str, ...], label_values: tuple[str, ...]
) -> tuple[tuple[str, str], ...]:
    if len(label_values) % 2 != 0:
        raise ValueError("odd number of label values")
    given = dict(zip(label_values[::2], label_values[1::2]))
    return tuple((n, given.get(n, "")) for n in names)


# -- the gauges and the histogram the port publishes --

BCCSP_FUSED_BATCHES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="fused", name="batches",
    help="Verify batches served end to end by the round-20 fused "
         "Pallas tier (device SHA-256 + scalar recovery + comb in one "
         "program — the host never hashes message lanes).")

BCCSP_FUSED_LANES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="fused", name="lanes",
    help="Message lanes whose SHA-256 ran on device inside the fused "
         "verify program since process start (digest-bearing lanes "
         "skip the hash stage and are not counted).")

BCCSP_PAIRING_PAIRS_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="pairing", name="pairs",
    help="Miller pairs served by the device pairing engines since "
         "process start — BLS12-381 aggregate-verify batches "
         "(round-21 wide-limb kernel, one shared final exponentiation "
         "per call) plus BN254 idemix pairing products.")

BCCSP_PAIRING_BATCHES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="pairing", name="batches",
    help="Batched pairing programs dispatched to device (one per "
         "verify_aggregate call or idemix pairing_check_batch that "
         "cleared the small-batch gate).")

BCCSP_DEVICE_STATE_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="state",
    help="Per-chip health state in the elastic verify mesh: 0 healthy "
         "(serving), 1 probing (cooldown elapsed, awaiting its "
         "re-admission probe), 2 quarantined (out of the mesh; the "
         "provider serves on the survivors). Device label = full-mesh "
         "index.", label_names=("device",))

BCCSP_DEVICE_TRIPS_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="trips",
    help="Per-chip breaker trips: device-attributed dispatch/transfer "
         "failures or straggler-strike budgets that opened this "
         "chip's quarantine breaker since process start.",
    label_names=("device",))

BCCSP_DEVICE_QUARANTINES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="quarantines",
    help="Times this chip entered quarantine (benched out of the "
         "serving mesh) since process start — each one triggered a "
         "degraded-mesh rebuild over the surviving chips.",
    label_names=("device",))

BCCSP_DEVICE_READMITS_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="readmits",
    help="Times this chip passed its re-admission probe and rejoined "
         "the serving mesh (the mesh grew back) since process start.",
    label_names=("device",))

BCCSP_DEVICE_QUARANTINES_TOTAL_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="quarantines_total",
    help="Chip quarantines across the whole mesh since process start "
         "— the scalar aggregate of the device-labeled "
         "bccsp_device_quarantines series, under its own canonical "
         "name so the generic provider-stats poller can publish it "
         "without colliding with the labeled gauge's fqname.")

BCCSP_DEVICE_READMITS_TOTAL_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="readmits_total",
    help="Probe re-admissions across the whole mesh since process "
         "start — the scalar aggregate of the device-labeled "
         "bccsp_device_readmits series (see "
         "bccsp_device_quarantines_total for why the name differs "
         "from the stats key).")

BCCSP_SHARD_DEVICES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="shard", name="devices",
    help="Device-mesh size the TPU verify provider shards the batch "
         "axis over (BCCSP.TPU.Devices; 1 = single-device pipeline, "
         "no mesh).")

BCCSP_SHARD_DISPATCHES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="shard", name="dispatches",
    help="Sharded span/chunk dispatches issued to the device mesh "
         "since process start (each runs one per-shard comb program "
         "on every chip).")

BCCSP_SHARD_TRANSFER_SECONDS_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="shard", name="transfer_s",
    help="Per-device host-to-device transfer-enqueue seconds for the "
         "most recent sharded verify batch: the round-robin span "
         "feeder runs one explicit stream per chip, so a chip with a "
         "slow link stands out instead of smearing into one number.",
    label_names=("device",))

BCCSP_SHARD_READY_SECONDS_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="shard", name="ready_s",
    help="Per-device seconds from the batch's first span dispatch "
         "until that device's slice of the final span's accept bitmap "
         "was ready. Sampled in a per-batch rotating order (each "
         "reading is an upper bound given earlier-sampled devices); "
         "a straggler chip shows as a step at its sampling position — "
         "the rotation guarantees a chip is not permanently sampled "
         "first, where its slowness would inflate every reading "
         "equally and hide.", label_names=("device",))

BCCSP_SHARD_LANES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="shard", name="lanes",
    help="Signature lanes the most recent sharded span placed on each "
         "device (the batch axis is dealt contiguously across the "
         "mesh).", label_names=("device",))

BCCSP_SHARD_SKEW_SECONDS_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="shard", name="skew_s",
    help="Ready-time spread (max - min) across mesh devices for the "
         "most recent sharded batch: persistent skew means one chip "
         "paces the whole mesh.")

BCCSP_COMPILE_TOTAL_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="compile", name="total",
    help="XLA programs built through the provider's compile seam "
         "(common/devicecost.py) since process start: each first "
         "dispatch of a new argument shape and each AOT prewarm "
         "compile, whether a cold compile or a persistent-cache "
         "load.")

BCCSP_COMPILE_CACHE_HITS_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="compile", name="cache_hits",
    help="Persistent-compile-cache hits among bccsp_compile_total "
         "(classified by cache-dir entry delta plus a wall-time "
         "threshold). total - cache_hits = cold compiles — the "
         "minutes-long restart cliff; a cold compile in steady state "
         "auto-dumps the flight recorder.")

BCCSP_COMPILE_SECONDS_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="compile", name="seconds",
    help="Cumulative wall seconds spent inside the compile seam "
         "(tracing + XLA compilation or cache load) since process "
         "start — the device-side cost the bench's compile_s stage "
         "field and the perf ledger track across rounds.")

BCCSP_DEVICE_MEM_USED_BYTES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="mem_used_bytes",
    help="Per-device bytes currently allocated (memory_stats "
         "bytes_in_use), polled by publish_devicecost_stats. Devices "
         "without the API (CPU meshes) publish nothing.",
    label_names=("device",))

BCCSP_DEVICE_MEM_PEAK_BYTES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="mem_peak_bytes",
    help="Per-device peak bytes allocated since process start "
         "(memory_stats peak_bytes_in_use) — the high-water mark an "
         "oversized span leaves behind.",
    label_names=("device",))

BCCSP_DEVICE_MEM_LIMIT_BYTES_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="mem_limit_bytes",
    help="Per-device memory capacity (memory_stats bytes_limit); "
         "used - limit headroom under FTPU_HBM_HEADROOM_FRAC also "
         "surfaces as the /healthz components.bccsp hbm_low "
         "sub-state.",
    label_names=("device",))

BCCSP_DEVICE_BUSY_RATIO_OPTS = GaugeOpts(
    namespace="bccsp", subsystem="device", name="busy_ratio",
    help="Per-device device-time over wall-time in the last poll "
         "window, fed from the same per-chip ready readings as the "
         "device.ready.d<k> tracing stages — sustained low ratios "
         "on a big mesh mean the feeder (host prep/transfer), not "
         "the chips, is the bottleneck.",
    label_names=("device",))

TRACE_STAGE_SECONDS_OPTS = HistogramOpts(
    namespace="trace", subsystem="stage", name="seconds",
    help="Per-stage latency distributions from the lifecycle-tracing "
         "spans (common/tracing.py): ingress batches, admission-"
         "window convoy waits, order window/propose/consensus/write, "
         "commit-pipeline validate/commit, device dispatch and "
         "per-device transfer/ready — p50/p99-derivable tails beside "
         "the last-batch snapshot gauges. The stage label is the "
         "span name.",
    label_names=("stage",),
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10))


class Counter:
    def __init__(self, opts: CounterOpts):
        self.opts = opts
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        self._labels: tuple[str, ...] = ()

    def with_labels(self, *label_values: str) -> "Counter":
        child = Counter.__new__(Counter)
        child.opts = self.opts
        child._lock = self._lock
        child._values = self._values
        child._labels = self._labels + label_values
        return child

    def add(self, delta: float = 1.0) -> None:
        key = _label_key(self.opts.label_names, self._labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta


class Gauge:
    def __init__(self, opts: GaugeOpts):
        self.opts = opts
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        self._labels: tuple[str, ...] = ()

    def with_labels(self, *label_values: str) -> "Gauge":
        child = Gauge.__new__(Gauge)
        child.opts = self.opts
        child._lock = self._lock
        child._values = self._values
        child._labels = self._labels + label_values
        return child

    def set(self, value: float) -> None:
        key = _label_key(self.opts.label_names, self._labels)
        with self._lock:
            self._values[key] = value

    def add(self, delta: float) -> None:
        key = _label_key(self.opts.label_names, self._labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta


@dataclass
class _HistState:
    counts: list[int]
    total: int = 0
    sum: float = 0.0


class Histogram:
    def __init__(self, opts: HistogramOpts):
        self.opts = opts
        self._lock = threading.Lock()
        self._states: dict[tuple, _HistState] = {}
        self._labels: tuple[str, ...] = ()

    def with_labels(self, *label_values: str) -> "Histogram":
        child = Histogram.__new__(Histogram)
        child.opts = self.opts
        child._lock = self._lock
        child._states = self._states
        child._labels = self._labels + label_values
        return child

    def observe(self, value: float) -> None:
        key = _label_key(self.opts.label_names, self._labels)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = _HistState(counts=[0] * len(self.opts.buckets))
                self._states[key] = st
            for i, ub in enumerate(self.opts.buckets):
                if value <= ub:
                    st.counts[i] += 1
            st.total += 1
            st.sum += value


class Provider:
    """Abstract provider; see PrometheusProvider / DisabledProvider."""

    def new_counter(self, opts: CounterOpts) -> Counter:
        raise NotImplementedError

    def new_gauge(self, opts: GaugeOpts) -> Gauge:
        raise NotImplementedError

    def new_histogram(self, opts: HistogramOpts) -> Histogram:
        raise NotImplementedError


class PrometheusProvider(Provider):
    """Registry-backed provider rendering Prometheus text exposition."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _register(self, name: str, inst):
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                if type(existing) is not type(inst) or existing.opts != inst.opts:
                    raise ValueError(
                        f"metric {name} re-registered with different type or opts"
                    )
                return existing
            self._instruments[name] = inst
            return inst

    def new_counter(self, opts: CounterOpts) -> Counter:
        return self._register(_fqname(opts), Counter(opts))

    def new_gauge(self, opts: GaugeOpts) -> Gauge:
        return self._register(_fqname(opts), Gauge(opts))

    def new_histogram(self, opts: HistogramOpts) -> Histogram:
        return self._register(_fqname(opts), Histogram(opts))

    def render(self) -> str:
        """Prometheus text exposition format (for the /metrics endpoint)."""
        out: list[str] = []
        with self._lock:
            instruments = dict(self._instruments)
        for name, inst in sorted(instruments.items()):
            if isinstance(inst, Counter):
                out.append(f"# HELP {name} {inst.opts.help}")
                out.append(f"# TYPE {name} counter")
                with inst._lock:
                    values = dict(inst._values)
                for key, v in sorted(values.items()):
                    out.append(f"{name}{_render_labels(key)} {_fmt(v)}")
            elif isinstance(inst, Gauge):
                out.append(f"# HELP {name} {inst.opts.help}")
                out.append(f"# TYPE {name} gauge")
                with inst._lock:
                    values = dict(inst._values)
                for key, v in sorted(values.items()):
                    out.append(f"{name}{_render_labels(key)} {_fmt(v)}")
            elif isinstance(inst, Histogram):
                out.append(f"# HELP {name} {inst.opts.help}")
                out.append(f"# TYPE {name} histogram")
                with inst._lock:
                    states = {
                        k: _HistState(list(s.counts), s.total, s.sum)
                        for k, s in inst._states.items()
                    }
                for key, st in sorted(states.items()):
                    for ub, c in zip(inst.opts.buckets, st.counts):
                        lk = key + (("le", _fmt(ub)),)
                        out.append(f"{name}_bucket{_render_labels(lk)} {c}")
                    lk = key + (("le", "+Inf"),)
                    out.append(f"{name}_bucket{_render_labels(lk)} {st.total}")
                    out.append(f"{name}_sum{_render_labels(key)} {_fmt(st.sum)}")
                    out.append(f"{name}_count{_render_labels(key)} {st.total}")
        return "\n".join(out) + "\n"


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _NoopInstrument:
    """True no-op: no locks, no state (reference common/metrics/disabled)."""

    def with_labels(self, *label_values: str) -> "_NoopInstrument":
        return self

    def add(self, delta: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


class DisabledProvider(Provider):
    def __init__(self) -> None:
        self._noop = _NoopInstrument()

    def new_counter(self, opts: CounterOpts) -> Counter:
        return self._noop  # type: ignore[return-value]

    def new_gauge(self, opts: GaugeOpts) -> Gauge:
        return self._noop  # type: ignore[return-value]

    def new_histogram(self, opts: HistogramOpts) -> Histogram:
        return self._noop  # type: ignore[return-value]
