"""Per-position health for the sharded verify mesh (fail in place): the
port's copy of fabric_tpu/common/devicehealth.py.

A ring of per-position `CircuitBreaker`s (common/breaker.py: the same
trip, cooldown and probe discipline), fed by three signals the sharded
dispatch produces (bccsp/cuda.py):

  * device-attributed dispatch failures (`DeviceLostError` from the span
    feeder, or a runtime error whose message names a device);
  * per-position transfer timings from `CUDAProvider._shard_put`;
  * per-position ready-lag skew from `_record_shard_stats`.

A position whose breaker opens is QUARANTINED: `healthy()` drops it and
the provider rebuilds a smaller mesh over the survivors
(`_rebuild_mesh`). After `cooldown_s` the breaker half-opens and
`probe_candidates()` offers the position for ONE probe; success
re-admits it and the mesh grows back. Unlike the reference's provider,
the port's serves no sw path meanwhile: the batch that met the failure
raises, and a dispatch with every position quarantined raises
`MeshUnavailableError`.

States per position (the `bccsp_device_state` gauge):
    0 healthy      in the serving mesh
    1 probing      cooldown elapsed, awaiting its probe's outcome
    2 quarantined  out of the mesh, cooling down
"""

from __future__ import annotations

import logging
import re
import threading
import time
from dataclasses import dataclass
from typing import Optional

from fabric_tpu_torch.common import tracing
from fabric_tpu_torch.common.breaker import (
    BreakerConfig,
    CircuitBreaker,
    CircuitOpen,
    DEGRADED,
    DEVICE,
)

logger = logging.getLogger("fabric_tpu_torch.common.devicehealth")


class DeviceLostError(RuntimeError):
    """A dispatch failure attributed to ONE mesh position (the sharded
    span feeder's transfer failed, or an armed `tpu.device_lost` fault
    fired): the position is quarantined and the batch raises this."""

    def __init__(self, device: int, cause: BaseException):
        super().__init__(f"device {device} lost: "
                         f"{type(cause).__name__}: {cause}")
        self.device = device
        self.cause = cause


class DeviceStragglerError(RuntimeError):
    """Synthetic failure fed to a position's breaker when its straggler
    strikes exceed the budget."""


class MeshUnavailableError(RuntimeError):
    """Every position of the mesh is quarantined: the dispatch raises at
    once (the reference serves sw here; the port has no fallback)."""

    def __init__(self, quarantined: list):
        super().__init__(
            f"every mesh position is quarantined: {quarantined}")
        self.quarantined = list(quarantined)


# runtime errors that name a device: the reference's XLA/PJRT patterns
# ("device 3", "TPU_3", "TPU:3", "device=3", "chip 3") and torch's and
# CUDA's ("cuda:1", "CUDA device 1", "on device 1")
_DEVICE_RE = re.compile(
    r"(?:\bdevice[\s=:#]+|\bTPU[_:]|\bchip[\s=:#]+|\bcuda:)(\d+)",
    re.IGNORECASE)


def device_from_error(message: str, n_devices: int) -> Optional[int]:
    """Best-effort attribution of a runtime error string: the first
    in-range device index the message names, else None."""
    for m in _DEVICE_RE.finditer(message or ""):
        d = int(m.group(1))
        if 0 <= d < n_devices:
            return d
    return None


@dataclass
class DeviceHealthConfig:
    """`BCCSP.CUDA.DeviceHealth` (bccsp/factory.py), the reference's
    `BCCSP.TPU.DeviceHealth` keys and defaults."""
    # device-attributed faults before quarantine
    trip_threshold: int = 1
    cooldown_s: float = 30.0
    # a position whose transfer time (or ready-lag jump) exceeds the
    # mesh median by this many seconds earns a straggler strike; <= 0
    # disables straggler quarantine
    straggler_skew_s: float = 2.0
    # consecutive struck batches before quarantine
    straggler_strikes: int = 3
    # wall bound on one re-admission probe
    probe_timeout_s: float = 5.0


class DeviceHealth:
    """Per-position fault and straggler accounting, and the quarantine
    ring. Indices are FULL-mesh positions, stable across rebuilds.
    Thread-safe: dispatches, the admission hook and the stats poller all
    read it."""

    def __init__(self, n_devices: int,
                 config: Optional[DeviceHealthConfig] = None,
                 clock=time.monotonic, name: str = "bccsp.device"):
        self.config = config or DeviceHealthConfig()
        self.n_devices = n_devices
        self._lock = threading.Lock()
        self._breakers = [
            CircuitBreaker(
                BreakerConfig(
                    trip_threshold=max(1, self.config.trip_threshold),
                    cooldown_s=self.config.cooldown_s),
                name=f"{name}{d}", clock=clock)
            for d in range(n_devices)
        ]
        self._strikes = [0] * n_devices
        self._quarantines = [0] * n_devices
        self._readmits = [0] * n_devices
        self._straggler_strikes_total = 0

    def set_clock(self, clock) -> None:
        """Test seam: drive every breaker's cooldown from an injectable
        monotonic clock."""
        for br in self._breakers:
            br._clock = clock

    # -- state --

    def state(self, d: int) -> str:
        return self._breakers[d].state

    def state_codes(self) -> list[int]:
        return [br.state_code for br in self._breakers]

    def healthy(self) -> list[int]:
        """Positions fit to serve (breaker closed); probing ones stay out
        until their probe succeeds."""
        return [d for d, br in enumerate(self._breakers)
                if br.state == DEVICE]

    def quarantined(self) -> list[int]:
        return [d for d, br in enumerate(self._breakers)
                if br.state != DEVICE]

    # -- fault accounting --

    def record_fault(self, d: int, exc: BaseException | None = None
                     ) -> bool:
        """Count one attributed failure against position `d`; True when
        it newly quarantined it. A benched position is left alone (a
        failure on an open breaker would re-arm its cooldown), and the
        whole check-fail-count sequence runs under the ring lock, so
        concurrent attributions count one quarantine."""
        br = self._breakers[d]
        with self._lock:
            if br.state != DEVICE:
                return False
            br.failure(exc)
            newly = br.state != DEVICE
            if newly:
                self._quarantines[d] += 1
                self._strikes[d] = 0
        if newly:
            logger.warning(
                "device %d QUARANTINED after %s (cooldown %.1fs; the mesh "
                "rebuilds over the survivors)", d,
                type(exc).__name__ if exc else "failure",
                self.config.cooldown_s)
            tracing.note_quarantine(d)
        return newly

    def attribute(self, exc: BaseException) -> Optional[int]:
        """Map a dispatch exception to a position and record the fault: a
        `DeviceLostError` carries its position; any other error is
        matched against the device-naming patterns. Returns the struck
        position, or None when unattributable."""
        if isinstance(exc, DeviceLostError):
            d = exc.device
        else:
            d = device_from_error(str(exc), self.n_devices)
        if d is None:
            return None
        self.record_fault(d, exc)
        return d

    # -- straggler accounting --

    def observe_shard(self, full_idx: list[int],
                      transfer_s: list[float],
                      ready_s: list[float]) -> list[int]:
        """Feed one sharded batch's per-position readings (in sampling
        order, mapping to `full_idx`). A position whose transfer time
        exceeds the mesh's lower median, or whose ready-lag jump over its
        predecessor exceeds it, by `straggler_skew_s` earns a strike; a
        clean batch clears its strikes. `straggler_strikes` strikes
        quarantine it. Returns every newly quarantined position."""
        skew = self.config.straggler_skew_s
        if skew <= 0 or len(full_idx) < 2:
            return []
        struck: set[int] = set()
        if transfer_s and len(transfer_s) == len(full_idx):
            # the LOWER median: with half the positions slow, the upper
            # median is the slow value and nothing would read as over
            med = sorted(transfer_s)[(len(transfer_s) - 1) // 2]
            for pos, t in enumerate(transfer_s):
                if t - med > skew:
                    struck.add(pos)
        if ready_s and len(ready_s) == len(full_idx):
            for pos in range(1, len(ready_s)):
                if ready_s[pos] - ready_s[pos - 1] > skew:
                    struck.add(pos)
        over: list[tuple[int, int]] = []
        with self._lock:
            for pos in range(len(full_idx)):
                d = full_idx[pos]
                if pos not in struck:
                    self._strikes[d] = 0
                    continue
                self._strikes[d] += 1
                self._straggler_strikes_total += 1
                logger.warning(
                    "device %d straggler strike %d/%d (skew budget "
                    "%.3fs)", d, self._strikes[d],
                    self.config.straggler_strikes, skew)
                if self._strikes[d] >= self.config.straggler_strikes:
                    over.append((d, self._strikes[d]))
        quarantined: list[int] = []
        for d, trip in over:
            exc = DeviceStragglerError(
                f"device {d} struck {trip} consecutive batches")
            # open the position's breaker through its own discipline, so
            # cooldown and probe re-entry are the fault path's
            br = self._breakers[d]
            for _ in range(max(1, self.config.trip_threshold)):
                if br.state != DEVICE:
                    break
                self.record_fault(d, exc)
            if br.state != DEVICE:
                quarantined.append(d)
        return quarantined

    # -- probe / re-admission --

    def probe_candidates(self) -> list[int]:
        """Quarantined positions whose cooldown elapsed AND whose probe
        slot this caller just took; the caller MUST report each one
        through probe_result()."""
        out = []
        for d, br in enumerate(self._breakers):
            if br.state == DEVICE:
                continue
            try:
                if br.admit():
                    out.append(d)
            except CircuitOpen:
                continue
        return out

    def probe_execution(self, d: int):
        """Mark position `d`'s probe live while it executes, so the
        breaker's stale-probe reclaim does not preempt a slow probe."""
        return self._breakers[d].execution()

    def probe_result(self, d: int, ok: bool,
                     exc: BaseException | None = None) -> None:
        """Report a probe outcome. A success counts as a re-admission
        only if the breaker actually closed (it stays open when the
        stale-probe reclaim already re-opened it)."""
        br = self._breakers[d]
        readmitted = False
        with self._lock:
            if ok:
                br.success()
                readmitted = br.state == DEVICE
                if readmitted:
                    self._readmits[d] += 1
                    self._strikes[d] = 0
            else:
                br.failure(exc or DeviceLostError(
                    d, RuntimeError("probe failed")))
        if readmitted:
            logger.info("device %d probe succeeded; re-admitted to the "
                        "mesh", d)
            tracing.note_readmit(d)
        elif ok:
            logger.warning(
                "device %d probe answered after its slot was reclaimed; "
                "staying quarantined until the next probe", d)

    # -- observability (bccsp_device_* gauges) --

    def snapshot(self) -> dict:
        """Per-position gauge rows, one slot per FULL-mesh position."""
        with self._lock:
            return {
                "state": self.state_codes(),
                "trips": [br.stats["trips"] for br in self._breakers],
                "quarantines": list(self._quarantines),
                "readmits": list(self._readmits),
            }

    def totals(self) -> dict:
        with self._lock:
            return {
                "device_quarantines": sum(self._quarantines),
                "device_readmits": sum(self._readmits),
                "device_straggler_strikes": self._straggler_strikes_total,
            }

    def any_unhealthy(self) -> bool:
        return any(br.state != DEVICE for br in self._breakers)

    def force_state(self, d: int, state: str) -> None:
        """Test seam: pin a position's breaker state directly."""
        br = self._breakers[d]
        with br._lock:
            br._state = state
            if state == DEGRADED:
                br._open_until = br._clock() + self.config.cooldown_s
