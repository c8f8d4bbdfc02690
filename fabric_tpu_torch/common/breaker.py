"""Circuit breaker: the port's copy of fabric_tpu/common/breaker.py, cut
to what the per-device health ring uses (common/devicehealth.py).

The port builds no provider-wide breaker: the reference's serves the sw
path while it is open, and the port has no fallback. One breaker a mesh
position records that position's device-attributed failures, opens
(quarantine) after `trip_threshold` of them, and half-opens after
`cooldown_s` for one re-admission probe.

States (the strings the reference surfaces, and the codes of the
`bccsp_device_state` gauge):

    device    (closed)    the position serves
    degraded  (open)      entered after `trip_threshold` consecutive
                          failures; refused until the cooldown elapses
    probing   (half-open) cooldown elapsed: ONE probe is admitted;
                          success closes, failure re-opens for another
                          cooldown

Left out, against the reference, with its provider-wide breaker:
`guard`/`run` (the watchdog around a dispatch), `DeadlineExceeded`, and
the config's `deadline_ms`, `probe_batch` and `ignore` (the health ring
sets none of them: its stale-probe window is the reference's at
`deadline_ms` 0, and it counts every failure it is given).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass

from fabric_tpu_torch.common import tracing

logger = logging.getLogger("fabric_tpu_torch.common.breaker")

DEVICE, DEGRADED, PROBING = "device", "degraded", "probing"

_STATE_CODES = {DEVICE: 0, PROBING: 1, DEGRADED: 2}


class CircuitOpen(RuntimeError):
    """Admission refused: the breaker is open, or its probe slot is
    taken."""


@dataclass
class BreakerConfig:
    trip_threshold: int = 5       # consecutive failures before opening
    cooldown_s: float = 30.0      # open -> probing after this long


class CircuitBreaker:
    def __init__(self, config: BreakerConfig | None = None,
                 name: str = "tpu", clock=time.monotonic):
        self.config = config or BreakerConfig()
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = DEVICE
        self._failures = 0           # consecutive
        self._open_until = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self._guards_inflight = 0    # executions marked live now
        self.stats = {"trips": 0, "probes": 0, "deadline_timeouts": 0,
                      "failures": 0, "rejected": 0, "stale_probes": 0}

    # -- state --

    @property
    def state(self) -> str:
        """Current state; resolves cooldown expiry (degraded ->
        probing) at observation time."""
        with self._lock:
            return self._state_locked()

    def _probe_timeout_s(self) -> float:
        return max(self.config.cooldown_s, 1.0)

    def _state_locked(self) -> str:
        now = self._clock()
        if self._state == DEGRADED and now >= self._open_until:
            self._state = PROBING
            self._probe_inflight = False
            logger.info("%s breaker cooldown elapsed; probing", self.name)
        elif self._state == PROBING and self._probe_inflight and \
                self._guards_inflight == 0 and \
                now - self._probe_started >= self._probe_timeout_s():
            # the probe's outcome was never reported: reclaim the slot as
            # a failed probe, or the breaker wedges in `probing`. A probe
            # still executing (marked by execution()) keeps the slot.
            self.stats["stale_probes"] += 1
            self._state = DEGRADED
            self._open_until = now + self.config.cooldown_s
            self._probe_inflight = False
            logger.warning(
                "%s breaker: probe outcome never reported after %.1fs; "
                "re-opening for %.1fs", self.name,
                self._probe_timeout_s(), self.config.cooldown_s)
        return self._state

    @property
    def state_code(self) -> int:
        return _STATE_CODES[self.state]

    # -- accounting --

    def admit(self) -> bool:
        """Raise CircuitOpen unless the device may be tried now. Returns
        True when this call took the single half-open probe slot
        (released by the following success()/failure()), False in the
        closed state."""
        with self._lock:
            st = self._state_locked()
            if st == DEVICE:
                return False
            if st == PROBING and not self._probe_inflight:
                self._probe_inflight = True
                self._probe_started = self._clock()
                self.stats["probes"] += 1
                return True
            self.stats["rejected"] += 1
        raise CircuitOpen(f"{self.name} breaker {st}")

    def success(self) -> None:
        with self._lock:
            st = self._state_locked()
            if st == DEGRADED:
                # a stale success must not force-close an open breaker:
                # re-entry goes through the cooldown and a probe
                return
            if st != DEVICE:
                logger.info("%s breaker: probe succeeded; re-admitted",
                            self.name)
            self._state = DEVICE
            self._failures = 0
            self._probe_inflight = False

    def failure(self, exc: BaseException | None = None) -> None:
        tripped = 0
        with self._lock:
            self.stats["failures"] += 1
            st = self._state_locked()
            self._failures += 1
            if st == PROBING or \
                    self._failures >= self.config.trip_threshold:
                if st != DEGRADED:
                    self.stats["trips"] += 1
                    tripped = self._failures
                    logger.warning(
                        "%s breaker OPEN after %d consecutive failure(s) "
                        "(%s) for %.1fs", self.name, self._failures,
                        type(exc).__name__ if exc else "failure",
                        self.config.cooldown_s)
                self._state = DEGRADED
                self._open_until = self._clock() + self.config.cooldown_s
                self._probe_inflight = False
        if tripped:
            # a flight-recorder landmark, outside the lock
            tracing.note_breaker_trip(self.name, failures=tripped)

    @contextlib.contextmanager
    def execution(self):
        """Mark an execution (a probe) live without recording an outcome,
        so the stale-probe reclaim does not preempt it."""
        with self._lock:
            self._guards_inflight += 1
        try:
            yield
        finally:
            with self._lock:
                self._guards_inflight -= 1
