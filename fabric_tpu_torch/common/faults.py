"""Process-wide fault-injection registry: the port's copy of
fabric_tpu/common/faults.py, cut to the points the port checks.

Named fault points are hooks that do nothing in production (an unarmed
`check()` is one dict lookup) and that tests and chaos runs arm to
raise, stall, or fail N times. The port's points:

    tpu.device_lost    per mesh position, in the sharded span feeder and
                       the quarantine probe (bccsp/cuda.py `_shard_put`,
                       `_probe_device`): checked with arg=<full-mesh
                       position>, so chaos targets position k; an error
                       there quarantines THAT position, the batch raises
                       DeviceLostError and the provider serves the next
                       batch on the survivors (common/devicehealth.py)
    tpu.device_straggler
                       the same per-position seam, delay mode: the
                       targeted position's transfer stalls, feeding the
                       straggler accounting

The reference's other points (tpu.dispatch, tpu.compile, tpu.ed25519,
the orderer's and the network's) belong to its sw fallback and its host
layers, which the port does not have. `arm()` warns on a name outside
`KNOWN_POINTS`, so a typo'd FTPU_FAULTS entry is loud instead of inert.

Arming:
  - code:  `faults.arm("tpu.device_lost", mode="error", count=1, arg=1)`
  - env:   FTPU_FAULTS="tpu.device_lost=error:1::1;
                        tpu.device_straggler=delay::0.2"
           (one line), parsed at import and re-applied by `reset()`.

Spec grammar: `point=mode[:count][:delay_s][:arg]`, `mode` in {error,
delay}; an empty count is unlimited. A `delay` fault sleeps, then
proceeds (a stall); an `error` fault raises FaultInjected. The optional
4th field targets an ARGUMENT: the fault fires only when the call
site's `check(point, arg=...)` matches it (`tpu.device_lost=error:1::3`
fails position 3 once); a check without an arg never matches an
arg-targeted arming. Everything after the 3rd `:` is the arg verbatim.
The reference's `crash` mode (its crash-recovery matrix) is left out:
the port has no durable state to replay.

Counts are consumed per fire; `fires(point)` reports how often a point
fired. `arming(point)` reads an arming and `consume(point, arg=)` books a
fire without acting, as in the reference.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger("fabric_tpu_torch.common.faults")

ENV_VAR = "FTPU_FAULTS"


class FaultInjected(RuntimeError):
    """Raised by an armed `error` fault point."""


# every `faults.check("...")` call-site literal of the port
KNOWN_POINTS = frozenset({
    "tpu.device_lost",
    "tpu.device_straggler",
})


@dataclass
class _Arming:
    mode: str                      # "error" | "delay"
    count: Optional[int] = None    # remaining fires; None = unlimited
    delay_s: float = 0.0
    message: str = ""
    arg: Optional[str] = None      # fire only when check(arg=) matches

    def snapshot(self) -> dict:
        return {"mode": self.mode, "count": self.count,
                "delay_s": self.delay_s, "arg": self.arg,
                "message": self.message}


class FaultRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, _Arming] = {}
        self._fires: dict[str, int] = {}

    # -- arming --

    def arm(self, point: str, mode: str = "error",
            count: Optional[int] = None, delay_s: float = 0.0,
            message: str = "", arg=None) -> None:
        if mode not in ("error", "delay"):
            raise ValueError(f"unknown fault mode {mode!r}")
        if point not in KNOWN_POINTS:
            logger.warning(
                "arming UNKNOWN fault point %r: no check() site of the "
                "port declares it in KNOWN_POINTS; a typo'd %s entry "
                "injects nothing", point, ENV_VAR)
        with self._lock:
            self._armed[point] = _Arming(
                mode=mode, count=count, delay_s=delay_s, message=message,
                arg=None if arg is None else str(arg))
        logger.info("fault point %s armed: mode=%s count=%s delay=%.3fs "
                    "arg=%s", point, mode, count, delay_s, arg)

    def disarm(self, point: str) -> None:
        with self._lock:
            self._armed.pop(point, None)

    def clear(self) -> None:
        """Disarm everything, including env-armed faults."""
        with self._lock:
            self._armed.clear()
            self._fires.clear()

    def reset(self) -> None:
        """Back to the process baseline: clear, then re-apply the
        FTPU_FAULTS env arming."""
        self.clear()
        self.arm_from_env()

    def arm_from_env(self, spec: Optional[str] = None) -> None:
        spec = os.environ.get(ENV_VAR, "") if spec is None else spec
        if not spec:
            return
        for part in spec.replace(",", ";").split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                point, _, rhs = part.partition("=")
                fields = rhs.split(":")
                mode = fields[0] or "error"
                count = (int(fields[1])
                         if len(fields) > 1 and fields[1] else None)
                delay = (float(fields[2])
                         if len(fields) > 2 and fields[2] else 0.0)
                # everything past the 3rd ':' is the arg verbatim
                arg = (":".join(fields[3:])
                       if len(fields) > 3 and fields[3] else None)
                self.arm(point.strip(), mode=mode, count=count,
                         delay_s=delay, message=f"env:{ENV_VAR}", arg=arg)
            except (ValueError, IndexError):
                logger.warning("ignoring malformed %s entry %r", ENV_VAR,
                               part)

    # -- observation --

    def fires(self, point: str) -> int:
        with self._lock:
            return self._fires.get(point, 0)

    def armed(self, point: str) -> bool:
        with self._lock:
            return point in self._armed

    def arming(self, point: str) -> Optional[dict]:
        """Read-only snapshot of the arming at `point`, or None."""
        with self._lock:
            a = self._armed.get(point)
            return None if a is None else a.snapshot()

    def _take(self, point: str, arg) -> Optional[dict]:
        """Under the lock: book one fire of the arming that matches this
        check (its count and `fires`) and return its snapshot from before
        the fire; None when nothing armed matches."""
        a = self._armed.get(point)
        if a is None:
            return None
        if a.arg is not None and (arg is None or str(arg) != a.arg):
            return None
        snap = a.snapshot()
        if a.count is not None:
            a.count -= 1
            if a.count <= 0:
                del self._armed[point]
        self._fires[point] = self._fires.get(point, 0) + 1
        return snap

    def consume(self, point: str, arg=None) -> Optional[dict]:
        """Book one fire at `point` without acting and return the arming
        snapshot, or None when nothing armed matches."""
        with self._lock:
            return self._take(point, arg)

    # -- the hot-path hook --

    def check(self, point: str, arg=None) -> None:
        """Fire the fault armed at `point`, if any: near-free when
        nothing is armed. `arg` is the call site's targeting argument
        (the per-position points pass the full-mesh position)."""
        if not self._armed:
            return
        with self._lock:
            a = self._take(point, arg)
        if a is None:
            return
        mode, delay_s, msg = a["mode"], a["delay_s"], a["message"]
        if a["arg"] is not None:
            msg = f"{msg};arg={a['arg']}" if msg else f"arg={a['arg']}"
        # act outside the lock: a stall must not serialize other points
        if mode == "delay":
            time.sleep(delay_s)
            return
        raise FaultInjected(
            f"injected fault at {point}" + (f" ({msg})" if msg else ""))


_registry = FaultRegistry()

arm = _registry.arm
disarm = _registry.disarm
clear = _registry.clear
reset = _registry.reset
arm_from_env = _registry.arm_from_env
fires = _registry.fires
armed = _registry.armed
arming = _registry.arming
consume = _registry.consume
check = _registry.check

# chaos runs arm the whole process through the env before it starts
_registry.arm_from_env()
