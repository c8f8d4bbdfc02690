"""Device-cost observability: kernel-library build telemetry, the
card's memory rows and its busy ratio. The port's copy of
fabric_tpu/common/devicecost.py.

  * ``CompileRecorder`` — one per provider, fed by the build seam
    (``build_seam``): the first load of each kernel library through a
    provider (``kernels.load``, ``native.load``) is timed, classified
    cold or hit, and recorded inside a ``tpu.compile`` span. The
    reference's persistent compile cache is the port's build directory
    (``torchenv.BUILD_DIR``), where libraries are named by the sha256 of
    their sources: a build that runs nvcc or g++ writes a new library
    there (a cold build, read as the reference reads its cache dir: an
    entry delta, here the one library's file appearing, backed by a
    wall-time threshold), a load that reuses one writes nothing (a hit).
    ``kernels.build_all`` (a node's prewarm, chip_smoke.py's build)
    passes every library through the same seam. A cold build emits a
    ``compile.cold`` instant and, once the provider is steady (after its
    first successful dispatch), auto-dumps the flight recorder. The
    reference books per provider and per argument shape; the port's
    kernels take any shape, so it books per provider and per library.
    There is no ``InstrumentedJit`` (the port has no jit) and no XLA cost
    analysis: an event's ``cost`` is always None.
  * ``device_memory()`` — one row per CUDA device from the caching
    allocator, polled by ``profiling.publish_devicecost_stats`` into the
    ``bccsp_device_mem_{used,peak,limit}_bytes`` gauges and read by the
    provider's ``health()`` (the ``hbm_low`` sub-state).
  * ``DeviceBusy`` — cumulative device time per card, fed by the
    provider from CUDA events around each dispatch; ``ratios()`` turns
    the window's accumulation into ``bccsp_device_busy_ratio``. The
    events open before a dispatch's first host-to-device copy and close
    after its last launch, so the ratio is the share of wall time the
    card spent in dispatches' device stages (the reference's whole-batch
    device stage), copies and the host-paced gaps between launches
    included: an upper bound on kernel occupancy, not a reading of it.

Knobs, as in the reference: ``FTPU_DEVICECOST_COLD_S`` and
``FTPU_HBM_HEADROOM_FRAC``.
"""

from __future__ import annotations

import contextvars
import functools
import logging
import os
import threading
import time
from typing import Callable, Optional

from fabric_tpu_torch.common import tracing

logger = logging.getLogger("fabric_tpu_torch.common.devicecost")

# a first load slower than this is a build even when the build-dir probe
# is unavailable (threshold rule); reusing a built library is a dlopen,
# far under a second
COLD_COMPILE_THRESHOLD_S = float(
    os.environ.get("FTPU_DEVICECOST_COLD_S", "5.0"))

# minimum free fraction of any device's memory limit before the
# provider's health() grows the hbm_low sub-state — the "an oversized
# batch is about to OOM" warning light
HBM_HEADROOM_FRAC = float(
    os.environ.get("FTPU_HBM_HEADROOM_FRAC", "0.10"))

_EVENT_CAP = 256        # bounded per-build event history


class DeviceBusy:
    """Cumulative per-device busy seconds -> windowed busy ratios.

    ``note(device, seconds)`` accumulates device-time (the per-chip
    ready lag of a sharded dispatch, or the whole-batch device stage
    on a single-chip provider); ``ratios()`` returns each device's
    busy-time share of the wall window since the previous ``ratios()``
    call, clamped to [0, 1] — the poller's cadence IS the window."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._busy: dict = {}       # device -> cumulative seconds
        self._last: dict = {}       # snapshot at the last ratios()
        self._last_t = clock()

    def note(self, device: int, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self._busy[device] = self._busy.get(device, 0.0) + \
                float(seconds)

    def totals(self) -> dict:
        with self._lock:
            return dict(self._busy)

    def ratios(self) -> dict:
        """{device: busy_fraction} over the window since the last
        call. A device with no dispatches in the window reads 0.0 —
        idle, not absent."""
        with self._lock:
            now = self._clock()
            wall = now - self._last_t
            out: dict = {}
            if wall > 0:
                for d, total in self._busy.items():
                    delta = total - self._last.get(d, 0.0)
                    out[d] = round(min(1.0, max(0.0, delta / wall)), 4)
            self._last = dict(self._busy)
            self._last_t = now
            return out


class CompileRecorder:
    """The build-seam bookkeeper (one per provider).

    Mirrors its counters into the provider's ``stats`` dict so they
    publish through the stats poller as the reference's
    ``bccsp_compile_*`` gauges:

      compile_total       libraries loaded through the seam
      compile_cache_hits  loads that reused a built library
      compile_cold_total  cold builds (the expensive complement)
      compile_failures    builds or loads that raised
      compile_seconds     cumulative wall seconds inside the seam

    ``cache_dir`` may be a path, a zero-arg callable resolving one, or
    None (threshold-only classification).
    """

    def __init__(self, stats: Optional[dict] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 cache_dir=None,
                 cold_threshold_s: Optional[float] = None):
        self.stats = stats if stats is not None else {}
        self.stats.setdefault("compile_total", 0)
        self.stats.setdefault("compile_cache_hits", 0)
        self.stats.setdefault("compile_cold_total", 0)
        self.stats.setdefault("compile_failures", 0)
        self.stats.setdefault("compile_seconds", 0.0)
        self._clock = clock
        self._cache_dir = cache_dir
        self.cold_threshold_s = (COLD_COMPILE_THRESHOLD_S
                                 if cold_threshold_s is None
                                 else float(cold_threshold_s))
        self.events: list = []      # bounded per-build records
        self._lock = threading.Lock()
        self._steady = False
        self.busy = DeviceBusy()
        self._seen: set = set()     # libraries booked by this recorder
        self._seen_lock = threading.Lock()

    # -- steady-state marker (set after the first successful
    #    dispatch: later cold builds are serving-path cliffs) --

    @property
    def steady(self) -> bool:
        return self._steady

    def mark_steady(self) -> None:
        self._steady = True

    # -- build-dir probe --

    def _cache_dir_path(self) -> Optional[str]:
        d = self._cache_dir
        if callable(d):
            try:
                d = d()
            except Exception:       # noqa: BLE001
                return None
        return d if isinstance(d, str) and d else None

    def cache_entries(self) -> int:
        """Entry count of the build directory, or -1 when there is none
        to probe. A cold build WRITES a library; a hit only reads — the
        before/after delta is the hit-vs-cold signal the wall-time
        threshold backstops."""
        d = self._cache_dir_path()
        if not d:
            return -1
        try:
            with os.scandir(d) as it:
                return sum(1 for e in it if e.is_file())
        except OSError:
            return -1

    # -- recording --

    def note(self, kind: str, seconds: float, *, cache_hit: bool,
             key=None, error: Optional[BaseException] = None) -> None:
        """Book one pass through the seam. ``error`` records a failed
        build (counter only — the caller re-raises and the enclosing
        ``tpu.compile`` span stamps error status)."""
        ev = {"kind": kind, "seconds": round(float(seconds), 6),
              "cache_hit": bool(cache_hit) and error is None,
              "cold": error is None and not cache_hit,
              # the port has no ahead-of-time path and no cost analysis
              "aot": False, "steady": self._steady,
              "key": repr(key) if key is not None else None,
              "cost": None,
              "error": repr(error) if error is not None else None}
        with self._lock:
            if error is not None:
                self.stats["compile_failures"] += 1
            else:
                self.stats["compile_total"] += 1
                self.stats["compile_seconds"] = round(
                    self.stats["compile_seconds"] + float(seconds), 6)
                if cache_hit:
                    self.stats["compile_cache_hits"] += 1
                else:
                    self.stats["compile_cold_total"] += 1
            self.events.append(ev)
            if len(self.events) > _EVENT_CAP:
                del self.events[:len(self.events) - _EVENT_CAP]
        if error is None and not cache_hit:
            tracing.instant("compile.cold", kind=kind,
                            seconds=round(float(seconds), 3),
                            steady=self._steady)
            if self._steady:
                # a cold build AFTER the provider reached steady state:
                # dump the timeline around it
                tracing.auto_dump("cold_compile")
            logger.info(
                "cold kernel build: kind=%s %.1fs%s", kind,
                float(seconds),
                " (STEADY STATE — unplanned library?)"
                if self._steady else "")

    def run_compile(self, kind: str, key, thunk,
                    library: Optional[Callable[[], str]] = None):
        """THE classification path: run `thunk` (a library's build and
        load) inside a ``tpu.compile`` span, time it, classify hit-vs-cold
        (an entry delta + wall threshold) and book the event. The delta
        is the build directory's entry count, or, when `library` gives
        the path of the one library the thunk loads, whether that file
        appeared: builds that run side by side then cannot mark each
        other cold. A raising thunk books a failure and re-raises."""
        entries = (self.cache_entries if library is None
                   else functools.partial(os.path.exists, library()))
        before = entries()
        t0 = self._clock()
        try:
            with tracing.span("tpu.compile", kind=kind, aot=False):
                out = thunk()
        except BaseException as e:
            self.note(kind, self._clock() - t0, cache_hit=False,
                      key=key, error=e)
            raise
        dt = self._clock() - t0
        wrote = before >= 0 and entries() > before
        hit = (not wrote) and dt < self.cold_threshold_s
        self.note(kind, dt, cache_hit=hit, key=key)
        return out

    def first_load(self, kind: str, thunk,
                   library: Optional[Callable[[], str]] = None):
        """Run `thunk` through ``run_compile`` the first time this
        recorder sees library `kind`, else just run it. The library is
        claimed before the call (concurrent first loads book once) and
        released on failure, so a retry books again."""
        with self._seen_lock:
            first = kind not in self._seen
            self._seen.add(kind)
        if not first:
            return thunk()
        try:
            return self.run_compile(kind, None, thunk, library)
        except BaseException:
            with self._seen_lock:
                self._seen.discard(kind)
            raise


# ---------------------------------------------------------------------------
# the build seam: which provider's recorder a library load books into
# ---------------------------------------------------------------------------

_recorder: contextvars.ContextVar = contextvars.ContextVar(
    "ftpu_compile_recorder", default=None)


class recording:
    """``with recording(rec):`` books the library loads of the block (on
    this thread) into `rec`: the provider sets it around its dispatches
    and its prewarm. A class, not a generator: it runs twice a commit-path
    call."""

    __slots__ = ("_rec", "_token")

    def __init__(self, rec: CompileRecorder):
        self._rec = rec

    def __enter__(self) -> CompileRecorder:
        self._token = _recorder.set(self._rec)
        return self._rec

    def __exit__(self, et, ev, tb) -> bool:
        _recorder.reset(self._token)
        return False


def current() -> Optional[CompileRecorder]:
    """The recorder this thread's library loads book into, if any."""
    return _recorder.get()


def build_seam(kind: str, thunk, library: Callable[[], str]):
    """Load library `kind` with `thunk`, through the current recorder's
    ``first_load`` when a provider set one (``recording``); `library`
    gives the path of the library file the thunk builds or reuses (read
    on a first load only), whose appearing marks the load cold."""
    rec = _recorder.get()
    if rec is None:
        return thunk()
    return rec.first_load(kind, thunk, library)


# ---------------------------------------------------------------------------
# per-device memory accounting
# ---------------------------------------------------------------------------

def device_memory() -> list:
    """One row per CUDA device: ``{"device", "kind", "bytes_in_use",
    "peak_bytes_in_use", "bytes_limit"}``. A host without CUDA, or whose
    CUDA runtime this process has not initialised yet, reports nothing:
    a poller on a CPU-only node never creates a context."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    rows = []
    for i in range(torch.cuda.device_count()):
        rows.append({
            "device": i,
            "kind": torch.cuda.get_device_name(i),
            # the caching allocator's reserved bytes: what the process
            # holds on the card, freed tensors' cached blocks included
            "bytes_in_use": int(torch.cuda.memory_reserved(i)),
            # its high-water mark since process start
            "peak_bytes_in_use": int(torch.cuda.max_memory_reserved(i)),
            # the card's total memory, as mem_get_info's total reports
            # it, read without creating a context on the device
            "bytes_limit": int(
                torch.cuda.get_device_properties(i).total_memory),
        })
    return rows


def peak_memory_bytes(rows: Optional[list] = None) -> int:
    """The fleet's worst per-device peak occupancy (bench stage-line
    ``mem_peak_bytes``); 0 when no device reports memory stats."""
    rows = device_memory() if rows is None else rows
    return max((r.get("peak_bytes_in_use", 0) for r in rows),
               default=0)


def hbm_substate(rows: Optional[list] = None,
                 headroom_frac: Optional[float] = None
                 ) -> Optional[str]:
    """`hbm_low:d<k>:<free>%free` naming the tightest device when any
    device's free fraction drops under the headroom threshold, else
    None — the `/healthz components.bccsp` sub-state that shows an
    oversized span BEFORE it OOMs."""
    frac = HBM_HEADROOM_FRAC if headroom_frac is None \
        else float(headroom_frac)
    rows = device_memory() if rows is None else rows
    worst = None
    for r in rows:
        limit = r.get("bytes_limit") or 0
        if limit <= 0:
            continue
        free = 1.0 - (r.get("bytes_in_use", 0) / limit)
        if worst is None or free < worst[1]:
            worst = (r.get("device"), free)
    if worst is not None and worst[1] < frac:
        return f"hbm_low:d{worst[0]}:{max(0, int(worst[1] * 100))}%free"
    return None
