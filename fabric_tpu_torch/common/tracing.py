"""Spans, instants and the flight recorder: the port's copy of
fabric_tpu/common/tracing.py, cut to what the port uses.

**Spans** — `with span("tpu.verify", **attrs): ...` around a seam, or
the `@traced("tpu.dispatch")` decorator for a whole function. A span
records a perf_counter pair plus its context (`trace_id`/`span_id`,
carried down the calling thread so nested spans link to their parent);
attrs are stored raw and formatted only at export, and error status is
stamped from a propagating exception. The cost is two clock reads, one
ring slot and one stage-reservoir observation. Every span feeds a
per-stage latency reservoir (`stage_quantiles()`) and, once a metrics
provider is bound (`bind_metrics`), the `trace_stage_seconds` histogram.

**Flight recorder** — a preallocated, drop-oldest ring of the most
recent spans and instants, always on (`FTPU_TRACE=0` opts out; disabled
mode costs one attribute read and allocates nothing). Exported as
Chrome-trace-event JSON (`chrome_trace`, perfetto / chrome://tracing
loadable, tid = the span name's first dotted segment) and written to a
file by `dump`, or by `auto_dump` (rate-limited, on a short-lived
thread) when the provider's build seam meets a cold build in steady
state (common/devicecost.py).

Left out, against the reference: the cluster-trace hook of
`bind_metrics` and the per-node attribution of events (the port runs no
cluster of nodes), the explicit cross-thread handoff (`new_context`,
`attached`: no port code hands work between threads under a span), and
the shed note (the port has no overload stages). The breaker, quarantine
and readmit notes are the mesh's landmarks (common/breaker.py,
common/devicehealth.py). A ring event is the reference's tuple
without its node field: (ph, name, trace_id, span_id, parent_span_id,
t0, dur, thread name, attrs, error).

Knobs, as in the reference: env `FTPU_TRACE`, `FTPU_TRACE_RING`,
`FTPU_TRACE_SAMPLE`, `FTPU_TRACE_DUMP_DIR`, `FTPU_TRACE_DUMP_MIN_S`, or
`configure(...)`. SampleEvery=N records every Nth span in the ring
(error spans and instants always record; the reservoirs always observe).
"""

from __future__ import annotations

import functools
import itertools
import json
import logging
import os
import re
import tempfile
import threading
import time
from typing import Optional

logger = logging.getLogger("fabric_tpu_torch.common.tracing")

# export epoch: Chrome-trace `ts` is microseconds relative to this
_PC0 = time.perf_counter()

_STAGE_RESERVOIR = 512   # per-stage duration reservoir (recent window)


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
    except ValueError:
        return default
    return v if v > 0 else default


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, ""))
    except ValueError:
        return default
    return v if v > 0 else default


class TraceContext:
    """One point in a trace: the correlation id shared by nested spans
    (`trace_id`) and this span's own id. Immutable."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}/{self.span_id})"


# ids: a per-process random prefix + counter — unique, collision-free
# across processes, and far cheaper than urandom per span
_ID_PREFIX = os.urandom(4).hex()
_id_seq = itertools.count(1)
_span_seq = itertools.count()    # sampling counter
_dump_seq = itertools.count(1)


def _next_id() -> str:
    return f"{_ID_PREFIX}{next(_id_seq):08x}"


class _State:
    """Module-wide mutable configuration + the recorder itself."""

    def __init__(self):
        self.enabled = os.environ.get("FTPU_TRACE", "1") != "0"
        self.sample_every = _env_int("FTPU_TRACE_SAMPLE", 1)
        self.ring: list = [None] * _env_int("FTPU_TRACE_RING", 4096)
        self.ring_idx = 0
        self.ring_lock = threading.Lock()
        self.stages: dict = {}           # stage -> _StageLat
        self.stage_lock = threading.Lock()
        self.hist = None                 # bound trace_stage_seconds
        self.dump_dir = os.environ.get("FTPU_TRACE_DUMP_DIR") or None
        self.dump_min_interval_s = _env_float("FTPU_TRACE_DUMP_MIN_S",
                                              10.0)
        self.last_dump_t: Optional[float] = None
        self.dump_lock = threading.Lock()


_state = _State()
_tls = threading.local()


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return _state.enabled


def set_enabled(flag: bool) -> None:
    """Flip recording at runtime (the overhead A/B uses this). Disabled
    mode is the zero-allocation fast path: span() returns a shared
    no-op."""
    _state.enabled = bool(flag)


def configure(enabled: Optional[bool] = None,
              ring_size: Optional[int] = None,
              sample_every: Optional[int] = None,
              dump_dir: Optional[str] = None,
              dump_min_interval_s: Optional[float] = None) -> None:
    if enabled is not None:
        _state.enabled = bool(enabled)
    if ring_size is not None and ring_size > 0:
        with _state.ring_lock:
            _state.ring = [None] * int(ring_size)
            _state.ring_idx = 0
    if sample_every is not None and sample_every > 0:
        _state.sample_every = int(sample_every)
    if dump_dir is not None:
        _state.dump_dir = dump_dir or None
    if dump_min_interval_s is not None:
        _state.dump_min_interval_s = float(dump_min_interval_s)


def bind_metrics(provider) -> None:
    """Attach a metrics provider: every span/stage observation also
    feeds the stage-labeled `trace_stage_seconds` histogram."""
    from fabric_tpu_torch.common import metrics as metrics_mod
    try:
        _state.hist = provider.new_histogram(
            metrics_mod.TRACE_STAGE_SECONDS_OPTS)
    except Exception:
        logger.warning("trace_stage_seconds histogram unavailable",
                       exc_info=True)


def reset(enabled: Optional[bool] = None) -> None:
    """Test isolation: drop every recorded event and stage reading
    (ids keep counting — resets must not make them collide)."""
    with _state.ring_lock:
        _state.ring = [None] * len(_state.ring)
        _state.ring_idx = 0
    with _state.stage_lock:
        _state.stages.clear()
    with _state.dump_lock:
        _state.last_dump_t = None
    if enabled is not None:
        _state.enabled = bool(enabled)


def capture() -> Optional[TraceContext]:
    """The calling thread's ambient context (None outside any span)."""
    return getattr(_tls, "ctx", None)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NoopSpan:
    """Disabled-mode span: a shared singleton — no allocation, no
    clock reads, no state."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "_parent", "ctx", "_prior", "_t0")

    def __init__(self, name: str, parent: Optional[TraceContext],
                 attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs
        self._parent = parent

    def __enter__(self) -> TraceContext:
        parent = self._parent
        if parent is None:
            parent = getattr(_tls, "ctx", None)
            self._parent = parent
        if parent is not None:
            ctx = TraceContext(parent.trace_id, _next_id())
        else:
            ctx = TraceContext(_next_id(), _next_id())
        self.ctx = ctx
        self._prior = getattr(_tls, "ctx", None)
        _tls.ctx = ctx
        self._t0 = time.perf_counter()
        return ctx

    def __exit__(self, et, ev, tb) -> bool:
        t1 = time.perf_counter()
        _tls.ctx = self._prior
        err = None
        if et is not None:
            # error status stamped from the propagating exception;
            # str(ev) is the ONE formatting cost and only on failures
            err = f"{et.__name__}: {ev}" if ev is not None \
                else et.__name__
        dur = t1 - self._t0
        _observe(self.name, dur)
        # sampled ring admission — error spans always record
        if err is not None or \
                next(_span_seq) % _state.sample_every == 0:
            parent = self._parent
            _record(("X", self.name, self.ctx.trace_id,
                     self.ctx.span_id,
                     parent.span_id if parent is not None else None,
                     self._t0, dur,
                     threading.current_thread().name,
                     self.attrs or None, err))
        return False


def span(name: str, parent: Optional[TraceContext] = None, **attrs):
    """Open one span: `with span("tpu.compile", kind="ptree"):`.
    Inherits the ambient context (or `parent`), records a perf_counter
    pair + the attrs (raw — formatted only at export), stamps error
    status from a propagating exception, and feeds the stage latency
    reservoir/histogram. Returns a shared no-op when tracing is
    disabled."""
    if not _state.enabled:
        return _NOOP
    return _Span(name, parent, attrs or None)


def traced(name: str):
    """Whole-function span decorator: `@traced("tpu.dispatch")` above
    the def."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _state.enabled:
                return fn(*args, **kwargs)
            with _Span(name, None, None):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def observe_span(name: str, t0: float, t1: float,
                 parent: Optional[TraceContext] = None,
                 **attrs) -> Optional[TraceContext]:
    """Record an already-measured interval as a complete span. `t0`/`t1`
    are perf_counter readings. Returns the span's context."""
    if not _state.enabled:
        return None
    if parent is None:
        parent = capture()
    if parent is not None:
        ctx = TraceContext(parent.trace_id, _next_id())
    else:
        ctx = TraceContext(_next_id(), _next_id())
    dur = max(0.0, t1 - t0)
    _observe(name, dur)
    # same ring-admission sampling as span() exit
    if next(_span_seq) % _state.sample_every == 0:
        _record(("X", name, ctx.trace_id, ctx.span_id,
                 parent.span_id if parent is not None else None,
                 t0, dur, threading.current_thread().name,
                 attrs or None, None))
    return ctx


def instant(name: str, **attrs) -> None:
    """An instant event in the recorder (a cold build): zero duration,
    always recorded (never sampled out) — the landmarks a postmortem
    is read by."""
    if not _state.enabled:
        return
    ctx = capture()
    _record(("i", name,
             ctx.trace_id if ctx is not None else None, _next_id(),
             ctx.span_id if ctx is not None else None,
             time.perf_counter(), 0.0,
             threading.current_thread().name, attrs or None, None))


def observe_stage(stage: str, seconds: float) -> None:
    """Feed one duration into a stage's latency distribution without
    a ring event (the device's busy reading of a dispatch)."""
    if not _state.enabled:
        return
    _observe(stage, seconds)


# ---------------------------------------------------------------------------
# the ring + stage reservoirs
# ---------------------------------------------------------------------------

def _record(ev: tuple) -> None:
    st = _state
    with st.ring_lock:
        ring = st.ring
        i = st.ring_idx
        st.ring_idx = i + 1
        ring[i % len(ring)] = ev


class _StageLat:
    __slots__ = ("ring", "idx", "count", "sum", "hist", "child")

    def __init__(self):
        self.ring = [0.0] * _STAGE_RESERVOIR
        self.idx = 0
        self.count = 0
        self.sum = 0.0
        # the stage-labeled histogram child, cached per stage
        self.hist = None        # the provider histogram it came from
        self.child = None


def _observe(stage: str, dur: float) -> None:
    st = _state
    hist = st.hist
    with st.stage_lock:
        sl = st.stages.get(stage)
        if sl is None:
            sl = st.stages[stage] = _StageLat()
        sl.ring[sl.idx % _STAGE_RESERVOIR] = dur
        sl.idx += 1
        sl.count += 1
        sl.sum += dur
        if hist is not None and sl.hist is not hist:
            # (re)bound provider: build this stage's child once
            try:
                sl.child = hist.with_labels("stage", stage)
                sl.hist = hist
            except Exception:
                logger.warning("trace_stage_seconds child bind "
                               "failed", exc_info=True)
                sl.child = None
                sl.hist = hist
        child = sl.child if hist is not None else None
    if child is not None:
        try:
            child.observe(dur)
        except Exception:
            logger.warning("trace_stage_seconds observe failed",
                           exc_info=True)
            st.hist = None     # never pay a failing path per span


def stage_quantiles() -> dict:
    """{stage: {"count", "mean_s", "p50_s", "p99_s"}} — mean/p50/p99
    all describe the SAME window, the stage's recent-duration
    reservoir (the last _STAGE_RESERVOIR observations); `count` alone
    is the all-time observation total."""
    with _state.stage_lock:
        items = [(name, list(sl.ring[:min(sl.idx, _STAGE_RESERVOIR)]),
                  sl.count)
                 for name, sl in _state.stages.items()]
    out = {}
    for name, data, count in items:
        if not data:
            continue
        data.sort()
        out[name] = {
            "count": count,
            "mean_s": sum(data) / len(data),
            "p50_s": data[int(0.50 * (len(data) - 1))],
            "p99_s": data[int(0.99 * (len(data) - 1))],
        }
    return out


def stage_quantile(stage: str, which: str,
                   ndigits: Optional[int] = None) -> Optional[float]:
    """One reading (`which` in count/mean_s/p50_s/p99_s), optionally
    rounded, or None if the stage never observed."""
    q = stage_quantiles().get(stage)
    v = None if q is None else q.get(which)
    if v is None or ndigits is None:
        return v
    return round(v, ndigits)


# ---------------------------------------------------------------------------
# export: Chrome trace events + dump files
# ---------------------------------------------------------------------------

def snapshot() -> list:
    """The recorder's events, oldest first (raw tuples)."""
    with _state.ring_lock:
        ring = list(_state.ring)
        idx = _state.ring_idx
    n = len(ring)
    if idx <= n:
        events = ring[:idx]
    else:
        cut = idx % n
        events = ring[cut:] + ring[:cut]
    return [e for e in events if e is not None]


def _fmt_attr(v):
    return v if isinstance(v, (bool, int, float, str)) or v is None \
        else str(v)


def clock_anchor() -> dict:
    """One (monotonic, wall) clock pair plus the derived wall time of
    trace ts=0, stamped into every export header."""
    pc = time.perf_counter()
    wall = time.time()
    return {"perf_counter": pc, "wall": wall,
            "epoch_wall_s": wall - (pc - _PC0)}


def chrome_trace(trace_id: Optional[str] = None) -> dict:
    """The recorder as a Chrome-trace-event document
    (chrome://tracing / perfetto loadable). tid = the span name's first
    dotted segment, so each layer renders as its own track; per-span
    correlation ids + attrs ride in `args`. `trace_id` filters to one
    trace's spans. Attrs were stored raw — THIS is where they are
    formatted."""
    pid = os.getpid()
    tids: dict = {}
    out = []
    for ph, name, tr, sp, par, t0, dur, tname, attrs, err in snapshot():
        if trace_id is not None and tr != trace_id:
            continue
        group = name.split(".", 1)[0]
        tid = tids.setdefault(group, len(tids) + 1)
        args = {"trace_id": tr, "span_id": sp, "thread": tname}
        if par is not None:
            args["parent_span_id"] = par
        if attrs:
            for k, v in attrs.items():
                args[k] = _fmt_attr(v)
        if err is not None:
            args["error"] = err
        rec = {"ph": ph, "name": name, "cat": group, "pid": pid,
               "tid": tid, "ts": round((t0 - _PC0) * 1e6, 1),
               "args": args}
        if ph == "X":
            rec["dur"] = round(dur * 1e6, 1)
        else:
            rec["s"] = "p"
        out.append(rec)
    meta = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "fabric-tpu"}}]
    for group, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": f"stage:{group}"}})
    return {"displayTimeUnit": "ms", "traceEvents": meta + out,
            "ftpu": {"pid": pid, "clock": clock_anchor(),
                     **({"trace_id": trace_id}
                        if trace_id is not None else {})}}


def _dump_path(reason: str) -> str:
    d = _state.dump_dir or os.path.join(tempfile.gettempdir(),
                                        "ftpu_trace")
    os.makedirs(d, exist_ok=True)
    slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:48] or "dump"
    return os.path.join(
        d, f"ftpu_trace_{os.getpid()}_{next(_dump_seq)}_{slug}.json")


def dump(reason: str = "manual", path: Optional[str] = None) -> str:
    """Write the recorder as a Chrome-trace JSON file and return the
    path. Default directory: FTPU_TRACE_DUMP_DIR, else <tmp>/ftpu_trace.
    The document carries an `ftpu` header (reason, pid, wall time, stage
    quantiles) so a dump is a self-contained postmortem."""
    doc = chrome_trace()
    doc["ftpu"].update({
        "reason": reason,
        "pid": os.getpid(),
        "wall_time": time.time(),
        "events": len(doc["traceEvents"]),
        "stage_quantiles": {
            k: {f: round(v, 6) if isinstance(v, float) else v
                for f, v in q.items()}
            for k, q in stage_quantiles().items()},
    })
    if path is None:
        path = _dump_path(reason)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    logger.warning("flight recorder dumped %d event(s) to %s (%s)",
                   len(doc["traceEvents"]), path, reason)
    return path


def auto_dump(reason: str) -> Optional[str]:
    """Rate-limited dump for automatic triggers (a cold build in steady
    state): at most one file per `dump_min_interval_s`, written on a
    short-lived daemon thread so the trigger's caller does not stall on
    file I/O. Returns the path the dump WILL land at (None when
    rate-limited); `wait_dumps()` joins the writer for tests."""
    try:
        now = time.monotonic()
        with _state.dump_lock:
            last = _state.last_dump_t
            if last is not None and \
                    now - last < _state.dump_min_interval_s:
                return None
            _state.last_dump_t = now
        path = _dump_path(reason)

        def write():
            try:
                dump(reason, path=path)
            except Exception:
                logger.warning("flight-recorder auto dump failed "
                               "(%s)", reason, exc_info=True)

        t = threading.Thread(target=write, name="ftpu-trace-dump",
                             daemon=True)
        _dump_threads.append(t)
        del _dump_threads[:-4]      # keep only recent writers joinable
        t.start()
        return path
    except Exception:
        logger.warning("flight-recorder auto dump failed (%s)",
                       reason, exc_info=True)
        return None


_dump_threads: list = []


def wait_dumps(timeout: float = 10.0) -> None:
    """Join any in-flight async dump writers (tests / teardown)."""
    for t in list(_dump_threads):
        t.join(timeout)


# ---------------------------------------------------------------------------
# degradation landmarks (called from breaker / devicehealth)
# ---------------------------------------------------------------------------

def note_breaker_trip(name: str, failures: int = 0) -> None:
    """A position's breaker opened: an instant event and a rate-limited
    flight-recorder dump. Never raises."""
    if not _state.enabled:
        return
    try:
        instant("breaker.trip", breaker=name, failures=failures)
        auto_dump("breaker_trip")
    except Exception:
        logger.warning("breaker-trip trace hook failed", exc_info=True)


def note_quarantine(device: int) -> None:
    if not _state.enabled:
        return
    try:
        instant("device.quarantine", device=device)
        auto_dump("device_quarantine")
    except Exception:
        logger.warning("quarantine trace hook failed", exc_info=True)


def note_readmit(device: int) -> None:
    if not _state.enabled:
        return
    try:
        instant("device.readmit", device=device)
    except Exception:
        logger.warning("readmit trace hook failed", exc_info=True)
