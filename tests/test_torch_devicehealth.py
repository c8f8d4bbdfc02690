"""fabric_tpu_torch.common.{devicehealth,breaker,faults} against the JAX
package's fabric_tpu.common.{devicehealth,breaker,faults}.

Each script is a list of events (a fault, an attributed error, a probe
taken and reported, a sharded batch's readings, the clock advanced) run
step by step on the port's DeviceHealth and the reference's under one
fake clock: every step's return value, and `state_codes()`,
`snapshot()` and `totals()` after it, must be equal. The breaker and the
fault registry run their own scripts the same way. No device is
touched: the modules are host logic.
"""

import pytest

from fabric_tpu.common import breaker as jbreaker
from fabric_tpu.common import devicehealth as jdh
from fabric_tpu.common import faults as jfaults
from fabric_tpu.common import tracing as jtracing

from fabric_tpu_torch.common import breaker, devicehealth, faults, tracing


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _no_dumps(monkeypatch):
    """A quarantine writes a flight-recorder dump in both packages when
    tracing is on: keep the scripts off the disk."""
    for mod in (tracing, jtracing):
        monkeypatch.setattr(mod._state, "enabled", False)


# -- the DeviceHealth scripts --

def _cfg(**kw):
    return {"trip_threshold": 1, "cooldown_s": 30.0,
            "straggler_skew_s": 2.0, "straggler_strikes": 3,
            "probe_timeout_s": 5.0, **kw}


SCRIPTS = {
    # a fault quarantines; the cooldown elapses; the probe readmits
    "fault_cooldown_probe_readmit": (4, _cfg(), [
        ("fault", 2), ("candidates",), ("advance", 29.9), ("candidates",),
        ("advance", 0.2), ("probe", True), ("advance", 1.0),
        ("candidates",)]),
    # a failed probe re-opens the cooldown; the next one readmits
    "failed_probe_reopens": (3, _cfg(cooldown_s=10.0), [
        ("fault", 0), ("advance", 10.0), ("probe", False),
        ("advance", 9.0), ("candidates",), ("advance", 1.5),
        ("probe", True)]),
    # a probe whose outcome never came back is reclaimed after the
    # cooldown; its late success is no readmit
    "stale_probe_is_no_readmit": (2, _cfg(cooldown_s=5.0), [
        ("fault", 1), ("advance", 5.0), ("take",), ("advance", 5.0),
        ("state",), ("report", 1, True), ("advance", 5.0),
        ("probe", True)]),
    # a probe still executing keeps its slot past the reclaim window
    "executing_probe_keeps_slot": (2, _cfg(cooldown_s=1.0), [
        ("fault", 0), ("advance", 1.0), ("take_executing",),
        ("advance", 3.0), ("state",), ("finish_executing", 0, True)]),
    # strikes count up over consecutive struck batches, a clean batch
    # clears them, the third consecutive strike quarantines
    "straggler_strikes_count_and_reset": (4, _cfg(), [
        ("observe", [0, 1, 2, 3], [0.1, 0.1, 2.5, 0.1], []),
        ("observe", [0, 1, 2, 3], [0.1, 0.1, 2.5, 0.1], []),
        ("observe", [0, 1, 2, 3], [0.1, 0.1, 0.1, 0.1], []),
        ("observe", [0, 1, 2, 3], [0.1, 0.1, 2.5, 0.1], []),
        ("observe", [0, 1, 2, 3], [0.1, 0.1, 2.5, 0.1], []),
        ("observe", [0, 1, 2, 3], [0.1, 0.1, 2.5, 0.1], [])]),
    # ready-lag jumps in sampling order strike the position after the
    # jump; two positions on one slow link cross together
    "correlated_stragglers": (4, _cfg(straggler_strikes=2), [
        ("observe", [2, 3, 0, 1], [0.1, 0.1, 3.0, 3.0], []),
        ("observe", [1, 2, 3, 0], [3.0, 0.1, 0.1, 3.0], []),
        ("observe", [0, 1, 2, 3], [], [0.1, 0.2, 2.5, 2.6]),
        ("observe", [0, 1, 2, 3], [], [0.1, 0.2, 2.5, 2.6])]),
    # skew <= 0 disables the strikes; a one-position reading is ignored
    "no_skew_no_strikes": (3, _cfg(straggler_skew_s=0.0), [
        ("observe", [0, 1, 2], [0.1, 9.0, 0.1], [0.1, 9.0, 9.1]),
        ("observe", [0, 1, 2], [0.1, 9.0, 0.1], [0.1, 9.0, 9.1]),
        ("observe", [0, 1, 2], [0.1, 9.0, 0.1], [0.1, 9.0, 9.1]),
        ("observe", [1], [9.0], [])]),
    # a fault re-attributed to a quarantined position does not extend its
    # cooldown
    "reattributed_fault_keeps_cooldown": (2, _cfg(cooldown_s=10.0), [
        ("fault", 1), ("advance", 6.0), ("fault", 1), ("attribute_lost", 1),
        ("advance", 4.5), ("candidates",)]),
    # attribute() reads the device from the error text, the reference's
    # patterns and torch's; out of range or no device is None
    "attribute_parses_device_names": (4, _cfg(trip_threshold=2), [
        ("attribute", "CUDA error: an illegal memory access on device 1"),
        ("attribute_torch", "Expected all tensors on cuda:3, found cpu",
         "Expected all tensors on device 3, found cpu"),
        ("attribute_torch", "CUDA error on cuda:9", "error on device 9"),
        ("attribute", "RuntimeError: TPU_2 halted"),
        ("attribute", "chip #0 answered late"),
        ("attribute", "device=7 is out of range"),
        ("attribute", "out of memory"),
        ("attribute", "device 1 lost again"),
        ("attribute_lost", 3)]),
    # trip threshold 2: one fault is a failure, the second a quarantine;
    # every position down, then a forced state
    "threshold_and_total_loss": (2, _cfg(trip_threshold=2), [
        ("fault", 0), ("fault", 0), ("fault", 1), ("fault", 1),
        ("advance", 30.0), ("candidates",), ("force", 0, "device"),
        ("force", 1, "degraded")]),
}


class _Run:
    """One package's DeviceHealth driven by the script's events."""

    def __init__(self, mod, n, cfg, clock):
        self.mod = mod
        self.dh = mod.DeviceHealth(n, mod.DeviceHealthConfig(**cfg),
                                   clock=clock)
        self.taken = []

    def step(self, ev):
        dh, kind = self.dh, ev[0]
        if kind == "fault":
            return dh.record_fault(ev[1], RuntimeError("transfer failed"))
        if kind == "attribute":
            return dh.attribute(RuntimeError(ev[1]))
        if kind == "attribute_torch":
            # torch's spelling for the port, the reference's for it
            return dh.attribute(RuntimeError(
                ev[1] if self.mod is devicehealth else ev[2]))
        if kind == "attribute_lost":
            return dh.attribute(self.mod.DeviceLostError(
                ev[1], RuntimeError("lost")))
        if kind == "candidates":
            return dh.probe_candidates()
        if kind == "probe":
            got = dh.probe_candidates()
            for d in got:
                dh.probe_result(d, ev[1])
            return got
        if kind == "take":
            self.taken = dh.probe_candidates()
            return self.taken
        if kind == "take_executing":
            self.taken = dh.probe_candidates()
            self.live = [dh.probe_execution(d) for d in self.taken]
            for cm in self.live:
                cm.__enter__()
            return self.taken
        if kind == "finish_executing":
            for cm in self.live:
                cm.__exit__(None, None, None)
            return dh.probe_result(ev[1], ev[2])
        if kind == "report":
            return dh.probe_result(ev[1], ev[2])
        if kind == "observe":
            return dh.observe_shard(*ev[1:])
        if kind == "state":
            return [dh.state(d) for d in range(dh.n_devices)]
        if kind == "force":
            return dh.force_state(ev[1], ev[2])
        raise AssertionError(kind)

    def view(self):
        dh = self.dh
        return (dh.state_codes(), dh.snapshot(), dh.totals(), dh.healthy(),
                dh.quarantined(), dh.any_unhealthy())


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_device_health_script_matches_reference(name):
    n, cfg, events = SCRIPTS[name]
    clock = _Clock()
    mine, ref = _Run(devicehealth, n, cfg, clock), _Run(jdh, n, cfg, clock)
    assert mine.view() == ref.view()
    seen_change = False
    for i, ev in enumerate(events):
        if ev[0] == "advance":
            clock.t += ev[1]
        else:
            assert mine.step(ev) == ref.step(ev), (i, ev)
        assert mine.view() == ref.view(), (i, ev)
        seen_change |= mine.view()[0] != [0] * n or any(
            mine.view()[2].values())
    # every script moves the ring (no vacuous pass), bar the one that
    # shows the strikes off
    assert seen_change or name == "no_skew_no_strikes"


def test_device_from_error_matches_reference():
    for msg in ("device 2", "cuda:1", "CUDA device 3 failed", "TPU:1",
                "device#0", "cuda:9", "no device here", "", None):
        for n in (1, 2, 4):
            want = jdh.device_from_error(msg, n)
            if msg is not None and "cuda:" in msg:
                # torch's spelling is the port's addition
                want = int(msg.split("cuda:")[1][0])
                want = want if want < n else None
            assert devicehealth.device_from_error(msg, n) == want, (msg, n)
    assert devicehealth.DeviceHealthConfig() == devicehealth.\
        DeviceHealthConfig(**vars(jdh.DeviceHealthConfig()))
    err = devicehealth.DeviceLostError(3, ValueError("x"))
    assert str(err) == str(jdh.DeviceLostError(3, ValueError("x")))
    assert (err.device, type(err.cause)) == (3, ValueError)


# -- the breaker's scripts --

BREAKER_SCRIPTS = {
    "trip_cooldown_probe_close": (dict(trip_threshold=3, cooldown_s=5.0), [
        "failure", "admit", "failure", "failure", "admit", ("advance", 5.0),
        "admit", "admit", "success", "admit"]),
    "probe_failure_reopens": (dict(trip_threshold=1, cooldown_s=2.0), [
        "failure", ("advance", 2.0), "admit", "failure", "admit",
        ("advance", 2.0), "admit", "success"]),
    "stale_probe_reclaimed": (dict(trip_threshold=1, cooldown_s=2.0), [
        "failure", ("advance", 2.0), "admit", ("advance", 2.0), "state",
        "success", ("advance", 2.0), "admit", "success"]),
    "short_cooldown_reclaims_after_1s": (
        dict(trip_threshold=1, cooldown_s=0.25), [
            "failure", ("advance", 0.25), "admit", ("advance", 0.5),
            "state", ("advance", 0.6), "state", ("advance", 0.25), "admit",
            "failure", "state"]),
    "executing_probe_keeps_slot": (dict(trip_threshold=2, cooldown_s=3.0), [
        "failure", "success", "failure", "failure", ("advance", 3.0), "admit",
        "enter", ("advance", 9.0), "state", "exit", "state", "failure",
        "state"]),
}


def _breaker_step(mod, br, ev):
    if ev == "admit":
        try:
            return br.admit()
        except mod.CircuitOpen as e:
            return f"open: {e}"
    if ev == "failure":
        return br.failure(RuntimeError("x"))
    if ev == "enter":
        br._live = br.execution()
        return br._live.__enter__()
    if ev == "exit":
        return br._live.__exit__(None, None, None)
    if ev == "success":
        return br.success()
    if ev == "state":
        return br.state
    raise AssertionError(ev)


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_script_matches_reference(name):
    cfg, events = BREAKER_SCRIPTS[name]
    clock = _Clock()
    mine = breaker.CircuitBreaker(breaker.BreakerConfig(**cfg), name="b",
                                  clock=clock)
    ref = jbreaker.CircuitBreaker(jbreaker.BreakerConfig(**cfg), name="b",
                                  clock=clock)
    for i, ev in enumerate(events):
        if isinstance(ev, tuple):
            clock.t += ev[1]
        else:
            assert _breaker_step(breaker, mine, ev) == \
                _breaker_step(jbreaker, ref, ev), (i, ev)
        assert (mine.state, mine.state_code, mine.stats) == \
            (ref.state, ref.state_code, ref.stats), (i, ev)
    assert (breaker.DEVICE, breaker.DEGRADED, breaker.PROBING) == \
        (jbreaker.DEVICE, jbreaker.DEGRADED, jbreaker.PROBING)


# -- the fault registry's scripts --

FAULT_SCRIPTS = {
    # an arg-targeted arming fires only on its position, fail-N times
    "arg_targeting_fail_n": [
        ("arm", "tpu.device_lost", dict(mode="error", count=2, arg=1)),
        ("check", "tpu.device_lost", None), ("check", "tpu.device_lost", 0),
        ("check", "tpu.device_lost", 1), ("check", "tpu.device_lost", "1"),
        ("check", "tpu.device_lost", 1)],
    # delay mode stalls and proceeds; disarm; unlimited count
    "delay_and_disarm": [
        ("arm", "tpu.device_straggler", dict(mode="delay", delay_s=0.001)),
        ("check", "tpu.device_straggler", 3),
        ("check", "tpu.device_straggler", None),
        ("disarm", "tpu.device_straggler"),
        ("check", "tpu.device_straggler", 3)],
    # the env grammar: point=mode[:count][:delay_s][:arg], ';' or ','
    # separated, the arg verbatim past the third ':', malformed entries
    # ignored
    "env_grammar": [
        ("env", "tpu.device_lost=error:1::2;tpu.device_straggler=delay::0.0"
                ":0, bogus.point=error:x"),
        ("check", "tpu.device_lost", 1), ("check", "tpu.device_lost", 2),
        ("check", "tpu.device_straggler", 0),
        ("env", "tpu.device_lost=:3:0.5:host:7050"),
        ("check", "tpu.device_lost", "host:7050"),
        ("consume", "tpu.device_lost", "host:7050"), ("clear",),
        ("check", "tpu.device_lost", "host:7050")],
}


def _fault_step(mod, reg, ev):
    kind = ev[0]
    if kind == "arm":
        return reg.arm(ev[1], **ev[2])
    if kind == "disarm":
        return reg.disarm(ev[1])
    if kind == "clear":
        return reg.clear()
    if kind == "env":
        return reg.arm_from_env(ev[1])
    if kind == "consume":
        return reg.consume(ev[1], arg=ev[2])
    if kind == "check":
        try:
            reg.check(ev[1], arg=ev[2])
            return "pass"
        except mod.FaultInjected as e:
            return f"raised: {e}"
    raise AssertionError(kind)


@pytest.mark.parametrize("name", sorted(FAULT_SCRIPTS))
def test_fault_script_matches_reference(name):
    mine, ref = faults.FaultRegistry(), jfaults.FaultRegistry()
    points = ("tpu.device_lost", "tpu.device_straggler", "bogus.point")
    for i, ev in enumerate(FAULT_SCRIPTS[name]):
        assert _fault_step(faults, mine, ev) == \
            _fault_step(jfaults, ref, ev), (i, ev)
        for p in points:
            assert (mine.arming(p), mine.fires(p), mine.armed(p)) == \
                (ref.arming(p), ref.fires(p), ref.armed(p)), (i, ev, p)
    assert faults.KNOWN_POINTS <= jfaults.KNOWN_POINTS
    with pytest.raises(ValueError):
        mine.arm("tpu.device_lost", mode="crash")
