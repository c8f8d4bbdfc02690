"""fabric_tpu_torch.common.tracing against fabric_tpu.common.tracing, and
the CUDA provider's spans.

The same sequence of spans (nested, with attrs, one raising), instants,
inline-measured spans and stage observations goes through both
packages' recorders: the snapshots agree on names, phases, nesting,
attrs and error status, the stage-quantile keys and counts agree, and
the Chrome-trace documents hold the same events by name and phase. The
bound `trace_stage_seconds` histogram renders the same buckets and
counts in both packages' Prometheus providers, and the port's `BCCSP_*`
opts equal the reference's field for field. A CPU provider's commit path
(`verify_prepared` over 64 q8 lanes) records its `tpu.verify` and
`tpu.dispatch` spans, marks its recorder steady, and notes no busy time.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from fabric_tpu.common import metrics as jmetrics
from fabric_tpu.common import tracing as jtr

from fabric_tpu_torch.common import metrics, tracing as tr


@pytest.fixture()
def traces(tmp_path):
    for mod in (tr, jtr):
        mod.configure(enabled=True, ring_size=64, sample_every=1,
                      dump_dir=str(tmp_path), dump_min_interval_s=0.0)
        mod.reset()
        mod._state.hist = None
        # the sampling counters start together
        mod._span_seq = itertools.count()
    yield tmp_path
    for mod in (tr, jtr):
        mod.wait_dumps()
        mod.configure(enabled=True, ring_size=4096, sample_every=1,
                      dump_dir="", dump_min_interval_s=10.0)
        mod.reset()
        mod._state.hist = None


def _drive(mod):
    """One fixed sequence of every recording entry point."""
    @mod.traced("tpu.dispatch")
    def dispatch(n):
        mod.observe_stage("device.ready.d0", 0.002 * n)
        return n

    with mod.span("tpu.verify", lanes=64):
        dispatch(1)
        mod.instant("compile.cold", kind="ptree", seconds=1.5,
                    steady=False)
        with mod.span("tpu.compile", kind="ptree", aot=False):
            pass
    with pytest.raises(ValueError):
        with mod.span("tpu.verify", lanes=object()):
            dispatch(2)
            raise ValueError("card lost")
    mod.observe_span("tpu.ed25519", 1.0, 1.25, n=3)
    mod.observe_stage("device.ready.d0", 0.004)


def _shape(events):
    """(ph, name, parent's name, attrs keys, error) per event."""
    by_id = {e[3]: e for e in events}
    out = []
    for e in events:
        parent = by_id.get(e[4])
        out.append((e[0], e[1], parent[1] if parent else None,
                    sorted((e[8] or {}).keys()), e[9]))
    return out


def test_snapshot_matches_reference(traces):
    for mod in (tr, jtr):
        _drive(mod)
    mine, ref = tr.snapshot(), jtr.snapshot()
    assert _shape(mine) == _shape(ref)
    assert [e[1] for e in mine] == [
        "tpu.dispatch", "compile.cold", "tpu.compile", "tpu.verify",
        "tpu.dispatch", "tpu.verify", "tpu.ed25519"]
    err = [e for e in mine if e[9] is not None]
    assert [(e[1], e[9]) for e in err] == [
        ("tpu.verify", "ValueError: card lost")]
    # attrs stay raw in the ring
    assert [e[8] for e in mine if e[1] == "tpu.compile"] == [
        {"kind": "ptree", "aot": False}]


def test_stage_quantiles_match_reference(traces):
    for mod in (tr, jtr):
        _drive(mod)
    mine, ref = tr.stage_quantiles(), jtr.stage_quantiles()
    assert sorted(mine) == sorted(ref)
    assert {k: v["count"] for k, v in mine.items()} == \
        {k: v["count"] for k, v in ref.items()}
    for k in ("mean_s", "p50_s", "p99_s"):
        assert mine["device.ready.d0"][k] == ref["device.ready.d0"][k]
    assert tr.stage_quantile("device.ready.d0", "p99_s", 6) == 0.004
    assert tr.stage_quantile("nothing", "p50_s") is None


def test_chrome_trace_matches_reference(traces):
    for mod in (tr, jtr):
        _drive(mod)
    mine = json.loads(json.dumps(tr.chrome_trace()))
    ref = jtr.chrome_trace()

    def events(doc):
        return [(e["name"], e["ph"], e.get("args", {}).get("error"))
                for e in doc["traceEvents"]]
    assert events(mine) == events(ref)
    lanes = [e["args"]["lanes"] for e in mine["traceEvents"]
             if e["name"] == "tpu.verify"]
    assert lanes[0] == 64 and isinstance(lanes[1], str)  # formatted
    assert set(mine["ftpu"]["clock"]) == set(ref["ftpu"]["clock"])


def test_ring_drops_oldest_and_samples(traces):
    for mod in (tr, jtr):
        mod.configure(ring_size=4, sample_every=2)
        for i in range(9):
            with mod.span(f"s{i}"):
                pass
        with pytest.raises(KeyError):
            with mod.span("bad"):
                raise KeyError("x")
    assert [e[1] for e in tr.snapshot()] == [e[1] for e in jtr.snapshot()]
    assert tr.snapshot()[-1][1] == "bad"       # errors always record
    assert len(tr.snapshot()) == 4


def test_disabled_is_a_shared_noop(traces):
    tr.set_enabled(False)
    try:
        assert tr.span("a") is tr.span("b")
        assert not tr.enabled()
        with tr.span("a"):
            tr.instant("i")
            tr.observe_stage("s", 1.0)
        assert tr.observe_span("x", 0.0, 1.0) is None
        assert tr.traced("t")(lambda: 5)() == 5
        assert tr.snapshot() == [] and tr.stage_quantiles() == {}
    finally:
        tr.set_enabled(True)


def test_dump_and_rate_limited_auto_dump(traces):
    _drive(tr)
    path = tr.dump("manual")
    doc = json.load(open(path))
    assert doc["ftpu"]["reason"] == "manual"
    assert "device.ready.d0" in doc["ftpu"]["stage_quantiles"]
    tr.configure(dump_min_interval_s=3600.0)
    first = tr.auto_dump("cold_compile")
    assert first is not None and tr.auto_dump("cold_compile") is None
    tr.wait_dumps()
    assert json.load(open(first))["ftpu"]["reason"] == "cold_compile"


def test_bound_histogram_renders_like_reference(traces):
    """The trace_stage_seconds family renders the same in both packages
    (the reference's bind_metrics also declares its cluster-trace
    histograms, which the port leaves out)."""
    provs = (metrics.PrometheusProvider(), jmetrics.PrometheusProvider())
    for mod, prov in zip((tr, jtr), provs):
        mod.bind_metrics(prov)
        # measured intervals only: the sums must not depend on the clock
        for t in (0.00005, 0.0003, 0.002, 0.2, 7.0, 20.0):
            mod.observe_span("tpu.verify", 1.0, 1.0 + t)
            mod.observe_stage("device.ready.d0", t / 2)

    def family(text):
        return [ln for ln in text.splitlines()
                if ln.replace("# HELP ", "").replace("# TYPE ", "")
                .startswith("trace_stage_seconds")]
    mine = provs[0].render()
    assert family(mine) == family(provs[1].render())
    assert mine.splitlines() == family(mine)
    assert 'trace_stage_seconds_count{stage="tpu.verify"} 6' in mine


def test_opts_match_reference():
    names = [n for n in dir(metrics) if n.endswith("_OPTS")]
    assert len(names) == 24
    for n in names:
        mine, ref = getattr(metrics, n), getattr(jmetrics, n)
        assert type(mine).__name__ == type(ref).__name__, n
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), n


def test_disabled_provider_is_inert():
    p = metrics.DisabledProvider()
    g = p.new_gauge(metrics.BCCSP_COMPILE_TOTAL_OPTS).with_labels("a", "b")
    g.set(1.0)
    p.new_counter(metrics.CounterOpts(name="c")).add(2.0)
    p.new_histogram(metrics.TRACE_STAGE_SECONDS_OPTS).observe(0.1)


# -- the provider's spans on the CPU --

@pytest.fixture(scope="module")
def prepared_block():
    """64 digest lanes over 3 keys (every seventh tampered), prepared by
    the port's native batch prep, and a CPU provider whose 8-bit Q table
    for the key set is cached from Python ints."""
    import hashlib

    from fabric_tpu_torch import native
    from fabric_tpu_torch.bccsp import factory, sw, utils
    from tests.test_torch_comb import _q8_ints

    rng = np.random.default_rng(12)
    csp = sw.SWProvider()
    privs = [sw.ECDSAPrivateKey(int.from_bytes(rng.bytes(32), "big")
                                % (utils.P256_N - 1) + 1) for _ in range(3)]
    pubs = [k.public_key() for k in privs]
    n = 64
    key_idx = np.arange(n) % 3
    digests = np.zeros((n, 32), np.uint8)
    sigs = []
    for i in range(n):
        d = hashlib.sha256(rng.bytes(40)).digest()
        sig = csp.sign(privs[key_idx[i]], d)
        if i % 7 == 3:
            d = bytes([d[0] ^ 1]) + d[1:]
        sigs.append(sig)
        digests[i] = np.frombuffer(d, np.uint8)
    ok, r8, rpn8, w8 = native.batch_prep(sigs)
    want = [csp.verify(pubs[key_idx[i]], sigs[i], bytes(digests[i]))
            for i in range(n)]
    order = sorted(p.x_bytes().tobytes() + p.y_bytes().tobytes()
                   for p in pubs)
    keys = [(int.from_bytes(kb[:32], "big"), int.from_bytes(kb[32:], "big"))
            for kb in order]
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "Device": "cpu", "MinBatch": 4, "UseG16": False}})
    prov._q8_cache[tuple(order)] = torch.as_tensor(
        _q8_ints(keys + keys[:1]))
    args = dict(digests=digests, r=r8, rpn=rpn8, w=w8, der_ok=ok,
                key_idx=key_idx, keys=pubs, get_sig=sigs.__getitem__)
    return prov, args, want


def test_cpu_provider_spans_and_no_busy(prepared_block, traces):
    prov, args, want = prepared_block
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert not prov.device_cost.steady
        got = prov.verify_prepared(**args)
    finally:
        torch.set_num_threads(n)
    assert got == want and not all(want)
    names = [e[1] for e in tr.snapshot()]
    # the enqueue's tpu.verify holds the dispatcher's span; the wait has
    # its own tpu.verify, as in the reference's prepared path
    assert names == ["tpu.dispatch", "tpu.verify", "tpu.verify"]
    spans = _shape(tr.snapshot())
    assert spans[0][2] == "tpu.verify"
    assert all(s[4] is None for s in spans)
    assert prov.device_cost.steady
    assert prov.device_cost.busy.totals() == {}
    assert "device.ready.d0" not in tr.stage_quantiles()
