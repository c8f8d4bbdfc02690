#!/usr/bin/env python3
"""What the provider's telemetry costs the commit path on the card.

    python3 fabric_tpu_torch/telemetry_timing.py [--txs 10240] [--calls 60]

Times `CUDAProvider.verify_prepared` on the org block (3 x `--txs`
digest lanes over 3 keys, `batch_timing.py`'s block, tables warm) in
turns across four arms, `--calls` calls each on the host's clock:

  on         spans and the busy events, as the provider ships them (the
             events drawn from the provider's free list);
  spans_off  `tracing.set_enabled(False)`: the busy events alone;
  bare       tracing off and the provider's `_mark` stubbed out: neither;
  fresh      spans on, each call's events made anew (no free list).

Then the host cost of each telemetry step alone, in microseconds, over
`--reps` repetitions: an event pair made anew and recorded on an idle
stream, the same pair reused, one elapsed-time reading and busy note, a
`_dispatch_span` with tracing on and off, and one `observe_stage`.
Each timed call follows an untimed one in the same arm, so the free list
holds a pair. Prints one JSON line with the card's name and power limit;
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _us(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--txs", type=int, default=10240)
    ap.add_argument("--calls", type=int, default=60)
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import torch
    if not torch.cuda.is_available():
        print("telemetry_timing: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch import batch_timing
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.common import tracing

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
    items = batch_timing._block(3, 3 * args.txs, args.seed)
    pr = batch_timing._prepared(items, 3)
    prov = factory.new_bccsp({"Default": "CUDA"})
    if not all(prov.verify_batch(items)):
        raise RuntimeError("a valid lane was rejected")
    for _ in range(3):
        prov.verify_prepared(**pr)

    shipped_mark, shipped_note = prov._mark, prov._note_busy

    def fresh_mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(prov.device))
        return ev

    def arm(name):
        tracing.set_enabled(name in ("on", "fresh"))
        prov.__dict__.pop("_mark", None)
        prov._events.clear()
        if name == "bare":
            prov._mark = lambda: None
        elif name == "fresh":
            prov._mark = fresh_mark

    arms = ("on", "spans_off", "bare", "fresh")
    times: dict = {a: [] for a in arms}
    try:
        for i in range(args.calls):
            for a in arms[i % 4:] + arms[:i % 4]:
                arm(a)
                prov.verify_prepared(**pr)      # the free list refilled
                t0 = time.perf_counter()
                got = prov.verify_prepared(**pr)
                times[a].append(time.perf_counter() - t0)
                if not all(got):
                    raise RuntimeError(f"{a}: a valid lane was rejected")
    finally:
        arm("on")

    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(prov.device)

    def fresh_pair():
        for _ in range(2):
            torch.cuda.Event(enable_timing=True).record(stream)

    pool = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def pooled_pair():
        for ev in pool:
            ev.record(stream)

    start, end = shipped_mark(), shipped_mark()
    end.synchronize()

    def span(on):
        tracing.set_enabled(on)

        def run():
            with prov._dispatch_span():
                pass
        return run

    micro = {"fresh_event_pair_us": _us(fresh_pair, args.reps),
             "reused_event_pair_us": _us(pooled_pair, args.reps),
             "elapsed_and_note_us": _us(lambda: shipped_note(start, end),
                                        args.reps),
             "dispatch_span_on_us": _us(span(True), args.reps),
             "dispatch_span_off_us": _us(span(False), args.reps)}
    tracing.set_enabled(True)
    micro["observe_stage_us"] = _us(
        lambda: tracing.observe_stage("device.ready.d0", 1e-3), args.reps)
    prov._events.clear()
    torch.cuda.synchronize()
    print(json.dumps({
        "telemetry_timing": card, "lanes": 3 * args.txs,
        "calls": args.calls,
        "median_ms": {a: statistics.median(t) * 1e3
                      for a, t in times.items()},
        "all_ms": {a: [x * 1e3 for x in t] for a, t in times.items()},
        "host_us": micro}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
