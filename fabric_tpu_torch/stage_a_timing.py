#!/usr/bin/env python3
"""Device time of stage A's kernels on the card, read from the profiler.

    python3 fabric_tpu_torch/stage_a_timing.py [--root DIR] [--lanes 32768]

Stage A's kernels run for tens of microseconds, less than their Python
wrappers take to check and launch them, so CUDA events around repeated
wrapper calls time the host. This script times each kernel's own
execution: it launches each entry `--reps` times under torch.profiler
and averages the device time of the kernel's events. The package timed
is the one under `--root` (default: this checkout), so one call can time
two checkouts in turns (for example a parent commit unpacked into a
git-ignored directory). It prints one JSON line per entry and measures
stage A at the main path's shape: `--lanes` lanes of 256-byte messages
(5 live SHA blocks of a bucket of 8), every 16th lane a digest lane.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import numpy as np


# where each kernel's last `device_ms` came from: "profiler" or
# "queued_events" (read by chip_smoke.py into its lines)
MS_FROM: dict = {}


def device_ms(fn, reps: int, name: str, windows: int = 5,
              pad_s: float = 0.05) -> float:
    """Mean device time (ms) of the CUDA kernels whose name holds `name`
    over `reps` calls of fn, warmed up first, read from torch.profiler.

    On the H100 the profiler has dropped the later kernels of a window
    that closed just after them (it kept 1 of 5 resident kernels in each
    of three windows once, and no ladder kernel in three windows of one
    call). So each window stays open `pad_s` seconds before the first
    call and after the last kernel has finished, the mean is over the
    events kept, and a window that kept fewer than half the calls is
    profiled again, up to `windows` times. If none kept them, the time
    is `queued_ms`'s: the card's time for all of fn's work, without the
    host's."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kept = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and name in ev.name]
        kept.append(len(us))
        if reps // 2 <= len(us) <= reps and us:
            MS_FROM[name] = "profiler"
            return sum(us) / len(us) / 1e3
    print(f"device_ms: {name}: the profiler kept {kept} kernel events of "
          f"{reps} calls in {windows} windows; timing with queued CUDA "
          "events", file=sys.stderr, flush=True)
    MS_FROM[name] = "queued_events"
    return queued_ms(fn, reps)


def queued_ms(fn, reps: int, hold_ms: float = 50.0) -> float:
    """Mean time (ms) of `reps` calls of fn on the card alone: CUDA
    events around the calls, queued behind a kernel that holds the
    stream for at least `hold_ms` (torch.cuda._sleep, at most 2 GHz), so
    every call is launched before the first one runs and the host's work
    falls outside the events. Raises if the hold ended before the last
    call was queued (fn waited for the card, or the host was slower)."""
    import torch

    fn()
    torch.cuda.synchronize()
    held = torch.cuda.Event()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms * 2e6))
    held.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if held.query():
        raise RuntimeError(f"queued_ms: the {hold_ms} ms hold ended before "
                           f"{reps} calls were queued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--lanes", type=int, default=32768)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("stage_a_timing: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.ops import fused_verify as fv
    from fabric_tpu_torch.ops import limb, p256, sha256

    B, N = args.lanes, p256.N
    rng = np.random.default_rng(args.seed)
    raw = rng.bytes(256 * B)
    blocks, counts = sha256.pack_messages(
        [raw[256 * i:256 * (i + 1)] for i in range(B)], 8)
    has = np.zeros(B, bool)
    has[15::16] = True
    nblocks = np.where(has, 0, counts).astype(np.int32)
    digests = rng.integers(0, 1 << 32, size=(B, 8), dtype=np.uint32)
    r8, w8 = (np.stack([np.frombuffer(
        (int.from_bytes(rng.bytes(32), "big") % N).to_bytes(32, "big"),
        np.uint8) for _ in range(B)]) for _ in range(2))
    dev = torch.device("cuda", 0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    blocks_t, nblocks_t, counts_t = (put(blocks.view(np.int32)),
                                     put(nblocks), put(counts))
    dig_t, has_t, r8_t, w8_t = (put(digests.view(np.int32)), put(has),
                                put(r8), put(w8))
    # the checkout's stage A takes r and w as limbs (before the 32-bit
    # redesign) or as the host's bytes
    takes_limbs = "r_l" in inspect.signature(fv.sha_windows).parameters
    r_arg, w_arg = ((limb.be_bytes_to_limbs(r8_t),
                     limb.be_bytes_to_limbs(w8_t)) if takes_limbs
                    else (r8_t, w8_t))
    card = torch.cuda.get_device_name(0)
    live = int(nblocks.sum())
    rows = []
    for wb in (8, 16):
        rows.append(("sha_windows", wb, device_ms(
            lambda: fv.sha_windows(blocks_t, nblocks_t, dig_t, has_t, r_arg,
                                   w_arg, wbits_g=wb, wbits_q=wb),
            args.reps, "sha_windows_kernel")))
        if hasattr(fv, "digest_windows"):
            rows.append(("digest_windows", wb, device_ms(
                lambda: fv.digest_windows(dig_t, r8_t, w8_t, wbits_g=wb,
                                          wbits_q=wb),
                args.reps, "digest_windows_kernel")))
    rows.append(("sha256_blocks", None, device_ms(
        lambda: sha256.sha256_blocks(blocks_t, counts_t), args.reps,
        "sha256_digest_kernel")))
    for entry, wb, ms in rows:
        print(json.dumps({"root": root, "entry": entry, "wbits": wb,
                          "lanes": B, "live_blocks": (
                              int(counts.sum()) if wb is None else live),
                          "device_ms": ms, "card": card,
                          "reps": args.reps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
