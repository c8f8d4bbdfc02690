#!/usr/bin/env python3
"""The Ed25519 kernel's time on the card beside the card's clock.

    python3 fabric_tpu_torch/ed_timing.py [--root DIR] [--widths
        32768,2048] [--reps 10] [--rounds 3] [--seed 7]

Times the package under `--root` (default: this checkout):
`ed25519.ed25519_verify` on its own table (`ed25519.device_table`) at
each width of `--widths`, `--rounds` windows of `--reps` back-to-back
calls between two CUDA events after one warm-up call (ms a call). The
lanes: 4,096 Ed25519 signatures over 256-byte messages by 64 keys (made
from `--seed`, signed in a process pool), every 50th message flipped
after signing, staged by the host prep (`ed25519_host.prep_verify`,
`ed25519.stage_rows`) and tiled to the width; every lane live but the
flipped ones, whose verdicts are False. The kernel runs the same steps
on every live lane, so the tiling costs what distinct signatures would.

Beside every window: the card's SM clock, its maximum, power draw and
temperature (ladder_timing.ClockPoller: nvidia-smi polled every 20 ms in
the background; min, median and max of the samples inside the window).
Beside the times: the library's build seconds, ptxas' registers, stack
and spills of each kernel, the SASS instruction count of one field
product and one squaring (a probe over the root's csrc/fe25519.cuh;
the squaring where the root has f25_sqr), and the sha256 of the verdicts
(runs on two checkouts must print the same). Running it on two checkouts
in turns (for example a parent commit unpacked with `git archive` into
the git-ignored `chip_tree/`: parent, change, change, parent) compares
them on one card. Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from fabric_tpu_torch.ladder_timing import (  # noqa: E402
    ClockPoller, _cuda_ms, probe_sass)

WIDTHS = (32768, 2048)
LANES, KEYS = 4096, 64


def _sign_chunk(jobs):
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    return [edh.sign(seed, msg) for seed, msg in jobs]


def make_rows(seed: int):
    """LANES lanes' operand rows (ed25519.stage_rows of the host prep) and
    the expected verdicts, from `seed`."""
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    from fabric_tpu_torch.ops import ed25519
    rng = np.random.default_rng(seed + 3)
    seeds = [rng.bytes(32) for _ in range(KEYS)]
    pks = [edh.public_from_seed(s) for s in seeds]
    key_of = rng.integers(KEYS, size=LANES).tolist()
    msgs = [rng.bytes(256) for _ in range(LANES)]
    nproc = os.cpu_count() or 1
    jobs = [(seeds[k], m) for k, m in zip(key_of, msgs)]
    with mp.get_context("spawn").Pool(nproc) as pool:
        parts = pool.map(_sign_chunk, [jobs[i::nproc] for i in range(nproc)])
    sigs = [None] * LANES
    for i, part in enumerate(parts):
        sigs[i::nproc] = part
    want = np.ones(LANES, bool)
    for i in range(0, LANES, 50):
        msgs[i] = bytes([msgs[i][0] ^ 1]) + msgs[i][1:]
        want[i] = False
    prep = [edh.prep_verify(pks[k], s, m)
            for k, s, m in zip(key_of, sigs, msgs)]
    return ed25519.stage_rows(prep, LANES), want


def f25_sass(root: str) -> dict:
    """SASS instructions of one f25_mul and one f25_sqr (probe kernels over
    the root's csrc/fe25519.cuh; the probe's loads, stores and exit are a
    few dozen of them), the squaring where the root has one."""
    with open(os.path.join(root, "fabric_tpu_torch", "csrc",
                           "fe25519.cuh")) as f:
        has_sqr = "f25_sqr(" in f.read()
    exprs = {"f25_mul": "f25_mul(a[i], b[i])", "f25_sqr": "f25_sqr(a[i])"}
    return {name: probe_sass(root, "fe25519.cuh", "F25", e)["instructions"]
            for name, e in exprs.items() if has_sqr or name == "f25_mul"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    widths = [int(w) for w in args.widths.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("ed_timing: no CUDA device", file=sys.stderr)
        return 2
    rows, want = make_rows(args.seed)

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("fabric_tpu_torch")]:
        del sys.modules[name]
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import ed25519

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
    lib = "ed25519_verify"
    cold = not os.path.exists(kernels.library_path(lib))
    t0 = time.perf_counter()
    kernels.load(lib)
    out = {"ed_timing": root, "card": card,
           "build_s": time.perf_counter() - t0, "build_cold": cold,
           "ptxas": kernels.ptxas_summary(lib), "sass": f25_sass(root),
           "reps": args.reps}
    dev = torch.device("cuda:0")
    tab = ed25519.device_table(dev)
    poller = ClockPoller()
    times, digests = {}, {}
    try:
        for w in widths:
            reps = -(-w // LANES)
            t = [torch.from_numpy(np.ascontiguousarray(
                np.concatenate([a] * reps)[:w])).to(dev) for a in rows]
            expect = np.concatenate([want] * reps)[:w]

            def call(t=t):
                return ed25519.ed25519_verify(tab, *t)
            got = call().cpu().numpy()
            if not (got == expect).all():
                raise SystemExit(f"ed_timing: wrong verdicts at {w} lanes")
            digests[str(w)] = hashlib.sha256(got.tobytes()).hexdigest()[:16]
            windows = []
            for _ in range(args.rounds):
                t0 = time.perf_counter()
                ms = _cuda_ms(call, args.reps)
                windows.append({"ms": ms, **poller.window(
                    t0, time.perf_counter())})
            times[str(w)] = windows
    finally:
        poller.stop()
    out.update(times=times, verdict_sha256=digests)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
