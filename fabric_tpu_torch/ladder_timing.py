#!/usr/bin/env python3
"""The P-256 kernels' time on the card beside the card's clock: the
Shamir ladder's two entries, the tree and the resident kernel, fresh and
after the self-tests, and the SASS of one field product.

    python3 fabric_tpu_torch/ladder_timing.py [--root DIR] [--lanes 32768]

Times the package under `--root` (default: this checkout), CUDA events
around `--reps` back-to-back calls a window, `--rounds` windows an
entry: csrc/ladder.cu's digest-lanes entry and the message entry
(`verify.ladder_verify`: one launch in older checkouts, the SHA kernel
and the digest entry since the one lane body), the tree kernel's points
entry at M = 32 and 64 points a lane (`ptree.tree_verify_points`) and
its windows entry at 8-bit windows (M = 64, the q8 route), and the
resident kernel (`fused_verify.fused_verify_resident`); first in a fresh
CUDA context, then again after the root's own `chip_smoke.field_vs_ints`,
the self-test kernels chip_smoke.py launches before the ladder.

Beside every window: the card's SM clock, its maximum, power draw and
temperature, from `nvidia-smi --query-gpu=clocks.sm,clocks.max.sm,
power.draw,temperature.gpu --loop-ms=20` polled in the background for the
whole run (the samples whose arrival falls inside the window; min,
median and max). Running it on two checkouts in turns (for example a
parent commit unpacked with `git archive` into the git-ignored
`chip_tree/`: parent, change, change, parent) tells a change of the code
from a change of the card's clock.

The lanes: `--lanes` random scalars over `--keys` random public keys,
256-byte messages (5 live SHA blocks of 8), every lane live. The ladder
runs the same steps on every live lane (no exit on data,
csrc/ladder.cuh), so random rows cost what signatures do; their
verdicts are not read. The tree and resident kernels take random
entries of the 8-bit G table as their points and tables (their work
does not depend on the values either).

It also builds one probe kernel, `out = fe_mul(a, b)` over the root's
csrc/p256_field.cuh, with nvcc for sm_90a and counts its SASS
instructions by opcode with `cuobjdump -sass` (`fe_mul_sass`; the
probe's loads, stores and exit are a few dozen of them). Prints one JSON
line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SMI_FIELDS = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu")
# a probe kernel over one of the root's field headers: header, element
# type, expression of a[i] and b[i]
PROBE = r"""
#include "%s"
extern "C" __global__ void probe(const %s* a, const %s* b, %s* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = %s;
}
"""


class ClockPoller:
    """nvidia-smi's clock, power and temperature every `period_ms`, in a
    background process read by a thread: (arrival time, values) pairs."""

    def __init__(self, period_ms: int = 20):
        self.samples: list = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader,nounits", f"--loop-ms={period_ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                vals = [float(v) for v in line.split(",")]
            except ValueError:
                continue
            if len(vals) == len(SMI_FIELDS):
                self.samples.append((time.perf_counter(), vals))

    def window(self, t0: float, t1: float) -> dict:
        """min, median and max of each field over [t0, t1]."""
        got = [v for t, v in list(self.samples) if t0 <= t <= t1]
        out = {"samples": len(got)}
        for i, name in enumerate(SMI_FIELDS):
            col = [v[i] for v in got]
            out[name] = ([min(col), statistics.median(col), max(col)]
                         if col else None)
        return out

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)


def _lanes(n: int, keys: int, seed: int):
    from fabric_tpu_torch.ops import p256, sha256

    rng = np.random.default_rng(seed)
    g = (p256.GX, p256.GY, 1)
    pubs = []
    for d in rng.integers(1, 1 << 62, size=keys).tolist():
        x, y = p256.to_affine_int(p256.scalar_mul_int(int(d), g))
        pubs.append(x.to_bytes(32, "big") + y.to_bytes(32, "big"))
    q8 = np.frombuffer(b"".join(pubs), np.uint8).reshape(keys, 64)[
        rng.integers(0, keys, size=n)]
    msgs = [rng.bytes(256) for _ in range(n)]
    dg = np.stack([np.frombuffer(hashlib.sha256(m).digest(), np.uint8)
                   for m in msgs])
    blocks, counts = sha256.pack_messages(msgs, 8)
    r8, rpn8, w8 = (rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
                    for _ in range(3))
    return dict(blocks=blocks, nblocks=counts.astype(np.int32),
                digests=dg.view(">u4").astype(np.uint32), q8=q8, r8=r8,
                rpn8=rpn8, w8=w8, premask=np.ones(n, bool))


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe_sass(root: str, header: str, elem: str, expr: str) -> dict:
    """The SASS instruction count and opcode mix of a probe kernel that
    stores `expr` (of a[i], b[i], `elem` values) over the root's
    csrc/`header`."""
    from fabric_tpu_torch import kernels

    nvcc = kernels.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    csrc = os.path.join(root, "fabric_tpu_torch", "csrc")
    with tempfile.TemporaryDirectory() as d:
        src, cubin = os.path.join(d, "probe.cu"), os.path.join(d, "p.cubin")
        with open(src, "w") as f:
            f.write(PROBE % (header, elem, elem, elem, expr))
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-cubin", "-I", csrc, "-o",
                        cubin, src], check=True, capture_output=True,
                       timeout=300)
        out = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                             capture_output=True, text=True,
                             timeout=120).stdout
    mix: dict = {}
    for ln in out.splitlines():
        m = kernels._SASS_OP.match(ln)
        if m:
            mix[m.group(1)] = mix.get(m.group(1), 0) + 1
    mix.pop("NOP", None)
    return {"instructions": sum(mix.values()),
            "mix": dict(sorted(mix.items(), key=lambda kv: -kv[1]))}


def fe_mul_sass(root: str) -> dict:
    """The probe `fe_mul`'s SASS instruction count and its opcode mix."""
    return probe_sass(root, "p256_field.cuh", "Fe", "fe_mul(a[i], b[i])")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--lanes", type=int, default=32768)
    ap.add_argument("--keys", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("ladder_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from fabric_tpu_torch.ops import comb, fused_verify, limb, ptree, verify

    # the G table is built in this process, not cached under HOME
    os.environ.setdefault(comb.GTAB_CACHE_ENV, "")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
    sass = fe_mul_sass(root)
    h = _lanes(args.lanes, args.keys, args.seed)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    rows = (put(h["q8"]), put(h["r8"]), put(h["rpn8"]), put(h["w8"]),
            put(h["premask"]))
    dg = put(h["digests"].view(np.int32))
    blocks, nblocks = put(h["blocks"].view(np.int32)), put(h["nblocks"])
    no_digest = put(np.zeros(args.lanes, bool))
    # the tree and resident kernels' inputs: entries of the 8-bit G table
    rng = np.random.default_rng(args.seed + 1)
    g8 = comb.g_tables()
    g_tab = put(g8)
    q_tab = put(np.concatenate([g8] * 3))
    n_ent = comb.NWIN * comb.NENT
    r_l = put(limb.ints_to_limbs([1] * args.lanes))
    win = put(rng.integers(0, comb.NENT, size=(args.lanes, comb.NWIN),
                           dtype=np.int32))
    key_idx = put(rng.integers(0, 3, size=args.lanes, dtype=np.int32))
    pts = {M: put(g8[rng.integers(0, n_ent, size=(args.lanes, M))])
           for M in (32, 64)}
    entries = {
        "ladder_digests": lambda: verify.ladder_verify_digests(dg, *rows),
        "ladder_message": lambda: verify.ladder_verify(
            blocks, nblocks, dg, no_digest, *rows),
        "tree_points_32": lambda: ptree.tree_verify_points(
            pts[32], r_l, r_l, rows[4]),
        "tree_points_64": lambda: ptree.tree_verify_points(
            pts[64], r_l, r_l, rows[4]),
        "tree_windows_64": lambda: ptree.tree_verify_windows(
            win, win, key_idx, g_tab, q_tab, 3, comb.WBITS, comb.WBITS,
            rows[1], rows[2], rows[4]),
        "resident": lambda: fused_verify.fused_verify_resident(
            blocks, nblocks, key_idx, q_tab, rows[1], rows[2], rows[3],
            rows[4], dg, no_digest, g_tab)}
    poller = ClockPoller()
    try:
        def times():
            out = {}
            for e, fn in entries.items():
                out[e] = []
                for _ in range(args.rounds):
                    t0 = time.perf_counter()
                    ms = _cuda_ms(fn, args.reps)
                    t1 = time.perf_counter()
                    out[e].append({"ms": ms, **poller.window(t0, t1)})
            return out
        t0 = time.perf_counter()
        fresh = times()
        chip_smoke.field_vs_ints(card, args.seed)
        after = times()
        seconds = time.perf_counter() - t0
    finally:
        poller.stop()
    print(json.dumps({"ladder_timing": root, "card": card,
                      "lanes": args.lanes, "reps": args.reps,
                      "fe_mul_sass": sass, "fresh": fresh,
                      "after_field_vs_ints": after, "seconds": seconds}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
