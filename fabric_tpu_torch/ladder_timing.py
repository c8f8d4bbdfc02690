#!/usr/bin/env python3
"""The Shamir ladder's time on the card, fresh and after the self-tests.

    python3 fabric_tpu_torch/ladder_timing.py [--root DIR] [--lanes 32768]

Times csrc/ladder.cu's digest-lanes and message entries of the package
under `--root` (default: this checkout) as chip_smoke.py's
ladder_vs_plain does, CUDA events around back-to-back calls: first in a
fresh CUDA context, then again after the root's own
`chip_smoke.field_vs_ints`, the self-test kernels that chip_smoke.py
launches before the ladder (in one checkout they hold the BN254 tower's
4.5 KB stack frame, in an older one they do not). Running it on two
checkouts in turns (for example a parent commit unpacked with `git
archive` into the git-ignored `chip_tree/`) tells a change of the code
from a change of the card. The lanes: `--lanes` random scalars over
`--keys` random public keys, 256-byte messages (5 live SHA blocks of 8),
every lane live. The ladder runs the same steps on every live lane (no
exit on data, csrc/ladder.cuh), so random rows cost what signatures do;
their verdicts are not read. Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--lanes", type=int, default=32768)
    ap.add_argument("--keys", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
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
    from fabric_tpu_torch.ops import verify

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
    h = _lanes(args.lanes, args.keys, args.seed)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    rows = (put(h["q8"]), put(h["r8"]), put(h["rpn8"]), put(h["w8"]),
            put(h["premask"]))
    dg = put(h["digests"].view(np.int32))
    entries = {
        "digests": (verify.ladder_verify_digests, (dg, *rows)),
        "message": (verify.ladder_verify, (
            put(h["blocks"].view(np.int32)), put(h["nblocks"]), dg,
            put(np.zeros(args.lanes, bool)), *rows))}

    def times():
        return {e: [_cuda_ms(lambda: fn(*a), args.reps)
                    for _ in range(args.rounds)]
                for e, (fn, a) in entries.items()}
    t0 = time.perf_counter()
    fresh = times()
    chip_smoke.field_vs_ints(card, args.seed)
    after = times()
    print(json.dumps({"ladder_timing": root, "card": card,
                      "lanes": args.lanes, "reps": args.reps,
                      "fresh_ms": fresh, "after_field_vs_ints_ms": after,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
