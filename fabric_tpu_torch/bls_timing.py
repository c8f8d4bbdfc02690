#!/usr/bin/env python3
"""The BLS12-381 pairing entries' times on the card, and verify_aggregate's.

    python3 fabric_tpu_torch/bls_timing.py [--root DIR] [--reps 20]
        [--call-reps 5] [--widths 3,7,15,31,1023] [--seed 7]

Times the package under `--root` (default: this checkout) on one orderer
identity's span of 1,023 block signatures (made from `--seed`, signed in
a process pool once and kept in this checkout's git-ignored
fabric_tpu_torch/_build/, so that runs on several checkouts time the same
pairs):

  * the Miller entry at 4 lanes (the k = 3 bucket) and at 1,024 (the span,
    k = 1,023), the reduce over those 4 and 1,024 lanes (its launches a
    call beside) and the final-exp entry on one lane (the span's product),
    each `--reps` calls back to back between two CUDA events after one
    warm-up call: ms a call; and the final-exp entry on short programs
    (no row; the easy part; the easy part then 64 squarings, or 64
    products): a row's cost by difference;
  * CUDAProvider.verify_aggregate on the span's first k signatures, k = 3,
    7, 15, 31 and 1,023 (`--widths`): after one warm-up call,
    `--call-reps` calls on the host's clock (their median) (ms a call, each call ending in its
    verdict) and the card's busy ms a call from the provider's CUDA events
    (device_cost.busy, their median); every verdict must be True.

Beside them: the library's build seconds and whether nvcc wrote it (cold:
the first run on a checkout), ptxas' registers, stack and spills of the
Miller, reduce and final-exp kernels, and the sha256 of the entries'
canonical outputs (runs on two checkouts must print the same). Running it on two
checkouts in turns (for example a parent commit unpacked with `git
archive` into the git-ignored `chip_tree/`: parent, change, change,
parent) compares them on one card. Prints one JSON line; needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import pickle
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
WIDTHS = (3, 7, 15, 31, 1023)
ROWS = 64                   # rows of the final-exp breakdown's programs


def _sign_chunk(jobs):
    from fabric_tpu_torch.ops import bls12_381_ref as b
    return [b.bls_sign(sk, m) for sk, m in jobs]


def make_span(seed: int, n: int) -> dict:
    """One key's signatures over n messages, and the aggregate of the
    first k for every k (ints of this checkout's reference), cached by
    (seed, n) in this checkout's build directory."""
    path = os.path.join(HERE, "_build", f"bls_span-{seed}-{n}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    from fabric_tpu_torch.ops import bls12_381_ref as b
    rng = np.random.default_rng(seed + 5)
    sk, pk = b.bls_keygen(rng.bytes(32))
    msgs = [b"block %d|" % i + rng.bytes(48) for i in range(n)]
    nproc = os.cpu_count() or 1
    chunks = [[(sk, m) for m in msgs[i::nproc]] for i in range(nproc)]
    with mp.get_context("spawn").Pool(nproc) as pool:
        parts = pool.map(_sign_chunk, chunks)
    sigs = [None] * n
    for i, part in enumerate(parts):
        sigs[i::nproc] = part
    aggs, acc = [], None
    for s in sigs:
        acc = b.g1_add(acc, s)
        aggs.append(acc)
    span = dict(pk=pk, msgs=msgs, aggs=aggs)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(span, f)
    os.replace(path + ".tmp", path)
    return span


def _events_ms(fn, reps: int) -> float:
    """ms a call of `reps` back-to-back calls between two CUDA events,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _sha(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--call-reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    args = ap.parse_args()
    widths = [int(k) for k in args.widths.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("bls_timing: no CUDA device", file=sys.stderr)
        return 2
    span = make_span(args.seed, max(widths))

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("fabric_tpu_torch")]:
        del sys.modules[name]
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.bccsp import factory, sw
    from fabric_tpu_torch.ops import bls12_381 as blsagg
    from fabric_tpu_torch.ops import bls12_381_kernel as blsk
    from fabric_tpu_torch.ops import bls12_381_ref as b
    from fabric_tpu_torch.ops import tower

    lib = "bls12_381_pairing"
    cold = not os.path.exists(kernels.library_path(lib))
    t0 = time.perf_counter()
    kernels.load(lib)
    out = {"root": root, "card": torch.cuda.get_device_name(0),
           "build_s": time.perf_counter() - t0, "build_cold": cold,
           "ptxas": {k: v for k, v in kernels.ptxas_summary(lib).items()
                     if "miller" in k or "final_exp" in k
                     or "reduce" in k},
           "reps": args.reps}

    dev = torch.device("cuda:0")
    n = max(widths)
    pairs = blsagg.stage_pairs([span["pk"]] * n, span["msgs"][:n],
                               span["aggs"][n - 1])
    st = blsk.to_device(blsk.stage_pairs(pairs), dev)
    entries = {}
    for lanes in (4, len(pairs)):
        s = [t[:lanes].contiguous() for t in st]
        Q = ((s[2], s[3]), (s[4], s[5]))

        def miller(s=s, Q=Q):
            return blsk.miller_loop_batch(s[0], s[1], Q, mask=s[6])
        f = tower.flat_from_f12(miller())
        entries[f"miller_{lanes}"] = dict(
            ms=_events_ms(miller, args.reps), sha256=_sha(f))
    # the reduce over the span's lanes and over k = 3's 4: ms a call and
    # its launches (one since the one-launch design, log2(B) before)
    for lanes in (4, f.shape[1]):
        fl = tower.f12_from_flat(f[:, :lanes].contiguous())
        r0 = blsk.reduce_launches
        red = tower.flat_from_f12(blsk.product_reduce(fl))
        entries[f"reduce_{lanes}"] = dict(
            launches=blsk.reduce_launches - r0, sha256=_sha(red),
            ms=_events_ms(lambda fl=fl: blsk.product_reduce(fl), args.reps))
    prod = tower.flat_from_f12(blsk.product_reduce(
        tower.f12_from_flat(f))).contiguous()
    prog = blsk._FINAL_EXP_PROGRAM
    gt, ok = blsk._final_exp_kernel(prod, prog)
    entries["final_exp_1"] = dict(
        ms=_events_ms(lambda: blsk._final_exp_kernel(prod, prog),
                      args.reps),
        sha256=_sha(gt), verdict=bool(ok.cpu()[0]))
    # the final-exp entry on short programs: no row (the load, 1/f and
    # the store), the easy part alone, and the easy part then ROWS
    # squarings of m (cyclotomic where the entry lowers them) or ROWS
    # products m * m^(p^2): each row's cost by difference
    easy = np.asarray(prog)[:5]
    rows = {"none": easy[:0], "easy": easy,
            "cyc": np.concatenate([easy, [[0, 2, 2, 2]] * ROWS]),
            "mul": np.concatenate([easy, [[0, 2, 2, 6]] * ROWS])}
    entries["final_exp_programs"] = {
        name: _events_ms(lambda p=p: blsk._final_exp_kernel(prod, p),
                         args.reps) for name, p in rows.items()}
    out["entries"] = entries

    prov = factory.new_bccsp({"Default": "CUDA"})
    key = sw.BLSPublicKey(b.g2_to_bytes(span["pk"]))
    calls = {}
    for k in widths:
        keys, msgs = [key] * k, span["msgs"][:k]
        sig = b.g1_to_bytes(span["aggs"][k - 1])
        if prov.verify_aggregate(keys, msgs, sig) is not True:
            raise SystemExit(f"bls_timing: k={k} did not verify")
        walls, busy = [], []
        for _ in range(args.call_reps):
            b0 = prov.device_cost.busy.totals().get(0, 0.0)
            t0 = time.perf_counter()
            if prov.verify_aggregate(keys, msgs, sig) is not True:
                raise SystemExit(f"bls_timing: k={k} did not verify")
            walls.append(time.perf_counter() - t0)
            busy.append(prov.device_cost.busy.totals().get(0, 0.0) - b0)
        calls[str(k)] = dict(wall_ms=statistics.median(walls) * 1e3,
                             busy_ms=statistics.median(busy) * 1e3)
    out["verify_aggregate"] = calls
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
