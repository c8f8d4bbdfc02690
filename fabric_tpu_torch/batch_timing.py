#!/usr/bin/env python3
"""`CUDAProvider.verify_batch`'s wall time for a block on the card.

    python3 fabric_tpu_torch/batch_timing.py [--root DIR] [--txs 10240]

Times the provider of the package under `--root` (default: this
checkout) on two blocks of 3 x `--txs` P-256 message lanes (256-byte
messages): the org block over 3 keys (the comb, fused tier, G16/Q16) and
the client block over 1,024 keys (the Shamir ladder). Each block's lanes
cycle over one valid signature per key, so the host's staging does a
block's work per call (every lane is parsed, gated and prepared on its
own) while signing stays cheap; every verdict must be True. After one
warm-up call per block (table builds, library builds), `--reps` calls
are timed on the host's clock, each ending in the verdicts' copy back.
On the org block it then times `--commit-reps` calls of the commit path,
`verify_prepared` over the block's operands as `native.batch_prep` and
the digests stage them (the tables warm).
Running it on two checkouts in turns (for example a parent commit
unpacked with `git archive` into the git-ignored `chip_tree/`) compares
their host stages on one card. Prints one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def _prepared(items, keys: int) -> dict:
    """`verify_prepared`'s operands for a block made by `_block`."""
    from fabric_tpu_torch import native

    sigs = [it.signature for it in items]
    der_ok, r, rpn, w = native.batch_prep(sigs)
    digests = np.frombuffer(b"".join(hashlib.sha256(it.message).digest()
                                     for it in items), np.uint8)
    return dict(digests=digests.reshape(len(items), 32), r=r, rpn=rpn, w=w,
                der_ok=der_ok,
                key_idx=np.arange(len(items), dtype=np.int64) % keys,
                keys=[it.key for it in items[:keys]],
                get_sig=sigs.__getitem__)


def _block(keys: int, lanes: int, seed: int):
    from fabric_tpu_torch.bccsp import bccsp as api
    from fabric_tpu_torch.bccsp import p256_host, sw, utils

    rng = np.random.default_rng(seed)
    signed = []
    for _ in range(keys):
        d = int.from_bytes(rng.bytes(32), "big") % (p256_host.N - 1) + 1
        msg = rng.bytes(256)
        r, s = p256_host.sign(d, hashlib.sha256(msg).digest())
        signed.append((sw.ECDSAPublicKey(*p256_host.derive_public(d)), msg,
                       utils.marshal_signature(r, utils.to_low_s(s))))
    return [api.VerifyItem(key=signed[i % keys][0],
                           signature=signed[i % keys][2],
                           message=signed[i % keys][1])
            for i in range(lanes)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--txs", type=int, default=10240)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--commit-reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("batch_timing: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.bccsp import factory

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
    out = {"batch_timing": root, "card": card, "lanes": 3 * args.txs}
    for name, keys in (("org", 3), ("client", 1024)):
        items = _block(keys, 3 * args.txs, args.seed)
        prov = factory.new_bccsp({"Default": "CUDA"})
        t0 = time.perf_counter()
        first = prov.verify_batch(items)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            got = prov.verify_batch(items)
            times.append(time.perf_counter() - t0)
            if not (all(got) and all(first)):
                raise RuntimeError(f"{name}: a valid lane was rejected")
        out[name] = {"keys": keys, "first_call_s": first_s,
                     "verify_batch_s": times,
                     "comb_batches": prov.stats["comb_batches"],
                     "fused_batches": prov.stats["fused_batches"],
                     "ladder_batches": prov.stats["ladder_batches"]}
        if name != "org":
            continue
        pr = _prepared(items, keys)
        commit = []
        for _ in range(args.commit_reps):
            t0 = time.perf_counter()
            got = prov.verify_prepared(**pr)
            commit.append(time.perf_counter() - t0)
            if not all(got):
                raise RuntimeError("org commit path: a valid lane was "
                                   "rejected")
        out[name]["verify_prepared_s"] = commit
        out[name]["verify_prepared_median_s"] = statistics.median(commit)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
