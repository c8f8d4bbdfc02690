#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold every kernel to
its plain version.

    python3 chip_smoke.py [--seed 7] [--txs 10240]

Phases, one JSON line each; any failure exits non-zero:

  device           the card (and nvidia-smi's name and power limit);
                   no CUDA device -> exit 2, nothing printed
  build            every kernel under fabric_tpu_torch/csrc, one nvcc per
                   source, started together; ptxas registers, stack and
                   spills per kernel (stage A's and the resident kernel's
                   must have no stack and no spills); the SASS mix
  field_vs_ints    the P-256 field core (csrc/p256_field.cuh) built by nvcc
                   (csrc/field_selftest.cu) against Python ints: mul, add,
                   sub and the 13-bit conversion on edge operands (0, 1,
                   p - 1, p, p + 1, 2^256 - 1, 2^256 + 2^243 - 1) and seeded
                   random ones, RCB15 Alg. 4 on P + P, P + (-P), P + inf,
                   inf + inf and random points; and the mod-n core
                   (csrc/modn32.cuh) on e = 0, 1, n - 1, n, n + 1,
                   2^256 - 1 against w = 1, n - 1 and r = 1, n - 1, and
                   seeded random ones; words equal
  block            a block made from --seed: --txs transactions x (2
                   endorsements + 1 creator) P-256 signatures over 3 org
                   keys, 256-byte messages, ~1% bad lanes of five kinds
                   (message flipped after signing, high-S, mangled DER,
                   checked against the wrong org's key, r >= n)
  main_path        the block through CUDAProvider (new_bccsp), route by
                   route, each path driven with every kernel count set to
                   0 just before it and read just after:
                     q16  G16/Q16 resident: verify_prepared (digest lanes,
                          the commit path: stage A's digest-lanes entry at
                          16/16 bits, then the tree kernel's windows entry,
                          which gathers by itself, at M = 32) and
                          verify_batch (message lanes, the fused tier:
                          sha_windows at 16/16 bits, then the windows
                          entry);
                     q8   "UseG16": false: the same at M = 64 and 8/8 bits;
                     q8_resident  the q8 provider's verify_batch with
                          FTPU_FUSED_RESIDENT=1: the resident kernel;
                     device_sha  "HashOnHost": false, "FusedVerify": false:
                          verify_batch hashes on the card (the digest-only
                          SHA-256 kernel), then the comb-digest pipeline
                          (stage A's digest-lanes entry, the tree).
                   Bitmaps must equal the expected one and the port's sw
                   provider on a sample of >= 2,048 lanes holding every bad
                   lane; each path's kernels must have launched; message
                   paths must show fused_batches >= 1 (fused routes) and
                   host_hashed_lanes == 0. Each verify_prepared must raise
                   the stage-A and tree counts by one per chunk. One
                   steady verify_prepared per comb route runs under
                   torch.profiler (the card's busy and idle share of the
                   call; fewer than 20 kernels, and no index_select gather
                   kernel, may run in it); on q16, verify_batch then runs
                   in turns on the fused tier and with hashlib
                   (FTPU_FUSED=0).
  kernel_vs_plain  both entries of the tree kernel against their plain
                   torch versions on the card at the main path's shape
                   (the block's 32,768-lane bucket, M = 32 and 64, windows
                   and tables of the providers' routes), the first 4,096
                   lanes made edge cases: all windows 0 (all infinity),
                   half of them 0, premask off, rpn = x(R) with a wrong r,
                   a wrong r, a key slot out of range (both entries), and
                   in the gathered points alone P + P, P + (-P), a sum at
                   infinity (the points entry). The bitmaps must equal the
                   plain versions, and Python-int sums on every edge lane,
                   every bad lane and 256 others. Kernel and plain times
                   are CUDA events around warmed-up runs, with one row per
                   threads-per-lane count T in 1, 2, 4, 8; each bound is
                   computed from the shapes and this run's data
                   (tree_bound, sha_bound, resident_bound).
  sha_vs_plain     the stage-A kernel (csrc/sha_windows.cu) against its
                   plain torch versions at the main path's shape (32,768
                   lanes, NB = 8 blocks for 256-byte messages): the message
                   entry at 8/8 and 16/16 bits, the digest-lanes entry at
                   8/8 and 16/16 bits (every lane's digest; lane 0's digest
                   n), and the digest-only entry: first lanes rewritten
                   into edge cases (message lengths 0, 1, 55, 56, 63, 64,
                   119, 120, 503; digest lanes with digest 0 and all-ones;
                   w = 1, w = n - 1, r = 1), garbage in every block past a
                   lane's count. Windows and words equal on every lane,
                   words equal hashlib, edge windows equal Python ints.
  resident_vs_plain  the resident kernel (csrc/fused_resident.cu) against
                   its plain version and the tiered kernels on the q8 route
                   (3 keys, K = 4) over the same lanes plus the block's bad
                   lanes; beyond the edge lanes, the expected bitmap; its
                   time at each T in 1, 2, 4, 8.
Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from fabric_tpu_torch.stage_a_timing import device_ms  # noqa: E402

# tree kernel bound: the least int32 multiply-adds the function needs per
# lane. A complete add for a = -3 is 14 field multiplies (RCB15 Alg. 4:
# 12M + 2m_b), the check 2; a 256-bit product is 8 x 8 partial products of
# 32-bit limbs, a low and a high IMAD each, and P-256's Solinas fold needs
# no multiply. Since the kernels' redesign this is also their own design's
# multiply count (csrc/p256_field.cuh).
L = 20
FIELD_MUL_IMAD = 2 * 8 * 8
CADD_IMAD = 14 * FIELD_MUL_IMAD
CHECK_IMAD = 2 * FIELD_MUL_IMAD
# H100 SXM: 132 SMs x 64 int32 multiply-adds per clock (CUDA C
# Programming Guide, arithmetic instruction throughput, cc 9.0) x
# 1.98 GHz boost; 3.35 TB/s HBM3
INT32_IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

# stage A: the least 32-bit operations of one SHA-256 compression (48
# schedule words of 2 sigmas of 2 funnel shifts + 1 shift + 1 LOP3, and
# the 4-term sum in 2 IADD3; 64 rounds of 2 Sigmas of 3 funnel shifts + 1
# LOP3, ch and maj one LOP3 each, T1's 5 terms in 2 IADD3, e = d + T1 and
# a = T1 + S0 + maj one IADD3 each; 8 final adds), and of one 256-bit
# product mod n (8 x 8 partial products of 32-bit limbs, a low and a high
# IMAD each, and a Montgomery reduction of the same size: n is not a
# Solinas prime). The same 64-per-clock int32 rate covers shifts, logic,
# 3-input adds and multiply-adds on sm_90 (CUDA C Programming Guide,
# arithmetic instruction throughput).
SHA_BLOCK_OPS = 48 * 10 + 64 * 14 + 8
MODN_MUL_OPS = 2 * 2 * 8 * 8

# the provider's launch-count stats, one per kernel
TREE, SHA = "tree_kernel_launches", "sha_windows_launches"
DIGEST, RESIDENT = "sha256_launches", "resident_launches"

BAD_KINDS = ("flipped", "high_s", "bad_der", "wrong_key", "r_ge_n")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def tree_bound(B: int, M: int, extra_bytes: int = 0) -> tuple[float, str]:
    """Least time for the tree kernel's work on these inputs (ms): the
    int32 multiply-adds the function needs over the card's rate, or the
    bytes it must move (each lane's M points read once, r, rpn and
    premask read once, the output written once, plus `extra_bytes`: the
    windows entry's windows and key slots) over HBM bandwidth, whichever
    is larger; and which one."""
    ops = B * ((M - 1) * CADD_IMAD + CHECK_IMAD)
    nbytes = B * (M * 3 * L * 4 + 2 * L * 4 + 1) + B + extra_bytes
    t_ops, t_bytes = ops / INT32_IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sha_bound(live_blocks: int, products: int,
              nbytes: int) -> tuple[float, str]:
    """Least time for a stage-A entry on these inputs (ms): SHA-256's
    operations over this run's live blocks plus `products` mod-n products
    (two a lane where the entry computes scalars), or the bytes it must
    move (the live blocks and per-lane inputs read once, windows and
    words written once), whichever is larger."""
    ops = live_blocks * SHA_BLOCK_OPS + products * MODN_MUL_OPS
    t_ops, t_bytes = ops / INT32_IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def resident_bound(live_blocks: int, B: int, live: int,
                   nbytes_in: int) -> tuple[float, str]:
    """Least time for the resident kernel (ms): stage A's operations plus
    the tree's at M = 64 over the lanes it verifies, against the bytes
    of its inputs plus the 64 gathered points of each verified lane."""
    ops = (live_blocks * SHA_BLOCK_OPS + live * 2 * MODN_MUL_OPS
           + live * (63 * CADD_IMAD + CHECK_IMAD))
    nbytes = nbytes_in + live * 64 * 3 * L * 4 + B
    t_ops, t_bytes = ops / INT32_IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# -- pool workers (spawned processes: module-level, torch-free) --

def _sign_chunk(jobs):
    from fabric_tpu_torch.bccsp import p256_host, utils
    out = []
    for d, digest in jobs:
        r, s = p256_host.sign(d, digest)
        out.append(utils.marshal_signature(r, utils.to_low_s(s)))
    return out


def _sw_chunk(jobs):
    from fabric_tpu_torch.bccsp import sw
    prov = sw.SWProvider()
    return [prov.verify(sw.ECDSAPublicKey(x, y), sig, digest)
            for x, y, sig, digest in jobs]


def _chunks(seq, n):
    step = max(1, -(-len(seq) // n))
    return [seq[i:i + step] for i in range(0, len(seq), step)]


def pool_map(pool, fn, jobs, nproc):
    out = []
    for part in pool.map(fn, _chunks(jobs, nproc * 4)):
        out.extend(part)
    return out


# -- the block --

def make_block(seed: int, txs: int, pool, nproc):
    """Keys, items and prepared arrays for one block, with the expected
    bitmap known by construction."""
    from fabric_tpu_torch.bccsp import bccsp as api
    from fabric_tpu_torch.bccsp import p256_host, sw, utils
    from fabric_tpu_torch.bccsp.cuda import host_prep_scalars

    rng = np.random.default_rng(seed)
    ds = [int.from_bytes(rng.bytes(32), "big") % (p256_host.N - 1) + 1
          for _ in range(3)]
    privs = [sw.ECDSAPrivateKey(d) for d in ds]
    pubs = [k.public_key() for k in privs]
    n = 3 * txs
    key_of = np.empty(n, dtype=np.int64)
    for t in range(txs):
        key_of[3 * t] = rng.integers(3)                       # creator
        key_of[3 * t + 1:3 * t + 3] = rng.choice(3, 2, replace=False)
    raw = rng.bytes(256 * n)
    msgs = [raw[256 * i:256 * (i + 1)] for i in range(n)]
    digests = [hashlib.sha256(m).digest() for m in msgs]
    t0 = time.perf_counter()
    sigs = pool_map(pool, _sign_chunk,
                    [(ds[key_of[i]], digests[i]) for i in range(n)], nproc)
    sign_s = time.perf_counter() - t0

    bad = rng.choice(n, size=max(len(BAD_KINDS), n // 100), replace=False)
    kind_of = {}
    for j, i in enumerate(bad.tolist()):
        kind = BAD_KINDS[j % len(BAD_KINDS)]
        kind_of[i] = kind
        r, s = utils.unmarshal_signature(sigs[i])
        if kind == "flipped":
            m = bytearray(msgs[i])
            m[int(rng.integers(256))] ^= 0x01
            msgs[i] = bytes(m)
            digests[i] = hashlib.sha256(msgs[i]).digest()
        elif kind == "high_s":
            sigs[i] = utils.marshal_signature(r, p256_host.N - s)
        elif kind == "bad_der":
            sigs[i] = b"\x31" + sigs[i][1:]
        elif kind == "wrong_key":
            key_of[i] = (key_of[i] + 1) % 3
        else:
            sigs[i] = utils.marshal_signature(r + p256_host.N, s)
    expected = np.ones(n, dtype=bool)
    expected[bad] = False

    items = [api.VerifyItem(key=pubs[key_of[i]], signature=sigs[i],
                            message=msgs[i]) for i in range(n)]
    t0 = time.perf_counter()
    r8 = np.zeros((n, 32), np.uint8)
    rpn8 = np.zeros((n, 32), np.uint8)
    w8 = np.zeros((n, 32), np.uint8)
    der_ok = np.zeros(n, dtype=bool)
    for i in range(n):
        prep = host_prep_scalars(pubs[key_of[i]], sigs[i])
        if prep is not None:
            der_ok[i] = True
            r8[i], rpn8[i], w8[i] = (np.frombuffer(b, np.uint8)
                                     for b in prep)
    prep_s = time.perf_counter() - t0
    prepared = dict(digests=np.frombuffer(b"".join(digests), np.uint8)
                    .reshape(n, 32), r=r8, rpn=rpn8, w=w8, der_ok=der_ok,
                    key_idx=key_of.copy(), keys=pubs,
                    get_sig=sigs.__getitem__)
    return dict(n=n, items=items, prepared=prepared, expected=expected,
                kind_of=kind_of, pubs=pubs, sigs=sigs, digests=digests,
                key_of=key_of, sign_s=sign_s, prep_s=prep_s, rng=rng)


# -- main path --

def profile_call(fn) -> dict:
    """One call under torch.profiler: its wall time, the summed time of
    the device's kernels and copies (the card's busy share of the call)
    and the device activities that took most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    kernels = [ev.name for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not ev.name.startswith(("Memcpy", "Memset"))]
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
            "device_activities": len(by_name), "kernels": len(kernels),
            "kernel_names": sorted({k[:70] for k in kernels}),
            "top_ms": {k[:70]: v for k, v in top},
            "gather_kernels": [k[:70] for k in by_name
                               if "indexselect" in k.lower().replace("_", "")]}


def counted(prov, label, need, fn):
    """Run one path with every kernel count set to 0 just before it and
    read just after; fail if a kernel of the path never launched or the
    provider's own counts disagree. Returns (result, counts by provider
    stat name, stat deltas, seconds)."""
    from fabric_tpu_torch.bccsp.cuda import LAUNCH_COUNTERS

    before = dict(prov.stats)
    for mod, attr in LAUNCH_COUNTERS.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    out = fn()
    secs = time.perf_counter() - t0
    got = {k: getattr(mod, attr) for k, (mod, attr) in LAUNCH_COUNTERS.items()}
    delta = {k: v - before[k] for k, v in prov.stats.items()
             if isinstance(v, int)}
    for k in need:
        check(got[k] > 0, f"{label}: {k} stayed 0")
    for k in got:
        check(delta[k] == got[k], f"{label}: the provider counts {delta[k]} "
              f"{k}, the wrappers {got[k]}")
    return out, got, delta, secs


def check_bits(label, got, blk, sw_bits, sample):
    exp = blk["expected"]
    got = np.asarray(got, dtype=bool)
    check(got.shape == exp.shape, f"{label} shape")
    check(bool((got == exp).all()),
          f"{label} != expected at lanes "
          f"{np.nonzero(got != exp)[0][:10].tolist()}")
    check(bool((got[sample] == sw_bits).all()), f"{label} != sw on the sample")


def alternate_host_hash(prov, blk, sw_bits, sample) -> dict:
    """verify_batch on the fused tier and with hashlib (FTPU_FUSED=0), in
    turns (fused, host, host, fused) on one provider: the two ways of
    hashing compared within one call. Seconds per call, by mode."""
    times: dict = {"fused": [], "host_hash": []}
    saved = os.environ.pop("FTPU_FUSED", None)
    try:
        for mode in ("fused", "host_hash", "host_hash", "fused"):
            if mode == "host_hash":
                os.environ["FTPU_FUSED"] = "0"
            t0 = time.perf_counter()
            got = prov.verify_batch(blk["items"])
            times[mode].append(time.perf_counter() - t0)
            os.environ.pop("FTPU_FUSED", None)
            check_bits(f"verify_batch ({mode})", got, blk, sw_bits, sample)
    finally:
        if saved is not None:
            os.environ["FTPU_FUSED"] = saved
    return times


def run_route(name, prov, blk, sw_bits, sample, card, *, prepared: bool,
              batch_need, fused: bool, alternate: bool = False):
    """One route of the main path: verify_prepared (the commit path, when
    `prepared`) and verify_batch (message lanes), each counted; with
    `alternate`, verify_batch in turns with host hashing. Returns
    {path: kernel counts}."""
    rec = {"phase": "main_path", "route": name, "ok": True, "card": card,
           "lanes": blk["n"], "bad_lanes": int((~blk["expected"]).sum()),
           "sample_vs_sw": int(len(sample))}
    counts = {}
    if prepared:
        pr = blk["prepared"]
        first, counts["verify_prepared"], _, first_s = counted(
            prov, f"{name} verify_prepared", (TREE, SHA),
            lambda: prov.verify_prepared(**pr))
        check_bits(f"{name} verify_prepared (first)", first, blk, sw_bits,
                   sample)
        chunks = -(-prov._bucket(blk["n"]) // prov._chunk)
        for k in (SHA, TREE):
            check(counts["verify_prepared"][k] == chunks,
                  f"{name} verify_prepared: {k} "
                  f"{counts['verify_prepared'][k]}, not one per chunk "
                  f"({chunks})")
        steady = []
        for _ in range(5):
            t0 = time.perf_counter()
            got = prov.verify_prepared(**pr)
            steady.append(time.perf_counter() - t0)
        check_bits(f"{name} verify_prepared", got, blk, sw_bits, sample)
        steady_s = statistics.median(steady)
        prof = profile_call(lambda: prov.verify_prepared(**pr))
        check(not prof["gather_kernels"],
              f"{name}: the commit path ran a gather kernel "
              f"{prof['gather_kernels']}")
        check(prof["kernels"] < 20,
              f"{name}: the commit path ran {prof['kernels']} kernels")
        rec.update({
            "verify_prepared_launches": counts["verify_prepared"],
            "table_build_s": prov.stats["table_build_s"],
            "first_verify_prepared_s": first_s,
            "verify_prepared_steady_s": steady_s,
            "verify_prepared_steady_all_s": steady,
            "sigs_per_s_commit_path": blk["n"] / steady_s,
            "verify_prepared_profiled": prof})
    got, counts["verify_batch"], delta, batch_s = counted(
        prov, f"{name} verify_batch", batch_need,
        lambda: prov.verify_batch(blk["items"]))
    check_bits(f"{name} verify_batch", got, blk, sw_bits, sample)
    check(delta["host_hashed_lanes"] == 0,
          f"{name}: {delta['host_hashed_lanes']} lanes hashed on the host")
    check((delta["fused_batches"] >= 1) == fused,
          f"{name}: fused_batches moved by {delta['fused_batches']}")
    rec.update({"verify_batch_s": batch_s,
                "verify_batch_launches": counts["verify_batch"],
                "verify_batch_stats": {k: delta[k] for k in (
                    "fused_batches", "fused_lanes", "comb_batches",
                    "host_hashed_lanes", "host_hash_fallbacks")},
                "table_build_s": prov.stats["table_build_s"],
                "q16_builds": prov.stats["q16_builds"],
                "q8_builds": prov.stats["q8_builds"]})
    if alternate:
        rec["verify_batch_alternating_s"] = alternate_host_hash(
            prov, blk, sw_bits, sample)
    emit(rec)
    return counts


# -- kernel vs plain --

EDGE_KINDS = ("inf", "p_plus_p", "p_minus_p", "sum_inf", "premask_off",
              "rpn_hit", "wrong_r", "half_inf", "key_oob")
# kinds written into the gathered points, which the points entry alone sees
POINT_KINDS = ("p_plus_p", "p_minus_p", "sum_inf")
EDGE_LANES = 4096
T_CHOICES = (1, 2, 4, 8)


def _int_sum_chunk(lanes):
    """Python-int sums of (M, 3, L) point arrays -> affine x or None."""
    from fabric_tpu_torch.ops import limb, p256
    out = []
    for pts in lanes:
        acc = (0, 1, 0)
        for m in range(pts.shape[0]):
            acc = p256.cadd_int(acc, tuple(limb.limbs_to_int(pts[m, c])
                                           for c in range(3)))
        aff = p256.to_affine_int(acc)
        out.append(None if aff is None else aff[0])
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean time (ms) of one call of fn, CUDA events around `reps` calls
    after a warm-up: the caller's cost, the wrapper's host work included
    (which bounds calls of kernels shorter than it). A kernel's own time
    is `device_ms`'s (fabric_tpu_torch/stage_a_timing.py: the
    profiler's device time of its events)."""
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


def kernel_vs_plain(prov, blk, M_expect, card, pool, nproc):
    """The block's lanes on `prov`'s route (windows and tables), the
    first EDGE_LANES made edge cases (kind = lane % 9), through both
    entries of the tree kernel and their plain versions on the card."""
    import torch

    from fabric_tpu_torch.ops import comb, limb, p256, ptree

    dev = prov.device
    pr = blk["prepared"]
    n = blk["n"]
    bucket = prov._bucket(n)
    key_map, slot = {}, np.zeros(bucket, np.int32)
    for i, k in enumerate(pr["keys"]):
        key_map.setdefault(k.x_bytes().tobytes() + k.y_bytes().tobytes(), i)
    slot[:n] = pr["key_idx"]
    key_np, K, q_flat, g16, q16 = prov._resolve_tables(key_map, slot)
    _, g_tab, wbits_g, wbits_q = comb.route_tables(q_flat, g16, q16)

    def put(a, shape, dtype):
        out = np.zeros(shape, dtype)
        out[:len(a)] = a
        return torch.from_numpy(out).to(dev)

    words = put(np.ascontiguousarray(pr["digests"]).view(">u4")
                .reshape(n, 8).astype(np.int64), (bucket, 8), np.int64)
    r, rpn, w = (limb.be_bytes_to_limbs(put(pr[k], (bucket, 32), np.uint8))
                 for k in ("r", "rpn", "w"))
    premask = put(pr["der_ok"], (bucket,), bool)
    key = torch.from_numpy(key_np).to(dev)
    w1, w2 = comb.comb_windows(words, r, w, wbits_g, wbits_q)
    M = w1.shape[1] + w2.shape[1]
    check(M == M_expect, f"route gives M={M}, expected {M_expect}")

    # edge lanes: lane i < EDGE_LANES takes kind i % 9; first the kinds
    # both entries see (windows, key slots, premask)
    E = EDGE_LANES
    kinds = np.arange(E) % len(EDGE_KINDS)
    at = {k: torch.from_numpy(np.nonzero(kinds == j)[0]).to(dev)
          for j, k in enumerate(EDGE_KINDS)}
    for wt in (w1, w2):
        wt[at["inf"]] = 0
        wt[at["half_inf"], ::2] = 0
    premask[at["premask_off"]] = False
    # the points entry gathers the lane's own key slot; the windows entry
    # is handed a slot out of range and must reject without reading
    pts = ptree.gather_rows(w1, w2, key, g_tab, q_flat, K, wbits_g,
                            wbits_q).contiguous()
    key[at["key_oob"]] = K
    wargs = (w1, w2, key, g_tab, q_flat, K, wbits_g, wbits_q)

    # then the kinds written into the gathered points (the points entry)
    def neg_y(y):
        return p256.FP.canonical(p256.FP.submod(torch.zeros_like(y), y))

    pts[at["p_plus_p"], 1] = pts[at["p_plus_p"], 0]
    pts[at["p_minus_p"], 1] = pts[at["p_minus_p"], 0]
    pts[at["p_minus_p"], 1, 1] = neg_y(pts[at["p_minus_p"], 0, 1])
    pts[at["sum_inf"], 1::2] = pts[at["sum_inf"], 0::2]
    pts[at["sum_inf"], 1::2, 1] = neg_y(pts[at["sum_inf"], 0::2, 1])

    # Python-int sums: every edge lane, every bad lane, 256 other lanes
    rng = blk["rng"]
    checked = np.array(sorted(set(range(E)) | set(blk["kind_of"]) | set(
        rng.choice(np.arange(E, bucket), 256, replace=False).tolist())))
    xs = pool_map(pool, _int_sum_chunk, list(pts[checked].cpu().numpy()),
                  nproc)
    x_of = dict(zip(checked.tolist(), xs))
    r_h, rpn_h = r[:E].cpu().numpy(), rpn[:E].cpu().numpy()
    for lane in range(E):
        kind, x = EDGE_KINDS[kinds[lane]], x_of[lane]
        if x is None:
            continue
        if kind in ("p_plus_p", "p_minus_p", "half_inf", "key_oob"):
            rv = x % p256.N
            r_h[lane] = limb.int_to_limbs(rv)
            rpn_h[lane] = limb.int_to_limbs(
                rv + p256.N if rv + p256.N < p256.P else rv)
        elif kind == "rpn_hit":
            r_h[lane] = limb.int_to_limbs((x + 1) % p256.N)
            rpn_h[lane] = limb.int_to_limbs(x)
        elif kind == "wrong_r":
            r_h[lane] = rpn_h[lane] = limb.int_to_limbs(
                (limb.limbs_to_int(r_h[lane]) + 1) % p256.N)
    r[:E] = torch.from_numpy(r_h).to(dev)
    rpn[:E] = torch.from_numpy(rpn_h).to(dev)
    # the points entry takes limbs, the windows entry the host's bytes
    targs = (r, rpn, premask)
    targs8 = (limb.limbs_to_be_bytes(r), limb.limbs_to_be_bytes(rpn),
              premask)

    got = {"points": ptree.tree_verify_points(pts, *targs),
           "windows": ptree.tree_verify_windows(*wargs, *targs8)}
    plain = {"points": ptree.tree_verify_plain(pts, *targs),
             "windows": ptree.tree_verify_windows_plain(*wargs, *targs8)}
    torch.cuda.synchronize()
    k_h = {e: t.cpu().numpy() for e, t in got.items()}
    max_abs_err = 0
    for e in got:
        p_h = plain[e].cpu().numpy()
        err = int(np.abs(k_h[e].astype(np.int64) - p_h).max())
        check(err == 0, f"M={M} {e} entry: kernel != plain at lanes "
              f"{np.nonzero(k_h[e] != p_h)[0][:10].tolist()}")
        max_abs_err = max(max_abs_err, err)

    pm_h, r_c, rpn_c, key_h = (t.cpu().numpy() for t in (premask, r, rpn,
                                                         key))
    accept_kinds = {"p_plus_p", "p_minus_p", "half_inf", "rpn_hit"}
    for lane, x in x_of.items():
        kind = EDGE_KINDS[kinds[lane]] if lane < E else None
        want = (bool(pm_h[lane]) and x is not None and x in (
            limb.limbs_to_int(r_c[lane]), limb.limbs_to_int(rpn_c[lane])))
        check(bool(k_h["points"][lane]) == want,
              f"M={M} lane {lane}: points entry {bool(k_h['points'][lane])}"
              f" != ints {want}")
        if kind not in POINT_KINDS:
            want_w = want and 0 <= key_h[lane] < K
            check(bool(k_h["windows"][lane]) == want_w,
                  f"M={M} lane {lane}: windows entry "
                  f"{bool(k_h['windows'][lane])} != ints {want_w}")
        if kind is not None and kind != "key_oob" and bool(pm_h[lane]):
            check(want == (kind in accept_kinds),
                  f"M={M} edge lane {lane} ({kind}) gave {want}")
    check(not k_h["windows"][:E][kinds == EDGE_KINDS.index("key_oob")].any(),
          f"M={M}: a key slot out of range accepted")
    exp = np.zeros(bucket, bool)
    exp[:n] = blk["expected"]
    for e in got:
        check(bool((k_h[e][E:] == exp[E:]).all()),
              f"M={M}: {e} entry != expected bitmap beyond the edge lanes")

    # one row per threads-per-lane count; the wrappers' own T is timed
    # again for the kernels line
    by_t = {}
    for T in T_CHOICES:
        for e, fn in (("points", lambda: ptree.tree_verify_points(
                pts, *targs, threads_per_lane=T)),
                      ("windows", lambda: ptree.tree_verify_windows(
                          *wargs, *targs8, threads_per_lane=T))):
            check(torch.equal(fn(), plain[e]), f"M={M} T={T}: {e} entry "
                  "!= plain")
            by_t.setdefault(T, {})[f"{e}_ms"] = cuda_ms(fn, 10)
    call_ms = cuda_ms(lambda: ptree.tree_verify_windows(*wargs, *targs8), 10)
    ms = device_ms(lambda: ptree.tree_verify_windows(*wargs, *targs8), 10,
                   "ptree_windows_kernel")
    points_ms = cuda_ms(lambda: ptree.tree_verify_points(pts, *targs), 10)
    plain_ms = cuda_ms(lambda: ptree.tree_verify_windows_plain(
        *wargs, *targs8), 2)
    bound_ms, bound_by = tree_bound(bucket, M, bucket * (M + 1) * 4)
    t_used = ptree.THREADS_PER_LANE
    emit({"phase": "kernel_vs_plain", "M": M, "lanes": bucket, "ok": True,
          "card": card, "edge_lanes": E, "threads_per_lane": t_used,
          "edge_accepts": {e: {k: int(k_h[e][:E][kinds == j].sum())
                               for j, k in enumerate(EDGE_KINDS)}
                           for e in k_h},
          "int_checked_lanes": len(x_of),
          "accepts": {e: int(v.sum()) for e, v in k_h.items()},
          "max_abs_err": max_abs_err, "windows_ms": ms,
          "windows_call_ms": call_ms, "points_ms": points_ms,
          "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "share_of_bound": bound_ms / ms, "ms_by_threads_per_lane": by_t})
    return dict(max_abs_err=max_abs_err, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, threads_per_lane=t_used,
                points_entry_ms=points_ms)


# -- stage A and the resident kernel vs plain --

EDGE_LENS = (0, 1, 55, 56, 63, 64, 119, 120, 503)
# lanes after the message-length edges: digest 0, digest all-ones, w = 1,
# w = n - 1, r = 1
LANE_D0, LANE_D1, LANE_W1, LANE_WN, LANE_R1 = range(9, 14)
N_EDGE = 14


def stage_lanes(prov, blk):
    """The main path's fused lanes at its shape (the provider's bucket,
    its block count for the block's messages) with the edge lanes
    written in, garbage in every block past a lane's count, every 16th
    block lane a digest lane with its true digest. Tensors on the card."""
    import torch

    from fabric_tpu_torch.ops import p256, sha256

    n = blk["n"]
    N = p256.N
    bucket = prov._bucket(n)
    rng = np.random.default_rng(1234)
    msgs = [it.message for it in blk["items"]] + [b""] * (bucket - n)
    for j, ln in enumerate(EDGE_LENS):
        msgs[j] = rng.bytes(ln)
    nb = prov._nb_bucket(max(len(m) for m in msgs))
    blocks, counts = sha256.pack_messages(msgs, nb)
    past = np.arange(nb)[None, :] >= counts[:, None]
    blocks[past] = rng.integers(0, 1 << 32, size=(int(past.sum()), 16),
                                dtype=np.uint32)
    has_digest = np.zeros(bucket, bool)
    digests = np.zeros((bucket, 8), np.uint32)
    dl = np.arange(N_EDGE + 15, n, 16)
    has_digest[dl] = True
    digests[dl] = np.frombuffer(b"".join(blk["digests"][i] for i in dl),
                                ">u4").reshape(-1, 8)
    has_digest[[LANE_D0, LANE_D1]] = True
    digests[LANE_D1] = 0xFFFFFFFF
    nblocks = np.where(has_digest, 0, counts).astype(np.int32)

    pr = blk["prepared"]

    def pad(a, shape, dtype):
        out = np.zeros(shape, dtype)
        out[:len(a)] = a
        return out

    r8, rpn8, w8 = (pad(pr[k], (bucket, 32), np.uint8)
                    for k in ("r", "rpn", "w"))
    w8[LANE_W1] = np.frombuffer((1).to_bytes(32, "big"), np.uint8)
    w8[LANE_WN] = np.frombuffer((N - 1).to_bytes(32, "big"), np.uint8)
    r8[LANE_R1] = np.frombuffer((1).to_bytes(32, "big"), np.uint8)
    rpn8[LANE_R1] = np.frombuffer((1 + N).to_bytes(32, "big"), np.uint8)
    key_map, slot = {}, np.zeros(bucket, np.int32)
    for i, k in enumerate(pr["keys"]):
        key_map.setdefault(k.x_bytes().tobytes() + k.y_bytes().tobytes(), i)
    slot[:n] = pr["key_idx"]
    key_idx, K, q_flat, g16, q16 = prov._resolve_tables(key_map, slot)
    check(not q16 and K == 4, f"stage lanes want the q8 route, got K={K}")
    dev = prov.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(
        msgs=msgs, counts=counts, nb=nb, has_digest_np=has_digest,
        digests_np=digests, nblocks_np=nblocks, premask_np=pad(
            pr["der_ok"], (bucket,), bool),
        blocks=put(blocks.view(np.int32)), nblocks=put(nblocks),
        counts_t=put(counts), digests=put(digests.view(np.int32)),
        has_digest=put(has_digest), r8=put(r8), rpn8=put(rpn8), w8=put(w8),
        key_idx=put(key_idx), premask=put(pad(pr["der_ok"], (bucket,),
                                              bool)), q_flat=q_flat, K=K)


def _int_windows(u: int, wbits: int) -> list[int]:
    return [(u >> (wbits * k)) & ((1 << wbits) - 1)
            for k in range(256 // wbits)]


def sha_vs_plain(st, card):
    """Stage A's two entries and the digest-only entry against their
    plain versions, hashlib and (on the edge lanes) Python ints; times
    and bounds."""
    import torch

    from fabric_tpu_torch.ops import fused_verify as fv
    from fabric_tpu_torch.ops import p256, sha256

    N = p256.N
    B = st["blocks"].shape[0]
    want = np.stack([np.frombuffer(hashlib.sha256(m).digest(), ">u4")
                     for m in st["msgs"]]).astype(np.int64)
    want_fused = np.where(st["has_digest_np"][:, None],
                          st["digests_np"].astype(np.int64), want)
    args = (st["blocks"], st["nblocks"], st["digests"], st["has_digest"],
            st["r8"], st["w8"])
    live = int(st["nblocks_np"].sum())
    r_int, w_int = ([int.from_bytes(x.tobytes(), "big")
                     for x in st[k][:N_EDGE].cpu().numpy()]
                    for k in ("r8", "w8"))

    def edge_ints(label, k1h, k2h, words, wb):
        for i in range(N_EDGE):
            e = int.from_bytes(b"".join(int(x).to_bytes(4, "big")
                                        for x in words[i]), "big")
            check(k1h[i].tolist() == _int_windows(e * w_int[i] % N, wb)
                  and k2h[i].tolist() == _int_windows(
                      r_int[i] * w_int[i] % N, wb),
                  f"{label} {wb}/{wb}: edge lane {i} != Python ints")

    res = {}
    for wb in (8, 16):
        k1, k2, kw = fv.sha_windows(*args, wbits_g=wb, wbits_q=wb)
        p1, p2, pw = fv.sha_windows_plain(*args, wb, wb)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in ((k1, p1), (k2, p2), (kw, pw)))
        check(err == 0, f"sha_windows {wb}/{wb}: kernel != plain")
        check(bool((kw.cpu().numpy() == want_fused).all()),
              f"sha_windows {wb}/{wb}: words != hashlib")
        edge_ints("sha_windows", k1.cpu().numpy(), k2.cpu().numpy(),
                  kw.cpu().numpy(), wb)
        ms = device_ms(lambda: fv.sha_windows(*args, wbits_g=wb,
                                              wbits_q=wb), 20,
                       "sha_windows_kernel")
        call_ms = cuda_ms(lambda: fv.sha_windows(*args, wbits_g=wb,
                                                 wbits_q=wb), 10)
        plain_ms = cuda_ms(lambda: fv.sha_windows_plain(*args, wb, wb), 2)
        # in: live blocks, nblocks, digests, has_digest, r8, w8; out: the
        # windows and the int64 words
        bound_ms, bound_by = sha_bound(live, 2 * B, live * 64 + B * (
            4 + 32 + 1 + 64) + B * (4 * 2 * 256 // wb + 64))
        res[wb] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, share_of_bound=bound_ms / ms)
        emit({"phase": "sha_vs_plain", "entry": "sha_windows", "wbits": wb,
              "ok": True, "card": card, "lanes": B, "nb": st["nb"],
              "live_blocks": live, "edge_lanes": N_EDGE, **res[wb]})

    # the digest-lanes entry (the commit path's scalar stage): every lane
    # takes its digest, the fused lanes' words, lane 0's digest n itself
    dwords = want_fused.astype(np.uint32)
    dwords[0] = np.frombuffer(N.to_bytes(32, "big"), ">u4")
    dg = torch.from_numpy(dwords.view(np.int32)).to(st["r8"].device)
    dargs = (dg, st["r8"], st["w8"])
    for wb in (8, 16):
        k1, k2 = fv.digest_windows(*dargs, wbits_g=wb, wbits_q=wb)
        p1, p2 = fv.digest_windows_plain(*dargs, wb, wb)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in ((k1, p1), (k2, p2)))
        check(err == 0, f"digest_windows {wb}/{wb}: kernel != plain")
        k1h = k1.cpu().numpy()
        edge_ints("digest_windows", k1h, k2.cpu().numpy(), dwords, wb)
        check(not k1h[0].any(), "digest_windows: e = n gave u1 != 0")
        ms = device_ms(lambda: fv.digest_windows(*dargs, wbits_g=wb,
                                                 wbits_q=wb), 20,
                       "digest_windows_kernel")
        call_ms = cuda_ms(lambda: fv.digest_windows(*dargs, wbits_g=wb,
                                                    wbits_q=wb), 10)
        plain_ms = cuda_ms(lambda: fv.digest_windows_plain(*dargs, wb, wb),
                           2)
        bound_ms, bound_by = sha_bound(0, 2 * B, B * (32 + 64)
                                       + B * 4 * 2 * 256 // wb)
        res[f"digest_lanes_{wb}"] = dict(
            max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms)
        emit({"phase": "sha_vs_plain", "entry": "digest_windows",
              "wbits": wb, "ok": True, "card": card, "lanes": B,
              "edge_lanes": N_EDGE, **res[f"digest_lanes_{wb}"]})

    # the digest-only entry: every lane hashed (no digest lanes)
    dargs = (st["blocks"], st["counts_t"])
    kd = sha256.sha256_blocks(*dargs)
    pd = sha256.sha256_plain(*dargs)
    torch.cuda.synchronize()
    err = int((kd - pd).abs().max())
    check(err == 0, "sha256_blocks: kernel != plain")
    check(bool((kd.cpu().numpy() == want).all()),
          "sha256_blocks: words != hashlib")
    live = int(st["counts"].sum())
    bound_ms, bound_by = sha_bound(live, 0, live * 64 + B * (4 + 64))
    ms = device_ms(lambda: sha256.sha256_blocks(*dargs), 20,
                   "sha256_digest_kernel")
    res["digest"] = dict(
        max_abs_err=err, ms=ms,
        call_ms=cuda_ms(lambda: sha256.sha256_blocks(*dargs), 10),
        plain_ms=cuda_ms(lambda: sha256.sha256_plain(*dargs), 2),
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms)
    emit({"phase": "sha_vs_plain", "entry": "sha256_blocks", "ok": True,
          "card": card, "lanes": B, "nb": st["nb"], "live_blocks": live,
          **res["digest"]})
    return res


def resident_vs_plain(st, blk, card):
    """The resident kernel against its plain version and the tiered
    kernels on the q8 tables; beyond the edge lanes, the expected
    bitmap."""
    import torch

    from fabric_tpu_torch.ops import comb
    from fabric_tpu_torch.ops import fused_verify as fv

    args = (st["blocks"], st["nblocks"], st["key_idx"], st["q_flat"],
            st["r8"], st["rpn8"], st["w8"], st["premask"], st["digests"],
            st["has_digest"])
    g8 = comb.g_tables_on(st["q_flat"].device)
    k = fv.fused_verify_resident(*args)
    plain = fv.resident_plain(*args, g8)
    tiered = fv.fused_verify_with_tables(*args)
    torch.cuda.synchronize()
    kh, ph, th = (t.cpu().numpy() for t in (k, plain, tiered))
    err = int(np.abs(kh.astype(np.int64) - ph).max())
    check(err == 0, f"resident: kernel != plain at lanes "
          f"{np.nonzero(kh != ph)[0][:10].tolist()}")
    check(bool((kh == th).all()), "resident != the tiered kernels")
    n = blk["n"]
    exp = np.zeros(len(kh), bool)
    exp[:n] = blk["expected"]
    check(bool((kh[N_EDGE:] == exp[N_EDGE:]).all()),
          "resident != expected bitmap beyond the edge lanes")
    B = len(kh)
    pm = st["premask_np"]
    live_lanes = int(pm.sum())
    live_blocks = int(st["nblocks_np"][pm].sum())
    nbytes_in = live_blocks * 64 + B * (4 + 32 + 1 + 4 + 3 * L * 4 + 1)
    bound_ms, bound_by = resident_bound(live_blocks, B, live_lanes,
                                        nbytes_in)
    by_t = {}
    for T in T_CHOICES:
        check(torch.equal(fv.fused_verify_resident(
            *args, threads_per_lane=T), plain),
              f"resident T={T}: kernel != plain")
        by_t[T] = cuda_ms(lambda: fv.fused_verify_resident(
            *args, threads_per_lane=T), 5)
    ms = device_ms(lambda: fv.fused_verify_resident(*args), 5,
                   "fused_resident_kernel")
    res = dict(max_abs_err=err, ms=ms,
               call_ms=cuda_ms(lambda: fv.fused_verify_resident(*args), 5),
               plain_ms=cuda_ms(lambda: fv.resident_plain(*args, g8), 2),
               bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms,
               threads_per_lane=fv.RESIDENT_THREADS_PER_LANE)
    emit({"phase": "resident_vs_plain", "ok": True, "card": card, "lanes": B,
          "K": st["K"], "accepts": int(kh.sum()), "live_lanes": live_lanes,
          "bad_lanes": len(blk["kind_of"]), "edge_lanes": N_EDGE,
          "table_bytes": fv.resident_table_bytes(st["K"]),
          "tiered_ms": cuda_ms(lambda: fv.fused_verify_with_tables(*args), 5),
          "ms_by_threads_per_lane": by_t, **res})
    return res


def field_vs_ints(card, seed: int) -> None:
    """The nvcc-built field core against Python ints (ptree.field_selftest
    and its plain version): edge operands in 13-bit form, every pair, and
    seeded random ones; Alg. 4 on the edge point pairs and random points.
    Every output word must be equal."""
    import torch

    from fabric_tpu_torch.ops import fused_verify as fv
    from fabric_tpu_torch.ops import limb, p256, ptree

    P = p256.P
    rng = np.random.default_rng(seed)
    edges = [0, 1, P - 1, P, P + 1, (1 << 256) - 1,
             (1 << 256) + (1 << 243) - 1]
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(512)]
    pairs = [(a, b) for a in edges for b in edges] + list(
        zip(rand[::2], rand[1::2]))
    a13 = limb.ints_to_limbs([a for a, _ in pairs])
    b13 = limb.ints_to_limbs([b for _, b in pairs])
    g = (p256.GX, p256.GY, 1)
    pts = [p256.scalar_mul_int(int(k), g) for k in rng.integers(1, 1 << 62,
                                                                 size=64)]
    inf, neg_g = (0, 1, 0), (p256.GX, P - p256.GY, 1)
    adds = [(g, g), (g, neg_g), (g, inf), (inf, inf)] + list(
        zip(pts[::2], pts[1::2]))

    def rows(ps):
        return np.stack([np.concatenate([limb.int_to_limbs(c % P)
                                         for c in q]) for q in ps])
    cpu = [torch.as_tensor(x) for x in (a13, b13, rows(a for a, _ in adds),
                                        rows(b for _, b in adds))]
    got = ptree.field_selftest(*(x.cuda() for x in cpu))
    want = ptree.field_selftest_plain(*cpu)
    torch.cuda.synchronize()
    bad = [int((g_.cpu() != w_).any(dim=1).sum()) for g_, w_ in zip(got, want)]
    check(bad == [0, 0], f"field core != Python ints on {bad} cases")

    # the mod-n core: u1 = e*w, u2 = r*w mod n, e unreduced
    N = p256.N
    e_edges = [0, 1, N - 1, N, N + 1, (1 << 256) - 1]
    rnd = [int.from_bytes(rng.bytes(32), "big") for _ in range(768)]
    cases = [(e, r, w) for e in e_edges for w in (1, N - 1, rnd[0] % N)
             for r in (1, N - 1, rnd[1] % N)]
    cases += [(rnd[i], rnd[i + 1] % N, rnd[i + 2] % N)
              for i in range(0, 768, 3)]

    def be(k, dtype):
        return np.stack([np.frombuffer(c[k].to_bytes(32, "big"), dtype)
                         for c in cases])
    e = torch.as_tensor(be(0, ">u4").astype(np.uint32).view(np.int32))
    r8, w8 = (torch.as_tensor(be(k, np.uint8)) for k in (1, 2))
    got_n = fv.modn_selftest(e.cuda(), r8.cuda(), w8.cuda())
    want_n = fv.modn_selftest_plain(e, r8, w8)
    torch.cuda.synchronize()
    bad_n = int((got_n.cpu() != want_n).any(dim=1).sum())
    check(bad_n == 0, f"mod-n core != Python ints on {bad_n} cases")
    emit({"phase": "field_vs_ints", "ok": True, "card": card,
          "op_cases": len(pairs), "add_cases": len(adds),
          "modn_cases": len(cases), "mismatches": 0})


def drive(args, pool, nproc, card):
    """The block, the sw sample, every main-path route and every kernel
    comparison; returns the kernels line's entries."""
    from fabric_tpu_torch.bccsp import factory

    field_vs_ints(card, args.seed)
    blk = make_block(args.seed, args.txs, pool, nproc)
    emit({"phase": "block", "ok": True, "lanes": blk["n"],
          "bad_lanes": {k: sum(1 for v in blk["kind_of"].values()
                               if v == k) for k in BAD_KINDS},
          "sign_s": blk["sign_s"], "host_prep_s": blk["prep_s"],
          "workers": nproc})
    rng = blk["rng"]
    sample = np.array(sorted(set(blk["kind_of"]) | set(
        rng.choice(blk["n"], 2048, replace=False).tolist())))
    pubs, key_of = blk["pubs"], blk["key_of"]
    jobs = [(pubs[key_of[i]].x, pubs[key_of[i]].y, blk["sigs"][i],
             blk["digests"][i]) for i in sample.tolist()]
    t0 = time.perf_counter()
    sw_bits = np.array(pool_map(pool, _sw_chunk, jobs, nproc), bool)
    sw_pool_s = time.perf_counter() - t0
    check(bool((sw_bits == blk["expected"][sample]).all()),
          "sw provider != expected bitmap on the sample")
    t0 = time.perf_counter()
    _sw_chunk(jobs[:200])
    sw_per_sig_ms = (time.perf_counter() - t0) / 200 * 1e3
    emit({"phase": "sw", "ok": True, "sample": len(sample),
          "sample_pool_s": sw_pool_s,
          "sw_per_sig_ms_one_core": sw_per_sig_ms})

    route = dict(blk=blk, sw_bits=sw_bits, sample=sample, card=card)
    prov16 = factory.new_bccsp({"Default": "CUDA"})
    c16 = run_route("q16", prov16, prepared=True, fused=True,
                    batch_need=(SHA, TREE), alternate=True, **route)
    prov8 = factory.new_bccsp({"Default": "CUDA", "CUDA": {"UseG16": False}})
    c8 = run_route("q8", prov8, prepared=True, fused=True,
                   batch_need=(SHA, TREE), **route)
    os.environ["FTPU_FUSED_RESIDENT"] = "1"
    try:
        cres = run_route("q8_resident", prov8, prepared=False, fused=True,
                         batch_need=(RESIDENT,), **route)
    finally:
        del os.environ["FTPU_FUSED_RESIDENT"]
    check(cres["verify_batch"][TREE] == 0 and
          cres["verify_batch"][SHA] == 0,
          "q8_resident: the tiered kernels ran beside the resident one")
    provsha = factory.new_bccsp({"Default": "CUDA", "CUDA": {
        "UseG16": False, "HashOnHost": False, "FusedVerify": False}})
    # the block's Q8 table, already built on this card by prov8: the
    # route times the device-SHA path, not a second table build
    provsha._q8_cache.update(prov8._q8_cache)
    csha = run_route("device_sha", provsha, prepared=False, fused=False,
                     batch_need=(DIGEST, TREE), **route)

    tree32 = kernel_vs_plain(prov16, blk, 32, card, pool, nproc)
    tree64 = kernel_vs_plain(prov8, blk, 64, card, pool, nproc)
    st = stage_lanes(prov8, blk)
    sha = sha_vs_plain(st, card)
    res = resident_vs_plain(st, blk, card)

    def n(counts, k):
        return sum(c[k] for c in counts.values())

    src = "fabric_tpu_torch/csrc/"
    return [
        dict(name="ptree.tree_verify_windows (M=32)", source=src + "ptree.cu",
             replaces="fabric_tpu/ops/ptree.py:335",
             launches=n(c16, TREE), **tree32),
        dict(name="ptree.tree_verify_windows (M=64)", source=src + "ptree.cu",
             replaces="fabric_tpu/ops/ptree.py:335",
             launches=n(c8, TREE) + n(csha, TREE), **tree64),
        dict(name="fused_verify.sha_windows (16/16)",
             source=src + "sha_windows.cu",
             replaces="fabric_tpu/ops/fused_verify.py:200",
             launches=c16["verify_batch"][SHA], **sha[16]),
        dict(name="fused_verify.sha_windows (8/8)",
             source=src + "sha_windows.cu",
             replaces="fabric_tpu/ops/fused_verify.py:200",
             launches=c8["verify_batch"][SHA], **sha[8]),
        dict(name="fused_verify.digest_windows (16/16, digest lanes)",
             source=src + "sha_windows.cu",
             replaces="fabric_tpu/ops/comb.py:376",
             launches=c16["verify_prepared"][SHA], **sha["digest_lanes_16"]),
        dict(name="fused_verify.digest_windows (8/8, digest lanes)",
             source=src + "sha_windows.cu",
             replaces="fabric_tpu/ops/comb.py:376",
             launches=c8["verify_prepared"][SHA] + csha["verify_batch"][SHA],
             **sha["digest_lanes_8"]),
        dict(name="sha256.sha256_blocks (digest-only entry)",
             source=src + "sha_windows.cu",
             replaces="fabric_tpu/ops/sha256.py:87",
             launches=n(csha, DIGEST), **sha["digest"]),
        dict(name="fused_verify.fused_verify_resident",
             source=src + "fused_resident.cu",
             replaces="fabric_tpu/ops/fused_verify.py:442",
             launches=n(cres, RESIDENT), **res),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--txs", type=int, default=10240)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.common import torchenv
    from fabric_tpu_torch.ops import comb

    # the 8-bit G table persists inside the checkout's build directory
    os.environ.setdefault(comb.GTAB_CACHE_ENV,
                          os.path.join(torchenv.BUILD_DIR, "gtab8.npy"))
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {k: kernels.ptxas_summary(k) for k in kernels.KERNELS}
    emit({"phase": "build", "ok": True, "seconds": build_s, "ptxas": ptxas,
          "sass": {k: kernels.sass_mix(k) for k in (
              "ptree", "sha_windows", "fused_resident")}})
    # stage A's entries and the resident kernel keep everything in
    # registers: no stack frame, no spills
    for lib in ("sha_windows", "fused_resident"):
        check(bool(ptxas[lib]), f"ptxas: no report for {lib}")
        for fn, rep in ptxas[lib].items():
            check(rep.get("stack") == 0 and rep.get("spill_stores") == 0
                  and rep.get("spill_loads") == 0,
                  f"ptxas: {fn} has a stack or spills: {rep}")

    nproc = os.cpu_count() or 1
    with mp.get_context("spawn").Pool(nproc) as pool:
        res = drive(args, pool, nproc, card)
        pool.close()
        pool.join()

    emit({"kernels": [{"name": k.pop("name"), "route": "cuda", **k,
                       "library_ms": None} for k in res]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
