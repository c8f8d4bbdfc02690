#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold every kernel to
its plain version.

    python3 chip_smoke.py [--seed 7] [--txs 10240]

Phases, one JSON line each; any failure exits non-zero:

  device           the card (and nvidia-smi's name and power limit);
                   no CUDA device -> exit 2, nothing printed
  build            the host's native batch prep (csrc/batchprep.cpp, g++:
                   native_build_s), then every kernel under
                   fabric_tpu_torch/csrc, one nvcc per source, started
                   together, all through the build seam into one recorder
                   (each library's seconds from its own nvcc's start and
                   whether the compiler wrote it, which must be so exactly
                   for the libraries not built before: `libraries`);
                   ptxas registers, stack and spills per kernel (stage
                   A's and the resident kernel's must have no stack and
                   no spills, the BLS12-381 Miller and final-exp entries
                   no spills and a stack under 1 KB, the BN254 ones no
                   spills in either layout and, 8 threads a lane, a
                   stack under 1 KB); the SASS mix
  field_vs_ints    the P-256 field core (csrc/p256_field.cuh) built by nvcc
                   (csrc/field_selftest.cu) against Python ints: mul, add,
                   sub and the 13-bit conversion on edge operands (0, 1,
                   p - 1, p, p + 1, 2^256 - 1, 2^256 + 2^243 - 1, and
                   ptree.CARRY_EDGES, where the PTX carry chains carry
                   through every word) and seeded random ones, RCB15 Alg. 4 on P + P, P + (-P), P + inf,
                   inf + inf and random points; the mod-n core
                   (csrc/modn32.cuh) on e = 0, 1, n - 1, n, n + 1,
                   2^256 - 1 against w = 1, n - 1 and r = 1, n - 1, and
                   seeded random ones; the ladder's doubling (pt_dbl)
                   against cdbl_int on G, -G, inf and random points; the
                   2^255 - 19 core (csrc/fe25519.cuh) on 0, 1, p - 1, p,
                   p + 1, 2^255 - 1, 2^256 - 1 and random operands, and
                   ed_add/ed_dbl on B, the identity, a small-order point
                   and random points; BN254's core (csrc/bn254_field.cuh:
                   mul, add, sub, Fermat's and the binary Euclid inverse
                   on 0, 1, p - 1, p, p + 1 and random operands below 2p)
                   against Python ints, its tower (csrc/bn254_tower.cuh:
                   Fp2 mul/sqr/inv, Fp12 mul, Frobenius and inverse, the
                   twist doubling and addition with their lines) against
                   the plain tower and the bn254_ref ints, and the
                   cooperative layer on it (its D-type line; the cases
                   and clock counts as BLS12-381's below:
                   bn254_coop_cycles); BLS12-381's 381-bit core
                   (csrc/bls12_381_field.cuh on 12 words: the same ops
                   and the 13-bit layout's round trip on 0, 1, p - 1, p,
                   p + 1, 2p - 1 and random operands below 2p) and its
                   M-type tower (csrc/bls12_381_tower.cuh, the same cases)
                   against Python ints and the plain tower; its
                   cooperative layer (csrc/pairing_coop.cuh, a warp a
                   case: Fp12 squaring, the sparse line product, the
                   cyclotomic squaring of a value past the easy part, the
                   product, inverse and Frobenius, beside the serial
                   formulas, and the binary Euclid Fp inverse on 0, 1,
                   p - 1 and random values) against the plain tower and
                   ints, with clock cycles (bls12_381_coop_cycles: Fermat's
                   inverse and the binary one on one thread, the warp's
                   Fp12 product and cyclotomic squaring, one thread's
                   f2_mul and f2_add); words equal
  block            a block made from --seed: --txs transactions x (2
                   endorsements + 1 creator) P-256 signatures over 3 org
                   keys, 256-byte messages, ~1% bad lanes of five kinds
                   (message flipped after signing, high-S, mangled DER,
                   checked against the wrong org's key, r >= n), prepared
                   by the native batch prep (host_prep_s) and held to
                   host_prep_scalars, the plain version, on every lane
                   and on an adversarial DER corpus with 256 bit flips
                   (host_prep_python_s: the plain version's seconds)
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
  mixed_curves     300 lanes on P-384, P-521 and P-224 keys (MIXED_LANES:
                   message lanes and digest lanes of 48, 64 and 32 bytes,
                   one tampered, one high-S, one on the wrong key) spread
                   through the block in one verify_batch on the q16
                   provider: they verify on sw, every verdict equal to
                   the expected bitmap and sw's (in the pool), and the
                   P-256 lanes launch exactly the kernels of the
                   P-256-only call.
  telemetry        the provider's telemetry on a fresh q16 provider over
                   the org block (the q16 provider's tables handed over):
                   (a) one build event a library its calls load
                   (batchprep, ptree, sha_windows), each a hit, with the
                   build phase's per-library seconds beside them; (b) one
                   commit-path call and one verify_batch under the
                   profiler, the busy ms the provider's CUDA events booked
                   for the same call between the profiler's kernel sum
                   (x 0.95) and the call's wall (x 1.05); (c) one
                   device_memory() row named as nvidia-smi names the card,
                   its limit within 2% of nvidia-smi's memory.total, in
                   use at least the Q16 table's 1,006,632,960 bytes, the
                   peak at least that; (d) health() "device" and
                   hbm_substate(headroom_frac=1.0) naming d0; (e) one
                   tpu.verify span a dispatch (two a commit-path call),
                   one tpu.dispatch a dispatcher call, chrome_trace() valid
                   JSON holding them; (f) three bounded torch trace
                   captures (0.5 s, keep=2) each around commit-path calls
                   leave two directories, the newest naming the tree
                   kernel, and a capture during a capture is refused; (g)
                   one devicecost tick and one provider-stats tick render
                   the memory, busy-ratio, compile and launch gauges; (h)
                   the commit path's steady median with tracing on, with
                   it off, and with it off and the busy events stubbed
                   out, in turns, 60 calls each: on within 5% or 0.10 ms
                   of each of the others.
  warm_restart     the Q16 table's lifecycle across a restart, on the org
                   block's key set (3 keys, K = 4), with a temporary
                   WarmKeysDir under fabric_tpu_torch/_build/ (removed at
                   the end): the cold leg in this process (the first
                   verify_prepared builds Q8 and Q16, flush_warm_tables
                   writes the Q16 file of 1,006,632,960 table bytes and the
                   Q8 file, both passing their sha256 sidecars); then four
                   legs, each in a spawned process (the 16-bit G table is
                   process-global): "restart" (prewarm(wait_restore=True)
                   restores the table from the file, then the first
                   verify_prepared: no Q16 build, one disk load, one
                   stage-A and one tree launch, the restored table's
                   sha256 the cold leg's; restart_first_block_s and
                   restore_s), "cold" (no warm dir: cold_first_block_s),
                   "restore_window" (a verify_prepared while the restore
                   runs, on whichever route it takes, then one after it),
                   "corrupt" (one byte of the file flipped: the sidecar
                   fails and the set is rebuilt, q16_builds 1). Every
                   bitmap equals the cold leg's, the expected one and sw on
                   the sample.
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
  ladder_path      a second block from --seed + 1: --txs x 3 P-256
                   signatures, the 2 endorsements from the 3 org keys and
                   the creator from 1,021 client keys (1,024 keys, over
                   MaxKeys = 16), bad lanes as above, through a fresh
                   CUDAProvider: verify_prepared (the ladder's digest-lanes
                   entry) and verify_batch (its message entry: the
                   digest-only SHA kernel, then the ladder), each counted:
                   the ladder (and on message lanes the SHA kernel) one
                   launch a chunk, every other kernel 0; bitmaps equal the expected
                   one and sw on >= 2,048 lanes; one steady verify_prepared
                   under torch.profiler.
  ladder_vs_plain  both ladder entries against the plain version
                   (ops/verify.py) on the card over 4,096 lanes, the first
                   of them edges: u1 = 0 (digest n), Q = G with u2 = -u1
                   (R at infinity), x(R) as rpn beside a wrong r, Q = -G
                   and Q = G (table entries at infinity and doublings),
                   premask off, message lengths 0, 55, 56, 64 and 503;
                   Python ints on the edge lanes, the expected bitmap
                   beyond; then each entry at the block's 32,768-lane
                   bucket: kernel = plain, its time (CUDA events: a call
                   is milliseconds; the message entry's two launches
                   together) against ladder_bound.
  ed25519_path     30,720 Ed25519 lanes from --seed over 64 keys, 256-byte
                   messages, ~1% bad lanes of five kinds (message flipped,
                   S + L, R encoded with y = p + 1, a small-order key, the
                   wrong key), interleaved with the first block's lanes in
                   one verify_batch on the q16 provider, so the router
                   splits it; bitmaps equal the expected ones and sw on a
                   sample holding every bad lane; the Ed25519 kernel one
                   launch a chunk; the host prep's seconds apart.
  ed25519_vs_plain the Ed25519 kernel against ed25519.verify_core on the
                   card over 4,096 lanes, the first of them edges (S = 0,
                   k = 0, RFC 8032 test 1, identity operands, a dead lane,
                   R off by one point, k whose signed digits are -8, 7 or
                   carry into the top digit, L - 1, an identity R), Python
                   ints on those, the expected bitmap beyond; then its
                   time at the 32,768-lane bucket and at 2,048 lanes
                   against ed25519_bound (the lanes' least products and
                   the executed ones, the 2-bit ladder's beside them).
  idemix_block     the idemix checks of a block from --seed (BASELINE.json
                   config 4): 10,240 PS-shaped 2-term pairing products, one
                   per creator, e(sigma1, q) e(-sigma2, G2) with sigma1 =
                   k G1, q = d G2, sigma2 = kd G1 (fabric_tpu/msp/
                   idemix_ps.py 328-338), ~1% bad of four kinds (sigma2 off
                   by G1, q of another lane, the G2 points swapped, sigma1
                   negated); 20,480 3-term MSM lanes, two a presentation
                   (s_sk Y~ + s_r G~ - c T~, and [6x^2] T~ padded with
                   (0, None)); 1,024 BLS lanes, ~1% bad of three kinds
                   (another message's signature, sig + G1, None). Made in
                   the process pool from bn254_ref's fast Jacobian ladders.
  pairing_path     the block through a CUDAProvider: pairing_check_batch
                   (one Miller and one final-exp launch a chunk),
                   g2_msm_batch (one MSM launch a chunk of the live lanes),
                   bls_verify_batch,
                   each counted with every kernel count 0 before; bitmaps
                   equal the expected ones and the port's sw provider on
                   samples of >= 256 lanes holding every bad lane (the sw
                   pairings run in the pool meanwhile), MSM points equal
                   bn254_ref.g2_msm on a sample and every subgroup lane
                   psi(T~); one steady call of each under torch.profiler;
                   the Miller and final-exp launches by layout
                   (layout_launches: the block's bucket one thread a
                   lane, bls_verify_batch's 1,024 lanes 8), each > 0.
  pairing_vs_plain the Miller entry (8,192 term lanes) and the final-exp
                   entry (4,096 two-term products) against their plain
                   torch versions on the card at full length (the 6t+2
                   loop, the whole final exponentiation), edge lanes
                   first: G1 with G2, the identity products
                   e(P, Q) e(P, -Q) and e(2P, Q) e(P, -2Q), an off-by-one
                   product. Canonical values equal, verdicts equal and
                   the expected bitmap; the edges also held to Python ints
                   (Miller values through the final exponentiation, GT
                   values); both entries in each layout (bn254.LAYOUTS).
                   Then each layout at the width where bn254.layout picks
                   it (the block's bucket, 32,768 Miller and 16,384
                   final-exp lanes; bls_verify_batch's, 2,048 and 1,024).
  msm_vs_plain     the MSM entry (4,096 lanes, 254-bit scalars) against
                   its plain version, the card's chain (g2_msm_chain),
                   limb for limb, edge lanes first: k = 0, 1, r - 1,
                   Q + Q, T + (-T), the subgroup lane of G2, all terms
                   zero, their points also against Python ints; then at
                   the block's 20,480 live lanes in the provider's class
                   order (beside it, padded_ms: 32,768 lanes with the
                   block's order and all-zero pads, as the provider
                   launched them before it launched live lanes only);
                   then 64 lanes each of 9 and 17 terms (past the local
                   joint tables: the scratch-table kernel) against
                   bn254_ref.g2_msm, and on 8-bit scalars against the
                   chain, with their times.
                   The pairing and MSM entries' times: CUDA events
                   against a bound
                   from the least Fp products of each function (live
                   lanes, cheapest published formulas:
                   miller_products_min, final_exp_products_min,
                   msm_products) and, beside it, one from the products
                   the kernels execute (executed_bound_ms; the layout's
                   schedule, bn254.miller_products, final_exp_products),
                   with the products one thread of a lane runs in series
                   (chain_products) and the us per chained product.
  bls_span         one orderer identity's span of 1,023 BLS12-381 block
                   signatures from --seed (fabric_tpu/orderer/
                   blockwriter.py _self_verify's shape), signed in the
                   process pool, its aggregates at every width.
  bls_aggregate_path  CUDAProvider.verify_aggregate on the card for the
                   span's first k signatures, k = 3, 7, 15, 31 (the
                   reference's sweep) and 1,023 (1,024 pairs): the valid
                   aggregate True; one message swapped for b"forged", the
                   aggregate plus a point off the subgroup, and one key off
                   the subgroup False; each call counted (valid and forged:
                   one Miller, one reduce and one final-exp launch; the
                   gated cases none); the sw provider's
                   verdicts equal on every case up to 31 keys and on the
                   valid 1,023-key span (in the pool meanwhile). Per
                   width: steady seconds, host staging seconds, the card's
                   busy ms by entry and idle share from one profiled call,
                   and sw_s_per_call_one_core; the steady call's busy ms
                   from the provider's CUDA events (events_busy_ms).
  bls_vs_plain     the Miller entry on the span's 1,024 lanes (edge lanes
                   (G1, G2), (-G1, G2), (2 G1, G2), (G1, 2 G2) in them, the
                   last 4 masked off), the reduce on the same lanes and the
                   final-exp entry on 4 single-lane inputs (that product,
                   the span's product, one, a random value) against their
                   plain versions on the card, canonically; the final
                   exponentiation's GT values and verdicts against
                   bls12_381_ref.final_exponentiation_chain, Miller lanes
                   0, 1 and the edges against bls12_381_ref.miller_loop up
                   to an Fp2 * w^(3k) monomial. Then each entry at the
                   path's shape (1,024 lanes, one final-exp lane; the
                   Miller entry also at 4 lanes, k = 3's bucket): CUDA
                   events against bounds from the functions' least Fp
                   products (576 IMAD each) and the products executed,
                   and beside them the products one thread of a lane's
                   warp runs in series (chain_products) and the measured
                   us per chained product; each line with the entry's
                   ptxas registers, stack and spills.
  telemetry_builds every path's provider booked one build event a library
                   it loaded, each a hit: ed25519_verify (q16),
                   fused_resident (q8), ladder, bn254_pairing and g2_msm,
                   bls12_381_pairing beside the P-256 libraries.
Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from fabric_tpu_torch.stage_a_timing import MS_FROM, device_ms  # noqa: E402

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


_T0 = time.monotonic()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also carries `t_s`, the
    script's seconds so far, so the phases' share of the time limit can
    be read from the output."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.monotonic() - _T0, 1)}
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

def _pub_chunk(ds):
    from fabric_tpu_torch.bccsp import p256_host
    return [p256_host.derive_public(d) for d in ds]


def check_prep(label, sigs, plain, prepped) -> None:
    """The native prep's (ok, r, rpn, w) against `host_prep_scalars`'
    rows (None where it rejects), lane for lane, bit for bit."""
    ok, r8, rpn8, w8 = prepped
    check(len(ok) == len(plain), f"{label}: prep lane count")
    for i, rows in enumerate(plain):
        if rows is None:
            same = not ok[i] and not (r8[i].any() or rpn8[i].any()
                                      or w8[i].any())
        else:
            same = bool(ok[i]) and (r8[i].tobytes(), rpn8[i].tobytes(),
                                    w8[i].tobytes()) == rows
        check(same, f"{label}: native prep != host_prep_scalars at lane "
              f"{i} ({sigs[i].hex()})")


def adversarial_sigs(seed: int) -> list:
    """Malformed and edge DER signatures (truncations, zero and negative
    integers, non-minimal encodings and lengths, trailing bytes, s at and
    past the low-S bound, r at and past n, the r + n probe on both sides)
    and 256 seeded bit flips of a valid one."""
    from fabric_tpu_torch.bccsp import p256_host, utils
    N, half = p256_host.N, p256_host.N >> 1
    sig = utils.marshal_signature
    corpus = [
        b"", b"\x30", b"\x30\x00", b"\x02\x01\x01",
        b"\x30\x06\x02\x01\x01\x02\x01\x01",
        b"\x30\x06\x02\x01\x01\x02\x01\x01xx",
        b"\x30\x07\x02\x01\x01\x02\x01\x01x",
        b"\x30\x06\x02\x01\x00\x02\x01\x01",
        b"\x30\x06\x02\x01\x01\x02\x01\x00",
        b"\x30\x06\x02\x01\x81\x02\x01\x01",
        b"\x30\x08\x02\x03\x00\x00\x01\x02\x01\x01",
        b"\x30\x07\x02\x02\x00\x80\x02\x01\x01",
        b"\x30\x84\x00\x00\x00\x06\x02\x01\x01\x02\x01\x01",
        b"\x30\x81\x06\x02\x01\x01\x02\x01\x01",
        sig(1, half), sig(1, half + 1), sig(N - 1, 1), sig(N, 1),
        sig(N + 5, 1), sig(1, 1), sig(2**256 + 7, 1),
        sig(p256_host.P - N - 1, half), sig(p256_host.P - N + 1, half),
        sig(1, 2), sig(1, 3), sig(1, half - 1)]
    rng = np.random.default_rng(seed)
    base = sig(1234567890123456789, 987654321)
    for _ in range(256):
        m = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(len(m)))] ^= 1 << int(rng.integers(8))
        corpus.append(bytes(m))
    return corpus


def make_block(seed: int, txs: int, pool, nproc, clients: int = 0):
    """Keys, items and prepared arrays for one block, with the expected
    bitmap known by construction: 2 endorsements a tx from the 3 org keys
    and 1 creator signature, from an org key or, with `clients`, from
    client key 3 + (t mod clients)."""
    from fabric_tpu_torch import native
    from fabric_tpu_torch.bccsp import bccsp as api
    from fabric_tpu_torch.bccsp import p256_host, sw, utils
    from fabric_tpu_torch.bccsp.cuda import host_prep_scalars

    rng = np.random.default_rng(seed)
    nkeys = 3 + clients
    ds = [int.from_bytes(rng.bytes(32), "big") % (p256_host.N - 1) + 1
          for _ in range(nkeys)]
    pubs = [sw.ECDSAPublicKey(x, y)
            for x, y in pool_map(pool, _pub_chunk, ds, nproc)]
    n = 3 * txs
    key_of = np.empty(n, dtype=np.int64)
    for t in range(txs):
        key_of[3 * t] = 3 + t % clients if clients else rng.integers(3)
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
            key_of[i] = (key_of[i] + 1) % nkeys
        else:
            sigs[i] = utils.marshal_signature(r + p256_host.N, s)
    expected = np.ones(n, dtype=bool)
    expected[bad] = False

    items = [api.VerifyItem(key=pubs[key_of[i]], signature=sigs[i],
                            message=msgs[i]) for i in range(n)]
    t0 = time.perf_counter()
    der_ok, r8, rpn8, w8 = native.batch_prep(sigs)
    prep_s = time.perf_counter() - t0
    # the plain version, lane for lane: it must give the same rows
    t0 = time.perf_counter()
    plain = [host_prep_scalars(pubs[key_of[i]], sigs[i]) for i in range(n)]
    prep_python_s = time.perf_counter() - t0
    check_prep(f"block {seed}", sigs, plain, (der_ok, r8, rpn8, w8))
    prepared = dict(digests=np.frombuffer(b"".join(digests), np.uint8)
                    .reshape(n, 32), r=r8, rpn=rpn8, w=w8, der_ok=der_ok,
                    key_idx=key_of.copy(), keys=pubs,
                    get_sig=sigs.__getitem__)
    return dict(n=n, items=items, prepared=prepared, expected=expected,
                kind_of=kind_of, pubs=pubs, sigs=sigs, digests=digests,
                key_of=key_of, sign_s=sign_s, prep_s=prep_s,
                prep_python_s=prep_python_s, rng=rng, msgs=msgs, ds=ds)


# -- main path --

def profile_call(fn, pad_s: float = 0.05) -> dict:
    """One call under torch.profiler: its wall time, the summed time of
    the device's kernels and copies (the card's busy share of the call),
    of its kernels alone, and the device activities that took most. The
    window stays open `pad_s` seconds before the call and after its work
    has finished: the profiler has dropped kernels near a window's edges
    (see `device_ms`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        time.sleep(pad_s)
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
            "kernel_ms": sum(v for k, v in by_name.items()
                             if not k.startswith(("Memcpy", "Memset"))),
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


# -- the provider's telemetry --

# the libraries each provider's paths load, once each (a first load books
# one build event in the provider's device_cost)
Q16_LIBS = ("batchprep", "ptree", "sha_windows")
TRACE_CAPTURES = 3              # bounded captures, 2 kept
OVERHEAD_CALLS = 240            # commit-path calls per tracing mode


def check_build_events(label, prov, need) -> dict:
    """The provider's build events: one per library it loaded, each a hit
    (the build phase built them all) with its seconds; `need` among them.
    Returns {kind: seconds}."""
    evs = prov.device_cost.events
    kinds = [e["kind"] for e in evs]
    check(len(kinds) == len(set(kinds)),
          f"{label}: a library booked twice: {kinds}")
    check(set(need) <= set(kinds), f"{label}: build events {kinds}, "
          f"missing {sorted(set(need) - set(kinds))}")
    for e in evs:
        check(e["cache_hit"] and e["error"] is None
              and e["seconds"] >= 0, f"{label}: build event {e}")
    return {e["kind"]: e["seconds"] for e in evs}


def events_vs_profiler(label, prov, fn) -> dict:
    """One call under the profiler and the provider's busy seconds (CUDA
    events) booked by the same call: the events' window holds every
    kernel of the call and lies inside its wall, so kernel_ms x 0.95 <=
    events_busy_ms <= wall_ms x 1.05."""
    busy = prov.device_cost.busy
    before = busy.totals().get(0, 0.0)
    prof = profile_call(fn)
    ev_ms = (busy.totals().get(0, 0.0) - before) * 1e3
    check(prof["kernel_ms"] * 0.95 <= ev_ms <= prof["wall_ms"] * 1.05,
          f"{label}: events busy {ev_ms:.4f} ms, profiler kernels "
          f"{prof['kernel_ms']:.4f} ms, wall {prof['wall_ms']:.4f} ms")
    return {"events_busy_ms": ev_ms, "profiler_kernel_ms": prof["kernel_ms"],
            "profiler_device_busy_ms": prof["device_busy_ms"],
            "wall_ms": prof["wall_ms"], "kernels": prof["kernels"]}


def telemetry(blk, prov16, sw_bits, sample, card, libs) -> None:
    """The provider's telemetry on the card, on a fresh q16 provider over
    the org block (prov16's tables handed over, so nothing is rebuilt):
    (a) one build event a library its paths load, each a hit; (b) busy
    time from CUDA events against the profiler on the commit path and on
    verify_batch; (c) device_memory's row; (d) health; (e) the spans;
    (f) bounded torch trace captures; (g) the gauges; (h) the commit
    path's steady median with tracing on, off, and off with the busy
    events stubbed out, in turns."""
    import threading

    import torch
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.common import devicecost, metrics, profiling
    from fabric_tpu_torch.common import tracing

    pr = blk["prepared"]
    prov = factory.new_bccsp({"Default": "CUDA"})
    with prov16._q16_lock:
        prov._q16_cache.update(prov16._q16_cache)
        prov._q16_bytes = prov16._q16_bytes
        prov._q8_cache.update(prov16._q8_cache)
    tracing.reset(enabled=True)
    calls = {"verify_prepared": 0, "verify_batch": 0}

    def prepared():
        calls["verify_prepared"] += 1
        return prov.verify_prepared(**pr)

    def batch():
        calls["verify_batch"] += 1
        return prov.verify_batch(blk["items"])

    # (a) the fresh provider's first calls book one event a library
    check_bits("telemetry verify_prepared", prepared(), blk, sw_bits, sample)
    check_bits("telemetry verify_batch", batch(), blk, sw_bits, sample)
    build_s = check_build_events("telemetry", prov, Q16_LIBS)
    check(sorted(build_s) == sorted(Q16_LIBS),
          f"telemetry: build events {sorted(build_s)}")
    compile_stats = {k: v for k, v in prov.stats.items()
                     if k.startswith("compile_")}
    check(compile_stats["compile_total"] == len(Q16_LIBS)
          and compile_stats["compile_cache_hits"] == len(Q16_LIBS)
          and compile_stats["compile_failures"] == 0,
          f"telemetry: compile stats {compile_stats}")
    # (b) busy from events against the profiler, tables warm
    busy = {"commit_path": events_vs_profiler("commit path", prov, prepared),
            "verify_batch": events_vs_profiler("verify_batch", prov, batch)}
    ratios = prov.device_cost.busy.ratios()
    # (c) memory, with the org block's Q16 set resident
    rows = devicecost.device_memory()
    check(len(rows) == 1, f"device_memory: {len(rows)} rows")
    row = rows[0]
    total = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]) << 20
    check(row["kind"] == card.split(",")[0].strip(),
          f"device_memory kind {row['kind']!r}, nvidia-smi {card!r}")
    check(abs(row["bytes_limit"] - total) <= 0.02 * total,
          f"bytes_limit {row['bytes_limit']} against {total}")
    check(row["bytes_in_use"] >= Q16_TABLE_BYTES,
          f"bytes_in_use {row['bytes_in_use']} < the Q16 table's "
          f"{Q16_TABLE_BYTES}")
    peak = devicecost.peak_memory_bytes()
    check(peak >= row["bytes_in_use"], f"peak {peak} < in use")
    # (d) health
    health = prov.health()
    check(health == "device", f"health() {health!r}")
    low = devicecost.hbm_substate(headroom_frac=1.0)
    check(low is not None and low.startswith("hbm_low:d0:"),
          f"hbm_substate(1.0) {low!r}")
    # (e) spans: a tpu.verify a dispatch (two a commit-path call: the
    # enqueue and the wait), a tpu.dispatch a dispatcher call
    snap = tracing.snapshot()
    n_verify = sum(1 for e in snap if e[1] == "tpu.verify")
    n_dispatch = sum(1 for e in snap if e[1] == "tpu.dispatch")
    want_verify = 2 * calls["verify_prepared"] + calls["verify_batch"]
    want_dispatch = calls["verify_prepared"] + calls["verify_batch"]
    check(n_verify == want_verify and n_dispatch == want_dispatch,
          f"spans: {n_verify} tpu.verify (want {want_verify}), "
          f"{n_dispatch} tpu.dispatch (want {want_dispatch})")
    check(not any(e[9] for e in snap), "spans: an error span")
    doc = json.loads(json.dumps(tracing.chrome_trace()))
    names = {e["name"] for e in doc["traceEvents"]}
    check({"tpu.verify", "tpu.dispatch", "tpu.compile"} <= names,
          f"chrome_trace names {sorted(names)}")
    # (f) bounded trace captures around commit-path calls, one refused
    parent = os.path.join(ROOT, "fabric_tpu_torch", "_build",
                          f"telemetry_traces_{os.getpid()}")
    shutil.rmtree(parent, ignore_errors=True)
    refused, tree_named, captures = False, False, 0
    try:
        while captures < TRACE_CAPTURES or (not tree_named
                                            and captures < 2 * TRACE_CAPTURES):
            got = {}
            t = threading.Thread(target=lambda: got.setdefault(
                "dir", profiling.capture_torch_trace_bounded(
                    0.5, parent_dir=parent, keep=2)))
            t.start()
            while not profiling._trace_lock.locked() and t.is_alive():
                time.sleep(0.005)
            if not refused:
                try:
                    profiling.capture_torch_trace_bounded(
                        0.01, parent_dir=parent, keep=2)
                except profiling.ProfilerBusyError:
                    refused = True
            time.sleep(0.1)
            for _ in range(3):
                prepared()
                time.sleep(0.05)
            t.join()
            captures += 1
            with open(os.path.join(got["dir"], "trace.json")) as f:
                tree_named = "ptree_windows_kernel" in f.read()
        kept = sorted(os.listdir(parent))
    finally:
        shutil.rmtree(parent, ignore_errors=True)
    check(refused, "a capture during a capture was not refused")
    check(len(kept) == 2, f"trace captures kept {kept}")
    check(tree_named, f"no capture of {captures} named the tree kernel")
    # (g) gauges: one tick of each publisher
    reg = metrics.PrometheusProvider()
    profiling.devicecost_tick(reg, prov)()
    profiling.provider_stats_tick(reg, prov)()
    text = reg.render()
    for want in ('bccsp_device_mem_used_bytes{device="0"} ',
                 'bccsp_device_busy_ratio{device="0"} ',
                 "bccsp_compile_total ", "bccsp_tree_kernel_launches "):
        check(any(ln.startswith(want) for ln in text.splitlines()),
              f"gauges: no {want.strip()!r}")
    gauges = {ln.split(" ")[0]: float(ln.split(" ")[1])
              for ln in text.splitlines() if ln.startswith(
                  ("bccsp_device_", "bccsp_compile_"))}
    # (h) the commit path in turns: everything on; spans off (the busy
    # events still recorded); and bare, spans off and the provider's
    # timing events stubbed out, so neither feed runs
    arms = ("on", "spans_off", "bare")
    times: dict = {a: [] for a in arms}
    try:
        for i in range(OVERHEAD_CALLS):
            for arm in arms[i % 3:] + arms[:i % 3]:
                tracing.set_enabled(arm == "on")
                if arm == "bare":
                    prov._mark = lambda: None
                t0 = time.perf_counter()
                prov.verify_prepared(**pr)
                times[arm].append(time.perf_counter() - t0)
                prov.__dict__.pop("_mark", None)
    finally:
        tracing.set_enabled(True)
        prov.__dict__.pop("_mark", None)
    med = {a: statistics.median(t) * 1e3 for a, t in times.items()}
    on_ms, off_ms, bare_ms = med["on"], med["spans_off"], med["bare"]
    check(abs(on_ms - off_ms) <= max(0.05 * off_ms, 0.10),
          f"tracing on {on_ms:.4f} ms against off {off_ms:.4f} ms")
    check(abs(on_ms - bare_ms) <= max(0.05 * bare_ms, 0.10),
          f"spans and events on {on_ms:.4f} ms against neither "
          f"{bare_ms:.4f} ms")
    emit({"phase": "telemetry", "ok": True, "card": card,
          "build_libraries": libs, "build_events_s": build_s,
          "compile_stats": compile_stats,
          "busy": busy, "busy_ratios": ratios,
          "memory": row, "peak_memory_bytes": peak, "health": health,
          "spans": {"tpu.verify": n_verify, "tpu.dispatch": n_dispatch,
                    "calls": calls},
          "stage_device_ready_d0": tracing.stage_quantiles().get(
              "device.ready.d0"),
          "trace_captures": captures, "gauges": gauges,
          "tracing_on_median_ms": on_ms, "tracing_off_median_ms": off_ms,
          "spans_and_events_off_median_ms": bare_ms,
          "commit_path_all_ms": {a: [x * 1e3 for x in t]
                                 for a, t in times.items()}})


# -- the Q16 table lifecycle across a restart --

# the org block's key set: 3 keys, K = 4 slots; its Q16 table's bytes
WARM_K = 4
Q16_TABLE_BYTES = 16 * WARM_K * 65536 * 3 * L * 4       # 1,006,632,960
WARM_STATS = ("q16_builds", "q8_builds", "q16_disk_loads", "q8_disk_loads",
              "q16_loading_skips", "table_build_s", "table_load_s")


def table_sha256(t) -> str:
    """sha256 of a table tensor's bytes (copied to the host)."""
    return hashlib.sha256(t.cpu().numpy()).hexdigest()


def _warm_child(leg, warm_dir, prepared):
    """One leg of warm_restart in a fresh process (the 16-bit G table is
    process-global, so a restart inside one process is none): construct
    a provider (with `warm_dir` as its WarmKeysDir, or none), prewarm it
    and verify the block's digest lanes. "restore_window" verifies once
    while the restore is still running, then once after it. Returns the
    bitmaps, launch counts, stats and seconds."""
    import torch

    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.bccsp.cuda import LAUNCH_COUNTERS

    def verify():
        for mod, attr in LAUNCH_COUNTERS.values():
            setattr(mod, attr, 0)
        t = time.perf_counter()
        bits = np.asarray(prov.verify_prepared(**prepared), dtype=bool)
        secs = time.perf_counter() - t
        return bits, {k: getattr(mod, attr) for k, (mod, attr)
                      in LAUNCH_COUNTERS.items()
                      if getattr(mod, attr)}, secs

    t0 = time.perf_counter()
    cuda = {"WarmKeysDir": warm_dir} if warm_dir else {}
    prov = factory.new_bccsp({"Default": "CUDA", "CUDA": cuda})
    prov.prewarm(wait_restore=leg != "restore_window")
    prewarm_s = time.perf_counter() - t0
    out = {"leg": leg, "prewarm_s": prewarm_s}
    if leg == "restore_window":
        skips = prov.stats["q16_loading_skips"]
        out["bits"], out["launches"], out["window_verify_s"] = verify()
        out["route"] = ("q8" if prov.stats["q16_loading_skips"] > skips
                        else "q16")
        prov.flush_warm_tables()
        out["restore_done_s"] = time.perf_counter() - t0
        out["after_bits"], out["after_launches"], _ = verify()
    else:
        out["bits"], out["launches"], out["verify_s"] = verify()
        out["first_block_s"] = time.perf_counter() - t0
    (cache_key, q16), = prov._q16_cache.items()
    out["table_sha256"] = table_sha256(q16)
    prov.flush_warm_tables()
    out["stats"] = {k: prov.stats[k] for k in WARM_STATS}
    out["device"] = torch.cuda.get_device_name(0)
    return out


def run_warm_child(leg, warm_dir, prepared):
    """_warm_child in a spawned process of its own; its result and the
    process's wall seconds, start-up included."""
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(1) as pool:
        out = pool.apply(_warm_child, (leg, warm_dir, prepared))
        pool.close()
        pool.join()
    out["process_s"] = time.perf_counter() - t0
    return out


def flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x01]))


def warm_restart(blk, sw_bits, sample, card) -> dict:
    """The org block's key set across a restart, with a temporary
    WarmKeysDir under the build directory (removed at the end): the
    cold leg here (first verify_prepared, then flush_warm_tables: the
    Q16 file of Q16_TABLE_BYTES and its sidecar), then each leg in a
    spawned process: "restart" (prewarm(wait_restore=True) restores the
    table: no Q16 build, one disk load, one stage-A and one tree launch,
    the table's sha256 the cold leg's), "cold" (no warm dir: the first
    block builds), "restore_window" (a batch while the restore runs,
    whichever route it takes), "corrupt" (one byte of the file flipped:
    rebuilt). Every bitmap equals the cold leg's, the expected one and sw
    on the sample."""
    import shutil
    import tempfile

    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.common import torchenv
    from fabric_tpu_torch.ops import comb

    pr = blk["prepared"]
    os.makedirs(torchenv.BUILD_DIR, exist_ok=True)
    warm = tempfile.mkdtemp(prefix="warm_keys_", dir=torchenv.BUILD_DIR)
    rec = {"phase": "warm_restart", "ok": True, "card": card,
           "lanes": blk["n"], "keys": len(pr["keys"]), "K": WARM_K}
    prov = factory.new_bccsp({"Default": "CUDA",
                              "CUDA": {"WarmKeysDir": warm}})
    try:
        bits, counts, _, first_s = counted(
            prov, "warm_restart cold", (TREE, SHA),
            lambda: prov.verify_prepared(**pr))
        check_bits("warm_restart cold", bits, blk, sw_bits, sample)
        cold_bits = np.asarray(bits, dtype=bool)
        check(prov.stats["q16_builds"] == 1,
              f"warm_restart cold: {prov.stats['q16_builds']} Q16 builds")
        t0 = time.perf_counter()
        prov.flush_warm_tables()
        flush_s = time.perf_counter() - t0
        (cache_key, q16), = prov._q16_cache.items()
        path = prov._table_path(cache_key)
        on_disk = np.load(path, mmap_mode="r")
        check(on_disk.dtype == np.int32
              and on_disk.nbytes == Q16_TABLE_BYTES
              and on_disk.shape == (Q16_TABLE_BYTES // (3 * L * 4), 3, L),
              f"warm_restart: {path} holds {on_disk.dtype} "
              f"{on_disk.shape}, not {Q16_TABLE_BYTES} bytes")
        del on_disk
        check(comb.verify_digest_sidecar(path) is True,
              f"warm_restart: {path} fails its sidecar")
        q8_path = prov._table_path(cache_key, "qtab8")
        check(comb.verify_digest_sidecar(q8_path) is True,
              f"warm_restart: {q8_path} missing or failing its sidecar")
        cold_sha = table_sha256(q16)
        rec["cold_leg"] = {
            "table_build_s": prov.stats["table_build_s"],
            "first_verify_prepared_s": first_s,
            "launches": {k: v for k, v in counts.items() if v},
            "flush_warm_tables_s": flush_s,
            "q16_file_bytes": os.path.getsize(path),
            "q16_table_bytes": Q16_TABLE_BYTES,
            "q8_file_bytes": os.path.getsize(q8_path)}
        del q16

        legs = {}
        for leg, leg_dir in (("restart", warm), ("cold", None),
                             ("restore_window", warm), ("corrupt", warm)):
            if leg == "corrupt":
                flip_byte(path, os.path.getsize(path) // 2)
                check(comb.verify_digest_sidecar(path) is False,
                      "warm_restart: the flipped file passes its sidecar")
            out = run_warm_child(leg, leg_dir, pr)
            for k in ("bits", "after_bits"):
                if k in out:
                    check_bits(f"warm_restart {leg} ({k})", out[k], blk,
                               sw_bits, sample)
                    check(bool((out.pop(k) == cold_bits).all()),
                          f"warm_restart {leg}: bitmap != the cold leg's")
            legs[leg] = out
        st = legs["restart"]["stats"]
        check(st["q16_builds"] == 0 and st["q16_disk_loads"] == 1,
              f"warm_restart restart: {st}")
        check(legs["restart"]["launches"] == {SHA: 1, TREE: 1},
              f"warm_restart restart launches {legs['restart']['launches']}")
        for leg in ("restart", "restore_window"):
            check(legs[leg]["table_sha256"] == cold_sha,
                  f"warm_restart {leg}: the restored table's sha256 is not "
                  "the cold leg's")
        check(legs["cold"]["stats"]["q16_builds"] == 1,
              f"warm_restart cold restart: {legs['cold']['stats']}")
        check(legs["corrupt"]["stats"]["q16_builds"] == 1
              and legs["corrupt"]["stats"]["q16_disk_loads"] == 0,
              f"warm_restart corrupt: {legs['corrupt']['stats']}")
        rec.update({
            "restart_first_block_s": legs["restart"]["first_block_s"],
            "cold_first_block_s": legs["cold"]["first_block_s"],
            "restore_s": legs["restart"]["stats"]["table_load_s"],
            "restore_window_route": legs["restore_window"]["route"],
            "restore_window_verify_s":
                legs["restore_window"]["window_verify_s"],
            "corrupt_rebuilt": True, "legs": legs})
    finally:
        # no writer of the cold leg may recreate the directory
        for t in prov._persist_threads:
            t.join(120)
        shutil.rmtree(warm, ignore_errors=True)
    emit(rec)
    return rec


# -- lanes on the other NIST curves, mixed into the org block --

# lanes by curve (digest lanes carry the curve's usual hash length); ~1%
# of them bad, one of each kind
MIXED_LANES = {"P-384": (120, 48), "P-521": (90, 64), "P-224": (90, 32)}
MIXED_BAD = ("tampered", "high_s", "wrong_key")


def _ec_sign_chunk(jobs):
    from fabric_tpu_torch.bccsp import sw
    prov = sw.SWProvider()
    return [prov.sign(sw.ECDSAPrivateKey(d, curve=curve), digest)
            for curve, d, digest in jobs]


def _ec_sw_chunk(jobs):
    from fabric_tpu_torch.bccsp import sw
    prov = sw.SWProvider()
    return [prov.verify(sw.ECDSAPublicKey(x, y, curve=curve), sig, digest)
            for curve, x, y, sig, digest in jobs]


def make_mixed_lanes(seed: int, pool, nproc) -> dict:
    """MIXED_LANES' P-384, P-521 and P-224 lanes from --seed over two keys
    a curve: every other lane a 256-byte message (SHA-256 on the host),
    the rest a digest of the curve's hash length; the sw provider's
    verdicts (in the pool) held to the expected bitmap."""
    from fabric_tpu_torch.bccsp import bccsp as api
    from fabric_tpu_torch.bccsp import ec_host, sw, utils

    rng = np.random.default_rng(seed + 384)
    lanes, sign_jobs = [], []
    for curve, (count, dlen) in MIXED_LANES.items():
        c = ec_host.CURVES[curve]
        ds = [int.from_bytes(rng.bytes(c.size + 8), "big") % (c.n - 1) + 1
              for _ in range(2)]
        pubs = [sw.ECDSAPrivateKey(d, curve=curve).public_key() for d in ds]
        for i in range(count):
            msg = rng.bytes(256)
            digest = (hashlib.sha256(msg).digest() if i % 2 else
                      hashlib.sha512(msg).digest()[:dlen])
            lanes.append(dict(pubs=pubs, msg=msg,
                              digest=None if i % 2 else digest, kind="ok"))
            sign_jobs.append((curve, ds[0], digest))
    t0 = time.perf_counter()
    sigs = pool_map(pool, _ec_sign_chunk, sign_jobs, nproc)
    sign_s = time.perf_counter() - t0
    bad = rng.choice(len(lanes), len(MIXED_BAD), replace=False).tolist()
    for lane, kind in zip(bad, MIXED_BAD):
        lanes[lane]["kind"] = kind
    items, sw_jobs = [], []
    for ln, sig in zip(lanes, sigs):
        pub = ln["pubs"][1 if ln["kind"] == "wrong_key" else 0]
        msg, digest = ln["msg"], ln["digest"]
        if ln["kind"] == "tampered":
            msg = msg[:-1] + bytes([msg[-1] ^ 1])
            if digest is not None:
                digest = hashlib.sha512(msg).digest()[:len(digest)]
        elif ln["kind"] == "high_s":
            r, s_ = utils.unmarshal_signature(sig)
            sig = utils.marshal_signature(r, pub.order - s_)
        items.append(api.VerifyItem(key=pub, signature=sig, digest=digest,
                                    message=msg if digest is None else None))
        sw_jobs.append((pub.curve, pub.x, pub.y, sig, digest
                        or hashlib.sha256(msg).digest()))
    expected = np.array([ln["kind"] == "ok" for ln in lanes])
    sw_bits = np.array(pool_map(pool, _ec_sw_chunk, sw_jobs, nproc), bool)
    check(bool((sw_bits == expected).all()),
          "mixed curves: sw provider != expected bitmap")
    return dict(items=items, expected=expected, sw_bits=sw_bits,
                sign_s=sign_s, bad=len(bad))


def mixed_curve_path(blk, mixed, prov, base_counts, sw_bits, sample, card):
    """The org block's verify_batch with the mixed lanes spread through
    it, on the q16 provider: every verdict equals the expected bitmap and
    sw's, and the P-256 lanes still reach the card with the launch counts
    of the P-256-only call (`base_counts`)."""
    n, extra = blk["n"], len(mixed["items"])
    at = set(np.linspace(0, n + extra - 1, extra).astype(int).tolist())
    check(len(at) == extra, "mixed curves: lane positions collide")
    items, where, base = [], [], iter(blk["items"])
    it_mixed = iter(mixed["items"])
    for pos in range(n + extra):
        if pos in at:
            where.append(pos)
            items.append(next(it_mixed))
        else:
            items.append(next(base))
    got, counts, delta, secs = counted(
        prov, "mixed curves verify_batch", (SHA, TREE),
        lambda: prov.verify_batch(items))
    got = np.asarray(got, dtype=bool)
    mine = np.zeros(n + extra, dtype=bool)
    mine[where] = True
    check_bits("mixed curves: the P-256 lanes", got[~mine], blk, sw_bits,
               sample)
    check(bool((got[mine] == mixed["expected"]).all()),
          "mixed curves: lanes off P-256 != expected bitmap")
    check(bool((got[mine] == mixed["sw_bits"]).all()),
          "mixed curves: lanes off P-256 != sw")
    check(counts == base_counts, f"mixed curves: launches {counts} != the "
          f"P-256-only call's {base_counts}")
    check(delta["nonp256_sw_lanes"] == extra,
          f"mixed curves: {delta['nonp256_sw_lanes']} sw lanes, not {extra}")
    emit({"phase": "mixed_curves", "ok": True, "card": card,
          "lanes": n + extra, "lanes_by_curve": {
              k: v[0] for k, v in MIXED_LANES.items()},
          "bad_lanes": mixed["bad"], "sign_s": mixed["sign_s"],
          "verify_batch_s": secs, "verify_batch_launches": counts,
          "nonp256_sw_lanes": delta["nonp256_sw_lanes"]})


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
    ms_from = MS_FROM["ptree_windows_kernel"]
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
          "max_abs_err": max_abs_err, "windows_ms": ms, "ms_from": ms_from,
          "windows_call_ms": call_ms, "points_ms": points_ms,
          "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "share_of_bound": bound_ms / ms, "ms_by_threads_per_lane": by_t})
    return dict(max_abs_err=max_abs_err, ms=ms, ms_from=ms_from,
                call_ms=call_ms,
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
        res[wb] = dict(max_abs_err=err, ms=ms,
                       ms_from=MS_FROM["sha_windows_kernel"], call_ms=call_ms,
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
            max_abs_err=err, ms=ms, ms_from=MS_FROM["digest_windows_kernel"],
            call_ms=call_ms, plain_ms=plain_ms,
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
        max_abs_err=err, ms=ms, ms_from=MS_FROM["sha256_digest_kernel"],
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
               ms_from=MS_FROM["fused_resident_kernel"],
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


# -- the Shamir ladder: a block over more than MaxKeys keys --

LADDER, ED = "ladder_launches", "ed25519_launches"
CLIENTS = 1021                  # creator keys: 3 org + 1,021 = 1,024 keys
# field products of one ladder lane (csrc/ladder.cuh): the table's one
# doubling and ten additions, 128 steps of two doublings and one addition,
# the check's two products; and stage A's three mod-n products
DBL_IMAD = 13 * FIELD_MUL_IMAD
LADDER_LANE_IMAD = (257 * DBL_IMAD + 138 * CADD_IMAD + CHECK_IMAD
                    + 3 * MODN_MUL_OPS)
# Ed25519 (csrc/ed25519.cuh): a product of 2^255 - 19 is 8 x 8 partial
# products (a low and a high IMAD each) plus the fold of the high half by
# 38 (8 more, low and high); a squaring 36 partial products (28 cross
# products, doubled, and 8 squares) and the same fold. A lane (ref10's
# split representations): the cached table of 0..8 * (-A), 65 products
# (T of -A, seven cached additions to P3, eight 2dT); [k](-A) on 64 signed
# radix-16 digits, the top digit's entry a P2 for free, then per lower
# digit three doublings to P2 (4 squarings, 3 products) and one to P3
# (4 and 4), and one cached addition to P2 (7), and the last T (1); [S]B
# by 32 Niels additions (7 each, the last 3); the check's 2. An addition
# of a zero digit or of a zero window adds the identity: the least count
# takes those off (ed_lane_products), ED_ADD products each.
F25_MUL_IMAD = 2 * 8 * 8 + 2 * 8
F25_SQR_IMAD = 2 * 36 + 2 * 8
ED_ADD = 7
ED_LANE_MULS = 65 + 63 * (3 * 3 + 4 + ED_ADD) + 1 + 32 * ED_ADD - 4 + 2
ED_LANE_SQRS = 63 * 4 * 4
# what the earlier kernel design ran (extended coordinates, [k](-A) by a
# 2-bit ladder): the old bound's count, printed beside the new one
ED_LADDER_LANE_PRODUCTS = 31 * 9 + 1 + 8 + 9 + 128 * (2 * 8 + 9) + 9 + 2
ED_TABLE_BYTES = 8192 * 3 * 8 * 4


def ladder_bound(live: int, live_blocks: int,
                 nbytes: int) -> tuple[float, str]:
    """Least time for a ladder entry on these inputs (ms): the IMAD of the
    `live` lanes it verifies (premask-off lanes return at once) plus
    SHA-256's operations over the live blocks, or the bytes it must move,
    whichever is larger."""
    ops = live * LADDER_LANE_IMAD + live_blocks * SHA_BLOCK_OPS
    t_ops, t_bytes = ops / INT32_IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ed_lane_products(s8, k8, premask) -> tuple[int, int, int]:
    """(least products, squarings, executed products) over the lanes of
    `stage_rows`' s8, k8 (B, 32) and premask: a live lane executes
    ED_LANE_MULS products and ED_LANE_SQRS squarings; its least takes off
    the additions of its zero signed digits below the top (k + 0x88...8's
    nibbles of 8) and of its zero bytes of S. Premask-off lanes compute
    nothing."""
    live = np.asarray(premask, bool)
    k = np.asarray(k8)[live]
    s = np.asarray(s8)[live]
    n = int(live.sum())
    bias = int("88" * 32, 16)
    kb = [int.from_bytes(row.tobytes(), "big") + bias for row in k]
    zero_digits = sum(sum(((v >> (4 * i)) & 15) == 8 for i in range(63))
                      for v in kb)
    zero_windows = int((s == 0).sum())
    return (n * ED_LANE_MULS - ED_ADD * (zero_digits + zero_windows),
            n * ED_LANE_SQRS, n * ED_LANE_MULS)


def ed25519_bound(muls: int, sqrs: int, B: int) -> tuple[float, str]:
    """Least time for the Ed25519 kernel (ms): the IMAD of `muls` products
    and `sqrs` squarings, or the bytes of six 32-byte rows and a premask
    byte a lane, the verdicts and the table read once, whichever is
    larger."""
    ops = muls * F25_MUL_IMAD + sqrs * F25_SQR_IMAD
    nbytes = B * (6 * 32 + 2) + ED_TABLE_BYTES
    t_ops, t_bytes = ops / INT32_IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _ladder_int(e, r, rpn, w, q, premask):
    """Python ints: the ladder lane's verdict."""
    from fabric_tpu_torch.ops import p256
    N = p256.N
    u1, u2 = e * w % N, r * w % N
    R = p256.cadd_int(p256.scalar_mul_int(u1, (p256.GX, p256.GY, 1)),
                      p256.scalar_mul_int(u2, (q[0], q[1], 1)))
    aff = p256.to_affine_int(R)
    return bool(premask) and aff is not None and aff[0] in (r, rpn)


def _ladder_int_chunk(jobs):
    return [_ladder_int(*j) for j in jobs]


def _ladder_construct(q, u1, u2):
    """(e, r, rpn, w) of a lane that accepts with u1*G + u2*Q: r = x(R)
    mod n, w = u2 / r, e = u1 / w (e = n where u1 = 0: a digest of n)."""
    from fabric_tpu_torch.ops import p256
    N, P = p256.N, p256.P
    R = p256.cadd_int(p256.scalar_mul_int(u1, (p256.GX, p256.GY, 1)),
                      p256.scalar_mul_int(u2, (q[0], q[1], 1)))
    r = p256.to_affine_int(R)[0] % N
    w = u2 * pow(r, -1, N) % N
    e = u1 * pow(w, -1, N) % N if u1 else N
    return e, r, (r + N if r + N < P else r), w


LADDER_EDGES = ("u1_zero", "r_at_inf", "rpn_hit", "table_inf", "table_dbl",
                "premask_off")
LADDER_MSG_LENS = (0, 55, 56, 64, 503)


def ladder_edges(blk, rng):
    """The ladder's edge lanes, each kind three times: u1 = 0 (digest n,
    accepts), Q = G with u2 = -u1 (R at infinity, rejects), x(R) given
    as rpn beside a wrong r (accepts through rpn), Q = -G and Q = G with
    R = u1*G + u2*Q (table entries at infinity and doublings, accept),
    an accepting lane with premask off; then message lanes of 0, 55, 56,
    64 and 503 bytes signed by an org key. Returns rows (kind, e or
    None, r, rpn, w, (qx, qy), premask, message or None)."""
    from fabric_tpu_torch.bccsp import p256_host
    from fabric_tpu_torch.ops import p256
    N, P = p256.N, p256.P
    G, negG = (p256.GX, p256.GY), (p256.GX, P - p256.GY)
    pubs = blk["pubs"]

    def rnd():
        return int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1

    rows = []
    for j in range(3):
        q = (pubs[3 + j].x, pubs[3 + j].y)
        rows.append(("u1_zero", *_ladder_construct(q, 0, rnd()), q, True,
                     None))
        e, w = rnd(), rnd()
        r = N - e
        rows.append(("r_at_inf", e, r, r + N if r + N < P else r, w, G,
                     True, None))
        e, r, w = rnd(), rnd(), rnd()
        R = p256.cadd_int(p256.scalar_mul_int(e * w % N, (*G, 1)),
                          p256.scalar_mul_int(r * w % N, (*q, 1)))
        rows.append(("rpn_hit", e, r, p256.to_affine_int(R)[0], w, q, True,
                     None))
        rows.append(("table_inf", *_ladder_construct(negG, rnd(), rnd()),
                     negG, True, None))
        rows.append(("table_dbl", *_ladder_construct(G, rnd(), rnd()), G,
                     True, None))
        rows.append(("premask_off", *_ladder_construct(q, rnd(), rnd()), q,
                     False, None))
    d, q = blk["ds"][0], (pubs[0].x, pubs[0].y)
    for ln in LADDER_MSG_LENS:
        msg = rng.bytes(ln)
        r, s = p256_host.sign(d, hashlib.sha256(msg).digest())
        s = min(s, N - s)
        rows.append((f"msg_{ln}", None, r, r + N if r + N < P else r,
                     pow(s, -1, N), q, True, msg))
    return rows


def ladder_lanes(blk, bucket: int, nb: int, edges=()):
    """The ladder block's lanes as both entries take them, on the host:
    the first len(edges) lanes rewritten by the edge rows. Returns numpy
    arrays and the message list."""
    n = min(blk["n"], bucket)
    pr = blk["prepared"]

    def pad(a, shape, dtype):
        out = np.zeros(shape, dtype)
        out[:n] = a[:n]
        return out

    msgs = list(blk["msgs"][:n]) + [b""] * (bucket - n)
    r8, rpn8, w8 = (pad(pr[k], (bucket, 32), np.uint8)
                    for k in ("r", "rpn", "w"))
    premask = pad(pr["der_ok"], (bucket,), bool)
    q8 = np.zeros((bucket, 64), np.uint8)
    q8[:n] = np.stack([np.concatenate([p.x_bytes(), p.y_bytes()])
                       for p in blk["pubs"]])[pr["key_idx"][:n]]
    dg = pad(np.ascontiguousarray(pr["digests"]), (bucket, 32), np.uint8)
    has_digest = np.zeros(bucket, bool)
    for i, (kind, e, r, rpn, w, q, pm, msg) in enumerate(edges):
        for row, v in ((r8, r), (rpn8, rpn), (w8, w)):
            row[i] = np.frombuffer(v.to_bytes(32, "big"), np.uint8)
        q8[i] = np.frombuffer(q[0].to_bytes(32, "big")
                              + q[1].to_bytes(32, "big"), np.uint8)
        premask[i] = pm
        if msg is None:
            dg[i] = np.frombuffer(e.to_bytes(32, "big"), np.uint8)
            has_digest[i] = True
            msgs[i] = b""
        else:
            dg[i] = np.frombuffer(hashlib.sha256(msg).digest(), np.uint8)
            msgs[i] = msg
    from fabric_tpu_torch.ops import sha256
    blocks, counts = sha256.pack_messages(msgs, nb)
    nblocks = np.where(has_digest, 0, counts).astype(np.int32)
    return dict(blocks=blocks, nblocks=nblocks, has_digest=has_digest,
                digests=dg.view(">u4").astype(np.uint32), q8=q8, r8=r8,
                rpn8=rpn8, w8=w8, premask=premask)


def _ladder_tensors(h, dev):
    import torch

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    dg = put(h["digests"].view(np.int32))
    rows = (put(h["q8"]), put(h["r8"]), put(h["rpn8"]), put(h["w8"]),
            put(h["premask"]))
    return (dict(digests=(dg, *rows),
                 message=(put(h["blocks"].view(np.int32)), put(h["nblocks"]),
                          dg, put(h["has_digest"]), *rows)))


def ladder_path(blk, prov, sw_bits, sample, card):
    """The ladder block through CUDAProvider: verify_prepared (digest
    lanes) and verify_batch (message lanes: the digest-only SHA kernel,
    then the ladder), each counted; one steady verify_prepared under the
    profiler."""
    from fabric_tpu_torch.bccsp.cuda import LAUNCH_COUNTERS

    n = blk["n"]
    pr = blk["prepared"]
    chunks = -(-prov._bucket(n) // prov._chunk)
    rec = {"phase": "ladder_path", "ok": True, "card": card, "lanes": n,
           "keys": len(blk["pubs"]),
           "bad_lanes": int((~blk["expected"]).sum()),
           "sample_vs_sw": int(len(sample))}
    counts = {}
    # message lanes: the digest-only SHA kernel, then the ladder
    for path, need, fn in (
            ("verify_prepared", (LADDER,),
             lambda: prov.verify_prepared(**pr)),
            ("verify_batch", (LADDER, DIGEST),
             lambda: prov.verify_batch(blk["items"]))):
        got, counts[path], delta, secs = counted(prov, f"ladder {path}",
                                                 need, fn)
        check_bits(f"ladder {path}", got, blk, sw_bits, sample)
        for k in need:
            check(counts[path][k] == chunks,
                  f"ladder {path}: {counts[path][k]} {k}, not one per "
                  f"chunk ({chunks})")
        others = [k for k in LAUNCH_COUNTERS if k not in need]
        check(all(counts[path][k] == 0 for k in others),
              f"ladder {path}: other kernels ran: {counts[path]}")
        check(delta["ladder_batches"] >= 1 and delta["comb_batches"] == 0,
              f"ladder {path}: stats {delta}")
        check(delta["host_hashed_lanes"] == 0,
              f"ladder {path}: lanes hashed on the host")
        rec[f"{path}_s"] = secs
        rec[f"{path}_launches"] = counts[path]
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = prov.verify_prepared(**pr)
        steady.append(time.perf_counter() - t0)
    check_bits("ladder verify_prepared (steady)", got, blk, sw_bits, sample)
    # the profiler has dropped the ladder's kernel event from whole windows
    # on the H100 (the launch counts above show it ran): profile again,
    # and say so in the line when no window kept it
    for tries in range(1, 6):
        prof = profile_call(lambda: prov.verify_prepared(**pr))
        if prof["kernels"]:
            break
    prof.update(windows=tries, kernel_event_kept=bool(prof["kernels"]))
    rec.update({"verify_prepared_steady_s": statistics.median(steady),
                "verify_prepared_steady_all_s": steady,
                "sigs_per_s_commit_path": n / statistics.median(steady),
                "verify_prepared_profiled": prof})
    emit(rec)
    return counts


def ladder_vs_plain(blk, prov, card, pool, nproc):
    """Both ladder entries against the plain version on the card over
    EDGE_LANES lanes (the edge rows first), Python ints on the edge lanes
    and the expected bitmap beyond; then each entry's device time at the
    block's bucket against its bound."""
    import torch

    from fabric_tpu_torch.ops import verify

    dev = prov.device
    rng = np.random.default_rng(4321)
    edges = ladder_edges(blk, rng)
    E = len(edges)
    nb = prov._nb_bucket(max(LADDER_MSG_LENS))
    h = ladder_lanes(blk, EDGE_LANES, nb, edges)
    t = _ladder_tensors(h, dev)
    got = {"digests": verify.ladder_verify_digests(*t["digests"]),
           "message": verify.ladder_verify(*t["message"])}
    plain = {"digests": verify.ladder_digests_plain(*t["digests"]),
             "message": verify.ladder_plain(*t["message"])}
    torch.cuda.synchronize()
    jobs = []
    for kind, e, r, rpn, w, q, pm, msg in edges:
        if msg is not None:
            e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
        jobs.append((e, r, rpn, w, q, pm))
    want_edges = np.array(pool_map(pool, _ladder_int_chunk, jobs, nproc))
    exp = blk["expected"][:EDGE_LANES]
    res = {}
    for entry in got:
        kh, ph = got[entry].cpu().numpy(), plain[entry].cpu().numpy()
        err = int(np.abs(kh.astype(np.int64) - ph).max())
        check(err == 0, f"ladder {entry}: kernel != plain at lanes "
              f"{np.nonzero(kh != ph)[0][:10].tolist()}")
        check(bool((kh[:E] == want_edges).all()),
              f"ladder {entry}: edge lanes != ints at "
              f"{np.nonzero(kh[:E] != want_edges)[0].tolist()}")
        check(bool((kh[E:] == exp[E:]).all()),
              f"ladder {entry}: != expected beyond the edge lanes")
        res[entry] = dict(max_abs_err=err)
    accepts = {k: bool(v) for (k, *_), v in zip(edges, want_edges)}
    for kind in ("u1_zero", "rpn_hit", "table_inf", "table_dbl",
                 "msg_0", "msg_503"):
        check(accepts[kind], f"ladder edge {kind} rejected by the ints")
    check(not accepts["r_at_inf"] and not accepts["premask_off"],
          "ladder edges r_at_inf / premask_off accepted")

    # device time at the block's bucket, both entries
    B = prov._bucket(blk["n"])
    h = ladder_lanes(blk, B, prov._nb_bucket(256))
    t = _ladder_tensors(h, dev)
    live = int(h["premask"].sum())
    live_blocks = int(h["nblocks"][h["premask"]].sum())
    for entry, fn, plain_fn, extra in (
            ("digests", verify.ladder_verify_digests,
             verify.ladder_digests_plain, 0),
            ("message", verify.ladder_verify, verify.ladder_plain,
             live_blocks * 64 + B * 5)):
        args = t[entry]
        out = fn(*args)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        pl = plain_fn(*args)
        t1.record()
        torch.cuda.synchronize()
        check(torch.equal(out, pl), f"ladder {entry} at {B} lanes: kernel "
              "!= plain")
        check(bool((out[:blk["n"]].cpu().numpy() == blk["expected"]).all()),
              f"ladder {entry} at {B} lanes: != expected")
        # a kernel of milliseconds keeps the queue ahead of its wrapper's
        # ~0.05 ms of host work, so events around back-to-back calls time
        # the card
        ms = cuda_ms(lambda: fn(*args), 5)
        bound_ms, bound_by = ladder_bound(
            live, live_blocks if entry == "message" else 0,
            B * (32 + 64 + 3 * 32 + 2) + extra)
        res[entry].update(ms=ms, plain_ms=t0.elapsed_time(t1),
                          bound_ms=bound_ms,
                          bound_by=bound_by, share_of_bound=bound_ms / ms)
        if entry == "message":
            # the two entries in turns, and the message entry with every
            # lane a digest lane (no SHA-256): what the message entry's
            # extra time is
            blocks, nblocks, dg, has, *rows = args
            dg_args = (blocks, torch.zeros_like(nblocks), dg,
                       torch.ones_like(has), *rows)
            check(torch.equal(verify.ladder_verify(*dg_args), out),
                  "ladder message entry on digest lanes != its verdicts")
            turns = {"digests": [], "message": []}
            for e in ("digests", "message", "message", "digests"):
                f = (verify.ladder_verify_digests if e == "digests"
                     else verify.ladder_verify)
                turns[e].append(cuda_ms(lambda: f(*t[e]), 5))
            res[entry]["turns_ms"] = turns
            res[entry]["message_entry_no_sha_ms"] = cuda_ms(
                lambda: verify.ladder_verify(*dg_args), 5)
        emit({"phase": "ladder_vs_plain", "entry": entry, "ok": True,
              "card": card, "lanes_vs_plain": EDGE_LANES,
              "edge_lanes": {k: bool(v) for (k, *_), v in zip(edges,
                                                             want_edges)},
              "lanes_timed": B, "live_lanes": live, **res[entry]})
    return res


# -- Ed25519 --

ED_BAD_KINDS = ("flipped", "s_ge_l", "noncanon_r", "small_order_a",
                "wrong_key")
ED_KEYS = 64
ED_LANES = 30720
# RFC 8032 section 7.1, test 1: secret key, public key, signature of b""
RFC8032_SEED = bytes.fromhex(
    "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
RFC8032_PK = bytes.fromhex(
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
RFC8032_SIG = bytes.fromhex(
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555"
    "fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")


def _ed_sign_chunk(jobs):
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    return [edh.sign(seed, msg) for seed, msg in jobs]


def _ed_prep_chunk(jobs):
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    return [edh.prep_verify(pk, sig, msg) for pk, sig, msg in jobs]


def _ed_sw_chunk(jobs):
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    return [edh.verify(pk, sig, msg) for pk, sig, msg in jobs]


def make_ed_block(seed: int, pool, nproc):
    """ED_LANES Ed25519 lanes over ED_KEYS keys, 256-byte messages, ~1%
    bad lanes of five kinds (message flipped after signing, S + L,
    R encoded non-canonically (y = p + 1), a small-order key, checked
    against another key), the expected bitmap known by construction."""
    from fabric_tpu_torch.bccsp import bccsp as api
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    from fabric_tpu_torch.bccsp import sw

    rng = np.random.default_rng(seed + 2)
    seeds = [rng.bytes(32) for _ in range(ED_KEYS)]
    pks = [edh.public_from_seed(s) for s in seeds]
    n = ED_LANES
    key_of = rng.integers(ED_KEYS, size=n)
    raw = rng.bytes(256 * n)
    msgs = [raw[256 * i:256 * (i + 1)] for i in range(n)]
    t0 = time.perf_counter()
    sigs = pool_map(pool, _ed_sign_chunk,
                    [(seeds[key_of[i]], msgs[i]) for i in range(n)], nproc)
    sign_s = time.perf_counter() - t0
    lane_pk = [pks[k] for k in key_of]
    small = edh.encode_point(0, edh.P - 1)           # order 2
    bad = rng.choice(n, size=n // 100, replace=False)
    kind_of = {}
    for j, i in enumerate(bad.tolist()):
        kind = ED_BAD_KINDS[j % len(ED_BAD_KINDS)]
        kind_of[i] = kind
        if kind == "flipped":
            m = bytearray(msgs[i])
            m[int(rng.integers(256))] ^= 0x01
            msgs[i] = bytes(m)
        elif kind == "s_ge_l":
            s = int.from_bytes(sigs[i][32:], "little") + edh.L
            sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
        elif kind == "noncanon_r":
            sigs[i] = (edh.P + 1).to_bytes(32, "little") + sigs[i][32:]
        elif kind == "small_order_a":
            lane_pk[i] = small
        else:
            lane_pk[i] = pks[(key_of[i] + 1) % ED_KEYS]
    expected = np.ones(n, dtype=bool)
    expected[bad] = False
    keys = {pk: sw.Ed25519PublicKey(pk) for pk in set(lane_pk)}
    items = [api.VerifyItem(key=keys[lane_pk[i]], signature=sigs[i],
                            message=msgs[i]) for i in range(n)]
    return dict(n=n, items=items, expected=expected, kind_of=kind_of,
                lane_pk=lane_pk, sigs=sigs, msgs=msgs, sign_s=sign_s,
                seeds=seeds, pks=pks, rng=rng)


def ed25519_path(eblk, blk, prov, card, pool, nproc):
    """The Ed25519 block through verify_batch, interleaved with the P-256
    block's lanes so the router splits the batch; bitmaps against the
    expected ones and the sw provider on a sample; counts; the host
    prep's seconds apart from the card's."""
    n = eblk["n"]
    mixed, at_ed, at_p = [], [], []
    for i in range(max(n, blk["n"])):
        for items, at in ((eblk["items"], at_ed), (blk["items"], at_p)):
            if i < len(items):
                at.append(len(mixed))
                mixed.append(items[i])
    before = prov.stats["ed25519_prep_s"]
    got, counts, delta, secs = counted(prov, "ed25519 verify_batch",
                                       (ED, SHA, TREE),
                                       lambda: prov.verify_batch(mixed))
    got = np.asarray(got, bool)
    ed_bits, p_bits = got[at_ed], got[at_p]
    check(bool((ed_bits == eblk["expected"]).all()),
          f"ed25519 != expected at lanes "
          f"{np.nonzero(ed_bits != eblk['expected'])[0][:10].tolist()}")
    check(bool((p_bits == blk["expected"]).all()),
          "the mixed batch's P-256 lanes != expected")
    rng = eblk["rng"]
    sample = np.array(sorted(set(eblk["kind_of"]) | set(
        rng.choice(n, min(2048, n), replace=False).tolist())))
    sw_bits = np.array(pool_map(pool, _ed_sw_chunk, [
        (eblk["lane_pk"][i], eblk["sigs"][i], eblk["msgs"][i])
        for i in sample.tolist()], nproc), bool)
    check(bool((sw_bits == ed_bits[sample]).all()),
          "ed25519 != sw on the sample")
    chunks = -(-prov._bucket(n) // prov._chunk)
    check(counts[ED] == chunks, f"ed25519: {counts[ED]} launches, not one "
          f"per chunk ({chunks})")
    check(delta["ed25519_batches"] >= 1 and delta["ed25519_sw_lanes"] == 0,
          f"ed25519 stats {delta}")
    prep_s = prov.stats["ed25519_prep_s"] - before
    emit({"phase": "ed25519_path", "ok": True, "card": card, "lanes": n,
          "p256_lanes": blk["n"], "keys": ED_KEYS,
          "bad_lanes": {k: sum(1 for v in eblk["kind_of"].values()
                               if v == k) for k in ED_BAD_KINDS},
          "sign_s": eblk["sign_s"], "sample_vs_sw": int(len(sample)),
          "verify_batch_s": secs, "ed25519_host_prep_s": prep_s,
          "launches": counts, "ed25519_batches": delta["ed25519_batches"]})
    return counts


def _ed_int(s, k, anx, ay, rx, ry, premask):
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    acc = edh.pt_add(edh.scalar_mult(s, edh.from_affine(edh.BX, edh.BY)),
                     edh.scalar_mult(k, edh.from_affine(anx, ay)))
    return bool(premask) and edh.pt_equal(acc, edh.from_affine(rx, ry))


def _ed_int_chunk(jobs):
    return [_ed_int(*j) for j in jobs]


# k whose signed radix-16 digits (the kernel's: k + 0x88...8 nibble by
# nibble, less 8, in [-8, 7]) hit the edges: -8 and 1 alternating (the
# table's 8 * (-A)), 7 and 1 alternating, a carry through every digit into
# the top one (2^252 - 1), L - 1. A digit of +8 does not occur.
ED_EDGE_K = {"k_digits_m8": int("08" * 31, 16),
             "k_digits_7": int("0F" * 31, 16),
             "k_top_carry": (1 << 252) - 1,
             "k_l_minus_1": 2 ** 252 + 27742317777372353535851937790883648492}


def ed25519_edges(rng):
    """Edge operand rows (kind, (s, k, neg_ax, ay, rx, ry) or None,
    premask): S = 0 and k = 0 with R made to match (accept), RFC 8032
    test 1 (accept), all-identity operands with premask on (accept), a
    dead lane (identity operands, premask off), an R off by one point
    (reject), the signed digits' edge scalars ED_EDGE_K as k with R made
    to match (accept), an identity R (S = k a for A = a B: accept); each
    twice but the vector."""
    from fabric_tpu_torch.bccsp import ed25519_host as edh
    P, Bp = edh.P, edh.from_affine(edh.BX, edh.BY)
    rows = []
    check(edh.public_from_seed(RFC8032_SEED) == RFC8032_PK
          and edh.sign(RFC8032_SEED, b"") == RFC8032_SIG,
          "RFC 8032 test 1 does not reproduce")
    rows.append(("rfc8032_1", edh.prep_verify(RFC8032_PK, RFC8032_SIG, b""),
                 True))
    for _ in range(2):
        a = edh.to_affine(edh.scalar_mult(
            int.from_bytes(rng.bytes(32), "little") % edh.L, Bp))
        neg_a = ((P - a[0]) % P, a[1])
        k = int.from_bytes(rng.bytes(32), "little") % edh.L
        s = int.from_bytes(rng.bytes(32), "little") % edh.L
        r = edh.to_affine(edh.scalar_mult(k, edh.from_affine(*neg_a)))
        rows.append(("s_zero", (0, k, *neg_a, *r), True))
        r = edh.to_affine(edh.scalar_mult(s, Bp))
        rows.append(("k_zero", (s, 0, *neg_a, *r), True))
        rows.append(("identity", (0, 0, 0, 1, 0, 1), True))
        rows.append(("dead", (0, 0, 0, 1, 0, 1), False))
        r = edh.to_affine(edh.pt_add(edh.scalar_mult(s, Bp), Bp))
        rows.append(("r_off", (s, 0, *neg_a, *r), True))
        for kind, ke in ED_EDGE_K.items():
            r = edh.pt_add(edh.scalar_mult(s, Bp), edh.scalar_mult(
                ke, edh.from_affine(*neg_a)))
            rows.append((kind, (s, ke, *neg_a, *edh.to_affine(r)), True))
        a_s = int.from_bytes(rng.bytes(32), "little") % edh.L
        neg_a = edh.to_affine(edh.scalar_mult(edh.L - a_s, Bp))
        rows.append(("identity_r", (a_s * k % edh.L, k, *neg_a, 0, 1),
                     True))
    return rows


def ed_rows(eblk, pool, nproc, bucket: int, edges=()):
    """The Ed25519 block's kernel operand rows (ed25519.stage_rows of the
    host prep, computed in the pool), the first len(edges) lanes taken by
    the edge rows."""
    from fabric_tpu_torch.ops import ed25519
    n = eblk["n"]
    prep = pool_map(pool, _ed_prep_chunk, [
        (eblk["lane_pk"][i], eblk["sigs"][i], eblk["msgs"][i])
        for i in range(min(n, bucket))], nproc)
    prep = list(prep)
    rows = ed25519.stage_rows(prep, bucket)
    for i, (_, op, pm) in enumerate(edges):
        one = ed25519.stage_rows([op], 1)
        for row, v in zip(rows[:6], one[:6]):
            row[i] = v[0]
        rows[6][i] = pm
    return rows


ED_SMALL_LANES = 2048            # a layout's second width


def ed25519_vs_plain(eblk, prov, card, pool, nproc):
    """The Ed25519 kernel against ed25519.verify_core's plain version on
    the card over EDGE_LANES lanes (edge rows first), Python ints on the
    edge lanes and the expected bitmap beyond; then its device time at
    the block's bucket and at ED_SMALL_LANES lanes, against the bound at
    the lanes' least products and, beside it, at the products the kernel
    executes and at the earlier 2-bit ladder's schedule."""
    import torch

    from fabric_tpu_torch.ops import ed25519

    dev = prov.device
    edges = ed25519_edges(np.random.default_rng(8765))
    E = len(edges)
    ktab = prov._ed_table()
    ptab = torch.as_tensor(ed25519.b_tables(), device=dev)

    def put(rows):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in rows]

    rows = ed_rows(eblk, pool, nproc, EDGE_LANES, edges)
    t = put(rows)
    kh = ed25519.ed25519_verify(ktab, *t).cpu().numpy()
    ph = ed25519.verify_core(ptab, *t).cpu().numpy()
    err = int(np.abs(kh.astype(np.int64) - ph).max())
    check(err == 0, f"ed25519: kernel != plain at lanes "
          f"{np.nonzero(kh != ph)[0][:10].tolist()}")
    jobs = [(*(op if op else (0, 0, 0, 1, 0, 1)), pm) for _, op, pm in edges]
    want = np.array(pool_map(pool, _ed_int_chunk, jobs, nproc))
    check(bool((kh[:E] == want).all()), "ed25519: edge lanes != ints")
    for (kind, _, _), v in zip(edges, want):
        check(v == (kind not in ("dead", "r_off")),
              f"ed25519 edge {kind} gave {v}")
    check(bool((kh[E:] == eblk["expected"][E:EDGE_LANES]).all()),
          "ed25519: != expected beyond the edge lanes")

    B = prov._bucket(eblk["n"])
    rows = ed_rows(eblk, pool, nproc, B)
    t = put(rows)
    out = ed25519.ed25519_verify(ktab, *t)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    pl = ed25519.verify_core(ptab, *t)
    e1.record()
    torch.cuda.synchronize()
    check(torch.equal(out, pl), f"ed25519 at {B} lanes: kernel != plain")
    check(bool((out[:eblk["n"]].cpu().numpy() == eblk["expected"]).all()),
          f"ed25519 at {B} lanes: != expected")
    live = int(rows[6].sum())
    # milliseconds a call: events time the card (see ladder_vs_plain)
    ms = cuda_ms(lambda: ed25519.ed25519_verify(ktab, *t), 5)
    small = [a[:ED_SMALL_LANES].contiguous() for a in t]
    small_ms = cuda_ms(lambda: ed25519.ed25519_verify(ktab, *small), 10)
    muls, sqrs, ex_muls = ed_lane_products(rows[0], rows[1], rows[6])
    bound_ms, bound_by = ed25519_bound(muls, sqrs, B)
    ex_ms, ex_by = ed25519_bound(ex_muls, sqrs, B)
    ladder_ms, _ = ed25519_bound(live * ED_LADDER_LANE_PRODUCTS, 0, B)
    sm_bound, sm_by = ed25519_bound(*ed_lane_products(
        rows[0][:ED_SMALL_LANES], rows[1][:ED_SMALL_LANES],
        rows[6][:ED_SMALL_LANES])[:2], ED_SMALL_LANES)
    res = dict(max_abs_err=err, ms=ms,
               plain_ms=e0.elapsed_time(e1), bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms,
               products=muls + sqrs, squarings=sqrs,
               executed_bound_ms=ex_ms, executed_bound_by=ex_by,
               executed_share=ex_ms / ms, products_executed=ex_muls + sqrs,
               ladder_schedule_bound_ms=ladder_ms,
               ptxas=ptxas_of("ed25519_verify", "ed25519_verify_kernel"))
    emit({"phase": "ed25519_vs_plain", "ok": True, "card": card,
          "lanes_vs_plain": EDGE_LANES,
          "edge_lanes": {f"{k}_{i}": bool(v) for i, ((k, _, _), v)
                         in enumerate(zip(edges, want))},
          "lanes_timed": B, "live_lanes": live,
          "small_lanes": ED_SMALL_LANES, "small_ms": small_ms,
          "small_bound_ms": sm_bound, "small_bound_by": sm_by, **res})
    return res


# -- BN254 pairings: the idemix credential checks --

MILLER, FINAL_EXP, MSM = ("miller_launches", "final_exp_launches",
                          "g2_msm_launches")
PS_LANES = 10240                # one presentation per creator of the block
BLS_LANES = 1024
PAIRING_BAD_KINDS = ("sigma2_off", "q_other", "g2_swapped", "neg_sigma1")
BLS_BAD_KINDS = ("wrong_msg", "sig_off", "none")
PAIRING_LANES = 4096            # lanes held to the plain versions
PAIRING_SAMPLE = 256            # lanes held to the sw provider, at least
# Fp products as executed: the BN254 Miller and final-exp entries' from
# their schedule (ops/bn254.py miller_products, final_exp_products: the
# layout's rounds on csrc/pairing_coop.cuh, chain and executed); the MSM's
# from csrc/bn254_tower.cuh: the doubling 7 Fp2 products and 2 complex
# squarings (25 Fp products), the mixed addition of the joint tables 13
# Fp2 products, the projective addition of the chain 14 (`msm_products`
# runs the kernel's warps over the launch order); the BLS12-381 reduce's
# from its schedule (ops/bls12_381_kernel.py reduce_products: the loads,
# a cooperative Karatsuba Fp12 product a tree node, the store). These give
# `executed_bound_ms`, the reading "products executed".
G2_DBL_FP = 7 * 3 + 2 * 2
G2_MIXED_FP = 13 * 3
G2_ADDP_FP = 14 * 3
# The functions' minimum, which `bound_ms` counts: the reference's
# algorithms (the 6t+2 loop, its final-exponentiation chain, double-and-add
# over the scalars' bits) at the cheapest published formulas, an Fp2
# product 3 Fp products (Karatsuba) and an Fp2 squaring 2. An Fp12 product
# 54 (Karatsuba Fp6, 6 Fp2 products); f^2 in the loop 36 (complex
# squaring, 2 Fp6 products); f * line 39 (the line's 3 nonzero Fp2
# coefficients, 13 Fp2 products); the tangent step 27 (2 products, 7
# squarings, b3' times Z^2 and the line scaled by xP, yP: Aranha et al.,
# Eurocrypt 2011), the chord step 41 (11 products, 2 squarings and the
# scaling); the first step's f^2 and f * line are free (f = 1). In the
# final exponentiation every squaring follows the easy part and squares in
# the cyclotomic subgroup: 18 (Granger-Scott, 9 Fp2 squarings); a Frobenius
# 10 (5 Fp2-by-Fp products, the p^2 map's cost); 1/f 341 (two Fp6
# squarings, an Fp6 inverse of 6 products and 3 squarings, the Fp2
# inverse's 4 products, an Fp inverse at its 253 squarings, two Fp6
# products). The MSM over live lanes only: a lane with a nonzero scalar
# doubles (its longest scalar's bits - 1) times and adds, the lesser of
# (its scalars' set bits - 1) mixed additions (double-and-add) and (its
# nonzero joint indices - 1) projective additions plus its joint table's
# composite entries by mixed additions (the kernel's chain), at RCB15's
# complete a = 0 formulas (doubling 6 products, 2 squarings and b3': 25;
# mixed addition 11 products and 2 b3': 39; projective addition 12
# products and 2 b3': 42), complete because the lanes hold Q + Q and
# T + (-T).
F12_MUL_MIN = 6 * 3 * 3
F12_SQR_MIN = 2 * 6 * 3
SPARSE_MIN = 13 * 3
DBL_LINE_MIN = 2 * 3 + 7 * 2 + 3 + 4
ADD_LINE_MIN = 11 * 3 + 2 * 2 + 4
CYC_SQR_MIN = 9 * 2
FROB_MIN = 5 * 2
F12_INV_MIN = 2 * 12 + (6 * 3 + 3 * 2) + 4 + 253 + 2 * 18
G2_DBL_MIN = 6 * 3 + 2 * 2 + 3
G2_ADD_MIN = 11 * 3 + 2 * 3
G2_ADDP_MIN = 12 * 3 + 2 * 3
EASY_ROWS = 5                   # the program's easy part: no squaring
BN_MUL_IMAD = 2 * 2 * 8 * 8


def miller_products_min(loop: int, corrections: int = 2) -> int:
    """The least Fp products of one Miller value (see F12_MUL_MIN)."""
    bits = bin(loop)[3:]
    return (DBL_LINE_MIN + (len(bits) - 1) * (F12_SQR_MIN + DBL_LINE_MIN
                                              + SPARSE_MIN)
            + (bits.count("1") + corrections) * (ADD_LINE_MIN + SPARSE_MIN))


def final_exp_products_min(program, nterms: int,
                           inv: int = F12_INV_MIN) -> int:
    """The least Fp products of one final-exp lane: the program's rows at
    their cheapest (cyclotomic squarings, Karatsuba products), 1/f at
    `inv`."""
    prog = np.asarray(program)
    mul = prog[:, 0] == 0
    sqr = mul & (prog[:, 2] == prog[:, 3])
    check(not sqr[:EASY_ROWS].any(), "final-exp program: a squaring in "
          "the easy part")
    return ((nterms - 1) * F12_MUL_MIN + inv
            + int((mul & ~sqr).sum()) * F12_MUL_MIN
            + int(sqr.sum()) * CYC_SQR_MIN
            + int((prog[:, 0] == 2).sum()) * FROB_MIN)


def msm_products(k_words, nbits: int) -> tuple[int, int, int]:
    """(executed, least, live lanes) Fp products of the MSM entry over
    k_words (B, T, 8) little-endian uint32 scalar words in launch order.
    Executed, as csrc/g2_msm.cu runs them: per warp of 32 lanes, on each
    of its lanes that is not all zero, a doubling a bit from the warp's
    highest top bit, a projective addition a window at each bit where any
    of those lanes has a nonzero index, and the joint tables' composite
    entries by mixed additions. Least: see G2_DBL_MIN."""
    from fabric_tpu_torch.ops import bn254

    w = np.ascontiguousarray(k_words).view(np.uint32)
    B, T = w.shape[:2]
    bits = np.unpackbits(w.view(np.uint8), axis=-1,
                         bitorder="little")[..., :nbits]    # (B, T, nbits)
    wins = bn254.msm_windows(T)
    idx = [sum(bits[:, lo + t].astype(np.int64) << t for t in range(hi - lo))
           for lo, hi in wins]                               # (B, nbits)
    nz = bits.any(axis=1)
    top = np.where(nz.any(axis=1), nbits - 1 - np.argmax(nz[:, ::-1], 1), -1)
    live = top >= 0
    tab = sum((1 << (hi - lo)) - 1 - (hi - lo) for lo, hi in wins)
    executed = 0
    for s in range(0, B, 32):
        lv = live[s:s + 32]
        if not lv.any():
            continue
        start = int(top[s:s + 32].max())
        adds = sum(int((ix[s:s + 32][lv, :start + 1] != 0).any(axis=0).sum())
                   for ix in idx)
        executed += int(lv.sum()) * ((start + 1) * G2_DBL_FP
                                     + adds * G2_ADDP_FP + tab * G2_MIXED_FP)
    ones = bits.sum(axis=(1, 2))
    joint = sum((ix != 0).sum(axis=1) for ix in idx)
    live_terms = [bits[:, lo:hi].any(axis=2).sum(axis=1) for lo, hi in wins]
    composite = sum((1 << t) - 1 - t for t in live_terms)
    old = top * G2_DBL_MIN + (ones - 1) * G2_ADD_MIN
    new = (top * G2_DBL_MIN + (joint - 1) * G2_ADDP_MIN
           + composite * G2_ADD_MIN)
    least = int(np.minimum(old, new)[live].sum())
    return executed, least, int(live.sum())


def bn_bound(products: int, nbytes: int,
             imad: int = BN_MUL_IMAD) -> tuple[float, str]:
    """Least time (ms) for `products` Fp products of `imad` multiply-adds
    each, or for `nbytes` of operands and results, whichever is larger."""
    t_ops = products * imad / INT32_IMAD_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bn_reading(ms: float, products: int, executed: int,
               nbytes: int, imad: int = BN_MUL_IMAD) -> dict:
    """A pairing entry's bound at the function's least products and,
    beside it, at the products the kernel executes (BN254's 256-IMAD
    products by default, `BLS_MUL_IMAD` for BLS12-381's)."""
    bound, by = bn_bound(products, nbytes, imad)
    ex, ex_by = bn_bound(executed, nbytes, imad)
    return dict(ms=ms, bound_ms=bound, bound_by=by,
                share_of_bound=bound / ms, products=products,
                executed_bound_ms=ex, executed_bound_by=ex_by,
                executed_share=ex / ms, products_executed=executed)


def _ps_chunk(jobs):
    """(k, d) -> the PS product's points: sigma1 = k G1, q = d G2,
    sigma2 = k d G1, so e(sigma1, q) e(-sigma2, G2) = 1."""
    from fabric_tpu_torch.ops import bn254_ref as b
    g2 = (b.G2_X, b.G2_Y)
    return [(b.g1_mul_fast(k, b.G1), b.g2_mul_fast(d, g2),
             b.g1_mul_fast(k * d % b.R, b.G1)) for k, d in jobs]


def _bls_sign_chunk(jobs):
    from fabric_tpu_torch.ops import bn254_ref as b
    return [b.g1_mul_fast(sk, b.hash_to_g1(m)) for sk, m in jobs]


def _sw_pairing_chunk(prods):
    """The sw provider's verdicts on `prods` and its seconds for them
    (one pool process, one core)."""
    from fabric_tpu_torch.bccsp import sw
    t0 = time.perf_counter()
    out = sw.SWProvider().pairing_check_batch(prods)
    return out, time.perf_counter() - t0


def _sw_bls_chunk(jobs):
    from fabric_tpu_torch.bccsp import sw
    prov = sw.SWProvider()
    return [prov.bls_verify_batch(pk, [m], [s])[0] for pk, m, s in jobs]


def _msm_ref_chunk(lanes):
    from fabric_tpu_torch.ops import bn254_ref as b
    return [b.g2_msm(lane) for lane in lanes]


def _gt_int_chunk(jobs):
    """(kernel value, [(P, Q), ...], miller?) -> does the kernel's value
    (a Miller value, taken through the final exponentiation, or a GT
    value) equal the int pairing product's?"""
    from fabric_tpu_torch.ops import bn254_ref as b
    out = []
    for val, terms, miller in jobs:
        acc = b.F12_ONE
        for p, q in terms:
            acc = b.f12_mul(acc, b.miller_loop(q, p))
        got = b.final_exponentiation_chain(val) if miller else val
        out.append(got == b.final_exponentiation_chain(acc))
    return out


def make_idemix_block(seed: int, pool, nproc):
    """The idemix checks of a block from `seed`: PS_LANES 2-term PS
    products e(sigma1, q) e(-sigma2, G2) (fabric_tpu/msp/idemix_ps.py
    328-338), ~1% bad of four kinds (sigma2 off by G1, q of another lane,
    the terms' G2 points swapped, sigma1 negated); two 3-term MSM lanes a
    presentation (idemix_ps.py 288-301: s_sk Y~ + s_r G~ - c T~, and
    [6x^2] T~ padded with (0, None)); BLS_LANES BLS lanes, ~1% bad of
    three kinds (another message's signature, sig + G1, None). Expected
    bitmaps by construction."""
    from fabric_tpu_torch.ops import bn254_ref as b
    rng = np.random.default_rng(seed + 3)

    def scalar():
        return int.from_bytes(rng.bytes(32), "big") % (b.R - 1) + 1
    g2 = (b.G2_X, b.G2_Y)
    t0 = time.perf_counter()
    pts = pool_map(pool, _ps_chunk, [(scalar(), scalar())
                                     for _ in range(PS_LANES)], nproc)
    prods = [[(s1, q), (b.g1_neg(s2), g2)] for s1, q, s2 in pts]
    bad = rng.choice(PS_LANES, size=max(len(PAIRING_BAD_KINDS),
                                        PS_LANES // 100), replace=False)
    kind_of = {}
    for j, i in enumerate(bad.tolist()):
        kind = PAIRING_BAD_KINDS[j % len(PAIRING_BAD_KINDS)]
        kind_of[i] = kind
        s1, q, s2 = pts[i]
        if kind == "sigma2_off":
            prods[i][1] = (b.g1_neg(b.g1_add_fast(s2, b.G1)), g2)
        elif kind == "q_other":
            prods[i][0] = (s1, pts[(i + 1) % PS_LANES][1])
        elif kind == "g2_swapped":
            prods[i] = [(s1, g2), (b.g1_neg(s2), q)]
        else:
            prods[i][0] = (b.g1_neg(s1), q)
    expected = np.ones(PS_LANES, bool)
    expected[bad] = False
    # the MSM lanes: T~ = each presentation's q, an issuer key Y~
    y_t = b.g2_mul_fast(scalar(), g2)
    msm = []
    for _, q, _ in pts:
        msm.append([(scalar(), y_t), (scalar(), g2), (b.R - scalar(), q)])
        msm.append([(6 * b.T_BN * b.T_BN, q), (0, None), (0, None)])
    # BLS
    sk = scalar()
    pk = b.g2_mul_fast(sk, g2)
    msgs = [rng.bytes(64) for _ in range(BLS_LANES)]
    sigs = pool_map(pool, _bls_sign_chunk, [(sk, m) for m in msgs], nproc)
    bls_bad = rng.choice(BLS_LANES, size=max(len(BLS_BAD_KINDS),
                                             BLS_LANES // 100),
                         replace=False)
    bls_kind = {}
    for j, i in enumerate(bls_bad.tolist()):
        kind = BLS_BAD_KINDS[j % len(BLS_BAD_KINDS)]
        bls_kind[i] = kind
        if kind == "wrong_msg":
            sigs[i] = sigs[(i + 1) % BLS_LANES]
        elif kind == "sig_off":
            sigs[i] = b.g1_add_fast(sigs[i], b.G1)
        else:
            sigs[i] = None
    bls_expected = np.ones(BLS_LANES, bool)
    bls_expected[bls_bad] = False
    return dict(pts=pts, prods=prods, expected=expected, kind_of=kind_of,
                msm=msm, pk=pk, msgs=msgs, sigs=sigs,
                bls_expected=bls_expected, bls_kind=bls_kind,
                make_s=time.perf_counter() - t0, rng=rng)


def _sample(rng, n, must) -> list[int]:
    """Lanes for a host-oracle sample: every lane of `must` and random
    ones, PAIRING_SAMPLE at least (or all n)."""
    extra = min(n, max(0, PAIRING_SAMPLE - len(set(must))) + 16)
    return sorted(set(must) | set(rng.choice(n, extra,
                                             replace=False).tolist()))


def pairing_path(iblk, prov, card, pool, nproc):
    """The idemix block through CUDAProvider: pairing_check_batch,
    g2_msm_batch and bls_verify_batch, each counted (every kernel count 0
    before, the path's kernels one launch a chunk after); bitmaps against
    the expected ones and the sw provider on samples holding every bad
    lane (the sw jobs run in the pool meanwhile), the MSM's points
    against bn254_ref.g2_msm on a sample and every subgroup lane against
    psi(T~); one steady call of each under the profiler."""
    from fabric_tpu_torch.ops import bn254_ref as b

    rng = iblk["rng"]
    n, nb = PS_LANES, BLS_LANES
    ps_sample = _sample(rng, n, iblk["kind_of"])
    bls_sample = _sample(rng, nb, iblk["bls_kind"])
    msm_sample = _sample(rng, 2 * n, [])
    sw_ps = pool.map_async(_sw_pairing_chunk, _chunks(
        [iblk["prods"][i] for i in ps_sample], nproc * 4))
    sw_bls = pool.map_async(_sw_bls_chunk, _chunks(
        [(iblk["pk"], iblk["msgs"][i], iblk["sigs"][i])
         for i in bls_sample], nproc * 4))
    ref_msm = pool.map_async(_msm_ref_chunk, _chunks(
        [iblk["msm"][i] for i in msm_sample], nproc * 4))
    others = [k for k in prov.stats if k.endswith("_launches")
              and k not in (MILLER, FINAL_EXP, MSM)]
    rec = {"phase": "pairing_path", "ok": True, "card": card,
           "products": n, "msm_lanes": 2 * n, "bls_lanes": nb,
           "bad_products": {k: sum(1 for v in iblk["kind_of"].values()
                                   if v == k) for k in PAIRING_BAD_KINDS},
           "bad_bls": {k: sum(1 for v in iblk["bls_kind"].values()
                              if v == k) for k in BLS_BAD_KINDS},
           "make_s": iblk["make_s"]}
    counts = {}
    calls = {
        "pairing_check_batch": ((MILLER, FINAL_EXP), lambda:
                                prov.pairing_check_batch(iblk["prods"])),
        "g2_msm_batch": ((MSM,), lambda: prov.g2_msm_batch(iblk["msm"])),
        "bls_verify_batch": ((MILLER, FINAL_EXP), lambda:
                             prov.bls_verify_batch(iblk["pk"],
                                                   iblk["msgs"],
                                                   iblk["sigs"]))}
    out = {}
    # the pairing entries' launches by layout over the path's calls
    from fabric_tpu_torch.ops import bn254
    for k in bn254.layout_launches:
        bn254.layout_launches[k] = 0
    for name, (need, fn) in calls.items():
        out[name], counts[name], delta, secs = counted(prov, name, need, fn)
        rec[f"{name}_s"] = secs
        lanes = nb if name == "bls_verify_batch" else (
            2 * n if name == "g2_msm_batch" else n)
        chunks = -(-lanes // prov._chunk)
        for k in need:
            check(counts[name][k] == chunks, f"{name}: {k} "
                  f"{counts[name][k]}, not one per chunk ({chunks})")
        check(all(counts[name][k] == 0 for k in others),
              f"{name}: other kernels ran: {counts[name]}")
        rec[f"{name}_launches"] = {k: counts[name][k] for k in need}
    got = np.array(out["pairing_check_batch"], bool)
    check(bool((got == iblk["expected"]).all()),
          f"pairing_check_batch != expected at "
          f"{np.nonzero(got != iblk['expected'])[0][:10].tolist()}")
    got_b = np.array(out["bls_verify_batch"], bool)
    check(bool((got_b == iblk["bls_expected"]).all()),
          f"bls_verify_batch != expected at "
          f"{np.nonzero(got_b != iblk['bls_expected'])[0][:10].tolist()}")
    msm = out["g2_msm_batch"]
    sub_bad = [j for j in range(n) if msm[2 * j + 1]
               != b.g2_frobenius_fast(iblk["pts"][j][1])]
    check(not sub_bad, f"g2_msm_batch: subgroup lanes != psi(T~) at "
          f"{sub_bad[:10]}")
    # the steady call of each method, under the profiler (its wall time
    # includes the profiler's overhead)
    rec["profiled"] = {name: profile_call(fn)
                       for name, (_, fn) in calls.items()}
    # the host oracles, run in the pool meanwhile
    t0 = time.perf_counter()
    sw_parts = sw_ps.get()
    sw_ps = [v for part, _ in sw_parts for v in part]
    # the sw provider's seconds a product on one core, over the sample
    rec["sw_s_per_product_one_core"] = (sum(s for _, s in sw_parts)
                                        / len(sw_ps))
    sw_bls = [v for part in sw_bls.get() for v in part]
    ref_msm = [v for part in ref_msm.get() for v in part]
    rec["host_oracle_wait_s"] = time.perf_counter() - t0
    check(bool((np.array(sw_ps) == got[ps_sample]).all()),
          "pairing_check_batch != sw on the sample")
    check(bool((np.array(sw_bls) == got_b[bls_sample]).all()),
          "bls_verify_batch != sw on the sample")
    check([msm[i] for i in msm_sample] == ref_msm,
          "g2_msm_batch != bn254_ref.g2_msm on the sample")
    layouts = {f"{e}_{g}": v for (e, g), v in bn254.layout_launches.items()}
    for e in ("miller", "final_exp"):
        for g in bn254.LAYOUTS:
            check(layouts[f"{e}_{g}"] > 0,
                  f"the {e} entry's {g}-thread layout never launched")
    rec.update(sample_vs_sw=len(ps_sample), bls_sample_vs_sw=len(bls_sample),
               msm_sample_vs_ref=len(msm_sample),
               pairings_per_s=n / rec["pairing_check_batch_s"],
               layout_launches=layouts)
    emit(rec)
    return counts, layouts


def pairing_edges():
    """Edge products (kind, [(P, Q), (P', Q')]): G1 with G2 twice (Q1 and
    nQ2 of G2), the identity product e(P, Q) e(P, -Q), e(2P, Q) e(P, -2Q),
    and an off-by-one product."""
    from fabric_tpu_torch.ops import bn254_ref as b
    g2 = (b.G2_X, b.G2_Y)
    P = b.g1_mul_fast(5, b.G1)
    Q = b.g2_mul_fast(7, g2)
    return [("g1_g2", [(b.G1, g2), (b.G1, g2)]),
            ("identity", [(P, Q), (P, b.g2_neg_tw(Q))]),
            ("identity_g", [(b.G1, g2), (b.G1, b.g2_neg_tw(g2))]),
            ("bilinear", [(b.g1_mul_fast(2, P), Q),
                          (P, b.g2_neg_tw(b.g2_add_fast(Q, Q)))]),
            ("off", [(b.g1_add_fast(P, b.G1), Q), (P, b.g2_neg_tw(Q))])]


def msm_edges():
    """Edge MSM lanes: k = 0, 1, r - 1; Q + Q; T + (-T) (infinity); the
    subgroup lane of G2; all terms zero."""
    from fabric_tpu_torch.ops import bn254_ref as b
    g2 = (b.G2_X, b.G2_Y)
    T = b.g2_mul_fast(99991, g2)
    return [("k0", [(0, T), (1, g2), (0, None)]),
            ("k1", [(1, T), (0, None), (0, None)]),
            ("k_r_minus_1", [(b.R - 1, T), (b.R - 1, g2), (1, g2)]),
            ("q_plus_q", [(1, T), (1, T), (0, None)]),
            ("t_minus_t", [(12345, T), (0, None), (12345, b.g2_neg_tw(T))]),
            ("subgroup_g2", [(6 * b.T_BN * b.T_BN, g2), (0, None),
                             (0, None)]),
            ("all_zero", [(0, None), (0, None), (0, None)])]


def pairing_vs_plain(iblk, prov, card, pool, nproc):
    """The Miller and final-exp entries against their plain versions on
    the card at full length: PAIRING_LANES product lanes (edge products
    first; the Miller entry over their 2 x PAIRING_LANES terms, the
    final-exp entry with T = 2); Miller values and GT values equal
    canonically, verdicts equal and the expected bitmap; edge lanes also
    held to Python ints (the Miller values through the final
    exponentiation, GT). Then each entry's time at the block's bucket
    against its bound (the MSM entry: msm_vs_plain)."""
    import torch

    from fabric_tpu_torch.ops import bn254, tower
    from fabric_tpu_torch.ops import bn254_ref as b

    dev = prov.device
    F = bn254.F
    edges = pairing_edges()
    E = len(edges)
    prods = [t for _, t in edges] + iblk["prods"][:PAIRING_LANES - E]
    want_ok = np.concatenate([[k != "off" and k != "g1_g2"
                               for k, _ in edges],
                              iblk["expected"][:PAIRING_LANES - E]])
    st = bn254.to_device(bn254.stage_pairing_products(prods), dev)
    xPs, yPs, Qs, Q1s, nQ2s = st

    def cat_pt(qs):
        return tuple(tuple(torch.cat([q[i][j] for q in qs])
                           for j in range(2)) for i in range(2))
    mst = (torch.cat(xPs), torch.cat(yPs), cat_pt(Qs), cat_pt(Q1s),
           cat_pt(nQ2s))
    res = {}
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    f_p = F.canonical(tower.flat_from_f12(bn254.miller_loop_plain(*mst)))
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    # each layout the launcher picks for an entry, held to the plain
    # version at full length (res keys (entry, threads a lane))
    for g in bn254.LAYOUTS:
        f_k = tower.flat_from_f12(bn254.miller_loop_batch(*mst, group=g))
        err = int((f_k - f_p).abs().max())
        check(err == 0, f"Miller entry ({g} threads a lane) != plain at "
              "lanes "
              f"{torch.nonzero((f_k != f_p).any(0).any(-1))[:10].tolist()}")
        res["miller", g] = dict(max_abs_err=err, plain_ms=plain_ms,
                                lanes_vs_plain=2 * PAIRING_LANES)
    prog = bn254._FINAL_EXP_PROGRAM
    e0.record()
    prod = bn254.f12_mul(tower.f12_from_flat(f_p[:, :PAIRING_LANES]),
                         tower.f12_from_flat(f_p[:, PAIRING_LANES:]))
    gt_p = bn254.final_exp_plain(prod)
    ok_p = bn254.gt_is_one(gt_p)
    e1.record()
    gt_p = F.canonical(tower.flat_from_f12(gt_p))
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    for g in bn254.LAYOUTS:
        gt_k, ok_k = bn254._final_exp_kernel(f_k, 2, PAIRING_LANES, prog,
                                             group=g)
        err = int((gt_k - gt_p).abs().max())
        check(err == 0, f"final-exp entry ({g} threads a lane) != plain")
        check(torch.equal(ok_k, ok_p), "final-exp verdicts != plain")
        check(bool((ok_k.cpu().numpy() == want_ok).all()),
              "final-exp verdicts != expected at "
              f"{np.nonzero(ok_k.cpu().numpy() != want_ok)[0][:10].tolist()}")
        res["final_exp", g] = dict(max_abs_err=err, plain_ms=plain_ms,
                                   lanes_vs_plain=PAIRING_LANES)
    # the edge lanes against Python ints: each term's Miller value through
    # the final exponentiation, and each product's GT
    f_e = bn254.f12_from_device(tower.f12_from_flat(
        torch.cat([f_k[:, :E], f_k[:, PAIRING_LANES:PAIRING_LANES + E]],
                  dim=1)))
    g_e = bn254.f12_from_device(tower.f12_from_flat(gt_k[:, :E]))
    jobs = [(f_e[t * E + i], [terms[t]], True) for t in range(2)
            for i, (_, terms) in enumerate(edges)]
    jobs += [(g_e[i], terms, False) for i, (_, terms) in enumerate(edges)]
    gt_ints = pool.map_async(_gt_int_chunk, [[j] for j in jobs])

    gt_ints = [v for part in gt_ints.get() for v in part]
    check(all(gt_ints), f"pairing edges != Python ints: "
          f"{[j for j, v in enumerate(gt_ints) if not v]}")

    # times: each layout at the width where the launcher picks it, the
    # block's bucket (16,384 products: 32,768 Miller lanes) or
    # bls_verify_batch's (BLS_LANES products), with the products one
    # thread of a lane's group runs in series (chain_products)
    bucket = 1
    while bucket < PS_LANES:
        bucket *= 2

    def tiled(n):
        """mst's two terms each tiled to n products (term t at column
        t * n + lane)."""
        def one(x):
            return torch.cat([torch.cat([x[t * PAIRING_LANES:(t + 1)
                                           * PAIRING_LANES]]
                                        * -(-n // PAIRING_LANES))[:n]
                              for t in range(2)])
        return tuple(one(x) if isinstance(x, torch.Tensor) else
                     tuple(tuple(one(c) for c in xy) for xy in x)
                     for x in mst)
    for n_prod in (bucket, BLS_LANES):
        big2 = tiled(n_prod)
        B2 = 2 * n_prod
        g = bn254.layout(B2)
        ms = cuda_ms(lambda: bn254.miller_loop_batch(*big2), 3)
        chain, executed = bn254.miller_products(group=g)
        res["miller", g].update(
            lanes_timed=B2, chain_products=chain,
            us_per_chained_product=ms * 1e3 / chain, **bn_reading(
                ms, B2 * miller_products_min(b.ATE_LOOP), B2 * executed,
                B2 * (14 + 12) * L * 4))
        f_big = tower.flat_from_f12(bn254.miller_loop_batch(*big2))
        g = bn254.layout(n_prod)
        ms = cuda_ms(lambda: bn254._final_exp_kernel(f_big, 2, n_prod,
                                                     prog), 3)
        chain, executed = bn254.final_exp_products(prog, 2, group=g)
        res["final_exp", g].update(
            lanes_timed=n_prod, chain_products=chain,
            us_per_chained_product=ms * 1e3 / chain,
            cyclotomic_row=bn254.cyclotomic_row(prog), **bn_reading(
                ms, n_prod * final_exp_products_min(prog, 2),
                n_prod * executed, n_prod * (24 + 12) * L * 4 + n_prod))
    for (entry, g), r in res.items():
        # milliseconds a call: events time the card (see ladder_vs_plain)
        r["ms_from"] = "cuda_events"
        r["ptxas"] = ptxas_of(*BN_KERNELS[entry, g])
        emit({"phase": "pairing_vs_plain", "entry": entry, "ok": True,
              "threads_a_lane": g, "card": card,
              "edge_products": [k for k, _ in edges], **r})
    return res


def msm_vs_plain(iblk, prov, card, pool, nproc):
    """The MSM entry against its plain version on the card at full length
    (254-bit scalars): PAIRING_LANES lanes, the edges of msm_edges first,
    held limb for limb to the chain's plain version (g2_msm_chain); the
    edges' points also to bn254_ref.g2_msm. Then its time at the block's
    live lanes in the provider's class order against its bound, and at
    the shape the provider launched before it launched live lanes only
    (padded_*: the block's order, all-zero lanes up to the power of two)."""
    import torch

    from fabric_tpu_torch.ops import bn254
    from fabric_tpu_torch.ops import bn254_ref as b

    dev = prov.device
    F = bn254.F
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    medges = msm_edges()
    ME = len(medges)
    lanes = [ln for _, ln in medges] + iblk["msm"][:PAIRING_LANES - ME]
    kw, qf = bn254.stage_g2_msm_words(lanes)
    kt = torch.as_tensor(kw.view(np.int32)).to(dev)
    qt = [torch.as_tensor(a).to(dev) for a in qf]
    m_k = bn254.g2_msm(kt, *qt)
    e0.record()
    m_p = bn254.g2_msm_chain(bn254.words_to_bits(kt), *qt)
    e1.record()
    torch.cuda.synchronize()
    mk = torch.stack([c for p in m_k for c in p])
    mp = F.canonical(torch.stack([c for p in m_p for c in p]))
    err = int((mk - mp).abs().max())
    check(err == 0, "MSM entry != plain")
    got_edges = bn254.read_g2_msm(tuple(tuple(c[:ME] for c in p)
                                        for p in m_k))
    want_edges = [b.g2_msm(ln) for _, ln in medges]
    check(got_edges == want_edges, "MSM edge lanes != bn254_ref.g2_msm at "
          f"{[k for (k, _), g, w in zip(medges, got_edges, want_edges) if g != w]}")
    check(got_edges[4] is None and got_edges[6] is None
          and got_edges[5] == b.g2_frobenius_fast((b.G2_X, b.G2_Y)),
          "MSM edges: T + (-T) or the zero lane not at infinity, or G2 "
          "outside the subgroup")
    res = dict(max_abs_err=err, plain_ms=e0.elapsed_time(e1),
               lanes_vs_plain=PAIRING_LANES)
    bucket = 1
    while bucket < len(iblk["msm"]):
        bucket *= 2
    # the MSM at the block's shape as the provider launches it: its live
    # lanes in class order (bn254.msm_order); beside it, the shape the
    # provider launched before, padded with all-zero lanes to the power of
    # two in the block's interleaved order
    kw_b, qf_b = bn254.stage_g2_msm_words(iblk["msm"])
    order = bn254.msm_order(kw_b)
    kw_b = np.ascontiguousarray(kw_b[order])
    kt_b = torch.as_tensor(kw_b.view(np.int32)).to(dev)
    qt_b = [torch.as_tensor(np.ascontiguousarray(a[order])).to(dev)
            for a in qf_b]
    ms = cuda_ms(lambda: bn254.g2_msm(kt_b, *qt_b), 3)
    Bm = kt_b.shape[0]
    executed, least, live = msm_products(kw_b, bn254.NBITS_R)
    kw_p, qf_p = bn254.stage_g2_msm_words(iblk["msm"] + [[(0, None)] * 3] * (
        bucket - len(iblk["msm"])))
    kt_p = torch.as_tensor(kw_p.view(np.int32)).to(dev)
    qt_p = [torch.as_tensor(a).to(dev) for a in qf_p]
    res.update(
        lanes_timed=Bm, live_lanes=live, launch_order="class",
        padded_lanes=kt_p.shape[0],
        padded_ms=cuda_ms(lambda: bn254.g2_msm(kt_p, *qt_p), 3),
        padded_products_executed=msm_products(kw_p, bn254.NBITS_R)[0],
        **bn_reading(ms, least, executed,
                     Bm * (3 * 32 + 12 * L * 4 + 6 * L * 4)))
    res.update(ms_from="cuda_events", ptxas=ptxas_of(*BN_KERNELS["msm", 1]))
    res["long_lanes"] = msm_long_lanes(dev, pool, nproc)
    emit({"phase": "msm_vs_plain", "entry": "msm", "ok": True,
          "threads_a_lane": 1, "card": card,
          "edge_lanes": [k for k, _ in medges], **res})
    return res


MSM_LONG_TERMS = (9, 17)        # past the kernel's local joint tables
MSM_LONG_LANES = 64


def msm_long_lanes(dev, pool, nproc) -> dict:
    """Lanes of more terms than the MSM kernel's local joint tables hold
    (its scratch-table instance, g2_msm_kernel<0>): MSM_LONG_LANES lanes of
    each of MSM_LONG_TERMS terms, an entry at infinity (T + (-T)) and an
    all-zero lane among them; on full-width scalars equal as points to
    bn254_ref.g2_msm (in the pool, meanwhile), with the kernel's time; on
    the same lanes' scalars cut to 8 bits limb for limb the plain chain
    (its eager steps cost the same at any lane count, so the full width
    would take minutes)."""
    import random

    import torch

    from fabric_tpu_torch.ops import bn254
    from fabric_tpu_torch.ops import bn254_ref as b
    rng = random.Random(4711)
    g2 = (b.G2_X, b.G2_Y)
    T = b.g2_mul_fast(31337, g2)
    pts = [g2, T, b.g2_neg_tw(T)]
    out, by_terms = {}, {}
    for nterms in MSM_LONG_TERMS:
        lanes = [[(rng.randrange(b.R), pts[(i + t) % 3])
                  for t in range(nterms)] for i in range(MSM_LONG_LANES - 2)]
        lanes.append([(5, T), (5, b.g2_neg_tw(T))]
                     + [(0, None)] * (nterms - 3) + [(1, g2)])
        lanes.append([(0, None)] * nterms)
        by_terms[nterms] = (lanes, pool.map_async(_msm_ref_chunk, [
            lanes[i::nproc] for i in range(nproc)]))

    def put(lanes):
        kw, qf = bn254.stage_g2_msm_words(lanes)
        return (torch.as_tensor(kw.view(np.int32)).to(dev),
                [torch.as_tensor(a).to(dev) for a in qf])
    for nterms, (lanes, ref_async) in by_terms.items():
        kt, qt = put(lanes)
        before = bn254.msm_launches
        got = bn254.g2_msm(kt, *qt)
        check(bn254.msm_launches == before + 1,
              f"MSM of {nterms} terms: not one launch")
        pts_got = bn254.read_g2_msm(got)
        want = [None] * len(lanes)
        for i, part in enumerate(ref_async.get()):
            want[i::nproc] = part
        check(pts_got == want, f"MSM of {nterms} terms != bn254_ref.g2_msm")
        check(pts_got[-2] == g2 and pts_got[-1] is None,
              f"MSM of {nterms} terms: edge lanes")
        k8, q8 = put([[(k & 255, q) for k, q in ln] for ln in lanes])
        got8 = bn254.g2_msm(k8, *q8, nbits=8)
        plain = bn254.g2_msm_chain(bn254.words_to_bits(k8, 8), *q8)
        mk = torch.stack([c for p in got8 for c in p])
        mp = bn254.F.canonical(torch.stack([c for p in plain for c in p]))
        err = int((mk - mp).abs().max())
        check(err == 0, f"MSM of {nterms} terms: kernel != plain")
        out[str(nterms)] = dict(lanes=len(lanes), max_abs_err=err,
                                ms=cuda_ms(lambda: bn254.g2_msm(kt, *qt), 3))
    out["ptxas"] = ptxas_of("g2_msm", "g2_msm_kernel<0>")
    return out


# each BN254 entry's wrapper and the JAX function it replaces
BN_NAMES = {"miller": ("bn254.miller_loop_batch",
                       "fabric_tpu/ops/bn254.py:137"),
            "final_exp": ("bn254.final_exp_batch (product of the terms)",
                          "fabric_tpu/ops/bn254.py:251"),
            "msm": ("bn254.g2_msm", "fabric_tpu/ops/bn254.py:332")}
# (library, kernel) of each BN254 entry by threads a lane
BN_KERNELS = {("miller", 1): ("bn254_pairing", "bn254_miller_kernel"),
              ("final_exp", 1): ("bn254_pairing", "bn254_final_exp_kernel"),
              ("msm", 1): ("g2_msm", "g2_msm_kernel<1>"),
              **{(e, g): ("bn254_pairing", f"bn254_{e}_coop_kernel<{g}>")
                 for e in ("miller", "final_exp") for g in (8,)}}


# -- BLS12-381: the orderer's aggregate verify --

BLS_MILLER, BLS_REDUCE, BLS_FINAL_EXP = (
    "bls_miller_launches", "bls_reduce_launches", "bls_final_exp_launches")
BLS_KERNELS = (BLS_MILLER, BLS_REDUCE, BLS_FINAL_EXP)
# a span of k block signatures by one orderer identity: the reference's
# own sweep (bench.py:1363-1365) and a long span of 1,024 pairs
BLS_WIDTHS = (3, 7, 15, 31, 1023)
BLS_SW_ALL = 31                 # sw on every case up to here, 1,023 once
BLS_CASES = ("valid", "forged", "sig_off", "pk_off")
BLS_FE_INPUTS = 4               # single-lane final-exp inputs vs plain
# a 381-bit product on 12 words: 12 x 12 partial products, a low and a
# high IMAD each, and a Montgomery reduction of the same size
BLS_MUL_IMAD = 2 * 2 * 12 * 12
# 1/f at its least (see F12_INV_MIN, Fermat at its 380 squarings); what
# the redesigned entries execute, and the products one thread of a lane's
# warp runs in series (`chain_products`), the schedules count
# (ops/bls12_381_kernel.py miller_products, final_exp_products)
BLS_F12_INV_MIN = 2 * 12 + (6 * 3 + 3 * 2) + 4 + 380 + 2 * 18
BLS_SMALL_LANES = 4             # the Miller entry timed at k = 3's bucket too


def _bls_sign_span_chunk(jobs):
    from fabric_tpu_torch.ops import bls12_381_ref as b
    return [b.bls_sign(sk, m) for sk, m in jobs]


def bls_key(point, checked: bool = True):
    """The port's sw BLS public key on `point`; checked=False builds a key
    whose point skipped the import's subgroup check (an adversarial key)."""
    from fabric_tpu_torch.bccsp import sw
    from fabric_tpu_torch.ops import bls12_381_ref as b
    if checked:
        return sw.BLSPublicKey(b.g2_to_bytes(point))
    k = object.__new__(sw.BLSPublicKey)
    k.point, k._raw = point, b.g2_to_bytes(point)
    return k


def _sw_aggregate_chunk(jobs):
    """The port's sw provider's verify_aggregate on (points, checked
    flags, messages, signature) jobs: (verdict, seconds) each, one pool
    process, one core."""
    from fabric_tpu_torch.bccsp import sw
    prov = sw.SWProvider()
    out = []
    for pts, checked, msgs, sig in jobs:
        keys = [bls_key(p, c) for p, c in zip(pts, checked)]
        t0 = time.perf_counter()
        v = prov.verify_aggregate(keys, msgs, sig)
        out.append((v, time.perf_counter() - t0))
    return out


def _bls_chain_chunk(jobs):
    """Python-int final_exponentiation_chain of each Fp12 value."""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    return [b.final_exponentiation_chain(f) for f in jobs]


def _bls_miller_ref_chunk(jobs):
    """(kernel Miller value, P, Q): is the kernel's value the int Miller
    loop's times one Fp2 coefficient on w^0 or w^3?"""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    out = []
    for val, p, q in jobs:
        ratio = b.f12_mul(val, b.f12_inv(b.miller_loop(q, p)))
        nz = [i for i, c in enumerate(c for half in ratio for c in half)
              if c != b.F2_ZERO]
        out.append(len(nz) == 1 and nz[0] in (0, 4))
    return out


def off_subgroup_g1():
    """A point of E(Fp) outside the order-r subgroup: try-and-increment
    on x without the cofactor clearing."""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    x = 1
    while True:
        rhs = (x * x * x + b.B_G1) % b.P
        y = pow(rhs, (b.P + 1) // 4, b.P)
        if y * y % b.P == rhs and not b.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


def _f2_sqrt(a):
    """A square root in Fp2 = Fp[u]/(u^2 + 1), p = 3 mod 4, or None."""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    P = b.P
    n = (a[0] * a[0] + a[1] * a[1]) % P
    s = pow(n, (P + 1) // 4, P)
    if s * s % P != n:
        return None
    for t in (s, P - s):
        h = (a[0] + t) * pow(2, -1, P) % P
        x0 = pow(h, (P + 1) // 4, P)
        if x0 * x0 % P == h and x0:
            x1 = a[1] * pow(2 * x0, -1, P) % P
            if b.f2_mul((x0, x1), (x0, x1)) == a:
                return (x0, x1)
    return None


def off_subgroup_g2():
    """A point of the twist E'(Fp2) outside the order-r subgroup: the
    smallest x = (k, 1) whose x^3 + 4(1 + u) is a square."""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    b_tw = b.f2_mul((b.B_G1, 0), b.XI)
    k = 0
    while True:
        x = (k, 1)
        y = _f2_sqrt(b.f2_add(b.f2_mul(b.f2_mul(x, x), x), b_tw))
        if y is not None and not b.g2_in_subgroup((x, y)):
            return (x, y)
        k += 1


def make_bls_span(seed: int, pool, nproc):
    """One orderer identity's span of max(BLS_WIDTHS) block signatures
    from `seed` (the shape of fabric_tpu/orderer/blockwriter.py
    _self_verify: one key, one message a block), signed in the pool, and
    the off-subgroup points the bad cases use."""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    rng = np.random.default_rng(seed + 5)
    t0 = time.perf_counter()
    sk, pk = b.bls_keygen(rng.bytes(32))
    n = max(BLS_WIDTHS)
    msgs = [b"block %d|" % i + rng.bytes(48) for i in range(n)]
    sigs = pool_map(pool, _bls_sign_span_chunk, [(sk, m) for m in msgs],
                    nproc)
    aggs, acc = {}, None
    for i, s in enumerate(sigs):
        acc = b.g1_add(acc, s)
        if i + 1 in BLS_WIDTHS:
            aggs[i + 1] = acc
    return dict(pk=pk, msgs=msgs, aggs=aggs, off_g1=off_subgroup_g1(),
                off_g2=off_subgroup_g2(), make_s=time.perf_counter() - t0)


def _bls_cases(span, k):
    """The four calls at width k: (keys' points, checked flags, messages,
    signature bytes, expected verdict) by case."""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    pts, msgs = [span["pk"]] * k, span["msgs"][:k]
    agg = span["aggs"][k]
    sig = b.g1_to_bytes(agg)
    j = k // 2
    ok = [True] * k
    return {
        "valid": (pts, ok, msgs, sig, True),
        "forged": (pts, ok, msgs[:j] + [b"forged"] + msgs[j + 1:], sig,
                   False),
        "sig_off": (pts, ok, msgs,
                    b.g1_to_bytes(b.g1_add(agg, span["off_g1"])), False),
        "pk_off": (pts[:j] + [span["off_g2"]] + pts[j + 1:],
                   ok[:j] + [False] + ok[j + 1:], msgs, sig, False)}


BLS_ENTRY_NAMES = {"miller": "bls_miller_kernel",
                   "reduce": "bls_reduce_kernel",
                   "final_exp": "bls_final_exp_kernel"}


def profile_kept(fn, names, windows: int = 3):
    """profile_call, repeated at most `windows` times with the window's
    pads doubled each time until every kernel named in `names` shows (the
    profiler on the H100 has dropped all the kernels of a ~100 ms window,
    cause unknown): (the last profile, the windows it took, whether they
    showed)."""
    for w in range(1, windows + 1):
        prof = profile_call(fn, pad_s=0.05 * 2 ** (w - 1))
        kept = all(any(n in k for k in prof["kernel_names"]) for n in names)
        if kept:
            break
    return prof, w, kept


def _by_kernel(top_ms: dict) -> dict:
    """The profiler's device ms of the BLS entries, by entry."""
    return {entry: sum(v for k, v in top_ms.items() if name in k)
            for entry, name in BLS_ENTRY_NAMES.items()}


def bls_aggregate_path(span, prov, card, pool, nproc):
    """A span of k block signatures by one identity through the provider's
    verify_aggregate on the card, k in BLS_WIDTHS: at each width the valid
    aggregate (True), one message swapped for b"forged" (False), the
    aggregate plus a point off the subgroup (False) and one key off the
    subgroup (False), each counted (every kernel count 0 before; valid and
    forged one Miller, one reduce and one final-exp launch, the gated
    cases none); the sw provider's verdicts on every case up to
    BLS_SW_ALL keys and on the valid 1,023-key span (run in the pool
    meanwhile) equal. Per width: the steady seconds of a valid call, the
    host staging seconds (gates, H(m_i), limbs), one valid call under the
    profiler (the card's busy ms by entry, the idle share; profiled again,
    a few times at most, while a window misses an entry's kernel, and
    listed under "profile_not_measured" when none kept them) and the sw
    provider's seconds a call on one core. The steady call's busy ms also
    from the provider's CUDA events (events_busy_ms), the profiler's
    reading beside it."""
    from fabric_tpu_torch.ops import bls12_381 as blsagg
    from fabric_tpu_torch.ops import bls12_381_kernel as blsk
    from fabric_tpu_torch.ops import bls12_381_ref as b

    jobs, where = [], []
    for k in BLS_WIDTHS:
        for case, (pts, ck, msgs, sig, _) in _bls_cases(span, k).items():
            if k <= BLS_SW_ALL or case == "valid":
                jobs.append((pts, ck, msgs, sig))
                where.append((k, case))
    sw_async = pool.map_async(_sw_aggregate_chunk, [[j] for j in jobs])
    others = [k for k in prov.stats if k.endswith("_launches")
              and k not in BLS_KERNELS]
    keys = {}
    total = {k: 0 for k in BLS_KERNELS}
    widths, not_measured = {}, []
    for k in BLS_WIDTHS:
        cases = _bls_cases(span, k)
        bucket = 1 << k.bit_length()          # k + 1 pairs, a power of two
        row = {"pairs": k + 1, "bucket": bucket}
        for case, (pts, ck, msgs, sig, want) in cases.items():
            for p, c in zip(pts, ck):
                if (p, c) not in keys:
                    keys[(p, c)] = bls_key(p, c)
            ks = [keys[(p, c)] for p, c in zip(pts, ck)]
            device = case in ("valid", "forged")
            out, counts, _, secs = counted(
                prov, f"bls {case} k={k}", BLS_KERNELS if device else (),
                lambda: prov.verify_aggregate(ks, msgs, sig))
            check(out is want, f"bls k={k} {case}: {out}, not {want}")
            per = {BLS_MILLER: 1, BLS_REDUCE: 1,
                   BLS_FINAL_EXP: 1} if device else dict.fromkeys(
                       BLS_KERNELS, 0)
            for kk, v in per.items():
                check(counts[kk] == v, f"bls k={k} {case}: {kk} "
                      f"{counts[kk]}, not {v}")
                total[kk] += counts[kk]
            check(all(counts[kk] == 0 for kk in others),
                  f"bls k={k} {case}: other kernels ran: {counts}")
            row[f"{case}_s"] = secs
        pts, ck, msgs, sig, _ = cases["valid"]
        ks = [keys[(p, c)] for p, c in zip(pts, ck)]
        busy0 = prov.device_cost.busy.totals().get(0, 0.0)
        t0 = time.perf_counter()
        check(prov.verify_aggregate(ks, msgs, sig) is True,
              f"bls k={k}: steady call")
        row["steady_s"] = time.perf_counter() - t0
        # the card's busy ms of that call from the provider's CUDA events
        row["events_busy_ms"] = (prov.device_cost.busy.totals().get(0, 0.0)
                                 - busy0) * 1e3
        check(0 < row["events_busy_ms"] <= row["steady_s"] * 1e3 * 1.05,
              f"bls k={k}: events busy {row['events_busy_ms']} ms in a "
              f"{row['steady_s']} s call")
        t0 = time.perf_counter()
        pairs = blsagg.stage_pairs(pts, msgs, b.g1_from_bytes(sig))
        blsk.stage_pairs(pairs, pad_to=bucket)
        row["host_staging_s"] = time.perf_counter() - t0
        prof, row["profile_windows"], kept = profile_kept(
            lambda: prov.verify_aggregate(ks, msgs, sig),
            BLS_ENTRY_NAMES.values())
        row["profiled"] = prof
        if kept:
            row["device_busy_ms_by_entry"] = _by_kernel(prof["top_ms"])
            row["device_idle_share"] = prof["device_idle_share"]
        else:
            # no window kept the three entries' kernels: say so, and put
            # no number in their place
            row["device_busy_ms_by_entry"] = "not measured"
            row["device_idle_share"] = "not measured"
            not_measured.append(k)
        widths[k] = row
    t0 = time.perf_counter()
    sw = [v for part in sw_async.get() for v in part]
    wait_s = time.perf_counter() - t0
    for (k, case), (v, secs) in zip(where, sw):
        want = _bls_cases(span, k)[case][4]
        check(v is want, f"bls k={k} {case}: sw says {v}, not {want}")
        if case == "valid":
            widths[k]["sw_s_per_call_one_core"] = secs
    emit({"phase": "bls_aggregate_path", "ok": True, "card": card,
          "widths": {str(k): v for k, v in widths.items()},
          "sw_cases": len(sw), "sw_wait_s": wait_s,
          "make_s": span["make_s"], "launches": total,
          "profile_not_measured": not_measured})
    return total, widths


def bls_vs_plain(span, prov, card, pool):
    """Each BLS entry against its plain version on the card: the Miller
    entry on the 1,023-key span's 1,024 lanes with edge lanes in it ((G1,
    G2), (-G1, G2), (2 G1, G2), (G1, 2 G2)) and its last four lanes masked
    off, limb for limb after `canonical`; the reduce on the same lanes;
    the final exponentiation on BLS_FE_INPUTS single-lane inputs (that
    reduce's product, the span's own product, Fp12 one and a random
    value), its GT values and verdicts also against
    bls12_381_ref.final_exponentiation_chain on Python ints; lanes 0, 1
    and the edges against bls12_381_ref.miller_loop up to an Fp2 *
    w^(3k) monomial. Then each entry at the path's shape (1,024 lanes;
    the reduce over them; one final-exp lane): CUDA events against
    bounds from the functions' least Fp products and, beside them, the
    products the kernels execute."""
    import torch

    from fabric_tpu_torch.ops import bls12_381 as blsagg
    from fabric_tpu_torch.ops import bls12_381_kernel as blsk
    from fabric_tpu_torch.ops import bls12_381_ref as b
    from fabric_tpu_torch.ops import tower

    dev = prov.device
    F = blsk.F
    n = max(BLS_WIDTHS)
    pairs = blsagg.stage_pairs([span["pk"]] * n, span["msgs"][:n],
                               span["aggs"][n])
    B = len(pairs)
    g2 = (b.G2_X, b.G2_Y)
    edges = [("g1_g2", (b.G1, g2)), ("neg_g1", (b.g1_neg(b.G1), g2)),
             ("two_g1", (b.g1_mul(2, b.G1), g2)),
             ("two_g2", (b.G1, b.g2_mul(2, g2)))]
    E0 = B - 8                                 # edges, then 4 masked lanes
    lanes = list(pairs)
    for i, (_, pq) in enumerate(edges):
        lanes[E0 + i] = pq
    staged = blsk.stage_pairs(lanes)
    staged[6][B - 4:] = False
    st = blsk.to_device(staged, dev)
    Q = ((st[2], st[3]), (st[4], st[5]))
    res = {}
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    f_k = tower.flat_from_f12(blsk.miller_loop_batch(st[0], st[1], Q,
                                                     mask=st[6]))
    e0.record()
    f_p = blsk.miller_loop_plain(st[0], st[1], Q)
    f_p = tower.select_f12(st[6], f_p, blsk.f12_one_like(st[0]))
    e1.record()
    f_p = F.canonical(tower.flat_from_f12(f_p))
    torch.cuda.synchronize()
    err = int((f_k - f_p).abs().max())
    check(err == 0, "BLS Miller entry != plain at lanes "
          f"{torch.nonzero((f_k != f_p).any(0).any(-1))[:10].tolist()}")
    res["miller"] = dict(max_abs_err=err, plain_ms=e0.elapsed_time(e1),
                         lanes_vs_plain=B)
    check(blsk.f12_from_device(tower.f12_from_flat(f_k[:, B - 4:]))
          == [b.F12_ONE] * 4, "BLS Miller entry: masked lanes are not one")
    look = [0, 1] + [E0 + i for i in range(len(edges))]
    vals = blsk.f12_from_device(tower.f12_from_flat(f_k[:, look]))
    miller_ref = pool.map_async(_bls_miller_ref_chunk, [
        [(v, *lanes[i])] for v, i in zip(vals, look)])

    r0 = blsk.reduce_launches
    r_k = tower.flat_from_f12(blsk.product_reduce(tower.f12_from_flat(f_k)))
    reduce_calls = blsk.reduce_launches - r0
    check(reduce_calls == 1, f"BLS reduce: {reduce_calls} launches a call")
    e0.record()
    r_p = blsk.product_reduce_plain(tower.f12_from_flat(f_p))
    e1.record()
    r_p = F.canonical(tower.flat_from_f12(r_p))
    torch.cuda.synchronize()
    err = int((r_k - r_p).abs().max())
    check(err == 0, "BLS reduce entry != plain")
    res["reduce"] = dict(max_abs_err=err, plain_ms=e0.elapsed_time(e1),
                         lanes_vs_plain=B)

    # the span's own 1,024 pairs: its product is one
    sp = blsk.to_device(blsk.stage_pairs(pairs), dev)
    Qs = ((sp[2], sp[3]), (sp[4], sp[5]))
    f_s = blsk.miller_loop_batch(sp[0], sp[1], Qs, mask=sp[6])
    r_s = tower.flat_from_f12(blsk.product_reduce(f_s))
    one = tower.flat_from_f12(blsk.f12_one_like(sp[0][:1]))
    rng = np.random.default_rng(12)
    rnd = torch.as_tensor(np.stack([F.to_mont(int.from_bytes(
        rng.bytes(48), "big") % b.P) for _ in range(12)])[:, None]).to(dev)
    inputs = torch.cat([r_k, r_s, one, rnd], dim=1)        # (12, 4, L)
    prog = blsk._FINAL_EXP_PROGRAM
    outs = [blsk._final_exp_kernel(inputs[:, i:i + 1].contiguous(), prog)
            for i in range(BLS_FE_INPUTS)]
    gt_k = torch.cat([g for g, _ in outs], dim=1)
    ok_k = torch.cat([o for _, o in outs])
    e0.record()
    gt_p = blsk.final_exp_plain(tower.f12_from_flat(inputs), prog)
    ok_p = blsk.gt_is_one(gt_p)
    e1.record()
    gt_p = F.canonical(tower.flat_from_f12(gt_p))
    torch.cuda.synchronize()
    err = int((gt_k - gt_p).abs().max())
    check(err == 0, "BLS final-exp entry != plain")
    check(torch.equal(ok_k, ok_p), "BLS final-exp verdicts != plain")
    ints = blsk.f12_from_device(tower.f12_from_flat(inputs))
    chain = [v for part in pool.map(_bls_chain_chunk, [[f] for f in ints])
             for v in part]
    check(blsk.f12_from_device(tower.f12_from_flat(gt_k)) == chain,
          "BLS final-exp entry != final_exponentiation_chain")
    want = [c == b.F12_ONE for c in chain]
    check(ok_k.cpu().tolist() == want and want[1:] == [True, True, False],
          f"BLS final-exp verdicts {ok_k.cpu().tolist()}, chain {want}")
    res["final_exp"] = dict(max_abs_err=err, plain_ms=e0.elapsed_time(e1),
                            lanes_vs_plain=BLS_FE_INPUTS,
                            verdicts=ok_k.cpu().tolist())
    miller_ref = [v for part in miller_ref.get() for v in part]
    check(all(miller_ref), "BLS Miller lanes != bls12_381_ref.miller_loop "
          f"up to a w^(3k) monomial at {[look[i] for i, v in enumerate(miller_ref) if not v]}")

    # times at the path's shape: the 1,023-key span, one call; the Miller
    # entry also at k = 3's bucket, where the chain sets its time
    ms = cuda_ms(lambda: blsk.miller_loop_batch(sp[0], sp[1], Qs,
                                                mask=sp[6]), 3)
    chain, executed = blsk.miller_products(b.X_BLS)
    res["miller"].update(lanes_timed=B, **bn_reading(
        ms, B * miller_products_min(b.X_BLS, 0), B * executed,
        B * (6 + 12) * blsk.L * 4 + B, BLS_MUL_IMAD))
    n4 = BLS_SMALL_LANES
    s4 = [t[:n4].contiguous() for t in sp]
    ms4 = cuda_ms(lambda: blsk.miller_loop_batch(
        s4[0], s4[1], ((s4[2], s4[3]), (s4[4], s4[5])), mask=s4[6]), 10)
    b4, by4 = bn_bound(n4 * miller_products_min(b.X_BLS, 0),
                       n4 * (6 + 12) * blsk.L * 4 + n4, BLS_MUL_IMAD)
    res["miller"].update(
        chain_products=chain, us_per_chained_product=ms * 1e3 / chain,
        small_lanes=n4, small_ms=ms4, small_bound_ms=b4, small_bound_by=by4,
        small_us_per_chained_product=ms4 * 1e3 / chain)
    ms = cuda_ms(lambda: blsk.product_reduce(f_s), 3)
    chain, executed = blsk.reduce_products(B)
    res["reduce"].update(
        lanes_timed=B, launches_a_call=reduce_calls, **bn_reading(
            ms, (B - 1) * F12_MUL_MIN, executed,
            (B + 1) * 12 * blsk.L * 4, BLS_MUL_IMAD),
        chain_products=chain, us_per_chained_product=ms * 1e3 / chain)
    one_lane = r_s.contiguous()
    ms = cuda_ms(lambda: blsk._final_exp_kernel(one_lane, prog), 10)
    chain, executed = blsk.final_exp_products(prog)
    res["final_exp"].update(lanes_timed=1, **bn_reading(
        ms, final_exp_products_min(prog, 1, BLS_F12_INV_MIN), executed,
        2 * 12 * blsk.L * 4 + 1 + prog.size * 4, BLS_MUL_IMAD),
        chain_products=chain, us_per_chained_product=ms * 1e3 / chain,
        cyclotomic_row=blsk.cyclotomic_row(prog))
    kernel = {"miller": "bls_miller_kernel", "reduce": "bls_reduce_kernel",
              "final_exp": "bls_final_exp_kernel"}
    for entry, r in res.items():
        r["ms_from"] = "cuda_events"
        emit({"phase": "bls_vs_plain", "entry": entry, "ok": True,
              "card": card, "edge_lanes": [k for k, _ in edges],
              "masked_lanes": 4,
              "ptxas": ptxas_of("bls12_381_pairing", kernel[entry]), **r})
    return res


def bls_tower_cases(rng, n: int):
    """BLS12-381 tower self-test cases, as bn_tower_cases."""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    g2 = (b.G2_X, b.G2_Y)

    def fp():
        return int.from_bytes(rng.bytes(48), "big") % b.P

    def sc():
        return int.from_bytes(rng.bytes(32), "big") % (b.R - 1) + 1
    cases = []
    for i in range(n):
        x, y = [fp() for _ in range(12)], [fp() for _ in range(12)]
        if i == 0:
            x[2:] = [0] * 10
        p = b.g1_mul(sc(), b.G1)
        q = b.g2_mul(sc(), g2)
        z = (fp() or 1, fp())
        t = [b.f2_mul(q[0], z), b.f2_mul(q[1], z), z]
        qa = q if i == 1 else b.g2_mul(sc(), g2)
        cases.append((x + y + list(p) + [c for f2 in t for c in f2]
                      + [c for f2 in qa for c in f2], q, qa))
    return cases


def bls_tower_int_misses(case, row) -> list[str]:
    """The BLS12-381 tower self-test's 90 outputs against the int tower
    and group law: the names of the outputs that differ."""
    from fabric_tpu_torch.ops import bls12_381_ref as b
    vals, q, qa = case

    def f12(v, o):
        return (tuple(tuple(v[o + 2 * j:o + 2 * j + 2]) for j in range(3)),
                tuple(tuple(v[o + 6 + 2 * j:o + 8 + 2 * j])
                      for j in range(3)))

    def affine(o):
        X, Y, Z = (tuple(row[o + 2 * j:o + 2 * j + 2]) for j in range(3))
        zi = b.f2_inv(Z)
        return (b.f2_mul(X, zi), b.f2_mul(Y, zi))
    x, y = f12(vals, 0), f12(vals, 12)
    dbl, add = b.g2_add(q, q), b.g2_add(q, qa)
    want = {"f2_mul": (tuple(row[0:2]), b.f2_mul(x[0][0], y[0][0])),
            "f2_sqr": (tuple(row[2:4]), b.f2_mul(x[0][0], x[0][0])),
            "f2_inv": (tuple(row[4:6]), b.f2_inv(x[0][0])),
            "f12_mul": (f12(row, 6), b.f12_mul(x, y)),
            "f12_frob": (f12(row, 18), b.f12_frob(x)),
            "f12_inv": (f12(row, 30), b.f12_inv(x)),
            "dbl_line_point": (affine(42), dbl),
            "add_line_point": (affine(60), add),
            "dbl_point": (affine(78), dbl), "add_point": (affine(84), add)}
    return [k for k, (g, w) in want.items() if g != w]


def coop_cases(rng, n: int, b):
    """Cooperative self-test cases on curve `b` (bls12_381_ref or
    bn254_ref; 42 plain values: x, y in Fp12, a line's A, B, C, and c in
    the cyclotomic subgroup, the easy part of a random value): x's first
    coefficient 0, 1 and p - 1 in the first three (the binary Euclid
    inverse's edges), random after."""
    def fp():
        return int.from_bytes(rng.bytes(48), "big") % b.P

    def f12():
        return tuple(tuple((fp(), fp()) for _ in range(3))
                     for _ in range(2))

    def flat(el):
        return [x for half in el for f2 in half for x in f2]
    cases = []
    for i in range(n):
        m = f12()
        m = b.f12_mul(b.f12_conj(m), b.f12_inv(m))
        c = b.f12_mul(b.f12_frob(b.f12_frob(m)), m)
        x = flat(f12())
        x[0] = (0, 1, b.P - 1)[i] if i < 3 else x[0]
        cases.append(x + flat(f12()) + flat(f12())[:6] + flat(c))
    return cases


def coop_int_misses(vals, row, b, mtype: bool) -> list[str]:
    """The cooperative self-test's 110 outputs against curve `b`'s int
    tower (its line M-type, slots w^0, w^2, w^3, or D-type, w^0, w^1,
    w^3): the names of the outputs that differ."""
    def f12(v, o):
        return (tuple(tuple(v[o + 2 * j:o + 2 * j + 2]) for j in range(3)),
                tuple(tuple(v[o + 6 + 2 * j:o + 8 + 2 * j])
                      for j in range(3)))
    x, y, c = f12(vals, 0), f12(vals, 12), f12(vals, 30)
    A, B, C = (tuple(vals[24 + 2 * i:26 + 2 * i]) for i in range(3))
    line = (((C, B, b.F2_ZERO), (b.F2_ZERO, A, b.F2_ZERO)) if mtype else
            ((A, b.F2_ZERO, b.F2_ZERO), (B, C, b.F2_ZERO)))
    want = {"f12_sqr": (0, b.f12_mul(x, x)), "coop_sqr": (12, b.f12_mul(x, x)),
            "f12_mul_line": (24, b.f12_mul(x, line)),
            "coop_mul_line": (36, b.f12_mul(x, line)),
            "f12_sqr_cyclotomic": (48, b.f12_mul(c, c)),
            "coop_cyc": (60, b.f12_mul(c, c)),
            "coop_mul": (72, b.f12_mul(x, y)),
            "coop_inv": (84, b.f12_inv(x)), "coop_frob": (96, b.f12_frob(x))}
    miss = [k for k, (o, w) in want.items() if f12(row, o) != w]
    inv = pow(vals[0] % b.P, b.P - 2, b.P)
    return miss + (["fp_inv"] if row[108] != inv or row[109] != inv
                   else [])


def bn_tower_cases(rng, n: int):
    """Tower self-test cases (36 plain values: x, y in Fp12, P in G1, T
    projective and Q affine on the twist), with T's point q and Q: case 0
    has x in Fp2 alone, case 1 adds T's own point (a doubling inside the
    complete addition)."""
    from fabric_tpu_torch.ops import bn254_ref as b
    g2 = (b.G2_X, b.G2_Y)

    def fp():
        return int.from_bytes(rng.bytes(32), "big") % b.P

    def sc():
        return int.from_bytes(rng.bytes(32), "big") % (b.R - 1) + 1
    cases = []
    for i in range(n):
        x, y = [fp() for _ in range(12)], [fp() for _ in range(12)]
        if i == 0:
            x[2:] = [0] * 10
        p = b.g1_mul_fast(sc(), b.G1)
        q = b.g2_mul_fast(sc(), g2)
        z = (fp() or 1, fp())
        t = [b.f2_mul(q[0], z), b.f2_mul(q[1], z), z]
        qa = q if i == 1 else b.g2_mul_fast(sc(), g2)
        cases.append((x + y + list(p) + [c for f2 in t for c in f2]
                      + [c for f2 in qa for c in f2], q, qa))
    return cases


def bn_tower_int_misses(case, row) -> list[str]:
    """The tower self-test's outputs (90 ints) against the int tower and
    group law: the names of the outputs that differ."""
    from fabric_tpu_torch.ops import bn254_ref as b
    vals, q, qa = case

    def f12(v, o):
        return (tuple(tuple(v[o + 2 * j:o + 2 * j + 2]) for j in range(3)),
                tuple(tuple(v[o + 6 + 2 * j:o + 8 + 2 * j])
                      for j in range(3)))

    def affine(o):
        X, Y, Z = (tuple(row[o + 2 * j:o + 2 * j + 2]) for j in range(3))
        zi = b.f2_inv(Z)
        return (b.f2_mul(X, zi), b.f2_mul(Y, zi))
    x, y = f12(vals, 0), f12(vals, 12)
    dbl, add = b.g2_add_fast(q, q), b.g2_add_fast(q, qa)
    want = {"f2_mul": (tuple(row[0:2]), b.f2_mul(x[0][0], y[0][0])),
            "f2_sqr": (tuple(row[2:4]), b.f2_mul(x[0][0], x[0][0])),
            "f2_inv": (tuple(row[4:6]), b.f2_inv(x[0][0])),
            "f12_mul": (f12(row, 6), b.f12_mul(x, y)),
            "f12_frob": (f12(row, 18), b.f12_frob(x)),
            "f12_inv": (f12(row, 30), b.f12_inv(x)),
            "dbl_line_point": (affine(42), dbl),
            "add_line_point": (affine(60), add),
            "dbl_point": (affine(78), dbl), "add_point": (affine(84), add)}
    return [k for k, (g, w) in want.items() if g != w]


def field_vs_ints(card, seed: int) -> None:
    """The nvcc-built field core against Python ints (ptree.field_selftest
    and its plain version): edge operands in 13-bit form with the carry
    edges (ptree.CARRY_EDGES), every pair, and seeded random ones; Alg. 4 on the edge point pairs and random points.
    Every output word must be equal."""
    import torch

    from fabric_tpu_torch.bccsp import ed25519_host as edh
    from fabric_tpu_torch.ops import ed25519
    from fabric_tpu_torch.ops import fused_verify as fv
    from fabric_tpu_torch.ops import limb, p256, ptree, verify

    P = p256.P
    rng = np.random.default_rng(seed)
    # and the operands where the PTX carry chains carry through every word
    edges = [0, 1, P - 1, P, P + 1, (1 << 256) - 1,
             (1 << 256) + (1 << 243) - 1] + ptree.CARRY_EDGES
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

    # the ladder's doubling (pt_dbl) against cdbl_int
    dbl = [g, neg_g, inf, (p256.GX, 0, 1)] + pts
    d13 = torch.as_tensor(rows(dbl))
    got_d = verify.dbl_selftest(d13.cuda())
    want_d = verify.dbl_selftest_plain(d13)
    torch.cuda.synchronize()
    bad_d = int((got_d.cpu() != want_d).any(dim=1).sum())
    check(bad_d == 0, f"pt_dbl != cdbl_int on {bad_d} cases")

    # the 2^255 - 19 core and Ed25519's group law
    PE = ed25519.P_ED
    f_edges = [0, 1, PE - 1, PE, PE + 1, (1 << 255) - 1, (1 << 256) - 1]
    f_rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(512)]
    f_pairs = [(a, b) for a in f_edges for b in f_edges] + list(
        zip(f_rand[::2], f_rand[1::2]))

    def words(vals):
        return torch.as_tensor(np.array(
            [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
             for v in vals], dtype=np.uint32).view(np.int32))
    fa, fb = words(a for a, _ in f_pairs), words(b for _, b in f_pairs)
    got_f = ed25519.f25_selftest(fa.cuda(), fb.cuda())
    want_f = ed25519.f25_selftest_plain(fa, fb)
    torch.cuda.synchronize()
    bad_f = int((got_f.cpu() != want_f).any(dim=1).sum())
    check(bad_f == 0, f"2^255 - 19 core != Python ints on {bad_f} cases")
    Bp = edh.from_affine(edh.BX, edh.BY)
    e_pts = [Bp, edh._IDENT, (0, PE - 1, 1, 0)] + [
        edh.scalar_mult(int(k), Bp) for k in rng.integers(1, 1 << 62,
                                                           size=61)]
    e_cases = [(p, q) for p in e_pts[:3] for q in e_pts[:3]] + list(
        zip(e_pts, e_pts[::-1]))
    # q affine (Z = 1): the self-test takes q's Niels form from (X, Y)
    e_cases = [(p, edh.from_affine(*edh.to_affine(q))) for p, q in e_cases]

    def ed_words(ps):
        return torch.as_tensor(np.array(
            [[(c % PE >> (32 * i)) & 0xFFFFFFFF for c in q
              for i in range(8)] for q in ps], dtype=np.uint32)
            .view(np.int32))
    ep, eq = ed_words(p for p, _ in e_cases), ed_words(q for _, q in e_cases)
    got_e = ed25519.ed_selftest(ep.cuda(), eq.cuda())
    want_e = ed25519.ed_selftest_plain(ep, eq)
    torch.cuda.synchronize()
    bad_e = int((got_e.cpu() != want_e).any(dim=1).sum())
    check(bad_e == 0, f"Ed25519 group law != Python ints on {bad_e} cases")

    # BN254's core and tower (csrc/bn254_field.cuh, bn254_tower.cuh)
    from fabric_tpu_torch.ops import bn254
    from fabric_tpu_torch.ops import bn254_ref as bref
    BP = bref.P
    b_edges = [0, 1, BP - 1, BP, BP + 1]
    b_rand = [int.from_bytes(rng.bytes(32), "big") % (2 * BP)
              for _ in range(512)]
    b_pairs = [(a, b) for a in b_edges for b in b_edges] + list(
        zip(b_rand[::2], b_rand[1::2]))
    ba, bb = words(a for a, _ in b_pairs), words(b for _, b in b_pairs)
    got_b = bn254.fp_selftest(ba.cuda(), bb.cuda())
    want_b = bn254.fp_selftest_plain(ba, bb)
    torch.cuda.synchronize()
    bad_b = int((got_b.cpu() != want_b).any(dim=1).sum())
    check(bad_b == 0, f"BN254 core != Python ints on {bad_b} cases")
    t_cases = bn_tower_cases(rng, 16)
    cw = words(v for vals, _, _ in t_cases for v in vals).reshape(
        len(t_cases), -1)
    got_t = bn254.tower_selftest(cw.cuda()).cpu()
    want_t = bn254.tower_selftest_plain(cw)
    bad_t = int((got_t != want_t).any(dim=1).sum())
    check(bad_t == 0, f"BN254 tower != the plain tower on {bad_t} cases")
    misses = [bn_tower_int_misses(case, limb.words_to_ints(row))
              for case, row in zip(t_cases, got_t.numpy())]
    check(not any(misses), f"BN254 tower != Python ints: {misses}")
    # the cooperative layer on BN254's tower (a warp a case: its D-type
    # line) and the serial formulas it distributes, with clock cycles
    bco_cases = coop_cases(rng, 8, bref)
    cw = words(v for vals in bco_cases for v in vals).reshape(
        len(bco_cases), -1)
    got_bco = bn254.coop_selftest(cw.cuda()).cpu()
    want_bco = bn254.coop_selftest_plain(cw)
    nwb = 8 * bn254.COOP_OUT
    bad_bco = int((got_bco[:, :nwb] != want_bco[:, :nwb]).any(dim=1).sum())
    check(bad_bco == 0, f"BN254 cooperative layer != the plain tower on "
          f"{bad_bco} cases")
    misses = [coop_int_misses(case, limb.words_to_ints(row[:nwb]), bref,
                              False)
              for case, row in zip(bco_cases, got_bco.numpy())]
    check(not any(misses), f"BN254 cooperative layer != Python ints: "
          f"{misses}")
    bn_cycles = np.median(got_bco[:, nwb:].numpy(), axis=0)

    # BLS12-381's 381-bit core and tower (csrc/bls12_381_field.cuh,
    # bls12_381_tower.cuh), on 12-word values
    from fabric_tpu_torch.ops import bls12_381_kernel as blsk
    LP = blsk.ref.P

    def words12(vals):
        return torch.as_tensor(np.array(limb.ints_to_words(
            list(vals), 12), dtype=np.uint32).reshape(-1, 12).view(np.int32))
    l_edges = [0, 1, LP - 1, LP, LP + 1, 2 * LP - 1]
    l_rand = [int.from_bytes(rng.bytes(48), "big") % (2 * LP)
              for _ in range(512)]
    l_pairs = [(a, b) for a in l_edges for b in l_edges] + list(
        zip(l_rand[::2], l_rand[1::2]))
    la, lb = words12(a for a, _ in l_pairs), words12(b for _, b in l_pairs)
    got_l = blsk.fp_selftest(la.cuda(), lb.cuda())
    want_l = blsk.fp_selftest_plain(la, lb)
    torch.cuda.synchronize()
    bad_l = int((got_l.cpu() != want_l).any(dim=1).sum())
    check(bad_l == 0, f"381-bit core != Python ints on {bad_l} cases")
    lt_cases = bls_tower_cases(rng, 8)
    lw = words12(v for vals, _, _ in lt_cases for v in vals).reshape(
        len(lt_cases), -1)
    got_lt = blsk.tower_selftest(lw.cuda()).cpu()
    want_lt = blsk.tower_selftest_plain(lw)
    bad_lt = int((got_lt != want_lt).any(dim=1).sum())
    check(bad_lt == 0, f"BLS12-381 tower != the plain tower on {bad_lt} "
          "cases")
    misses = [bls_tower_int_misses(case, limb.words_to_ints(row, 12))
              for case, row in zip(lt_cases, got_lt.numpy())]
    check(not any(misses), f"BLS12-381 tower != Python ints: {misses}")
    # the cooperative layer (csrc/pairing_coop.cuh, a warp a case) and
    # the serial formulas it distributes; the clock cycles of the two Fp
    # inverses on one thread
    co_cases = coop_cases(rng, 8, blsk.ref)
    cw = words12(v for vals in co_cases for v in vals).reshape(
        len(co_cases), -1)
    got_co = blsk.coop_selftest(cw.cuda()).cpu()
    want_co = blsk.coop_selftest_plain(cw)
    nw = 12 * blsk.COOP_OUT
    bad_co = int((got_co[:, :nw] != want_co[:, :nw]).any(dim=1).sum())
    check(bad_co == 0, f"BLS12-381 cooperative layer != the plain tower on "
          f"{bad_co} cases")
    misses = [coop_int_misses(case, limb.words_to_ints(row[:nw], 12),
                              blsk.ref, True)
              for case, row in zip(co_cases, got_co.numpy())]
    check(not any(misses), f"BLS12-381 cooperative layer != Python ints: "
          f"{misses}")
    cycles = np.median(got_co[:, nw:].numpy(), axis=0)
    emit({"phase": "field_vs_ints", "ok": True, "card": card,
          "op_cases": len(pairs), "add_cases": len(adds),
          "modn_cases": len(cases), "dbl_cases": len(dbl),
          "f25_cases": len(f_pairs), "ed_cases": len(e_cases),
          "bn254_fp_cases": len(b_pairs), "bn254_tower_cases": len(t_cases),
          "bn254_coop_cases": len(bco_cases),
          "bn254_coop_cycles": dict(zip(bn254.COOP_CYCLE_NAMES,
                                        map(int, bn_cycles))),
          "bls12_381_fp_cases": len(l_pairs),
          "bls12_381_tower_cases": len(lt_cases),
          "bls12_381_coop_cases": len(co_cases),
          "bls12_381_coop_cycles": dict(zip(blsk.COOP_CYCLE_NAMES,
                                            map(int, cycles))),
          "mismatches": 0})


def sw_sample(blk, pool, nproc, label):
    """The port's sw provider on >= 2,048 lanes of `blk` holding every
    bad lane (in the pool), held to the expected bitmap; returns (sample
    lanes, sw bits)."""
    rng = blk["rng"]
    sample = np.array(sorted(set(blk["kind_of"]) | set(
        rng.choice(blk["n"], min(2048, blk["n"]), replace=False).tolist())))
    pubs, key_of = blk["pubs"], blk["key_of"]
    jobs = [(pubs[key_of[i]].x, pubs[key_of[i]].y, blk["sigs"][i],
             blk["digests"][i]) for i in sample.tolist()]
    t0 = time.perf_counter()
    sw_bits = np.array(pool_map(pool, _sw_chunk, jobs, nproc), bool)
    sw_pool_s = time.perf_counter() - t0
    check(bool((sw_bits == blk["expected"][sample]).all()),
          f"{label}: sw provider != expected bitmap on the sample")
    t0 = time.perf_counter()
    _sw_chunk(jobs[:200])
    sw_per_sig_ms = (time.perf_counter() - t0) / 200 * 1e3
    emit({"phase": label, "ok": True, "sample": len(sample),
          "sample_pool_s": sw_pool_s,
          "sw_per_sig_ms_one_core": sw_per_sig_ms})
    return sample, sw_bits


def drive(args, pool, nproc, card):
    """The block, the sw sample, every main-path route and every kernel
    comparison; returns the kernels line's entries."""
    from fabric_tpu_torch.bccsp import factory

    from fabric_tpu_torch import native
    from fabric_tpu_torch.bccsp.cuda import host_prep_scalars

    field_vs_ints(card, args.seed)
    blk = make_block(args.seed, args.txs, pool, nproc)
    corpus = adversarial_sigs(args.seed)
    check_prep("adversarial corpus", corpus,
               [host_prep_scalars(blk["pubs"][0], sig) for sig in corpus],
               native.batch_prep(corpus))
    emit({"phase": "block", "ok": True, "lanes": blk["n"],
          "bad_lanes": {k: sum(1 for v in blk["kind_of"].values()
                               if v == k) for k in BAD_KINDS},
          "sign_s": blk["sign_s"], "host_prep_s": blk["prep_s"],
          "host_prep_python_s": blk["prep_python_s"],
          "native_build_s": args.native_build_s,
          "prep_checked_lanes": blk["n"] + len(corpus), "workers": nproc})
    sample, sw_bits = sw_sample(blk, pool, nproc, "sw")

    route = dict(blk=blk, sw_bits=sw_bits, sample=sample, card=card)
    prov16 = factory.new_bccsp({"Default": "CUDA"})
    c16 = run_route("q16", prov16, prepared=True, fused=True,
                    batch_need=(SHA, TREE), alternate=True, **route)
    mixed_curve_path(blk, make_mixed_lanes(args.seed, pool, nproc), prov16,
                     c16["verify_batch"], sw_bits, sample, card)
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
    telemetry(blk, prov16, sw_bits, sample, card, args.build_libs)
    warm_restart(blk, sw_bits, sample, card)

    tree32 = kernel_vs_plain(prov16, blk, 32, card, pool, nproc)
    tree64 = kernel_vs_plain(prov8, blk, 64, card, pool, nproc)
    st = stage_lanes(prov8, blk)
    sha = sha_vs_plain(st, card)
    res = resident_vs_plain(st, blk, card)

    # the Shamir ladder: a block whose creators sign with 1,021 client keys
    blk_l = make_block(args.seed + 1, args.txs, pool, nproc,
                       clients=CLIENTS)
    emit({"phase": "ladder_block", "ok": True, "lanes": blk_l["n"],
          "keys": len(blk_l["pubs"]),
          "bad_lanes": {k: sum(1 for v in blk_l["kind_of"].values()
                               if v == k) for k in BAD_KINDS},
          "sign_s": blk_l["sign_s"], "host_prep_s": blk_l["prep_s"],
          "host_prep_python_s": blk_l["prep_python_s"]})
    sample_l, sw_l = sw_sample(blk_l, pool, nproc, "ladder_sw")
    provl = factory.new_bccsp({"Default": "CUDA"})
    cl = ladder_path(blk_l, provl, sw_l, sample_l, card)
    lad = ladder_vs_plain(blk_l, provl, card, pool, nproc)
    # Ed25519: its block mixed with the P-256 block on the q16 provider
    eblk = make_ed_block(args.seed, pool, nproc)
    ced = ed25519_path(eblk, blk, prov16, card, pool, nproc)
    edr = ed25519_vs_plain(eblk, prov16, card, pool, nproc)
    # BN254: the idemix checks of a block (pairings, MSMs, BLS)
    iblk = make_idemix_block(args.seed, pool, nproc)
    emit({"phase": "idemix_block", "ok": True, "products": PS_LANES,
          "msm_lanes": len(iblk["msm"]), "bls_lanes": BLS_LANES,
          "make_s": iblk["make_s"]})
    provp = factory.new_bccsp({"Default": "CUDA"})
    cp, cp_layouts = pairing_path(iblk, provp, card, pool, nproc)
    pvp = pairing_vs_plain(iblk, provp, card, pool, nproc)
    pvp["msm", 1] = msm_vs_plain(iblk, provp, card, pool, nproc)
    # BLS12-381: an orderer's span of block signatures, aggregated
    span = make_bls_span(args.seed, pool, nproc)
    emit({"phase": "bls_span", "ok": True, "signatures": max(BLS_WIDTHS),
          "widths": list(BLS_WIDTHS), "make_s": span["make_s"]})
    provb = factory.new_bccsp({"Default": "CUDA"})
    cb, cbw = bls_aggregate_path(span, provb, card, pool, nproc)
    bvp = bls_vs_plain(span, provb, card, pool)
    # every path's provider booked one build event a library it loaded
    emit({"phase": "telemetry_builds", "ok": True, "providers": {
        label: check_build_events(label, p, need) for label, p, need in (
            ("q16", prov16, Q16_LIBS + ("ed25519_verify",)),
            ("q8", prov8, Q16_LIBS + ("fused_resident",)),
            ("device_sha", provsha, Q16_LIBS),
            ("ladder", provl, ("batchprep", "ladder")),
            ("pairing", provp, ("bn254_pairing", "g2_msm")),
            ("bls", provb, ("bls12_381_pairing",)))}})
    # launches a call on the 1,023-key span: one of each entry
    per_call = dict.fromkeys(BLS_KERNELS, 1)

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
             launches=n(csha, DIGEST) + cl["verify_batch"][DIGEST],
             **sha["digest"]),
        dict(name="fused_verify.fused_verify_resident",
             source=src + "fused_resident.cu",
             replaces="fabric_tpu/ops/fused_verify.py:442",
             launches=n(cres, RESIDENT), **res),
        dict(name="verify.ladder_verify_digests (digest lanes)",
             source=src + "ladder.cu",
             replaces="fabric_tpu/ops/p256.py:326",
             launches=cl["verify_prepared"][LADDER], **lad["digests"]),
        dict(name="verify.ladder_verify (message lanes: the SHA "
             "kernel, then the ladder)",
             source=src + "ladder.cu",
             replaces="fabric_tpu/bccsp/tpu.py:3111",
             launches=cl["verify_batch"][LADDER], launches_per_call=2,
             **lad["message"]),
        dict(name="ed25519.ed25519_verify",
             source=src + "ed25519_verify.cu",
             replaces="fabric_tpu/ops/ed25519.py:264",
             launches=ced[ED], **edr),
        *[dict(name=f"{BN_NAMES[e][0]} ({g} thread{'s' * (g > 1)} a lane)",
               source=src + BN_KERNELS[e, g][0] + ".cu",
               replaces=BN_NAMES[e][1],
               launches=n(cp, MSM) if e == "msm" else cp_layouts[f"{e}_{g}"],
               **r) for (e, g), r in pvp.items()],
        dict(name="bls12_381.miller_loop_batch",
             source=src + "bls12_381_pairing.cu",
             replaces="fabric_tpu/ops/bls12_381_kernel.py:87",
             launches=cb[BLS_MILLER],
             launches_per_call=per_call[BLS_MILLER],
             ptxas=ptxas_of("bls12_381_pairing", "bls_miller_kernel"),
             **bvp["miller"]),
        dict(name="bls12_381.product_reduce",
             source=src + "bls12_381_pairing.cu",
             replaces="fabric_tpu/ops/bls12_381_kernel.py:172",
             launches=cb[BLS_REDUCE],
             launches_per_call=per_call[BLS_REDUCE],
             ptxas=ptxas_of("bls12_381_pairing", "bls_reduce_kernel"),
             **bvp["reduce"]),
        dict(name="bls12_381.final_exp_batch (one lane, gt_is_one)",
             source=src + "bls12_381_pairing.cu",
             replaces="fabric_tpu/ops/bls12_381_kernel.py:158",
             launches=cb[BLS_FINAL_EXP],
             launches_per_call=per_call[BLS_FINAL_EXP],
             ptxas=ptxas_of("bls12_381_pairing", "bls_final_exp_kernel"),
             **bvp["final_exp"]),
    ]


def ptxas_of(lib: str, kernel: str) -> dict:
    """ptxas' registers, stack and spills of `kernel` in `lib`'s build."""
    from fabric_tpu_torch import kernels
    return next((v for k, v in kernels.ptxas_summary(lib).items()
                 if k.endswith(kernel)), {})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--txs", type=int, default=10240)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch import kernels, native
    from fabric_tpu_torch.common import devicecost, torchenv
    from fabric_tpu_torch.ops import comb

    # the 8-bit G table and the Ed25519 B table persist inside the
    # checkout's build directory
    os.environ.setdefault(comb.GTAB_CACHE_ENV,
                          os.path.join(torchenv.BUILD_DIR, "gtab8.npy"))
    os.environ.setdefault("FABRIC_TPU_TORCH_EDTAB_CACHE",
                          os.path.join(torchenv.BUILD_DIR, "edtab8.npy"))
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # the batch prep, then every kernel library, through the build seam
    # into one recorder: each library's event holds its seconds and
    # whether the compiler wrote it, which is so exactly for the
    # libraries this checkout had not built
    fresh = {k: not os.path.exists(kernels.library_path(k))
             for k in kernels.KERNELS}
    fresh["batchprep"] = not os.path.exists(native.library_path())
    rec = devicecost.CompileRecorder()
    t0 = time.perf_counter()
    with devicecost.recording(rec):
        native.load()
        built = kernels.build_all()
    build_s = time.perf_counter() - t0
    args.build_libs = {e["kind"]: {"seconds": e["seconds"],
                                   "cold": e["cold"]} for e in rec.events}
    args.native_build_s = args.build_libs["batchprep"]["seconds"]
    check(sorted(args.build_libs) == sorted(fresh)
          and all(args.build_libs[k]["cold"] == fresh[k] for k in fresh)
          and all(built[k] == args.build_libs[k] for k in kernels.KERNELS),
          f"build: events {args.build_libs}, build_all {built}, "
          f"not yet built {fresh}")
    check(rec.stats["compile_cold_total"] == sum(fresh.values())
          and rec.stats["compile_failures"] == 0,
          f"build: compile stats {rec.stats}")
    ptxas = {k: kernels.ptxas_summary(k) for k in kernels.KERNELS}
    emit({"phase": "build", "ok": True, "seconds": build_s,
          "native_build_s": args.native_build_s,
          "libraries": args.build_libs, "ptxas": ptxas,
          "sass": {k: kernels.sass_mix(k) for k in (
              "ptree", "sha_windows", "fused_resident", "ladder",
              "ed25519_verify", "bn254_pairing", "g2_msm",
              "bls12_381_pairing")}})
    # stage A's entries and the resident kernel keep everything in
    # registers: no stack frame, no spills
    for lib in ("sha_windows", "fused_resident"):
        check(bool(ptxas[lib]), f"ptxas: no report for {lib}")
        for fn, rep in ptxas[lib].items():
            check(rep.get("stack") == 0 and rep.get("spill_stores") == 0
                  and rep.get("spill_loads") == 0,
                  f"ptxas: {fn} has a stack or spills: {rep}")

    # the redesigned BLS12-381 Miller and final-exp entries keep a lane's
    # state in shared memory: no spills, a stack frame under 1 KB
    for fn in ("bls_miller_kernel", "bls_final_exp_kernel"):
        rep = ptxas_of("bls12_381_pairing", fn)
        check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0
              and rep.get("stack", 1 << 20) < 1024,
              f"ptxas: {fn} spills or has a stack of 1 KB or more: {rep}")
    # the BN254 entries' layouts the launcher picks: no spills, and the
    # cooperative ones (state in shared memory) a stack under 1 KB
    from fabric_tpu_torch.ops import bn254
    for e in ("miller", "final_exp"):
        for g in bn254.LAYOUTS:
            rep = ptxas_of(*BN_KERNELS[e, g])
            check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0
                  and (g == 1 or rep.get("stack", 1 << 20) < 1024),
                  f"ptxas: {BN_KERNELS[e, g][1]} spills or (a cooperative "
                  f"layout) has a stack of 1 KB or more: {rep}")

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
