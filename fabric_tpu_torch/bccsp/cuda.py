"""CUDA BCCSP provider — batched signature verification on the card.

The port's counterpart of fabric_tpu/bccsp/tpu.py TPUProvider, for the
slices the port has so far: the P-256 comb-digest path, the fused verify
tier, the Shamir ladder, the Ed25519 batch path, the BN254 pairings of
the idemix credential checks and the BLS12-381 aggregate verify of the
orderer's block signatures. Everything but the batch paths delegates
to the port's SWProvider (the pkcs11-style containment of the
reference). `verify_batch` is the scheme router: it
splits a batch by key scheme (`_lane_scheme`) into a P-256 sub-batch
(`_verify_batch_p256`), an Ed25519 one (`_verify_batch_ed25519`) and
BLS12-381 lanes, which the sw provider verifies one by one (aggregates
arrive through `verify_aggregate`). A P-256 batch is staged on the
host — strict DER, low-S and range gates, w = s^-1 mod n — and verified
on the card.

Message lanes (`verify_batch` items without a digest) take one of three
routes, chosen as `_verify_batch_device` chooses them:

  * the fused tier (`FusedVerify`, on for a CUDA device): the host packs
    SHA-padded blocks (`sha256.pack_messages`) and never hashes; the
    card runs stage A (SHA-256, u1/u2, windows: csrc/sha_windows.cu),
    the gather and the tree kernel — or, on the q8 route with
    FTPU_FUSED_RESIDENT=1 and the key set's tables within
    `fused_verify.RESIDENT_TABLE_BUDGET`, the one resident kernel
    (csrc/fused_resident.cu);
  * `HashOnHost: false` with the fused tier off: SHA-256 on the card
    (the digest-only kernel), then the comb-digest pipeline;
  * `HashOnHost: true` (the default) with the fused tier off: hashlib on
    the host, then the comb-digest pipeline.

Digest lanes — `verify_prepared` (the commit path), and every lane of a
batch whose lanes all carry digests or are hashed before the card — take
the comb-digest pipeline (`fused_verify.digest_verify_with_tables`):
per chunk one stage-A launch (u1, u2 and the windows from the digests
and the scalars' bytes) and one tree launch.

A batch holding a message over `MaxBlocks` SHA blocks is hashed on the
host (`host_hash_fallbacks`): routing by size, as the reference does.

A P-256 batch over more than `MaxKeys` distinct keys has no comb tables:
the whole batch takes the Shamir ladder (`ladder_batches`), one kernel
launch a chunk (csrc/ladder.cu, `ops/verify.py`) — message lanes with
SHA-256 inside the kernel, digest lanes (`verify_prepared`, a batch
hashed on the host) on its digest-lanes entry — as fabric_tpu's
`_dispatch_arrays` sends such a batch to `_pipeline`.

Ed25519 lanes: host gates and the SHA-512 challenge per lane
(`ed25519_host.prep_verify`), then one kernel launch a chunk
(csrc/ed25519_verify.cu, `ops/ed25519.py`); sub-batches under
`MinBatch` and the `Ed25519: false` knob serve the sw provider.

BN254 pairings (the idemix MSP's consumers, fabric_tpu/msp/idemix.py
392-427): `pairing_check_batch` pads a batch of pairing products to a
power-of-two bucket (a 2-term pad lane is e(P0, Q0) e(P0, -Q0), the
reference's rule), stages it (`bn254.stage_pairing_products`) and runs,
per chunk, one Miller launch over the products' terms and one final-exp
launch (csrc/bn254_pairing.cu); `g2_msm_batch` runs the G2 MSM kernel
(csrc/g2_msm.cu) a chunk at a time; `bls_verify_batch` checks the lanes
with a signature as 2-term products. Batches under the host cutoffs
(`max(2, MinBatch // 4)` products, `max(2, MinBatch // 8)` MSM lanes),
and products of other than 2 terms that would need padding, are served
by the sw provider and `bn254_ref.g2_msm`: routing by size, as the
reference does.

BLS12-381 aggregates (the orderer's span of block signatures,
fabric_tpu/orderer/blockwriter.py 131-170): `verify_aggregate` gates and
stages the call on the host (`bls12_381.stage_pairs`: the signature's and
keys' subgroup checks, H(m_i)), pads its pairs to a power-of-two bucket
(masked filler lanes) and runs one Miller launch over every pair,
log2(bucket) reduce launches and one final-exp launch on the product's
lane (csrc/bls12_381_pairing.cu, `ops/bls12_381_kernel.py`): one verdict.
Pair lists under `max(2, MinBatch // 4)`, and every call with the
`BLSPairing` knob off (on by default for a CUDA device), take the staged
host path (`bls12_381.miller_products`, `check_products`): routing by
size, as the reference does.

Device errors propagate: the port has no breaker and no sw fallback yet
(the reference's pairing methods and `verify_aggregate` fall back to the
host on any device error; here they raise), and no counterpart of
`_try_fused`'s demotion to host hashing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import ed25519_host as edh
from fabric_tpu_torch.bccsp import sw as swmod
from fabric_tpu_torch.bccsp import utils
from fabric_tpu_torch.common import torchenv
from fabric_tpu_torch.ops import bls12_381 as blsagg
from fabric_tpu_torch.ops import bls12_381_kernel as blsk
from fabric_tpu_torch.ops import bn254, comb, ed25519, fused_verify, limb
from fabric_tpu_torch.ops import bn254_ref, ptree, sha256, verify

logger = logging.getLogger("fabric_tpu_torch.bccsp.cuda")

P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = utils.P256_N

# 8-bit Q tables (~1.97 MB per key slot) kept per key set, by count
Q8_CACHE_SETS = 16

# provider stat -> (module, attribute) of each kernel wrapper's launch count
LAUNCH_COUNTERS = {
    "tree_kernel_launches": (ptree, "launches"),
    "sha_windows_launches": (fused_verify, "sha_windows_launches"),
    "sha256_launches": (sha256, "launches"),
    "resident_launches": (fused_verify, "resident_launches"),
    "ladder_launches": (verify, "launches"),
    "ed25519_launches": (ed25519, "launches"),
    "miller_launches": (bn254, "miller_launches"),
    "final_exp_launches": (bn254, "final_exp_launches"),
    "g2_msm_launches": (bn254, "msm_launches"),
    "bls_miller_launches": (blsk, "miller_launches"),
    "bls_reduce_launches": (blsk, "reduce_launches"),
    "bls_final_exp_launches": (blsk, "final_exp_launches"),
}


def host_prep_scalars(pub, signature):
    """Per-lane signature prep: strict DER + low-S + scalar-range gates,
    then the device operands. Returns (r, rpn, w) as 32-byte big-endian
    rows, or None when the host rejects the lane."""
    rs = swmod.check_signature(pub, signature)
    if rs is None:
        return None
    r, s = rs
    if r >= N or s >= N:
        # crypto/ecdsa.Verify rejects out-of-range scalars before any
        # curve math
        return None
    rpn = r + N if r + N < P256_P else r
    w = pow(s, -1, N)
    return (r.to_bytes(32, "big"), rpn.to_bytes(32, "big"),
            w.to_bytes(32, "big"))


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class CUDAProvider(api.BCCSP):
    def __init__(self, *, device=None, min_batch: int = 16,
                 max_keys: int = 16, chunk: int = 32768,
                 use_g16: bool | None = None,
                 table_cache_bytes: int = 6 << 30,
                 hash_on_host: bool = True,
                 fused_verify: bool | None = None,
                 max_blocks: int = 64, ed25519_enabled: bool = True,
                 bls_pairing: bool | None = None):
        self.device = torchenv.resolve_device(device)
        self._sw = swmod.SWProvider()
        self._min_batch = min_batch
        self._max_keys = max_keys       # comb path cutoff (distinct keys)
        self._chunk = chunk             # lanes per kernel launch
        # 16-bit windows on both bases: 32 points per signature instead
        # of 64, for ~252 MB of G table plus ~252 MB per key slot of Q
        # table resident. None = on for the card, off on the CPU, where
        # the table builds take minutes.
        self._use_g16 = (self.device.type == "cuda" if use_g16 is None
                         else use_g16)
        self._table_cache_bytes = table_cache_bytes
        # with the fused tier off: hash message lanes with hashlib (True)
        # or with the SHA-256 kernel on the card (False)
        self._hash_on_host = hash_on_host
        # the fused tier; None = on for a CUDA device, off on the CPU
        # (FTPU_FUSED=0/1 overrides, see _fused_enabled)
        self._fused_verify = fused_verify
        # the largest power-of-two SHA block count a device batch pads
        # its messages to; a longer message sends its batch to hashlib
        self._max_blocks = max_blocks
        # the Ed25519 kernel (CUDA.Ed25519); False serves Ed25519 lanes on
        # the sw provider
        self._ed25519 = ed25519_enabled
        # the BLS12-381 aggregate kernels (CUDA.BLSPairing); None = on for
        # a CUDA device; off serves every aggregate on the staged host path
        self._bls_pairing = bls_pairing
        self._ed_tab = None
        # per-key-set tables, least recently used first: Q16 bounded by
        # bytes, Q8 (~1.97 MB per key slot) by count
        self._lock = threading.Lock()
        self._q16_cache: OrderedDict = OrderedDict()
        self._q16_bytes = 0
        self._q8_cache: OrderedDict = OrderedDict()
        self.stats = {"comb_batches": 0, "host_hashed_lanes": 0,
                      "host_hash_fallbacks": 0, "fused_batches": 0,
                      "fused_lanes": 0,
                      "q8_builds": 0, "q16_builds": 0,
                      "q16_oversize_skips": 0, "nonp256_sw_lanes": 0,
                      "table_build_s": 0.0, "tree_kernel_launches": 0,
                      "sha_windows_launches": 0, "sha256_launches": 0,
                      "resident_launches": 0, "ladder_batches": 0,
                      "ladder_launches": 0, "ed25519_batches": 0,
                      "ed25519_sw_lanes": 0, "ed25519_launches": 0,
                      "ed25519_prep_s": 0.0, "pairing_batches": 0,
                      "pairing_pairs": 0, "g2_msm_batches": 0,
                      "miller_launches": 0, "final_exp_launches": 0,
                      "g2_msm_launches": 0, "bls_aggregate_checks": 0,
                      "bls_sw_lanes": 0, "bls_miller_launches": 0,
                      "bls_reduce_launches": 0,
                      "bls_final_exp_launches": 0}

    def _fused_enabled(self) -> bool:
        """The fused-tier knob (CUDA.FusedVerify): FTPU_FUSED=0/1 first,
        then the knob, then on for a CUDA device and off for the CPU."""
        env = os.environ.get("FTPU_FUSED")
        if env is not None:
            return env != "0"
        if self._fused_verify is not None:
            return self._fused_verify
        return self.device.type == "cuda"

    @staticmethod
    def _fused_resident_enabled() -> bool:
        """The resident kernel's gate: FTPU_FUSED_RESIDENT=1 (default
        off, as in the reference; the tiered pair is the serving
        configuration)."""
        return os.environ.get("FTPU_FUSED_RESIDENT") == "1"

    # -- everything non-batch delegates --

    def key_gen(self, opts):
        return self._sw.key_gen(opts)

    def key_import(self, raw, opts):
        return self._sw.key_import(raw, opts)

    def get_key(self, ski):
        return self._sw.get_key(ski)

    def hash(self, msg, opts=None):
        return self._sw.hash(msg, opts)

    def sign(self, key, digest, opts=None):
        # secret keys and nonces never leave the host
        return self._sw.sign(key, digest, opts)

    def verify(self, key, signature, digest, opts=None):
        return self._sw.verify(key, signature, digest, opts)

    # -- the item path --

    @staticmethod
    def _lane_scheme(item) -> str:
        """The router's partition key for one lane: "ed25519" for an
        Ed25519 key, "bls" for a BLS12-381 key, else "p256" (P-256, other
        ECDSA curves and dead non-ECDSA keys, which the P-256 staging
        handles inline)."""
        scheme = getattr(item.key, "scheme", None)
        if scheme == "ed25519":
            return "ed25519"
        if scheme == "bls12381":
            return "bls"
        return "p256"

    def verify_batch(self, items: Sequence[api.VerifyItem]) -> list[bool]:
        """The scheme router (fabric_tpu's `verify_batch`): a batch under
        `MinBatch` serves the sw provider; otherwise its lanes are split
        by `_lane_scheme` into per-scheme sub-batches, each verified on
        its path (BLS lanes one by one on the sw provider, as fabric_tpu's
        router sends them), and the verdicts go back in the items' order.
        A batch of P-256 lanes alone takes the P-256 path as it is."""
        if len(items) < self._min_batch:
            return self._sw.verify_batch(items)
        schemes = [self._lane_scheme(it) for it in items]
        if all(s == "p256" for s in schemes):
            return self._verify_batch_p256(items)
        by_scheme: dict[str, list[int]] = {}
        for i, s in enumerate(schemes):
            by_scheme.setdefault(s, []).append(i)
        result = [False] * len(items)
        for scheme, lanes in by_scheme.items():
            sub = [items[i] for i in lanes]
            if scheme == "ed25519":
                out = self._verify_batch_ed25519(sub)
            elif scheme == "bls":
                self.stats["bls_sw_lanes"] += len(sub)
                out = self._sw.verify_batch(sub)
            else:
                out = self._verify_batch_p256(sub)
            for i, v in zip(lanes, out):
                result[i] = v
        return result

    def _verify_batch_p256(self, items) -> list[bool]:
        """The P-256 branch of fabric_tpu's `_verify_batch_device`; a
        sub-batch under `MinBatch` serves the sw provider. Message lanes
        take the fused tier, the device-SHA route or host hashing (see
        the module docstring), or the ladder over more than `MaxKeys`
        keys; digest lanes are digests on every route. Lanes on non-ECDSA
        keys reject; a P-256 key with a digest other than 32 bytes
        verifies on the sw path; an ECDSA key on another curve raises
        NotImplementedError."""
        if len(items) < self._min_batch:
            return self._sw.verify_batch(items)
        n = len(items)
        bucket = self._bucket(n)
        fused = self._fused_enabled()
        hash_here = self._hash_on_host and not fused
        premask = np.zeros(bucket, dtype=bool)
        r_b = np.zeros((bucket, 32), dtype=np.uint8)
        rpn_b = np.zeros((bucket, 32), dtype=np.uint8)
        w_b = np.zeros((bucket, 32), dtype=np.uint8)
        key_idx = np.zeros(bucket, dtype=np.int32)
        digests = np.zeros((bucket, 8), dtype=np.uint32)
        has_digest = np.zeros(bucket, dtype=bool)
        msgs = [b""] * bucket
        key_map: dict[bytes, int] = {}
        sw_lanes: list[int] = []
        hashed = 0
        for i, it in enumerate(items):
            pub = it.key.public_key()
            if not isinstance(pub, swmod.ECDSAPublicKey):
                continue                    # premask stays False: reject
            if not pub.is_p256():
                raise NotImplementedError(swmod.NOT_P256)
            if it.digest is not None and len(it.digest) != 32:
                sw_lanes.append(i)
                continue
            prep = host_prep_scalars(pub, it.signature)
            if prep is None:
                continue
            premask[i] = True
            r_b[i] = np.frombuffer(prep[0], np.uint8)
            rpn_b[i] = np.frombuffer(prep[1], np.uint8)
            w_b[i] = np.frombuffer(prep[2], np.uint8)
            kb = pub.x_bytes().tobytes() + pub.y_bytes().tobytes()
            key_idx[i] = key_map.setdefault(kb, len(key_map))
            digest = it.digest
            if digest is None and hash_here:
                # an empty message still hashes to SHA-256(b"")
                digest = self._sw.hash(it.message)
                hashed += 1
            if digest is not None:
                digests[i] = np.frombuffer(digest, dtype=">u4")
                has_digest[i] = True
            else:
                msgs[i] = it.message
        nb = None                   # None: every live lane is a digest lane
        pending = np.nonzero(premask & ~has_digest)[0]
        if len(pending):
            max_len = max(len(msgs[i]) for i in pending)
            nb = self._nb_bucket(max_len)
            if nb is None:
                # a message over the block budget: hash the batch's
                # message lanes on the host instead
                self.stats["host_hash_fallbacks"] += 1
                logger.info("message of %d bytes exceeds the %d-block "
                            "device budget; hashing the batch host-side",
                            max_len, self._max_blocks)
                for i in pending:
                    digests[i] = np.frombuffer(self._sw.hash(msgs[i]),
                                               dtype=">u4")
                has_digest[pending] = True
                hashed += len(pending)
        self.stats["host_hashed_lanes"] += hashed
        result = [False] * n
        if key_map:
            ladder = len(key_map) > self._max_keys
            if nb is None:
                dispatch = (self._dispatch_ladder if ladder
                            else self._dispatch_comb_digest)
                out = dispatch(bucket, key_map, key_idx, r_b, rpn_b, w_b,
                               premask, digests)
            else:
                blocks, nblocks = sha256.pack_messages(msgs, nb)
                # digest lanes skip the device hash: no live block
                nblocks[has_digest] = 0
                if ladder:
                    out = self._dispatch_ladder(
                        bucket, key_map, key_idx, r_b, rpn_b, w_b, premask,
                        digests, (blocks, nblocks, has_digest))
                else:
                    dispatch = (self._dispatch_fused_verify if fused
                                else self._dispatch_device_sha)
                    out = dispatch(bucket, key_map, key_idx, blocks, nblocks,
                                   r_b, rpn_b, w_b, premask, digests,
                                   has_digest)
            result = out()[:n].tolist()
        if sw_lanes:
            self.stats["nonp256_sw_lanes"] += len(sw_lanes)
            for i, v in zip(sw_lanes, self._sw.verify_batch(
                    [items[i] for i in sw_lanes])):
                result[i] = v
        return result

    # -- the prepared-block path --

    def verify_prepared(self, digests: np.ndarray, r: np.ndarray,
                        rpn: np.ndarray, w: np.ndarray, der_ok: np.ndarray,
                        key_idx: np.ndarray, keys, get_sig) -> list[bool]:
        return self.verify_prepared_start(
            digests, r, rpn, w, der_ok, key_idx, keys, get_sig)()

    def verify_prepared_start(self, digests: np.ndarray, r: np.ndarray,
                              rpn: np.ndarray, w: np.ndarray,
                              der_ok: np.ndarray, key_idx: np.ndarray,
                              keys, get_sig):
        """Batched verify over pre-staged operands: digests (n, 32)
        uint8, r/rpn/w (n, 32) uint8 big-endian (host_prep_scalars),
        der_ok (n,) bool, key_idx (n,) int indexing `keys` (Key objects),
        get_sig(i) -> lane i's DER (read on the sw path only).

        Returns a resolver: the device work is enqueued now and the
        resolver waits for it, so the caller's host work overlaps the
        card's. Verdicts equal verify_batch over the same items."""
        n = len(der_ok)
        if n == 0:
            return lambda: []
        pubs = []
        for k in keys:
            pub = k.public_key() if k is not None else None
            if isinstance(pub, swmod.ECDSAPublicKey) and not pub.is_p256():
                raise NotImplementedError(swmod.NOT_P256)
            pubs.append(pub if isinstance(pub, swmod.ECDSAPublicKey)
                        else None)
        if n < self._min_batch:
            out = self._verify_prepared_sw(range(n), digests, key_idx, keys,
                                           get_sig)
            return lambda: out

        bucket = self._bucket(n)
        lane_key = np.asarray(key_idx, dtype=np.int64)
        key_ok = np.array([p is not None for p in pubs], dtype=bool)
        premask = np.zeros(bucket, dtype=bool)
        premask[:n] = np.asarray(der_ok, dtype=bool) & key_ok[lane_key]
        # key slots over the P-256 keys; dead lanes keep slot 0 (masked)
        key_map: dict[bytes, int] = {}
        slot_of = np.zeros(len(keys), dtype=np.int32)
        for j, p in enumerate(pubs):
            if p is not None:
                kb = p.x_bytes().tobytes() + p.y_bytes().tobytes()
                slot_of[j] = key_map.setdefault(kb, len(key_map))
        lane_slot = np.zeros(bucket, dtype=np.int32)
        lane_slot[:n] = slot_of[lane_key]
        dg = np.zeros((bucket, 8), dtype=np.uint32)
        dg[:n] = np.ascontiguousarray(digests).view(">u4").reshape(n, 8)

        def pad(a):
            out = np.zeros((bucket, 32), dtype=np.uint8)
            out[:n] = a
            return out

        if not key_map:
            return lambda: [False] * n
        dispatch = (self._dispatch_ladder if len(key_map) > self._max_keys
                    else self._dispatch_comb_digest)
        thunk = dispatch(bucket, key_map, lane_slot, pad(r), pad(rpn),
                         pad(w), premask, dg)
        return lambda: thunk()[:n].tolist()

    def _verify_prepared_sw(self, lanes, digests, key_idx, keys,
                            get_sig) -> list[bool]:
        out = []
        for i in lanes:
            k = keys[key_idx[i]]
            try:
                out.append(k is not None and self._sw.verify(
                    k, get_sig(i), bytes(digests[i])))
            except TypeError:               # a non-ECDSA key rejects
                out.append(False)
        return out

    # -- dispatch --

    @staticmethod
    def _canonical_key_order(key_map: dict, key_idx: np.ndarray):
        """Reassign key indices by sorted key bytes: table slot order and
        the cache key must not depend on first-appearance order (a hit
        with another slot order would comb against the wrong key).
        Returns (ordered key bytes, remapped key_idx)."""
        order = sorted(key_map)
        remap = np.zeros(len(key_map), dtype=np.int32)
        for j, kb in enumerate(order):
            remap[key_map[kb]] = j
        return order, remap[key_idx]

    def _bucket(self, n: int) -> int:
        b = self._min_batch
        while b < n:
            b *= 2
        return b

    def _nb_bucket(self, max_len: int) -> int | None:
        """Power-of-two SHA block count covering max_len, else None."""
        nb = 1
        while sha256.max_message_len(nb) < max_len:
            nb *= 2
            if nb > self._max_blocks:
                return None
        return nb

    def _dispatch_comb_digest(self, bucket, key_map, key_idx, r8, rpn8, w8,
                              premask, digests):
        """Enqueue the comb-digest pipeline for a staged batch, per
        `chunk` lanes one stage-A launch (digest lanes: u1, u2 and the
        windows) and one tree launch; returns a thunk that waits and
        hands back the (bucket,) numpy verdicts."""
        key_idx, K, q_flat, g16, q16 = self._resolve_tables(key_map, key_idx)
        self.stats["comb_batches"] += 1
        words = digests.view(np.int32)        # the same bits
        return self._chunked(bucket, lambda c: (
            fused_verify.digest_verify_with_tables(
                c(words), c(key_idx), q_flat, c(r8), c(rpn8), c(w8),
                c(premask), g16=g16, q16=q16)))

    def _dispatch_device_sha(self, bucket, key_map, key_idx, blocks,
                             nblocks, r8, rpn8, w8, premask, digests,
                             has_digest):
        """`HashOnHost: false` with the fused tier off (fabric_tpu's
        `_comb_pipeline_locked` fused body): SHA-256 on the card by the
        digest-only kernel, the lanes' digests where they have one, then
        the comb-digest pipeline; one chunk at a time."""
        key_idx, K, q_flat, g16, q16 = self._resolve_tables(key_map, key_idx)
        self.stats["comb_batches"] += 1
        blocks = blocks.view(np.int32)
        words = digests.view(np.int32)

        def run(c):
            # int64 words masked to 32 bits -> int32, the same bits
            hashed = sha256.sha256_blocks(c(blocks), c(nblocks))
            dw = torch.where(c(has_digest)[:, None], c(words),
                             hashed.to(torch.int32))
            return fused_verify.digest_verify_with_tables(
                dw, c(key_idx), q_flat, c(r8), c(rpn8), c(w8), c(premask),
                g16=g16, q16=q16)
        return self._chunked(bucket, run)

    def _dispatch_fused_verify(self, bucket, key_map, key_idx, blocks,
                               nblocks, r8, rpn8, w8, premask, digests,
                               has_digest):
        """The fused tier, one chunk at a time: padded SHA blocks and
        compact u8 scalars go to the card, the verdicts come back. The
        tiered pair (stage A, gather, tree), or the resident kernel as
        fabric_tpu's `_fused_pipeline` picks it: only on the q8 route,
        only with FTPU_FUSED_RESIDENT=1, only within the budget."""
        key_idx, K, q_flat, g16, q16 = self._resolve_tables(key_map, key_idx)
        resident = (not q16 and self._fused_resident_enabled()
                    and fused_verify.resident_table_bytes(K)
                    <= fused_verify.RESIDENT_TABLE_BUDGET)
        self.stats["fused_batches"] += 1
        self.stats["fused_lanes"] += int(np.sum(premask & ~has_digest))
        blocks = blocks.view(np.int32)
        digests = digests.view(np.int32)

        def run(c):
            args = (c(blocks), c(nblocks), c(key_idx), q_flat, c(r8),
                    c(rpn8), c(w8), c(premask), c(digests), c(has_digest))
            if resident:
                return fused_verify.fused_verify_resident(*args)
            return fused_verify.fused_verify_with_tables(
                *args, g16=g16, q16=q16)
        return self._chunked(bucket, run)

    def _dispatch_ladder(self, bucket, key_map, key_idx, r8, rpn8, w8,
                         premask, digests, message=None):
        """The Shamir ladder for a batch over more than `MaxKeys` keys
        (fabric_tpu's `_dispatch_arrays` ladder branch), one launch a
        chunk: each lane's key goes to the card as 64 bytes (x then y,
        big-endian). With `message` = (blocks, nblocks, has_digest) the
        message entry hashes the lanes without a digest inside the
        kernel; without it every lane is a digest lane."""
        self.stats["ladder_batches"] += 1
        qk = np.zeros((len(key_map), 64), dtype=np.uint8)
        for kb, j in key_map.items():
            qk[j] = np.frombuffer(kb, dtype=np.uint8)
        q8 = qk[key_idx]
        words = digests.view(np.int32)        # the same bits
        if message is None:
            return self._chunked(bucket, lambda c: (
                verify.ladder_verify_digests(c(words), c(q8), c(r8),
                                             c(rpn8), c(w8), c(premask))))
        blocks, nblocks, has_digest = message
        blocks = blocks.view(np.int32)
        return self._chunked(bucket, lambda c: verify.ladder_verify(
            c(blocks), c(nblocks), c(words), c(has_digest), c(q8), c(r8),
            c(rpn8), c(w8), c(premask)))

    # -- the Ed25519 batch path (the router's "ed25519" lanes) --

    def _verify_batch_ed25519(self, items) -> list[bool]:
        """fabric_tpu's `_verify_batch_ed25519` without its breaker: a
        sub-batch under `MinBatch`, or any with the kernel switched off
        (`Ed25519: false`), serves the sw provider with the same
        verdicts; the rest is one device dispatch. Device errors
        propagate."""
        if len(items) < self._min_batch or not self._ed25519:
            self.stats["ed25519_sw_lanes"] += len(items)
            return self._sw.verify_batch(items)
        return self._dispatch_ed25519(items)

    def _dispatch_ed25519(self, items) -> list[bool]:
        """Host prep (the gates and the SHA-512 challenge of
        `ed25519_host.prep_verify`, the policy the sw path shares), the
        kernel's operand rows (`ed25519.stage_rows`), one launch a
        chunk; the prep's seconds go to stats["ed25519_prep_s"]."""
        n = len(items)
        t0 = time.perf_counter()
        prep = []
        for it in items:
            msg = it.message if it.message is not None else it.digest
            prep.append(None if msg is None else edh.prep_verify(
                it.key.public_key().bytes(), it.signature, msg))
        bucket = self._bucket(n)
        rows = ed25519.stage_rows(prep, bucket)
        self.stats["ed25519_prep_s"] += time.perf_counter() - t0
        tab = self._ed_table()
        out = self._chunked(bucket, lambda c: ed25519.ed25519_verify(
            tab, *(c(a) for a in rows)))
        self.stats["ed25519_batches"] += 1
        return out()[:n].tolist()

    def _ed_table(self) -> torch.Tensor:
        """The fixed-base B table in the layout the device's path takes
        (`ed25519.device_table`: the kernel's 32-bit plain-domain words
        on the card, the JAX layout on the CPU), moved to the device once
        per provider."""
        with self._lock:
            if self._ed_tab is None:
                self._ed_tab = self._timed(ed25519.device_table,
                                           self.device)
            return self._ed_tab

    # -- BN254 pairings (idemix; BASELINE config 4) --

    def pairing_check_batch(self, products) -> list[bool]:
        """prod_j e(P_j, Q_j) == 1 per lane, on the card (fabric_tpu's
        `pairing_check_batch` without its host fallback on device errors).

        products: [[(P_int_affine, Q_twist_int_affine), ...] per lane]
        with a uniform term count. Batches under the host cutoff, and
        products of other than 2 terms that would need padding, go to
        the sw provider's exact pairing."""
        if len(products) < max(2, self._min_batch // 4):
            return self._sw.pairing_check_batch(products)
        nterms, n = len(products[0]), len(products)
        bucket = _pow2(n)
        if nterms != 2 and bucket != n:
            return self._sw.pairing_check_batch(products)
        # pad with a trivially-true product: infinity is not representable
        # affine, so a VALID identity product e(P, Q) * e(P, -Q) from lane
        # 0's first term
        p0, q0 = products[0][0]
        pad = [(p0, q0), (p0, bn254_ref.g2_neg_tw(q0))]
        staged = bn254.stage_pairing_products(
            list(products) + [pad] * (bucket - n))
        outs = []
        with self._count_launches():
            for lo in range(0, bucket, self._chunk):
                hi = lo + self._chunk
                outs.append(bn254.pairing_product_is_one(
                    *bn254.to_device(staged, self.device, lo, hi)))
        out = torch.cat(outs).cpu().numpy()
        self.stats["pairing_batches"] += 1
        self.stats["pairing_pairs"] += n * nterms
        return out[:n].tolist()

    def g2_msm_batch(self, lanes) -> list:
        """Per lane sum_t k_t * Q_t over the BN254 twist (affine int
        points or None; returns affine int points, None for infinity), on
        the card: the idemix PS presentations' Schnorr recombinations and
        subgroup lanes in one dispatch. Batches under the host cutoff take
        the host Strauss MSM (bn254_ref.g2_msm)."""
        if len(lanes) < max(2, self._min_batch // 8):
            return [bn254_ref.g2_msm(lane) for lane in lanes]
        nterms, n = len(lanes[0]), len(lanes)
        bucket = _pow2(n)
        kw, q_flat = bn254.stage_g2_msm_words(
            list(lanes) + [[(0, None)] * nterms] * (bucket - n))
        kw = kw.view(np.int32)
        outs = []
        with self._count_launches():
            for lo in range(0, bucket, self._chunk):
                hi = lo + self._chunk
                outs.append(bn254.g2_msm(
                    *bn254.to_device([kw, *q_flat], self.device, lo, hi)))
        self.stats["g2_msm_batches"] += 1
        out = tuple(tuple(torch.cat([o[i][j] for o in outs]).cpu()
                          for j in range(2)) for i in range(3))
        return bn254.read_g2_msm(out)[:n]

    def bls_verify_batch(self, pk_tw, msgs, sig_points) -> list[bool]:
        """Issuer-credential BLS verify: e(sig, G2) e(H(m), -pk) == 1 per
        lane. None entries of `sig_points` (malformed) are False without
        touching the card."""
        idx = [i for i, s in enumerate(sig_points) if s is not None]
        out = [False] * len(msgs)
        if idx:
            prods = bn254.bls_products(pk_tw, [msgs[i] for i in idx],
                                       [sig_points[i] for i in idx])
            for i, v in zip(idx, self.pairing_check_batch(prods)):
                out[i] = v
        return out

    # -- BLS12-381 aggregate verify (the orderer's block signatures) --

    def verify_aggregate(self, keys, messages, signature) -> bool:
        """BLS12-381 aggregate verify (fabric_tpu's `verify_aggregate`
        without its sw fallback): the structural and subgroup gates stage
        the pairing-product pair list (`bls12_381.stage_pairs`), then
        `_bls_pairing_check` decides it, on the card or on the staged host
        path. Verdicts equal the sw provider's on every route."""
        ops = swmod.bls_aggregate_operands(keys, signature)
        if ops is None:
            return False
        pairs = blsagg.stage_pairs(ops[0], list(messages), ops[1])
        out = False if pairs is None else self._bls_pairing_check(pairs)
        self.stats["bls_aggregate_checks"] += 1
        return out

    def _bls_pairing_enabled(self) -> bool:
        """The BLS kernels' knob (CUDA.BLSPairing): as set, else on for a
        CUDA device and off on the CPU."""
        if self._bls_pairing is not None:
            return self._bls_pairing
        return self.device.type == "cuda"

    def _bls_pairing_check(self, pairs) -> bool:
        """One staged pair list: the card's kernels when the knob is on
        and the pair count reaches `max(2, MinBatch // 4)`, else the
        staged host path (routing by size, as the reference does)."""
        if (not self._bls_pairing_enabled()
                or len(pairs) < max(2, self._min_batch // 4)):
            return blsagg.check_products(blsagg.miller_products(pairs))
        return self._dispatch_bls_pairing(pairs)

    def _dispatch_bls_pairing(self, pairs) -> bool:
        """Pad the pairs to a power-of-two bucket (masked filler lanes
        contribute Fp12 one), stage them, and run one Miller, log2(bucket)
        reduce and one final-exp launch; one verdict comes back."""
        n = len(pairs)
        staged = blsk.to_device(blsk.stage_pairs(pairs, pad_to=_pow2(n)),
                                self.device)
        with self._count_launches():
            out = blsk.pairs_product_is_one(*staged)
        self.stats["pairing_batches"] += 1
        self.stats["pairing_pairs"] += n
        return bool(out.cpu()[0])

    @contextlib.contextmanager
    def _count_launches(self):
        """Add the kernels launched inside the block to the stats."""
        before = {k: getattr(*c) for k, c in LAUNCH_COUNTERS.items()}
        try:
            yield
        finally:
            for k, c in LAUNCH_COUNTERS.items():
                self.stats[k] += getattr(*c) - before[k]

    def _chunked(self, bucket, run):
        """Call run(c) for each `chunk` of the bucket, c(a) putting a
        chunk of host array `a` on the card; count the kernels launched
        and return a thunk that waits for the (bucket,) numpy verdicts."""
        outs = []
        with self._count_launches():
            for lo in range(0, bucket, self._chunk):
                def c(a, lo=lo):
                    return torch.from_numpy(np.ascontiguousarray(
                        a[lo:lo + self._chunk])).to(self.device)
                outs.append(run(c))
        return lambda: torch.cat(outs).cpu().numpy()

    def _resolve_tables(self, key_map, key_idx):
        """Canonical slot order + the key set's tables: Q16 (with G16)
        when it fits the byte budget, else Q8 with the 8-bit G table.
        Returns (key_idx remapped, K, q_flat, g16 or None, q16?)."""
        order, key_idx = self._canonical_key_order(key_map, key_idx)
        K = 1
        while K < len(order):
            K *= 2
        qk = np.zeros((K, 64), dtype=np.uint8)
        for i, kb in enumerate(order):
            qk[i] = np.frombuffer(kb, dtype=np.uint8)
        cache_key = tuple(order)
        if self._use_g16:
            q16 = self._q16_cached(cache_key, K, qk)
            if q16 is not None:
                g16 = comb.g16_resident(self.device)
                if g16 is None:
                    g16 = self._timed(comb.g16_tables, self.device)
                return key_idx, K, q16, g16, True
        return key_idx, K, self._q8_cached(cache_key, qk), None, False

    def _timed(self, fn, *args):
        """Run a table build to completion on the card and add its
        seconds to stats["table_build_s"]."""
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["table_build_s"] += time.perf_counter() - t0
        return out

    def _q8_cached(self, cache_key, qk: np.ndarray) -> torch.Tensor:
        with self._lock:
            q8 = self._q8_cache.pop(cache_key, None)
            if q8 is not None:
                self._q8_cache[cache_key] = q8            # most recent
                return q8
        q = torch.from_numpy(qk).to(self.device)
        q8 = self._timed(comb.build_q_tables,
                         limb.be_bytes_to_limbs(q[:, :32]),
                         limb.be_bytes_to_limbs(q[:, 32:]))
        with self._lock:
            self.stats["q8_builds"] += 1
            self._q8_cache[cache_key] = q8
            while len(self._q8_cache) > Q8_CACHE_SETS:
                self._q8_cache.popitem(last=False)
        return q8

    def _q16_cached(self, cache_key, K: int, qk: np.ndarray):
        """The key set's 16-bit Q table from a byte-bounded LRU, built on
        a miss; None when one table alone exceeds the budget (that set
        stays on the 8-bit path)."""
        with self._lock:
            q16 = self._q16_cache.pop(cache_key, None)
            if q16 is not None:
                self._q16_cache[cache_key] = q16          # most recent
                return q16
        est = comb.NWIN_G16 * K * comb.NENT_G16 * 3 * limb.L * 4
        if est > self._table_cache_bytes:
            self.stats["q16_oversize_skips"] += 1
            logger.warning(
                "16-bit Q table for %d keys needs %.1f GB > TableCacheMB "
                "budget (%.1f GB); staying on the 8-bit Q path for this "
                "key set", K, est / 2**30, self._table_cache_bytes / 2**30)
            return None
        q8 = self._q8_cached(cache_key, qk)
        q16 = self._timed(comb.build_q16_tables, q8, K)
        with self._lock:
            self.stats["q16_builds"] += 1
            while self._q16_cache and \
                    self._q16_bytes + est > self._table_cache_bytes:
                _, old = self._q16_cache.popitem(last=False)
                self._q16_bytes -= old.numel() * 4
            self._q16_cache[cache_key] = q16
            self._q16_bytes += est
        return q16
