"""Stage A and the fused verify tier: device SHA-256 feeding the comb.

Port of fabric_tpu/ops/fused_verify.py, and of the scalar stage of the
JAX package's comb-digest pipeline (fabric_tpu/bccsp/tpu.py
`_comb_pipeline_digest`). The host ships SHA-padded message blocks
(`sha256.pack_messages`) or digests, and 32-byte big-endian scalar
rows, and the card computes the rest:

  stage A, one kernel (csrc/sha_windows.cu) with two entries: per lane,
    the digest words (`sha_windows`: SHA-256 over its live blocks or its
    given digest; `digest_windows`: its digest), u1 = e*w and u2 = r*w
    (mod n, canonical) and the comb windows of u1 and u2;
  stage B: the gather, the sum and the check in one kernel
    (`ptree.tree_verify_windows`). `fused_verify_with_tables` (message
    lanes) and `digest_verify_with_tables` (digest lanes: the commit
    path) run the two stages;
  the resident variant (`fused_verify_resident`): one kernel runs stage
    A at 8-bit windows, the gather from the g8/q8 tables and the
    64-point sum and check; only the verdicts come back.

A tensor on the CPU runs a kernel's plain torch version here; a CUDA
tensor launches the hand-written kernel (csrc/sha_windows.cu,
csrc/fused_resident.cu) and adds one to its count
(`sha_windows_launches` for either stage-A entry, `resident_launches`);
anything else raises. Nothing falls back. Layout is batch-major, as in
the rest of the port: (B, rows) where the JAX package keeps (rows,
lanes) tiles.
"""

from __future__ import annotations

import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.ops import comb, limb, p256, ptree, sha256
from fabric_tpu_torch.ops.limb import L

# The resident kernel gathers 64 random table rows per lane from the g8
# table and the lane's q8 key slot, so its speed rests on those tables
# staying in L2 while the lanes' blocks and scalars stream past once. On
# the TPU the budget was a VMEM limit (64 MiB); on the H100 the tables live
# in global memory, and the budget is half of its 50 MiB L2, leaving the
# other half to the streamed operands: (1 + K) x 1.97 MB fits for up to 12
# key slots, so key sets of up to 8 keys (K is a power of two) qualify.
H100_L2_BYTES = 50 << 20
RESIDENT_TABLE_BUDGET = H100_L2_BYTES // 2

# the resident kernel's threads per lane, from chip_smoke.py's per-T
# timing on the H100 (PERF.md)
RESIDENT_THREADS_PER_LANE = 1

# kernel launches since import (or since a caller last set them to 0)
sha_windows_launches = 0
resident_launches = 0

WBITS_OK = (8, 16)

_U8 = (torch.uint8,)


# ---------------------------------------------------------------------------
# Stage A: the plain versions
# ---------------------------------------------------------------------------

def digest_windows_plain(digests, r8, w8, wbits_g: int = comb.WBITS,
                         wbits_q: int = comb.WBITS):
    """The plain torch version of stage A's digest-lanes entry, on any
    device: the JAX package's scalar stage (`comb.comb_windows`) on the
    digest words and the limbs of r8 and w8."""
    return comb.comb_windows(sha256.words64(digests),
                             limb.be_bytes_to_limbs(r8),
                             limb.be_bytes_to_limbs(w8), wbits_g, wbits_q)


def sha_windows_plain(blocks, nblocks, digests, has_digest, r8, w8,
                      wbits_g: int = comb.WBITS, wbits_q: int = comb.WBITS):
    """The plain torch version of stage A's message entry, on any
    device: fabric_tpu's `_sha_scalar_rows` and windows, batch-major.
    The SHA block loop masks each lane's state at its live count; digest
    lanes take their digest after it; e is the digest as a 256-bit
    integer, not reduced mod n first. Returns (w1, w2, words (B, 8)
    int64)."""
    hashed = sha256.sha256_plain(blocks, nblocks)
    words = torch.where(has_digest[:, None], sha256.words64(digests), hashed)
    w1, w2 = digest_windows_plain(words, r8, w8, wbits_g, wbits_q)
    return w1, w2, words


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(ref, want, aligned=()):
    kernels.check_args(ref, want, "stage-A", aligned)


def _lane_rows(B, digests, r8, w8):
    return [("digests", digests, (B, 8), sha256.WORD_DTYPES),
            ("r8", r8, (B, 32), _U8), ("w8", w8, (B, 32), _U8)]


def _widths(wbits_g: int, wbits_q: int) -> None:
    # the provider's routes pair G16 with Q16 only, so mixed widths have
    # no caller and the kernel is built for 8/8 and 16/16 alone
    if wbits_g not in WBITS_OK or wbits_q != wbits_g:
        raise ValueError(f"window widths must be 8/8 or 16/16, got "
                         f"{wbits_g}/{wbits_q}")


def _windows_out(B, wbits_g, wbits_q, dev):
    return (torch.empty((B, 256 // wbits_g), dtype=torch.int32, device=dev),
            torch.empty((B, 256 // wbits_q), dtype=torch.int32, device=dev))


def sha_windows(blocks, nblocks, digests, has_digest, r8, w8, *,
                wbits_g: int = comb.WBITS, wbits_q: int = comb.WBITS):
    """Stage A over message lanes: batched SHA-256 + scalar derivation +
    comb windows.

    blocks: (B, NB, 16) uint32/int32 SHA-padded message words
    (sha256.pack_messages); nblocks: (B,) int32 live block counts (0 for
    digest lanes); digests: (B, 8) uint32/int32 precomputed digest
    words; has_digest: (B,) bool; r8, w8: (B, 32) uint8 big-endian
    scalar rows. Returns (w1 (B, 256 // wbits_g) int32, w2 (B, 256 //
    wbits_q) int32, words (B, 8) int64): the G-side and Q-side comb
    windows of u1 = e*w and u2 = r*w (mod n) and the digest words. CPU
    tensors run the plain version; CUDA tensors launch
    csrc/sha_windows.cu's message entry.
    """
    global sha_windows_launches
    _widths(wbits_g, wbits_q)
    sha256.check_blocks(blocks, nblocks)
    B = blocks.shape[0]
    _check(blocks, [("blocks", blocks, blocks.shape, sha256.WORD_DTYPES),
                    ("nblocks", nblocks, (B,), (torch.int32,)),
                    ("has_digest", has_digest, (B,), (torch.bool,)),
                    *_lane_rows(B, digests, r8, w8)],
           aligned=("blocks", "digests", "r8", "w8"))
    if blocks.device.type == "cpu":
        return sha_windows_plain(blocks, nblocks, digests, has_digest, r8,
                                 w8, wbits_g, wbits_q)
    dev = blocks.device
    w1, w2 = _windows_out(B, wbits_g, wbits_q, dev)
    words = torch.empty((B, 8), dtype=torch.int64, device=dev)
    kernels.launch(dev, "sha_windows", "sha_windows_launch", blocks,
                   nblocks, digests, has_digest, r8, w8, w1, w2, words, B,
                   blocks.shape[1], wbits_g, wbits_q)
    sha_windows_launches += 1
    return w1, w2, words


def digest_windows(digests, r8, w8, *, wbits_g: int = comb.WBITS,
                   wbits_q: int = comb.WBITS):
    """Stage A over digest lanes (the commit path's scalar stage): every
    lane takes its digest. digests: (B, 8) uint32/int32 big-endian
    digest words; r8, w8: (B, 32) uint8 big-endian scalar rows. Returns
    (w1, w2) as `sha_windows`. CPU tensors run the plain version; CUDA
    tensors launch csrc/sha_windows.cu's digest-lanes entry."""
    global sha_windows_launches
    _widths(wbits_g, wbits_q)
    B = digests.shape[0]
    _check(digests, _lane_rows(B, digests, r8, w8),
           aligned=("digests", "r8", "w8"))
    if digests.device.type == "cpu":
        return digest_windows_plain(digests, r8, w8, wbits_g, wbits_q)
    dev = digests.device
    w1, w2 = _windows_out(B, wbits_g, wbits_q, dev)
    kernels.launch(dev, "sha_windows", "digest_windows_launch", digests, r8,
                   w8, w1, w2, B, wbits_g, wbits_q)
    sha_windows_launches += 1
    return w1, w2


def fused_verify_with_tables(blocks, nblocks, key_idx, q_flat, r8, rpn8, w8,
                             premask, digests, has_digest, g16=None,
                             q16: bool = False, g_flat=None):
    """The tiered fused pipeline: stage A (`sha_windows`), then the
    gather and the tree (`ptree.tree_verify_windows`); verdicts equal
    `comb.comb_verify_with_tables` over the lanes' SHA-256 digests.

    blocks/nblocks/digests/has_digest as `sha_windows`; key_idx (B,)
    int32; r8/rpn8/w8 (B, 32) uint8 big-endian scalar rows; premask
    (B,) bool; tables as `comb.comb_verify_with_tables`.
    """
    K, g_tab, wbits_g, wbits_q = comb.route_tables(q_flat, g16, q16, g_flat)
    w1, w2, _ = sha_windows(blocks, nblocks, digests, has_digest, r8, w8,
                            wbits_g=wbits_g, wbits_q=wbits_q)
    return ptree.tree_verify_windows(w1, w2, key_idx, g_tab, q_flat, K,
                                     wbits_g, wbits_q, r8, rpn8, premask)


def digest_verify_with_tables(digests, key_idx, q_flat, r8, rpn8, w8,
                              premask, g16=None, q16: bool = False,
                              g_flat=None):
    """The comb-digest pipeline over digest lanes and byte scalars (the
    body of fabric_tpu's `_comb_pipeline_digest`): stage A's digest-lanes
    entry (`digest_windows`), then the gather and the tree
    (`ptree.tree_verify_windows`). On the card that is two launches and
    no eager scalar arithmetic. Verdicts equal
    `comb.comb_verify_with_tables` on the limbs of r8, rpn8 and w8.

    digests (B, 8) uint32/int32 digest words; key_idx (B,) int32;
    r8/rpn8/w8 (B, 32) uint8 big-endian scalar rows; premask (B,) bool;
    tables as `comb.comb_verify_with_tables`.
    """
    K, g_tab, wbits_g, wbits_q = comb.route_tables(q_flat, g16, q16, g_flat)
    w1, w2 = digest_windows(digests, r8, w8, wbits_g=wbits_g,
                            wbits_q=wbits_q)
    return ptree.tree_verify_windows(w1, w2, key_idx, g_tab, q_flat, K,
                                     wbits_g, wbits_q, r8, rpn8, premask)


# ---------------------------------------------------------------------------
# The mod-n core's self-test (csrc/field_selftest.cu)
# ---------------------------------------------------------------------------

def _words_int(words) -> int:
    return int.from_bytes(b"".join(int(x).to_bytes(4, "big")
                                   for x in words), "big")


def modn_selftest_plain(e, r8, w8):
    """Python ints, the reference of csrc/modn32.cuh: e (n, 8) 32-bit
    big-endian words, r8 and w8 (n, 32) uint8 big-endian rows -> (n, 16)
    int64 little-endian words of u1 = e*w mod n and u2 = r*w mod n."""
    N = p256.N
    rows = []
    for ew, rb, wb in zip(sha256.words64(e).tolist(), r8.tolist(),
                          w8.tolist()):
        ev, rv, wv = (_words_int(ew), int.from_bytes(bytes(rb), "big"),
                      int.from_bytes(bytes(wb), "big"))
        rows.append([(u >> (32 * i)) & 0xFFFFFFFF
                     for u in (ev * wv % N, rv * wv % N) for i in range(8)])
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 16)


def modn_selftest(e, r8, w8):
    """The mod-n core on the cases of modn_selftest_plain: CPU tensors
    run the plain version, CUDA tensors launch csrc/field_selftest.cu's
    mod-n entry (the nvcc build of modn32.cuh)."""
    n = e.shape[0]
    _check(e, _lane_rows(n, e, r8, w8), aligned=("r8", "w8"))
    if e.device.type == "cpu":
        return modn_selftest_plain(e, r8, w8)
    out = torch.empty((n, 16), dtype=torch.int32, device=e.device)
    kernels.launch(e.device, "field_selftest", "modn_selftest_launch", e, r8,
                   w8, n, out)
    return out.to(torch.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The resident variant
# ---------------------------------------------------------------------------

def resident_table_bytes(K: int) -> int:
    """Bytes of the tables the resident kernel gathers from: the 8-bit G
    table plus K key slots of 8-bit Q table, (NWIN*NENT, 3, L) int32
    each."""
    return comb.NWIN * comb.NENT * (1 + K) * 3 * L * 4


def resident_plain(blocks, nblocks, key_idx, q_flat, r8, rpn8, w8, premask,
                   digests, has_digest, g_flat):
    """The plain torch version of the resident kernel, on any device:
    stage A at 8-bit windows, the gather, the 64-point tree and check. A
    lane whose key slot is outside [0, K) rejects, as in the kernel."""
    K = q_flat.shape[0] // (comb.NWIN * comb.NENT)
    w1, w2, _ = sha_windows_plain(blocks, nblocks, digests, has_digest, r8,
                                  w8)
    return ptree.tree_verify_windows_plain(
        w1, w2, key_idx, g_flat, q_flat, K, comb.WBITS, comb.WBITS, r8,
        rpn8, premask)


def fused_verify_resident(blocks, nblocks, key_idx, q_flat, r8, rpn8, w8,
                          premask, digests, has_digest, g_flat=None, *,
                          threads_per_lane=RESIDENT_THREADS_PER_LANE):
    """The single-kernel variant: SHA + scalars + 8-bit windows + the
    gather from the g8/q8 tables + the 64-point tree and check, with
    only the (B,) bool verdicts leaving the kernel. q_flat must be an
    8-bit table (comb.build_q_tables); callers keep
    resident_table_bytes(K) within RESIDENT_TABLE_BUDGET. Verdicts equal
    `fused_verify_with_tables` on the 8-bit tables. CPU tensors run the
    plain version; CUDA tensors launch csrc/fused_resident.cu with
    `threads_per_lane` threads a lane (1, 2, 4 or 8)."""
    global resident_launches
    if threads_per_lane not in ptree.T_CHOICES:
        raise ValueError(f"threads_per_lane must be one of "
                         f"{ptree.T_CHOICES}, got {threads_per_lane}")
    ent = comb.NWIN * comb.NENT
    if q_flat.dim() != 3 or q_flat.shape[0] % ent or \
            tuple(q_flat.shape[1:]) != (3, L):
        raise ValueError(f"q_flat must be (K*{ent}, 3, {L}), got "
                         f"{tuple(q_flat.shape)}")
    K = q_flat.shape[0] // ent
    if g_flat is None:
        g_flat = comb.g_tables_on(q_flat.device)
    sha256.check_blocks(blocks, nblocks)
    B = blocks.shape[0]
    _check(blocks, [("blocks", blocks, blocks.shape, sha256.WORD_DTYPES),
                    ("nblocks", nblocks, (B,), (torch.int32,)),
                    ("has_digest", has_digest, (B,), (torch.bool,)),
                    *_lane_rows(B, digests, r8, w8),
                    ("rpn8", rpn8, (B, 32), _U8),
                    ("key_idx", key_idx, (B,), (torch.int32,)),
                    ("premask", premask, (B,), (torch.bool,)),
                    ("g_flat", g_flat, (ent, 3, L), (torch.int32,)),
                    ("q_flat", q_flat, (K * ent, 3, L), (torch.int32,))],
           aligned=("blocks", "digests", "r8", "rpn8", "w8", "g_flat",
                    "q_flat"))
    if blocks.device.type == "cpu":
        return resident_plain(blocks, nblocks, key_idx, q_flat, r8, rpn8, w8,
                              premask, digests, has_digest, g_flat)
    out = torch.empty(B, dtype=torch.bool, device=blocks.device)
    kernels.launch(blocks.device, "fused_resident", "fused_resident_launch",
                   blocks, nblocks, digests, has_digest, key_idx, r8, rpn8,
                   w8, premask, g_flat, q_flat, out, B, blocks.shape[1], K,
                   threads_per_lane)
    resident_launches += 1
    return out
