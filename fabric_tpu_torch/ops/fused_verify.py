"""The fused verify tier: device SHA-256 feeding the comb.

Port of fabric_tpu/ops/fused_verify.py. The host ships SHA-padded
message blocks (`sha256.pack_messages`) instead of hashing, and the
card computes the rest:

  stage A (`sha_windows`): per lane, SHA-256 over its live blocks (or
    its precomputed digest), the digest as 13-bit limbs, u1 = e*w and
    u2 = r*w (mod n, canonical) and the comb windows of u1 and u2;
  stage B: the gather, the sum and the check in one kernel
    (`ptree.tree_verify_windows`), as on the comb-digest path;
  the resident variant (`fused_verify_resident`): one kernel runs stage
    A at 8-bit windows, the gather from the g8/q8 tables and the
    64-point sum and check; only the verdicts come back.

A tensor on the CPU runs a kernel's plain torch version here; a CUDA
tensor launches the hand-written kernel (csrc/sha_windows.cu,
csrc/fused_resident.cu) and adds one to its count
(`sha_windows_launches`, `resident_launches`); anything else raises.
Nothing falls back. Layout is batch-major, as in the rest of the port:
(B, rows) where the JAX package keeps (rows, lanes) tiles.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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


@functools.lru_cache(maxsize=None)
def _fnk() -> ptree.KMod:
    """Packed mod-n constants (the scalar field), the stage-A kernels'
    input: the KMod twin of comb's `FN` use."""
    return ptree.KMod(p256.FN)


@functools.lru_cache(maxsize=None)
def _consts_n_on(device: str) -> torch.Tensor:
    return torch.as_tensor(_fnk().pack_consts(), device=device).contiguous()


# ---------------------------------------------------------------------------
# Stage A: the plain version
# ---------------------------------------------------------------------------

def sha_windows_plain(blocks, nblocks, digests, has_digest, r_l, w_l,
                      wbits_g: int = comb.WBITS, wbits_q: int = comb.WBITS):
    """The plain torch version of the stage-A kernel, on any device:
    fabric_tpu's `_sha_scalar_rows` and windows, batch-major. The SHA
    block loop masks each lane's state at its live count; digest lanes
    take their digest after it; e is the digest as a 256-bit integer,
    not reduced mod n first. Returns (w1, w2, words (B, 8) int64)."""
    hashed = sha256.sha256_plain(blocks, nblocks)
    words = torch.where(has_digest[:, None], sha256.words64(digests), hashed)
    e = limb.words_be_to_limbs(words)
    u1 = p256.FN.canonical(p256.FN.mulmod(e, w_l))
    u2 = p256.FN.canonical(p256.FN.mulmod(r_l, w_l))
    return comb._windows(u1, wbits_g), comb._windows(u2, wbits_q), words


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_stage_a(blocks, nblocks, digests, has_digest, extra):
    """Shapes, types, devices and (for CUDA) contiguity of stage A's
    inputs and `extra`, (name, tensor, shape, dtypes) rows."""
    sha256.check_blocks(blocks, nblocks)
    B = blocks.shape[0]
    want = [("digests", digests, (B, 8), sha256.WORD_DTYPES),
            ("has_digest", has_digest, (B,), (torch.bool,)), *extra]
    for name, t, shape, dtypes in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if t.device != blocks.device:
            raise ValueError(f"{name} is on {t.device}, blocks on "
                             f"{blocks.device}")
    if blocks.device.type == "cuda":
        for name, t in [("blocks", blocks), ("nblocks", nblocks)] + [
                (n, t) for n, t, *_ in want]:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif blocks.device.type != "cpu":
        raise ValueError(f"no fused-verify kernel for device {blocks.device}")


def _raise_on(err: int, what: str, lib, fn: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({getattr(lib, fn)(err).decode()})")


def sha_windows(blocks, nblocks, digests, has_digest, r_l, w_l, *,
                wbits_g: int = comb.WBITS, wbits_q: int = comb.WBITS):
    """Batched SHA-256 + scalar derivation + comb windows.

    blocks: (B, NB, 16) uint32/int32 SHA-padded message words
    (sha256.pack_messages); nblocks: (B,) int32 live block counts (0 for
    digest lanes); digests: (B, 8) uint32/int32 precomputed digest
    words; has_digest: (B,) bool; r_l, w_l: (B, L) int32 canonical
    limbs. Returns (w1 (B, 256 // wbits_g) int32, w2 (B, 256 // wbits_q)
    int32, words (B, 8) int64): the G-side and Q-side comb windows of
    u1 = e*w and u2 = r*w (mod n) and the digest words. CPU tensors run
    the plain version; CUDA tensors launch csrc/sha_windows.cu.
    """
    global sha_windows_launches
    # the provider's routes pair G16 with Q16 only, so mixed widths have
    # no caller and the kernel is built for 8/8 and 16/16 alone
    if wbits_g not in WBITS_OK or wbits_q != wbits_g:
        raise ValueError(f"window widths must be 8/8 or 16/16, got "
                         f"{wbits_g}/{wbits_q}")
    B = blocks.shape[0]
    _check_stage_a(blocks, nblocks, digests, has_digest, [
        ("r", r_l, (B, L), (torch.int32,)),
        ("w", w_l, (B, L), (torch.int32,))])
    if blocks.device.type == "cpu":
        return sha_windows_plain(blocks, nblocks, digests, has_digest, r_l,
                                 w_l, wbits_g, wbits_q)
    from fabric_tpu_torch import kernels

    lib = kernels.load("sha_windows")
    NB = blocks.shape[1]
    dev = blocks.device
    w1 = torch.empty((B, 256 // wbits_g), dtype=torch.int32, device=dev)
    w2 = torch.empty((B, 256 // wbits_q), dtype=torch.int32, device=dev)
    words = torch.empty((B, 8), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.sha_windows_launch(
            blocks.data_ptr(), nblocks.data_ptr(), digests.data_ptr(),
            has_digest.data_ptr(), r_l.data_ptr(), w_l.data_ptr(),
            _consts_n_on(str(dev)).data_ptr(),
            sha256.sha_consts_on(str(dev)).data_ptr(), w1.data_ptr(),
            w2.data_ptr(), words.data_ptr(), ctypes.c_int(B),
            ctypes.c_int(NB), ctypes.c_int(wbits_g), ctypes.c_int(wbits_q),
            ctypes.c_void_p(stream))
    _raise_on(err, "sha_windows", lib, "sha_windows_error_string")
    sha_windows_launches += 1
    return w1, w2, words


def _scalar_limbs(r8, rpn8, w8):
    return tuple(limb.be_bytes_to_limbs(x) for x in (r8, rpn8, w8))


def fused_verify_with_tables(blocks, nblocks, key_idx, q_flat, r8, rpn8, w8,
                             premask, digests, has_digest, g16=None,
                             q16: bool = False, g_flat=None):
    """The tiered fused pipeline: stage A (`sha_windows`), then the
    gather and the tree (`ptree.tree_verify_windows`); verdicts equal
    `comb.comb_verify_with_tables` over the lanes' SHA-256 digests.

    blocks/nblocks/digests/has_digest as `sha_windows`; key_idx (B,)
    int32; r8/rpn8/w8 (B, 32) uint8 big-endian scalar rows (limbs made
    on the tensors' device); premask (B,) bool; tables as
    `comb.comb_verify_with_tables`.
    """
    K, g_tab, wbits_g, wbits_q = comb.route_tables(q_flat, g16, q16, g_flat)
    r_l, rpn_l, w_l = _scalar_limbs(r8, rpn8, w8)
    w1, w2, _ = sha_windows(blocks, nblocks, digests, has_digest, r_l, w_l,
                            wbits_g=wbits_g, wbits_q=wbits_q)
    return ptree.tree_verify_windows(w1, w2, key_idx, g_tab, q_flat, K,
                                     wbits_g, wbits_q, r_l, rpn_l, premask)


# ---------------------------------------------------------------------------
# The resident variant
# ---------------------------------------------------------------------------

def resident_table_bytes(K: int) -> int:
    """Bytes of the tables the resident kernel gathers from: the 8-bit G
    table plus K key slots of 8-bit Q table, (NWIN*NENT, 3, L) int32
    each."""
    return comb.NWIN * comb.NENT * (1 + K) * 3 * L * 4


def resident_plain(blocks, nblocks, key_idx, q_flat, r_l, rpn_l, w_l,
                   premask, digests, has_digest, g_flat):
    """The plain torch version of the resident kernel, on any device:
    stage A at 8-bit windows, the gather, the 64-point tree and check. A
    lane whose key slot is outside [0, K) rejects, as in the kernel."""
    K = q_flat.shape[0] // (comb.NWIN * comb.NENT)
    w1, w2, _ = sha_windows_plain(blocks, nblocks, digests, has_digest, r_l,
                                  w_l)
    return ptree.tree_verify_windows_plain(
        w1, w2, key_idx, g_flat, q_flat, K, comb.WBITS, comb.WBITS, r_l,
        rpn_l, premask)


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
    B = blocks.shape[0]
    _check_stage_a(blocks, nblocks, digests, has_digest, [
        ("r8", r8, (B, 32), (torch.uint8,)),
        ("rpn8", rpn8, (B, 32), (torch.uint8,)),
        ("w8", w8, (B, 32), (torch.uint8,)),
        ("key_idx", key_idx, (B,), (torch.int32,)),
        ("premask", premask, (B,), (torch.bool,)),
        ("g_flat", g_flat, (ent, 3, L), (torch.int32,)),
        ("q_flat", q_flat, (K * ent, 3, L), (torch.int32,))])
    if blocks.device.type == "cpu":
        return resident_plain(blocks, nblocks, key_idx, q_flat,
                              *_scalar_limbs(r8, rpn8, w8), premask, digests,
                              has_digest, g_flat)
    for name, t in (("r8", r8), ("rpn8", rpn8), ("w8", w8),
                    ("g_flat", g_flat), ("q_flat", q_flat)):
        if t.data_ptr() % 16:                 # rows read as 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    from fabric_tpu_torch import kernels

    lib = kernels.load("fused_resident")
    dev = blocks.device
    out = torch.empty(B, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fused_resident_launch(
            blocks.data_ptr(), nblocks.data_ptr(), digests.data_ptr(),
            has_digest.data_ptr(), key_idx.data_ptr(), r8.data_ptr(),
            rpn8.data_ptr(), w8.data_ptr(), premask.data_ptr(),
            _consts_n_on(str(dev)).data_ptr(),
            sha256.sha_consts_on(str(dev)).data_ptr(), g_flat.data_ptr(),
            q_flat.data_ptr(), out.data_ptr(), ctypes.c_int(B),
            ctypes.c_int(blocks.shape[1]), ctypes.c_int(K),
            ctypes.c_int(threads_per_lane), ctypes.c_void_p(stream))
    _raise_on(err, "fused_resident", lib, "fused_resident_error_string")
    resident_launches += 1
    return out
