"""Batched SHA-256 over pre-padded message blocks.

Port of fabric_tpu/ops/sha256.py: the host pack (`pack_messages`, a
numpy copy, byte-identical) and `sha256_blocks`, which hashes a batch
of SHA-padded messages with a per-lane live block count. In the JAX
package `sha256_blocks` is XLA, not Pallas; it serves the provider's
`HashOnHost: false, FusedVerify: false` route.

A tensor on the CPU runs the plain torch version here. Torch on the CPU
has no uint32 shift, add, not or compare, so its words travel as int64
masked to 32 bits after every add (`~e` is `e ^ 0xFFFFFFFF`). A CUDA
tensor launches the digest-only entry point of the hand-written kernel
in csrc/sha_windows.cu and adds one to `launches`; the plain version is
never used on the card's path (it would be thousands of launches per
call). Anything else raises.

Words, in and out: message blocks are (B, NB, 16) 32-bit big-endian
words as uint32 or int32 (the same bits); digests come back as (B, 8)
int64 words masked to 32 bits, the form `comb.comb_verify_with_tables`
and `limb.words_be_to_limbs` take.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

M32 = 0xFFFFFFFF

_K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

_H0 = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)

# digest-only kernel launches since import (or since a caller last set it
# to 0)
launches = 0


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------

def max_message_len(nb: int) -> int:
    """Largest message (bytes) that fits nb SHA-256 blocks after padding."""
    return nb * 64 - 9


def pack_messages(msgs: list[bytes], nb: int) -> tuple[np.ndarray, np.ndarray]:
    """SHA-pad each message and pack into (B, nb, 16) uint32 words + block
    counts. Every message must satisfy len(msg) <= max_message_len(nb).

    One flat-byte scatter plus numpy word assembly; blocks past a
    message's own count stay zero. Byte-identical to the JAX package's
    pack (tests/test_torch_sha256.py pins it).
    """
    B = len(msgs)
    out = np.zeros((B, nb, 16), dtype=np.uint32)
    counts = np.zeros((B,), dtype=np.int32)
    if B == 0:
        return out, counts
    lens = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=B)
    if lens.max() > max_message_len(nb):
        i = int(np.argmax(lens > max_message_len(nb)))
        raise ValueError(f"message {i} too long for {nb} blocks")
    counts[:] = (lens + 9 + 63) // 64

    # one (B, nb*64) byte plane: message bytes scattered flat (byte j of
    # the join lands at its row offset plus its position in the message),
    # then the 0x80 terminator and the 8-byte big-endian bit length
    rowlen = nb * 64
    buf = np.zeros((B, rowlen), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        flat = np.frombuffer(b"".join(msgs), dtype=np.uint8)
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        shift = np.repeat(np.arange(B, dtype=np.int64) * rowlen - starts,
                          lens)
        buf.reshape(-1)[np.arange(total, dtype=np.int64) + shift] = flat
    rows_all = np.arange(B)
    buf[rows_all, lens] = 0x80
    bitlen = 8 * lens.astype(np.uint64)
    tail0 = counts.astype(np.int64) * 64 - 8
    for j in range(8):
        buf[rows_all, tail0 + j] = \
            ((bitlen >> np.uint64(8 * (7 - j))) & np.uint64(0xFF))
    out = buf.view(">u4").astype(np.uint32).reshape(B, nb, 16)
    return np.ascontiguousarray(out), counts


# ---------------------------------------------------------------------------
# The plain version (int64 words masked to 32 bits)
# ---------------------------------------------------------------------------

def words64(t: torch.Tensor) -> torch.Tensor:
    """32-bit words held as uint32, int32 or int64 -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & M32


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, block, kc):
    """One SHA-256 compression, batch-major: state (B, 8), block (B, 16)
    int64 words, kc (64,) int64 -> (B, 8); fabric_tpu's `_compress`."""
    w = [block[:, t] for t in range(16)]
    for t in range(16, 64):
        wm15, wm2 = w[t - 15], w[t - 2]
        s0 = _rotr(wm15, 7) ^ _rotr(wm15, 18) ^ (wm15 >> 3)
        s1 = _rotr(wm2, 17) ^ _rotr(wm2, 19) ^ (wm2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = (state[:, i] for i in range(8))
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = (h + S1 + ch + kc[t] + w[t]) & M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        a, b, c, d, e, f, g, h = ((t1 + t2) & M32, a, b, c, (d + t1) & M32,
                                  e, f, g)
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & M32


def sha256_plain(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """The plain torch version, on any device: the JAX package's block
    loop, a lane's state moving only while j < nblocks[lane], so blocks
    at or past its count never change it (whatever they hold)."""
    B, NB = blocks.shape[0], blocks.shape[1]
    kc = torch.as_tensor(_K.astype(np.int64), device=blocks.device)
    state = torch.as_tensor(_H0.astype(np.int64),
                            device=blocks.device).expand(B, 8)
    words = words64(blocks)
    for j in range(NB):
        nxt = _compress(state, words[:, j], kc)
        state = torch.where((j < nblocks)[:, None], nxt, state)
    return state.contiguous()


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

WORD_DTYPES = (torch.uint32, torch.int32)


def check_blocks(blocks, nblocks) -> None:
    """Shapes and types the plain version and the kernel both take."""
    if blocks.dim() != 3 or blocks.shape[2] != 16:
        raise ValueError(f"blocks must be (B, NB, 16), got "
                         f"{tuple(blocks.shape)}")
    if blocks.dtype not in WORD_DTYPES:
        raise TypeError(f"blocks must be uint32 or int32 words, got "
                        f"{blocks.dtype}")
    if blocks.shape[1] < 1:
        raise ValueError("blocks needs at least one block per lane")
    if tuple(nblocks.shape) != (blocks.shape[0],):
        raise ValueError(f"nblocks must be ({blocks.shape[0]},), got "
                         f"{tuple(nblocks.shape)}")
    if nblocks.dtype != torch.int32:
        raise TypeError(f"nblocks must be int32, got {nblocks.dtype}")
    if nblocks.device != blocks.device:
        raise ValueError(f"nblocks is on {nblocks.device}, blocks on "
                         f"{blocks.device}")


def sha_consts() -> np.ndarray:
    """(72, 1) uint32: the 64 round constants followed by the 8 initial
    state words (fabric_tpu's `fused_verify._sha_consts`), which the
    kernels carry as compile-time words (csrc/sha256.cuh sha_k, sha_h0;
    tests/test_torch_stage_a_host.py holds them to this)."""
    return np.concatenate([_K, _H0]).reshape(72, 1)


def sha256_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Hash pre-padded messages: blocks (B, NB, 16) uint32/int32 words,
    nblocks (B,) int32 live counts -> (B, 8) int64 digest words. CPU
    tensors run the plain version; CUDA tensors launch the digest-only
    entry of csrc/sha_windows.cu."""
    global launches
    check_blocks(blocks, nblocks)
    if blocks.device.type == "cpu":
        return sha256_plain(blocks, nblocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"no SHA-256 kernel for device {blocks.device}")
    for name, t in (("blocks", blocks), ("nblocks", nblocks)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if blocks.data_ptr() % 16:                # blocks read as 16-byte loads
        raise ValueError("blocks must be 16-byte aligned")
    from fabric_tpu_torch import kernels

    lib = kernels.load("sha_windows")
    B, NB = blocks.shape[0], blocks.shape[1]
    out = torch.empty((B, 8), dtype=torch.int64, device=blocks.device)
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    with torch.cuda.device(blocks.device):
        err = lib.sha256_digest_launch(
            blocks.data_ptr(), nblocks.data_ptr(), out.data_ptr(),
            ctypes.c_int(B), ctypes.c_int(NB), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(
            f"sha256 kernel launch failed: CUDA error {err} "
            f"({lib.sha_windows_error_string(err).decode()})")
    launches += 1
    return out


def sha256_host(msgs: list[bytes], nb: int | None = None,
                device=None) -> np.ndarray:
    """Convenience: hash a batch through `sha256_blocks` on `device`
    (cuda:0 unless the caller passes another; raises without CUDA),
    returning (B, 8) uint32 digest words."""
    from fabric_tpu_torch.common import torchenv

    dev = torchenv.resolve_device(device)
    if nb is None:
        nb = max((len(m) + 9 + 63) // 64 for m in msgs) if msgs else 1
    blocks, counts = pack_messages(msgs, nb)
    out = sha256_blocks(torch.from_numpy(blocks).to(dev),
                        torch.from_numpy(counts).to(dev))
    return out.cpu().numpy().astype(np.uint32)

