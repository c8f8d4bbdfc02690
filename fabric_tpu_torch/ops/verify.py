"""The generic P-256 verify pipeline: SHA-256 and the Shamir ladder.

Port of fabric_tpu/ops/verify.py and of the provider's ladder program
(fabric_tpu/bccsp/tpu.py `_pipeline`): a batch whose keys have no comb
tables (more than `MaxKeys` distinct keys) is verified lane by lane with
R = u1*G + u2*Q from a 2-bit Shamir ladder over each lane's own key.

    verify_pipeline(blocks, nblocks, qx, qy, r, rpn, w, premask,
                    digests=None, has_digest=None)
        the plain torch version, in the JAX package's signature and
        layout (limbs): SHA-256 of each lane's blocks, a lane's given
        digest where `has_digest` is set (as `_pipeline`'s select), then
        `p256.verify_core`;
    ladder_verify(blocks, nblocks, digests, has_digest, q8, r8, rpn8, w8,
                  premask)
        message lanes on the card: the digest-only SHA-256 kernel
        (`sha256.sha256_blocks`), each lane's own digest where has_digest
        is set (`message_digests`), then `ladder_verify_digests`: two
        launches;
    ladder_verify_digests(digests, q8, r8, rpn8, w8, premask)
        the ladder kernel over digest lanes (the commit path, batches
        hashed on the host, and message lanes once hashed).

The card entries take the host's compact rows: q8 (B, 64) uint8, each
lane's key as x then y in 32-byte big-endian form, and r8, rpn8, w8 (B,
32) uint8 big-endian scalars. A tensor on the CPU runs the plain version;
a CUDA tensor launches the hand-written kernel in csrc/ladder.cu and adds
one to `launches` (the SHA kernel adds to `sha256.launches`); anything
else raises. Nothing falls back. The kernel adds with RCB15 Alg. 4 where
the plain version uses Alg. 1, so the two reach R through other
projective representatives; the check is invariant under projective
scaling and the verdicts agree.
"""

from __future__ import annotations

import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.ops import limb, p256, sha256

# kernel launches since import (or since a caller last set it to 0)
launches = 0

_U8 = (torch.uint8,)
_ALIGNED = ("blocks", "digests", "q8", "r8", "rpn8", "w8")


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def verify_pipeline(blocks, nblocks, qx, qy, r, rpn, w, premask,
                    digests=None, has_digest=None):
    """Hash-and-verify a batch of (message, pubkey, signature) triples.

    blocks (B, NB, 16) SHA-padded message words (sha256.pack_messages);
    nblocks (B,) int32 live block counts; qx, qy (B, L) canonical limbs
    of the keys' affine points; r, rpn, w (B, L) canonical limbs (see
    p256.verify_core); premask (B,) bool. With `digests` (B, 8) digest
    words and `has_digest` (B,) bool, a lane with has_digest set takes
    its digest instead of its blocks' hash. Returns (B,) bool."""
    words = sha256.sha256_plain(blocks, nblocks)
    if digests is not None:
        words = torch.where(has_digest[:, None], sha256.words64(digests),
                            words)
    return p256.verify_core(words, qx, qy, r, rpn, w, premask)


def _limbs(q8, r8, rpn8, w8):
    return (limb.be_bytes_to_limbs(q8[:, :32]),
            limb.be_bytes_to_limbs(q8[:, 32:]),
            limb.be_bytes_to_limbs(r8), limb.be_bytes_to_limbs(rpn8),
            limb.be_bytes_to_limbs(w8))


def ladder_plain(blocks, nblocks, digests, has_digest, q8, r8, rpn8, w8,
                 premask):
    """The plain torch version of the message entry, on any device:
    `verify_pipeline` on the limbs of the byte rows."""
    qx, qy, r, rpn, w = _limbs(q8, r8, rpn8, w8)
    return verify_pipeline(blocks, nblocks, qx, qy, r, rpn, w, premask,
                           digests, has_digest)


def ladder_digests_plain(digests, q8, r8, rpn8, w8, premask):
    """The plain torch version of the digest-lanes entry, on any device:
    `p256.verify_core` on the digest words and the rows' limbs."""
    qx, qy, r, rpn, w = _limbs(q8, r8, rpn8, w8)
    return p256.verify_core(sha256.words64(digests), qx, qy, r, rpn, w,
                            premask)


# ---------------------------------------------------------------------------
# The card entries
# ---------------------------------------------------------------------------

def _check(ref, want):
    kernels.check_args(ref, want, "ladder", _ALIGNED)


def _lane_rows(B, digests, q8, r8, rpn8, w8, premask):
    return [("digests", digests, (B, 8), sha256.WORD_DTYPES),
            ("q8", q8, (B, 64), _U8), ("r8", r8, (B, 32), _U8),
            ("rpn8", rpn8, (B, 32), _U8), ("w8", w8, (B, 32), _U8),
            ("premask", premask, (B,), (torch.bool,))]


def message_digests(blocks, nblocks, digests, has_digest):
    """(B, 8) int32 digest words of message lanes: SHA-256 of each lane's
    blocks (`sha256.sha256_blocks`: the plain version on the CPU, the
    digest-only kernel on the card), a lane's own digest where has_digest
    is set (`verify_pipeline`'s select)."""
    words = sha256.sha256_blocks(blocks, nblocks).to(torch.int32)
    return torch.where(has_digest[:, None], digests.view(torch.int32), words)


def ladder_verify(blocks, nblocks, digests, has_digest, q8, r8, rpn8, w8,
                  premask):
    """The ladder over message lanes: blocks (B, NB, 16) uint32/int32
    SHA-padded words, nblocks (B,) int32, digests (B, 8) uint32/int32
    digest words, has_digest (B,) bool, q8 (B, 64) uint8, r8, rpn8, w8
    (B, 32) uint8, premask (B,) bool -> (B,) bool. CPU tensors run the
    plain version; CUDA tensors hash the lanes with the digest-only SHA
    kernel and launch csrc/ladder.cu on the digests."""
    sha256.check_blocks(blocks, nblocks)
    B = blocks.shape[0]
    _check(blocks, [("blocks", blocks, blocks.shape, sha256.WORD_DTYPES),
                    ("nblocks", nblocks, (B,), (torch.int32,)),
                    ("has_digest", has_digest, (B,), (torch.bool,)),
                    *_lane_rows(B, digests, q8, r8, rpn8, w8, premask)])
    if blocks.device.type == "cpu":
        return ladder_plain(blocks, nblocks, digests, has_digest, q8, r8,
                            rpn8, w8, premask)
    return ladder_verify_digests(
        message_digests(blocks, nblocks, digests, has_digest), q8, r8, rpn8,
        w8, premask)


def ladder_verify_digests(digests, q8, r8, rpn8, w8, premask):
    """The ladder over digest lanes: digests (B, 8) uint32/int32
    big-endian digest words and the rows of `ladder_verify` -> (B,)
    bool. CPU tensors run the plain version; CUDA tensors launch
    csrc/ladder.cu's digest-lanes entry."""
    global launches
    B = digests.shape[0]
    _check(digests, _lane_rows(B, digests, q8, r8, rpn8, w8, premask))
    if digests.device.type == "cpu":
        return ladder_digests_plain(digests, q8, r8, rpn8, w8, premask)
    out = torch.empty(B, dtype=torch.bool, device=digests.device)
    kernels.launch(digests.device, "ladder", "ladder_digest_launch",
                   digests, q8, r8, rpn8, w8, premask, out, B)
    launches += 1
    return out


# ---------------------------------------------------------------------------
# The doubling's self-test (csrc/field_selftest.cu)
# ---------------------------------------------------------------------------

def dbl_selftest_plain(p13):
    """Python ints, the reference of csrc/p256_field.cuh's pt_dbl: p13
    (n, 60) int32 points (X, Y, Z in 13-bit limbs) -> (n, 24) int64
    little-endian canonical words of p256.cdbl_int, which pt_dbl follows
    step for step."""
    rows = []
    for row in p13.tolist():
        pt = tuple(limb.limbs_to_int(row[20 * c:20 * c + 20]) % p256.P
                   for c in range(3))
        rows.append([(v >> (32 * i)) & 0xFFFFFFFF
                     for v in p256.cdbl_int(pt) for i in range(8)])
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 24)


def dbl_selftest(p13):
    """pt_dbl on the cases of dbl_selftest_plain: CPU tensors run the
    plain version, CUDA tensors launch csrc/field_selftest.cu's doubling
    entry (the nvcc build of p256_field.cuh)."""
    n = p13.shape[0]
    kernels.check_args(p13, [("p13", p13, (n, 60), (torch.int32,))],
                       "self-test")
    if p13.device.type == "cpu":
        return dbl_selftest_plain(p13)
    out = torch.empty((n, 24), dtype=torch.int32, device=p13.device)
    kernels.launch(p13.device, "field_selftest", "dbl_selftest_launch", p13,
                   n, out)
    return out.to(torch.int64) & 0xFFFFFFFF
