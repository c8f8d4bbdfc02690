"""Fixed-base comb ECDSA-P256 verification for key-grouped batches.

Port of fabric_tpu/ops/comb.py. A block's signatures come from a handful
of org keys, so R = u1*G + u2*Q is computed with fixed-base combs on both
bases:

    R = sum_i T_G[i][win_i(u1)] + sum_i T_Q[key][i][win_i(u2)]

with 8-bit windows (32 per scalar; 64 points per signature) or 16-bit
windows (16 per scalar; 32 points) where the large tables are resident.
Window value 0 gathers the point at infinity, which the complete
addition law absorbs, so zero windows and padded lanes need no special
case.

Every table is built with the torch `cadd`/`cdbl` on the tensors' device
(the JAX package leaves this to XLA, outside any Pallas kernel). The
u1 = e*w, u2 = r*w (mod n) scalar stage here (`comb_windows`) is the
plain torch version of stage A's digest-lanes kernel
(ops/fused_verify.py `digest_windows`), which the card's routes run.
The gather and the per-signature tree sum are ops/ptree.py: on the card
one CUDA kernel that reads each lane's table rows by window, on the CPU
the plain gather and tree.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading

import numpy as np
import torch

from fabric_tpu_torch.ops import limb, p256, ptree
from fabric_tpu_torch.ops.limb import L, W
from fabric_tpu_torch.ops.p256 import FN, cadd, cdbl

logger = logging.getLogger("fabric_tpu_torch.ops.comb")

WBITS = 8                   # comb window width (bits)
NWIN = 256 // WBITS         # windows per 256-bit scalar
NENT = 1 << WBITS           # table entries per window

# 16-bit windows: half the points per signature, 256x the table
NWIN_G16 = 16
NENT_G16 = 1 << 16

# where the 8-bit G table persists (empty string disables)
GTAB_CACHE_ENV = "FABRIC_TPU_TORCH_GTAB_CACHE"


# ---------------------------------------------------------------------------
# Persisted-table integrity: a cached table carries a sha256 sidecar
# (<path>.sha256); a mismatch means rebuild, never wrong points.
# ---------------------------------------------------------------------------

def file_sha256(path: str, blk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(blk), b""):
            h.update(chunk)
    return h.hexdigest()


def write_digest_sidecar(path: str, digest: str | None = None) -> None:
    """Record `path`'s sha256 beside it (tmp + rename)."""
    if digest is None:
        digest = file_sha256(path)
    side = path + ".sha256"
    tmp = side + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(digest)
    os.replace(tmp, side)


def verify_digest_sidecar(path: str):
    """True = digest matches; False = mismatch (rebuild); None = no
    sidecar."""
    try:
        with open(path + ".sha256") as f:
            want = f.read().strip()
    except FileNotFoundError:
        return None
    try:
        return file_sha256(path) == want
    except OSError:
        return False


def drop_digest_sidecar(path: str) -> None:
    """Remove `path`'s sidecar, if it has one."""
    try:
        os.remove(path + ".sha256")
    except OSError:
        pass


# ---------------------------------------------------------------------------
# G-side tables
# ---------------------------------------------------------------------------

def _build_g_tables() -> np.ndarray:
    out = np.zeros((NWIN * NENT, 3, L), dtype=np.int32)
    base = (p256.GX, p256.GY, 1)
    for i in range(NWIN):
        acc = (0, 1, 0)
        for j in range(NENT):
            for c in range(3):
                out[i * NENT + j, c] = limb.int_to_limbs(acc[c])
            acc = p256.cadd_int(acc, base)
        for _ in range(WBITS):
            base = p256.cdbl_int(base)
    return out


_g8_lock = threading.Lock()
_g8: list = []


def g_tables() -> np.ndarray:
    """(NWIN * NENT, 3, L) int32 — projective T_G[i*NENT + j] = j*2^(8i)*G.

    Entry j=0 is the point at infinity (0 : 1 : 0). Built once over
    Python ints (exact), kept for the process and persisted to
    $FABRIC_TPU_TORCH_GTAB_CACHE (default
    ~/.cache/fabric_tpu_torch/gtab8.npy; empty string disables) with a
    sha256 sidecar. The bytes equal fabric_tpu's g_tables()."""
    with _g8_lock:
        if _g8:
            return _g8[0]
        cache = os.environ.get(
            GTAB_CACHE_ENV,
            os.path.expanduser("~/.cache/fabric_tpu_torch/gtab8.npy"))
        arr = None
        if cache and os.path.exists(cache) \
                and verify_digest_sidecar(cache) is not False:
            try:
                got = np.load(cache)
                if got.dtype == np.int32 and got.shape == (NWIN * NENT, 3, L):
                    arr = got
            except (OSError, ValueError) as e:
                logger.warning("G-table cache %s unreadable (%s); "
                               "rebuilding", cache, e)
        if arr is None:
            arr = _build_g_tables()
            if cache:
                try:
                    os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
                    tmp = cache + f".tmp{os.getpid()}"
                    with open(tmp, "wb") as f:
                        np.save(f, arr)
                    digest = file_sha256(tmp)
                    os.replace(tmp, cache)
                    write_digest_sidecar(cache, digest)
                except OSError as e:
                    logger.warning("G-table cache persist to %s failed (%s)",
                                   cache, e)
        _g8.append(arr)
        return arr


_dev_lock = threading.Lock()
_g8_dev: dict = {}
_g16_lock = threading.Lock()
_g16_dev: dict = {}


def g_tables_on(device) -> torch.Tensor:
    """The 8-bit G table as a tensor on `device` (kept per device)."""
    key = str(torch.device(device))
    with _dev_lock:
        t = _g8_dev.get(key)
        if t is None:
            t = torch.as_tensor(g_tables(), device=device)
            _g8_dev[key] = t
        return t


def _combine16(t8: torch.Tensor, lo_base, hi_base) -> torch.Tensor:
    """16-bit window entries T16[j] = T8[lo_base + (j & 255)] +
    T8[hi_base + (j >> 8)]: one vectorized complete add. lo_base and
    hi_base: (S,) int64 row offsets -> (S, 65536, 3, L)."""
    j = torch.arange(NENT_G16, dtype=torch.int64, device=t8.device)
    a = t8[lo_base[:, None] + (j & 255)]
    b = t8[hi_base[:, None] + (j >> 8)]
    X, Y, Z = cadd((a[..., 0, :], a[..., 1, :], a[..., 2, :]),
                   (b[..., 0, :], b[..., 1, :], b[..., 2, :]))
    return torch.stack([X, Y, Z], dim=-2)


def g16_tables(device) -> torch.Tensor:
    """(NWIN_G16 * NENT_G16, 3, L) — T16[i*65536 + j] = j * 2^(16i) * G,
    built on `device` once per process from the 8-bit table:
    T16_i[j] = T8_{2i}[j & 255] + T8_{2i+1}[j >> 8]. ~252 MB resident."""
    key = str(torch.device(device))
    # held through the build: two callers must not both build ~252 MB
    with _g16_lock:
        t = _g16_dev.get(key)
        if t is None:
            g8 = g_tables_on(device)
            out = torch.empty((NWIN_G16, NENT_G16, 3, L), dtype=torch.int32,
                              device=g8.device)
            for i in range(NWIN_G16):
                base = torch.tensor([2 * i * NENT], device=g8.device)
                out[i] = _combine16(g8, base, base + NENT)[0]
            t = _g16_dev[key] = out.reshape(NWIN_G16 * NENT_G16, 3, L)
        return t


def g16_resident(device) -> torch.Tensor | None:
    """The 16-bit G table if it is already built on `device`, else None
    (waits for a build in progress)."""
    with _g16_lock:
        return _g16_dev.get(str(torch.device(device)))


# ---------------------------------------------------------------------------
# Q-side tables (per distinct key)
# ---------------------------------------------------------------------------

def build_q_tables(qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
    """(K, L) affine key coords -> (NWIN * K * NENT, 3, L) projective table,
    flat[(i * K + k) * NENT + j] = j * 2^(8i) * Q_k, on qx's device.

    The JAX package's two scans, as loops: window bases b_i = 2^(8i) * Q
    (31 steps of 8 doublings, width K), then running multiples
    e_(j+1) = cadd(e_j, b) (254 adds, width NWIN*K). Entries are
    semi-reduced projective coordinates."""
    K = qx.shape[0]
    ones = torch.as_tensor(limb.int_to_limbs(1), device=qx.device)
    pt = (qx, qy, ones.expand(K, L))
    bases = [pt]
    for _ in range(NWIN - 1):
        for _ in range(WBITS):
            pt = cdbl(pt)
        bases.append(pt)
    base = tuple(torch.stack([b[c] for b in bases]) for c in range(3))
    out = torch.zeros((NWIN, K, NENT, 3, L), dtype=torch.int32,
                      device=qx.device)
    out[:, :, 0, 1, 0] = 1                          # entry 0: (0 : 1 : 0)
    acc = base
    for j in range(1, NENT):
        if j > 1:
            acc = cadd(acc, base)
        out[:, :, j] = torch.stack(acc, dim=-2)
    return out.reshape(NWIN * K * NENT, 3, L)


def build_q16_tables(q_flat: torch.Tensor, K: int) -> torch.Tensor:
    """8-bit Q tables -> 16-bit Q tables by pairwise window combining:
    T16_{i,k}[j] = T8_{2i,k}[j & 255] + T8_{2i+1,k}[j >> 8]. Layout
    flat16[(i * K + k) * 65536 + j]; ~252 * K MB, so callers cache it per
    key set."""
    out = torch.empty((NWIN_G16, K, NENT_G16, 3, L), dtype=torch.int32,
                      device=q_flat.device)
    k = torch.arange(K, device=q_flat.device)
    for i in range(NWIN_G16):
        out[i] = _combine16(q_flat, ((2 * i) * K + k) * NENT,
                            ((2 * i + 1) * K + k) * NENT)
    return out.reshape(NWIN_G16 * K * NENT_G16, 3, L)


def tables_from_numpy(g_flat, q_flat, g16=None, *, device):
    """The JAX package's tables, as numpy arrays, -> the port's tensors
    on `device` (g_flat, q_flat, g16 or None): the state that lets both
    packages run on identical tables."""
    def put(a):
        return None if a is None else torch.tensor(
            np.asarray(a, dtype=np.int32), device=device)
    return put(g_flat), put(q_flat), put(g16)


# ---------------------------------------------------------------------------
# Window extraction + gather
# ---------------------------------------------------------------------------

def _windows(u: torch.Tensor, wbits: int = WBITS) -> torch.Tensor:
    """Canonical (B, L) scalar -> (B, 256 // wbits) int32 windows (a
    window spans at most three 13-bit limbs for wbits <= 16)."""
    cols = []
    for i in range(256 // wbits):
        bit0 = i * wbits
        j0, off = bit0 // W, bit0 % W
        v = u[:, j0] >> off
        got = W - off
        j = j0 + 1
        while got < wbits and j < L:
            v = v | (u[:, j] << got)
            got += W
            j += 1
        cols.append(v & ((1 << wbits) - 1))
    return torch.stack(cols, dim=1)


def route_tables(q_flat, g16=None, q16: bool = False, g_flat=None):
    """A route's tables and widths: (K, G table, G window bits, Q window
    bits). The 16-bit G table with g16, else g_flat (default
    g_tables_on(device)); Q windows of 16 bits with q16 (a
    build_q16_tables table), else 8 (build_q_tables)."""
    K = q_flat.shape[0] // (NWIN_G16 * NENT_G16 if q16 else NWIN * NENT)
    wbits_q = 16 if q16 else WBITS
    if g16 is not None:
        return K, g16, 16, wbits_q
    if g_flat is None:
        g_flat = g_tables_on(q_flat.device)
    return K, g_flat, WBITS, wbits_q


def gather_from_windows(w1, w2, key_idx, g_flat, q_flat, K: int,
                        g16=None, q16: bool = False) -> torch.Tensor:
    """The per-signature comb points from window indices, (B, M, 3, L):
    M = 16 or 32 G-side plus 16 or 32 Q-side, by window width (w1 of 16
    bits with g16, w2 of 16 bits with q16). A plain index_select on the
    tables (ptree.gather_rows; XLA's gather in the JAX package, outside
    any Pallas kernel)."""
    g_tab, wbits_g = (g16, 16) if g16 is not None else (g_flat, WBITS)
    return ptree.gather_rows(w1, w2, key_idx, g_tab, q_flat, K, wbits_g,
                             16 if q16 else WBITS)


def comb_gather_points(u1, u2, key_idx, g_flat, q_flat, K: int,
                       g16=None, q16: bool = False) -> torch.Tensor:
    """The per-signature comb points of canonical scalars u1, u2: their
    windows, then `gather_from_windows`."""
    return gather_from_windows(
        _windows(u1, 16 if g16 is not None else WBITS),
        _windows(u2, 16 if q16 else WBITS), key_idx, g_flat, q_flat, K,
        g16=g16, q16=q16)


def _tree_reduce(X, Y, Z):
    """(B, M, L) point arrays -> (B, L) sum by log2(M) levels of
    odd/even pairing (the JAX package's XLA tree), padding odd counts
    with the point at infinity. Plain torch; the verify path sums
    through ptree instead, and this twin of the JAX tree is held
    against it in the tests."""
    while X.shape[1] > 1:
        if X.shape[1] % 2:
            inf = torch.zeros_like(X[:, :1])
            one = inf.clone()
            one[..., 0] = 1
            X = torch.cat([X, inf], dim=1)
            Y = torch.cat([Y, one], dim=1)
            Z = torch.cat([Z, inf], dim=1)
        X, Y, Z = cadd((X[:, 0::2], Y[:, 0::2], Z[:, 0::2]),
                       (X[:, 1::2], Y[:, 1::2], Z[:, 1::2]))
    return X[:, 0], Y[:, 0], Z[:, 0]


def comb_windows(digest_words, r, w, wbits_g: int, wbits_q: int):
    """The scalar stage: u1 = e*w, u2 = r*w (mod n, canonical), then
    their comb windows (w1 of wbits_g bits, w2 of wbits_q)."""
    e = limb.words_be_to_limbs(digest_words)
    u1 = FN.canonical(FN.mulmod(e, w))
    u2 = FN.canonical(FN.mulmod(r, w))
    return _windows(u1, wbits_g), _windows(u2, wbits_q)


def comb_points(digest_words, key_idx, q_flat, r, w, g16=None,
                q16: bool = False, g_flat=None) -> torch.Tensor:
    """The scalar stage and the gather: u1 = e*w, u2 = r*w (mod n,
    canonical), then the (B, M, 3, L) comb points."""
    K, g_tab, wbits_g, wbits_q = route_tables(q_flat, g16, q16, g_flat)
    w1, w2 = comb_windows(digest_words, r, w, wbits_g, wbits_q)
    return ptree.gather_rows(w1, w2, key_idx, g_tab, q_flat, K, wbits_g,
                             wbits_q)


def comb_verify_with_tables(digest_words, key_idx, q_flat, r, rpn, w,
                            premask, g16=None, q16: bool = False,
                            g_flat=None):
    """Batched ECDSA accept/reject against prebuilt tables, in the JAX
    package's limb form (its comb_verify_with_tables).

    digest_words: (B, 8) int64 SHA-256 words; key_idx: (B,) int32 in
    [0, K) (a slot outside rejects); q_flat: build_q_tables (q16=False)
    or build_q16_tables (q16=True); r, rpn, w: (B, L) int32 canonical
    limbs; premask (B,) bool; g16: the 16-bit G table or None for the
    8-bit one (g_flat, default g_tables_on(device)). The scalar stage
    runs here in plain torch (`comb_windows`); the gather, sum and check
    are ptree.tree_verify_windows, which takes r and rpn as bytes. The
    card's routes take fused_verify.digest_verify_with_tables instead,
    whose scalar stage is one kernel and whose scalars stay bytes.
    """
    K, g_tab, wbits_g, wbits_q = route_tables(q_flat, g16, q16, g_flat)
    w1, w2 = comb_windows(digest_words, r, w, wbits_g, wbits_q)
    return ptree.tree_verify_windows(w1, w2, key_idx, g_tab, q_flat, K,
                                     wbits_g, wbits_q,
                                     limb.limbs_to_be_bytes(r),
                                     limb.limbs_to_be_bytes(rpn), premask)
