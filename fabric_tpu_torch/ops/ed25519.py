"""Batched Ed25519 verification: [S]B + [k](-A) == R per lane.

Port of fabric_tpu/ops/ed25519.py. Every policy gate (canonical
encodings, S < L, small-order rejection, the challenge k = SHA-512(R || A
|| M) mod L) is applied on the host by `bccsp/ed25519_host.prep_verify`,
as on the P-256 path; the device decides the curve equation.

The plain torch versions follow the JAX package step for step, on
`ops/mont.MontMod(2^255 - 19)` (Montgomery domain, 13-bit limbs): the
complete a = -1 extended twisted Edwards addition (add-2008-hwcd-3) and
doubling (dbl-2008-hwcd), [S]B by a fixed-base 8-bit comb (32 gathered
points of `b_tables`, a tree of additions), [k](-A) by a 2-bit ladder
(128 steps of two doublings and one addition of a 4-entry table).

    ed25519_verify(tab, s8, k8, anx8, ay8, rx8, ry8, premask)
        the card entry: a tensor on the CPU runs `verify_core`, the plain
        version (tab = b_tables(), the JAX layout); a CUDA tensor
        launches the hand-written kernel in csrc/ed25519_verify.cu (tab =
        kernel_table(...), its own layout: the entries in Niels form,
        plain-domain values in 32-bit words) and adds one to `launches`;
        anything else raises. Nothing falls back.
        `device_table` gives the table a device's path takes.

The kernel computes [k](-A) on signed radix-16 digits and then adds
[S]B's 32 points one after another, where the plain version runs a 2-bit
ladder and adds [S]B as a tree; it works on other representatives of the
same points, and its check compares x and y of the sum with R's in
canonical form (X = rx*Z and Y = ry*T on the completed point), which is
invariant under projective scaling, so the verdicts agree.
"""

from __future__ import annotations

import logging
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from fabric_tpu_torch import kernels
from fabric_tpu_torch.bccsp import ed25519_host as edh
from fabric_tpu_torch.ops import comb, limb
from fabric_tpu_torch.ops.limb import L
from fabric_tpu_torch.ops.mont import MontMod

logger = logging.getLogger("fabric_tpu_torch.ops.ed25519")

P_ED = edh.P

FED = MontMod(P_ED)

WBITS = comb.WBITS              # 8-bit comb windows, as the G/Q tables
NWIN = comb.NWIN
NENT = comb.NENT

_R2_LIMBS = limb.int_to_limbs(FED.r2_mod_m)       # to-Montgomery factor
_ONE_M = limb.int_to_limbs(FED.r_mod_m)           # mont(1)
_D2_M = limb.int_to_limbs(edh.D2 * FED.R % P_ED)  # mont(2d)
_ONE = limb.int_to_limbs(1)

# where the B table persists (empty string disables)
EDTAB_CACHE_ENV = "FABRIC_TPU_TORCH_EDTAB_CACHE"

# kernel launches since import (or since a caller last set it to 0)
launches = 0

_U8 = (torch.uint8,)


def _c(limbs, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(limbs, device=like.device).expand(like.shape)


def _to_mont(v):
    """Plain canonical limbs -> Montgomery domain (one REDC product)."""
    return FED.mul(v, _c(_R2_LIMBS, v))


# ---------------------------------------------------------------------------
# Extended twisted Edwards arithmetic over limb tensors (a = -1)
# ---------------------------------------------------------------------------

def ed_add(p, q):
    """Complete addition (add-2008-hwcd-3): tuples of (..., L) int32
    Montgomery-domain coordinates (X, Y, Z, T). Mirrors
    `ed25519_host.pt_add` and fabric_tpu's `ed_add` exactly."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = FED.mul(FED.sub(Y1, X1), FED.sub(Y2, X2))
    b = FED.mul(FED.add(Y1, X1), FED.add(Y2, X2))
    c = FED.mul(FED.mul(T1, _c(_D2_M, X1)), T2)
    dd = FED.mul(Z1, Z2)
    dd = FED.add(dd, dd)
    e, f, g, h = FED.sub(b, a), FED.sub(dd, c), FED.add(dd, c), \
        FED.add(b, a)
    return (FED.mul(e, f), FED.mul(g, h), FED.mul(f, g), FED.mul(e, h))


def ed_double(p):
    """a = -1 doubling (dbl-2008-hwcd); complete. Mirrors
    `ed25519_host.pt_double` and fabric_tpu's `ed_double` exactly."""
    X1, Y1, Z1, _ = p
    a = FED.mul(X1, X1)
    b = FED.mul(Y1, Y1)
    c = FED.mul(Z1, Z1)
    c = FED.add(c, c)
    xy = FED.add(X1, Y1)
    h = FED.add(a, b)
    e = FED.sub(h, FED.mul(xy, xy))
    g = FED.sub(a, b)
    f = FED.add(c, g)
    return (FED.mul(e, f), FED.mul(g, h), FED.mul(f, g), FED.mul(e, h))


def _identity(shape, device):
    one = torch.as_tensor(_ONE_M, device=device).expand(shape)
    zero = torch.zeros(shape, dtype=torch.int32, device=device)
    return (zero, one, one, zero)


# ---------------------------------------------------------------------------
# The fixed-base comb table for B (host constants, persisted with the
# sidecar contract of comb.g_tables: B is a universal constant like G)
# ---------------------------------------------------------------------------

def _build_b_tables() -> np.ndarray:
    out = np.zeros((NWIN * NENT, 4, L), dtype=np.int32)
    base = edh.from_affine(edh.BX, edh.BY)
    for i in range(NWIN):
        acc = edh._IDENT
        for j in range(NENT):
            if j == 0:
                x, y = 0, 1
            else:
                x, y = edh.to_affine(acc)
            coords = (x, y, 1, x * y % P_ED)
            for c in range(4):
                out[i * NENT + j, c] = limb.int_to_limbs(
                    coords[c] * FED.R % P_ED)
            acc = edh.pt_add(acc, base)
        for _ in range(WBITS):
            base = edh.pt_double(base)
    return out


_btab_lock = threading.Lock()
_btab: list = []


def b_tables() -> np.ndarray:
    """(NWIN * NENT, 4, L) int32 — T_B[i*NENT + j] = j * 2^(8i) * B in
    Montgomery-domain extended coordinates (Z = mont(1), T = X*Y); entry
    j = 0 is the identity. Built once over Python ints (exact), kept for
    the process and persisted to $FABRIC_TPU_TORCH_EDTAB_CACHE (default
    ~/.cache/fabric_tpu_torch/edtab8.npy; empty string disables) with a
    sha256 sidecar: a table whose digest disagrees is rebuilt, never
    used. The bytes equal fabric_tpu's b_tables()."""
    with _btab_lock:
        if _btab:
            return _btab[0]
        cache = os.environ.get(
            EDTAB_CACHE_ENV,
            os.path.expanduser("~/.cache/fabric_tpu_torch/edtab8.npy"))
        arr = None
        if cache and os.path.exists(cache) \
                and comb.verify_digest_sidecar(cache) is not False:
            try:
                got = np.load(cache)
                if got.dtype == np.int32 and got.shape == (NWIN * NENT, 4,
                                                           L):
                    arr = got
            except (OSError, ValueError) as e:
                logger.warning("Ed25519 B-table cache %s unreadable (%s); "
                               "rebuilding", cache, e)
        if arr is None:
            arr = _build_b_tables()
            if cache:
                try:
                    os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
                    tmp = cache + f".tmp{os.getpid()}"
                    with open(tmp, "wb") as f:
                        np.save(f, arr)
                    digest = comb.file_sha256(tmp)
                    os.replace(tmp, cache)
                    comb.write_digest_sidecar(cache, digest)
                except OSError as e:
                    logger.warning("Ed25519 B-table cache persist to %s "
                                   "failed (%s)", cache, e)
        _btab.append(arr)
        return arr


def kernel_table(tab: torch.Tensor) -> torch.Tensor:
    """The kernel's layout of the B table: (NWIN*NENT, 3, 8) int32, each
    entry (x, y) in Niels form (y + x, y - x, 2d*x*y), each coordinate's
    canonical plain-domain value (mont^-1: one REDC product by 1) as 8
    little-endian 32-bit words; the identity is (1, 1, 0). tab: the
    b_tables() layout (NWIN*NENT, 4, L) int32 (Z = mont(1), T = X*Y), on
    any device."""
    X, Y, T = tab[:, 0], tab[:, 1], tab[:, 3]
    niels = torch.stack([FED.add(Y, X), FED.sub(Y, X),
                         FED.mul(T, _c(_D2_M, T))], dim=1)
    x = FED.canonical(FED.mul(niels, _c(_ONE, niels))).to(torch.int64)
    words = []
    for k in range(8):                      # word k: bits [32k, 32k + 32)
        v = torch.zeros_like(x[..., 0])
        for i in range(L):
            lo = limb.W * i - 32 * k        # limb i's bit 0 within word k
            hi = lo + limb.W
            if hi <= 0 or lo >= 32:
                continue
            v = v | ((x[..., i] << lo) if lo >= 0 else (x[..., i] >> -lo))
        words.append(v & 0xFFFFFFFF)
    w = torch.stack(words, dim=-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)



def device_table(device) -> torch.Tensor:
    """The B table in the layout `ed25519_verify` takes on `device`: the
    kernel's (kernel_table) on a CUDA device, b_tables() on the CPU."""
    dev = torch.device(device)
    tab = torch.as_tensor(b_tables(), device=dev)
    return kernel_table(tab).contiguous() if dev.type == "cuda" else tab


def _tree_reduce4(X, Y, Z, T):
    """(B, M, L) extended-point tensors -> (B, L) sum via log2(M)
    complete-add levels (the comb tree shape, 4 coordinates)."""
    while X.shape[1] > 1:
        if X.shape[1] % 2:          # pad with the identity
            one = torch.as_tensor(_ONE_M, device=X.device)
            X = F.pad(X, (0, 0, 0, 1))
            T = F.pad(T, (0, 0, 0, 1))
            Y = torch.cat([Y, one.expand(Y.shape[0], 1, L)], dim=1)
            Z = torch.cat([Z, one.expand(Z.shape[0], 1, L)], dim=1)
        X, Y, Z, T = ed_add(
            (X[:, 0::2], Y[:, 0::2], Z[:, 0::2], T[:, 0::2]),
            (X[:, 1::2], Y[:, 1::2], Z[:, 1::2], T[:, 1::2]))
    return X[:, 0], Y[:, 0], Z[:, 0], T[:, 0]


def comb_mul_base(s, tab):
    """[S]B by the fixed-base comb: s (B, L) canonical scalar limbs, tab
    the b_tables() tensor. 32 gathered points, no doublings."""
    w = comb._windows(s)                                    # (B, NWIN)
    win = torch.arange(NWIN, device=s.device, dtype=torch.int64)[None, :]
    pts = tab[win * NENT + w.to(torch.int64)]               # (B, NWIN, 4, L)
    return _tree_reduce4(pts[:, :, 0], pts[:, :, 1], pts[:, :, 2],
                         pts[:, :, 3])


def _select4(idx, table):
    """Branchless 4-way point select: idx (B,), table a list of four
    extended points as tuples of (B, L) coordinates."""
    w = idx[:, None]
    out = []
    for c in range(4):
        lo = torch.where(w < 1, table[0][c], table[1][c])
        hi = torch.where(w < 3, table[2][c], table[3][c])
        out.append(torch.where(w < 2, lo, hi))
    return tuple(out)


def ladder_mul(k, pt):
    """[k]pt for a batch: k (B, L) canonical scalar limbs, pt an extended
    point of (B, L) coordinates. 2-bit windows: 128 steps of two
    doublings and one complete addition of a 4-entry table."""
    ident = _identity(k.shape, k.device)
    p2 = ed_double(pt)
    p3 = ed_add(p2, pt)
    table = [tuple(c.expand(k.shape) for c in ident), pt, p2, p3]

    def bit(b):
        return (k[:, b // limb.W] >> (b % limb.W)) & 1

    acc = ident
    for i in range(128):
        acc = ed_double(ed_double(acc))
        pos = 254 - 2 * i
        acc = ed_add(acc, _select4(bit(pos) + 2 * bit(pos + 1), table))
    return acc


# ---------------------------------------------------------------------------
# The verify core (the plain version) and the host staging helper
# ---------------------------------------------------------------------------

def verify_core(tab, s8, k8, anx8, ay8, rx8, ry8, premask):
    """Batched Ed25519 accept/reject (fabric_tpu's `verify_core`).

    tab: b_tables() as a tensor on the operands' device.
    s8, k8: (B, 32) uint8 big-endian rows of S and of the challenge k
        (host-reduced mod L).
    anx8, ay8: (B, 32) uint8 big-endian affine coordinates of -A.
    rx8, ry8: (B, 32) uint8 big-endian affine coordinates of R.
    premask: (B,) bool host gate verdicts; dead lanes carry the identity
        for A and R, so the complete formulas stay on curve points.
    Returns (B,) bool: premask & ([S]B + [k](-A) == R)."""
    s = limb.be_bytes_to_limbs(s8)
    k = limb.be_bytes_to_limbs(k8)
    anx = _to_mont(limb.be_bytes_to_limbs(anx8))
    ay = _to_mont(limb.be_bytes_to_limbs(ay8))
    rx = _to_mont(limb.be_bytes_to_limbs(rx8))
    ry = _to_mont(limb.be_bytes_to_limbs(ry8))

    sb = comb_mul_base(s, tab)
    neg_a = (anx, ay, _c(_ONE_M, anx), FED.mul(anx, ay))
    ka = ladder_mul(k, neg_a)
    X3, Y3, Z3, _ = ed_add(sb, ka)

    def eq(a, b):
        return (FED.canonical(a) == FED.canonical(b)).all(dim=-1)

    return premask & eq(X3, FED.mul(rx, Z3)) & eq(Y3, FED.mul(ry, Z3))


def stage_rows(prep, bucket: int):
    """Pack `prep` — per-lane `ed25519_host.prep_verify` results (None =
    host-rejected) — into the kernel's operand rows, numpy. Dead and
    padded lanes carry zero scalars and identity points, so every
    lane's math stays on the curve. Returns (s8, k8, anx8, ay8, rx8,
    ry8, premask)."""
    s8 = np.zeros((bucket, 32), dtype=np.uint8)
    k8 = np.zeros((bucket, 32), dtype=np.uint8)
    anx8 = np.zeros((bucket, 32), dtype=np.uint8)
    ay8 = np.zeros((bucket, 32), dtype=np.uint8)
    rx8 = np.zeros((bucket, 32), dtype=np.uint8)
    ry8 = np.zeros((bucket, 32), dtype=np.uint8)
    premask = np.zeros(bucket, dtype=bool)
    # identity (0, 1) for every dead lane
    one = (1).to_bytes(32, "big")
    ay8[:] = np.frombuffer(one, np.uint8)
    ry8[:] = np.frombuffer(one, np.uint8)
    for i, p in enumerate(prep):
        if p is None:
            continue
        s, k, neg_ax, ay, rx, ry = p
        premask[i] = True
        for row, v in ((s8, s), (k8, k), (anx8, neg_ax), (ay8, ay),
                       (rx8, rx), (ry8, ry)):
            row[i] = np.frombuffer(v.to_bytes(32, "big"), np.uint8)
    return s8, k8, anx8, ay8, rx8, ry8, premask


# ---------------------------------------------------------------------------
# The card entry
# ---------------------------------------------------------------------------

def ed25519_verify(tab, s8, k8, anx8, ay8, rx8, ry8, premask):
    """The batched Ed25519 check over `stage_rows` operands (as tensors):
    s8, k8, anx8, ay8, rx8, ry8 (B, 32) uint8 big-endian rows, premask
    (B,) bool -> (B,) bool. tab is `device_table(device)`: b_tables() on
    the CPU, where the plain version runs; kernel_table(...) on the card,
    where csrc/ed25519_verify.cu runs. k must be below L, as
    `prep_verify` makes it: the kernel's signed digits take k below
    about 2^254.9 only, where `verify_core` walks all 256 bits."""
    global launches
    B = s8.shape[0]
    cuda = s8.device.type == "cuda"
    tab_shape = (NWIN * NENT, 3, 8) if cuda else (NWIN * NENT, 4, L)
    rows = (("s8", s8), ("k8", k8), ("anx8", anx8), ("ay8", ay8),
            ("rx8", rx8), ("ry8", ry8))
    kernels.check_args(
        s8, [("tab", tab, tab_shape, (torch.int32,)),
             *[(nm, t, (B, 32), _U8) for nm, t in rows],
             ("premask", premask, (B,), (torch.bool,))],
        "Ed25519", aligned=("tab", *(nm for nm, _ in rows)))
    if not cuda:
        return verify_core(tab, s8, k8, anx8, ay8, rx8, ry8, premask)
    out = torch.empty(B, dtype=torch.bool, device=s8.device)
    kernels.launch(s8.device, "ed25519_verify", "ed25519_verify_launch", s8,
                   k8, anx8, ay8, rx8, ry8, premask, tab, out, B)
    launches += 1
    return out


# ---------------------------------------------------------------------------
# The field and group-law self-tests (csrc/field_selftest.cu)
# ---------------------------------------------------------------------------

def f25_selftest_plain(a, b):
    """Python ints, the reference of csrc/fe25519.cuh: a, b (n, 8)
    little-endian 32-bit words (any value below 2^256) -> (n, 40) int64
    canonical words of a mod p, a + b, a - b, a * b and a^2 (mod
    2^255 - 19)."""
    P = P_ED
    rows = []
    for ra, rb in zip(a.tolist(), b.tolist()):
        x, y = limb.words_to_ints(ra)[0], limb.words_to_ints(rb)[0]
        rows.append(limb.ints_to_words([x % P, (x + y) % P, (x - y) % P,
                                        x * y % P, x * x % P]))
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 40)


# The kernel's group law (csrc/fe25519.cuh) in Python ints, step for step:
# points as tuples of ints mod p (P3 (X, Y, Z, T), P2 (X, Y, Z), completed
# P1 (X, Z, Y, T) as the kernel's (X, Y, Z, T) fields, cached (Y + X,
# Y - X, 2Z, 2dT), Niels (y + x, y - x, 2dxy)).

def cached_int(p):
    X, Y, Z, T = p
    return ((Y + X) % P_ED, (Y - X) % P_ED, 2 * Z % P_ED, T * edh.D2 % P_ED)


def niels_int(x, y):
    return ((y + x) % P_ED, (y - x) % P_ED, x * y * edh.D2 % P_ED)


def _sum_int(pp, mm, tt, zz, neg):
    a, b = (zz + tt) % P_ED, (zz - tt) % P_ED
    return ((pp - mm) % P_ED, (pp + mm) % P_ED) + ((b, a) if neg else (a, b))


def add_cached_int(p, q, neg=False):
    X, Y, Z, T = p
    ypx, ymx, z2, t2d = q
    if neg:
        ypx, ymx = ymx, ypx
    return _sum_int((Y + X) * ypx, (Y - X) * ymx, T * t2d, Z * z2, neg)


def madd_int(p, q):
    X, Y, Z, T = p
    ypx, ymx, xy2d = q
    return _sum_int((Y + X) * ypx, (Y - X) * ymx, T * xy2d, 2 * Z, False)


def dbl_int(p):
    X, Y, Z = p[:3]
    y, z = (Y * Y + X * X) % P_ED, (Y * Y - X * X) % P_ED
    return (((X + Y) ** 2 - y) % P_ED, y, z, (2 * Z * Z - z) % P_ED)


def p1_to_p3_int(p):
    X, Y, Z, T = p
    return (X * T % P_ED, Y * Z % P_ED, Z * T % P_ED, X * Y % P_ED)


def ed_selftest_plain(p, q):
    """Python ints (the kernel's formulas above): p, q (n, 32) words of
    extended points (X, Y, Z, T; q affine, Z = 1) -> (n, 128) int64
    canonical P3 words of p + q (cached addition), 2p (doubling of p's
    P2), p + q (mixed addition of q's Niels form) and p - q."""
    rows = []
    for rp, rq in zip(p.tolist(), q.tolist()):
        pp, qq = tuple(limb.words_to_ints(rp)), tuple(limb.words_to_ints(rq))
        qc = cached_int(qq)
        outs = [add_cached_int(pp, qc), dbl_int(pp),
                madd_int(pp, niels_int(qq[0], qq[1])),
                add_cached_int(pp, qc, neg=True)]
        rows.append(limb.ints_to_words([c for o in outs
                                        for c in p1_to_p3_int(o)]))
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 128)


def _selftest(fn: str, plain, width: int, x, y):
    """(n, w) int32 word rows x, y -> (n, width) int64 words: `plain` on
    the CPU, library field_selftest's `fn` on the card."""
    n, w = x.shape
    kernels.check_args(x, [("x", x, (n, w), (torch.int32,)),
                           ("y", y, (n, w), (torch.int32,))], "self-test")
    if x.device.type == "cpu":
        return plain(x, y)
    out = torch.empty((n, width), dtype=torch.int32, device=x.device)
    kernels.launch(x.device, "field_selftest", fn, x, y, n, out)
    return out.to(torch.int64) & 0xFFFFFFFF


def f25_selftest(a, b):
    """The 2^255 - 19 core on the cases of f25_selftest_plain (a, b (n,
    8) int32 words): CPU tensors run the plain version, CUDA tensors
    csrc/field_selftest.cu's entry (the nvcc build of fe25519.cuh)."""
    return _selftest("f25_selftest_launch", f25_selftest_plain, 40, a, b)


def ed_selftest(p, q):
    """The group law of csrc/fe25519.cuh on the cases of
    ed_selftest_plain (p, q (n, 32) int32 words): CPU tensors run the
    plain version, CUDA tensors csrc/field_selftest.cu's entry."""
    return _selftest("ed_selftest_launch", ed_selftest_plain, 128, p, q)
