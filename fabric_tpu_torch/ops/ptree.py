"""The per-signature complete-add tree and projective check.

Port of fabric_tpu/ops/ptree.py. Two entries compute the same verdicts:

    tree_verify_points(pts, r, rpn, premask)
        pts (B, M, 3, 20) int32 gathered comb points (semi-reduced),
        the JAX signature and layout;
    tree_verify_windows(w1, w2, key_idx, g_tab, q_tab, K, wbits_g,
                        wbits_q, r8, rpn8, premask)
        the comb windows and the tables: each lane's points are gathered
        as comb.gather_from_windows gathers them (windows taken modulo
        2^wbits; a key slot outside [0, K) rejects); r and rpn as the
        host's (B, 32) uint8 big-endian rows, which the kernel reads
        itself;

r, rpn (B, 20) int32 canonical limbs (points entry), premask (B,) bool
-> (B,) bool: accept iff premask ∧ R != ∞ ∧ (X ≡ r*Z ∨ X ≡ rpn*Z mod
p), R the sum of the lane's M points.

A tensor on the CPU runs the plain torch version here (`tree_body`: the
JAX package's pairing by halves, odd counts padded with (0:1:0); the
windows entry gathers with `gather_rows` first). A CUDA tensor launches
the hand-written kernel in csrc/ptree.cu (both entries share its device
code) and adds one to `launches`; anything else raises. The kernel keeps
32-bit limbs in registers and sums each lane's points on T threads
(`THREADS_PER_LANE`), in another order than by halves: complete addition
has no exceptional cases and the check is invariant under projective
scaling, so the verdicts agree though the coordinates do not.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fabric_tpu_torch.ops import limb, p256
from fabric_tpu_torch.ops.limb import L

# the largest per-lane point count the kernel takes (q8 route: 32 G-side
# + 32 Q-side windows)
MAX_POINTS = 64

# threads per lane, from chip_smoke.py's per-T timing on the H100
# (PERF.md): one thread per lane was the fastest at both of the routes'
# point counts, M = 32 and 64 (the kernel is bound by instruction issue,
# and T > 1 issues the merge rounds' additions on every thread)
THREADS_PER_LANE = 1
T_CHOICES = (1, 2, 4, 8)

# window widths the windows entry takes (M = 256/wbits_g + 256/wbits_q)
WBITS_CHOICES = (1, 2, 4, 8, 16)

# kernel launches since import (or since a caller last set it to 0)
launches = 0


# ---------------------------------------------------------------------------
# Limb-leading modular arithmetic (limb.Mod with axis 0 = limbs)
# ---------------------------------------------------------------------------

class KMod:
    """limb.Mod twin with the limb axis LEADING: shapes (L, *tile).

    Each operation moves the limb axis last, runs the proven limb.Mod
    operation and moves it back, so the two cannot drift. The packed
    constants are the kernel's input: rows [c256, sub_off, m_limbs, A,
    B3, fold_hi[0..L-1]], as fabric_tpu's `KMod.pack_consts`.
    """

    _ROWS = ("c256", "sub_off", "m_limbs", "curve_a", "curve_b3")
    NCONST = len(_ROWS) + L                 # + fold_hi rows

    def __init__(self, mod: limb.Mod):
        self.mod = mod

    def pack_consts(self) -> np.ndarray:
        """(NCONST, L) int32 packed constants."""
        rows = [self.mod.c256, self.mod.sub_off, self.mod.m_limbs,
                p256.A_LIMBS, p256.B3_LIMBS]
        return np.concatenate(
            [np.stack(rows), self.mod.fold_hi]).astype(np.int32)

    @staticmethod
    def _lead(fn, *xs):
        return fn(*(x.movedim(0, -1) for x in xs)).movedim(-1, 0)

    def mulmod(self, a, b):
        return self._lead(self.mod.mulmod, a, b)

    def addmod(self, a, b):
        return self._lead(self.mod.addmod, a, b)

    def submod(self, a, b):
        return self._lead(self.mod.submod, a, b)

    def canonical(self, a):
        return self._lead(self.mod.canonical, a)


@functools.lru_cache(maxsize=None)
def _fpk() -> KMod:
    return KMod(p256.FP)


def cadd_k(p1, p2):
    """Complete projective addition, limb-leading (RCB15 Alg. 1): p1, p2
    tuples of (L, *tile) int32 semi-reduced coordinates. The operation
    sequence is p256.cadd's, which is fabric_tpu's cadd_k's."""
    lead = [c.movedim(0, -1) for c in (*p1, *p2)]
    out = p256.cadd(tuple(lead[:3]), tuple(lead[3:]))
    return tuple(c.movedim(-1, 0) for c in out)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _inf_rows(x, rows: int):
    """(L, rows, *rest) point-at-infinity (0 : 1 : 0) coordinates."""
    zeros = torch.zeros_like(x[:, :rows])
    y = zeros.clone()
    y[0] = 1
    return zeros, y, zeros


def tree_body(X, Y, Z, r, rpn, premask):
    """(L, M, *tile) gathered points -> verify mask of r's tail shape.

    Pairs the top and bottom halves of the point axis at each level
    (sums commute, so halving pairs every point exactly once), padding
    an odd count with the point at infinity, then runs the projective
    check. r, rpn: (L, 1, *tile); premask: (1, *tile).
    """
    F = _fpk()
    pts = X.shape[1]
    while pts > 1:
        if pts % 2:
            rpp = X.shape[1] // pts          # rows per point slot
            ix, iy, iz = _inf_rows(X, rpp)
            X = torch.cat([X, ix], dim=1)
            Y = torch.cat([Y, iy], dim=1)
            Z = torch.cat([Z, iz], dim=1)
            pts += 1
        h = X.shape[1] // 2
        X, Y, Z = cadd_k((X[:, :h], Y[:, :h], Z[:, :h]),
                         (X[:, h:], Y[:, h:], Z[:, h:]))
        pts //= 2
    zc = F.canonical(Z)
    nonzero = (zc != 0).any(dim=0)
    xc = F.canonical(X)
    ok1 = (xc == F.canonical(F.mulmod(r, Z))).all(dim=0)
    ok2 = (xc == F.canonical(F.mulmod(rpn, Z))).all(dim=0)
    return (premask != 0) & nonzero & (ok1 | ok2)


def tree_verify_plain(pts, r_l, rpn_l, premask):
    """The plain torch version of the kernel, on any device: the tree by
    halves over the (L, M, B) limb-leading transpose."""
    pt = pts.permute(2, 3, 1, 0)                      # (3, L, M, B)
    out = tree_body(pt[0], pt[1], pt[2], r_l.t().unsqueeze(1),
                    rpn_l.t().unsqueeze(1), premask.unsqueeze(0))
    return out[0]


def gather_rows(w1, w2, key_idx, g_tab, q_tab, K: int, wbits_g: int,
                wbits_q: int) -> torch.Tensor:
    """Each lane's comb points from its windows, (B, M, 3, L): point
    m < 256/wbits_g is g_tab[m * 2^wbits_g + w1[m]], point 256/wbits_g + i
    is q_tab[(i * K + key) * 2^wbits_q + w2[i]]. A plain index_select on
    the tables (XLA's gather in the JAX package)."""
    B, dev = w1.shape[0], w1.device
    win_g = torch.arange(w1.shape[1], dtype=torch.int64, device=dev)
    win_q = torch.arange(w2.shape[1], dtype=torch.int64, device=dev)
    key = key_idx.to(torch.int64)[:, None]
    g_idx = (win_g << wbits_g) + w1
    q_idx = ((win_q * K + key) << wbits_q) + w2
    pts_g = g_tab.index_select(0, g_idx.reshape(-1))
    pts_q = q_tab.index_select(0, q_idx.reshape(-1))
    return torch.cat([pts_g.reshape(B, -1, 3, L),
                      pts_q.reshape(B, -1, 3, L)], dim=1)


def tree_verify_windows_plain(w1, w2, key_idx, g_tab, q_tab, K: int,
                              wbits_g: int, wbits_q: int, r8, rpn8,
                              premask):
    """The plain torch version of the windows entry, on any device: the
    gather (`gather_rows`), then `tree_verify_plain` on the limbs of r8
    and rpn8. Windows are taken modulo 2^wbits and a key slot outside
    [0, K) rejects, as in the kernel."""
    key_ok = (key_idx >= 0) & (key_idx < K)
    pts = gather_rows(w1 & ((1 << wbits_g) - 1), w2 & ((1 << wbits_q) - 1),
                      key_idx.clamp(0, K - 1), g_tab, q_tab, K, wbits_g,
                      wbits_q)
    return tree_verify_plain(pts, limb.be_bytes_to_limbs(r8),
                             limb.be_bytes_to_limbs(rpn8), premask & key_ok)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _check(ref, want, aligned=()):
    """Each (name, tensor, shape, dtype) must match and lie on ref's
    device; CUDA tensors must also be contiguous, and those named in
    `aligned` 16-byte aligned (the kernel reads their rows as int4)."""
    for name, t, shape, dt in want:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
    if ref.device.type == "cuda":
        for name, t, *_ in want:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if name in aligned and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    elif ref.device.type != "cpu":
        raise ValueError(f"no tree kernel for device {ref.device}")


def _lane_inputs(B, r, rpn, premask, width=L, dtype=torch.int32):
    return [("r", r, (B, width), dtype), ("rpn", rpn, (B, width), dtype),
            ("premask", premask, (B,), torch.bool)]


def _threads(threads_per_lane):
    if threads_per_lane is None:
        return THREADS_PER_LANE
    if threads_per_lane not in T_CHOICES:
        raise ValueError(f"threads_per_lane must be one of {T_CHOICES}, "
                         f"got {threads_per_lane}")
    return threads_per_lane


def _launch(dev, fn: str, *args) -> None:
    """Call the ptree library's `fn` with the tensors' pointers and the
    ints, on the current stream; raise if the launch was refused."""
    global launches
    from fabric_tpu_torch import kernels

    lib = kernels.load("ptree")
    stream = torch.cuda.current_stream(dev).cuda_stream
    cargs = [ctypes.c_int(a) if isinstance(a, int) else a.data_ptr()
             for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*cargs, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"ptree kernel launch failed: CUDA error {err} "
                           f"({lib.ptree_error_string(err).decode()})")
    launches += 1


def tree_verify_points(pts, r_l, rpn_l, premask, *, threads_per_lane=None):
    """Batched R = sum(points); accept iff premask ∧ R != ∞ ∧ x(R) ≡ r
    or rpn (mod p). CPU tensors run the plain version; CUDA tensors
    launch csrc/ptree.cu with `threads_per_lane` threads a lane (default
    THREADS_PER_LANE). See the module docstring for shapes."""
    if pts.dim() != 4 or pts.shape[2] != 3 or pts.shape[3] != L:
        raise ValueError(f"pts must be (B, M, 3, {L}), got {tuple(pts.shape)}")
    B, M = pts.shape[0], pts.shape[1]
    if not 1 <= M <= MAX_POINTS:
        raise ValueError(f"M={M} outside 1..{MAX_POINTS}")
    T = _threads(threads_per_lane)
    _check(pts, [("pts", pts, pts.shape, torch.int32),
                 *_lane_inputs(B, r_l, rpn_l, premask)],
           aligned=("pts", "r", "rpn"))
    if pts.device.type == "cpu":
        return tree_verify_plain(pts, r_l, rpn_l, premask)
    out = torch.empty(B, dtype=torch.bool, device=pts.device)
    _launch(pts.device, "ptree_verify_launch", pts, r_l, rpn_l, premask, out,
            B, M, T)
    return out


def tree_verify_windows(w1, w2, key_idx, g_tab, q_tab, K: int, wbits_g: int,
                        wbits_q: int, r8, rpn8, premask, *,
                        threads_per_lane=None):
    """The tree over points gathered from the tables by window: the
    verdicts of tree_verify_points(gather_rows(...)) without the
    (B, M, 3, L) intermediate. w1 (B, 256/wbits_g), w2 (B, 256/wbits_q)
    and key_idx (B,) int32; g_tab (256/wbits_g * 2^wbits_g, 3, L) and
    q_tab (256/wbits_q * K * 2^wbits_q, 3, L) int32; r8 and rpn8 (B, 32)
    uint8 big-endian rows. CPU tensors run the plain version; CUDA
    tensors launch csrc/ptree.cu's windows entry."""
    for name, wb in (("wbits_g", wbits_g), ("wbits_q", wbits_q)):
        if wb not in WBITS_CHOICES:
            raise ValueError(f"{name} must be one of {WBITS_CHOICES}, got "
                             f"{wb}")
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    nwin_g, nwin_q = 256 // wbits_g, 256 // wbits_q
    M = nwin_g + nwin_q
    if not 1 <= M <= MAX_POINTS:
        raise ValueError(f"M={M} outside 1..{MAX_POINTS}")
    T = _threads(threads_per_lane)
    B = w1.shape[0]
    _check(w1, [("w1", w1, (B, nwin_g), torch.int32),
                ("w2", w2, (B, nwin_q), torch.int32),
                ("key_idx", key_idx, (B,), torch.int32),
                ("g_tab", g_tab, (nwin_g << wbits_g, 3, L), torch.int32),
                ("q_tab", q_tab, ((nwin_q * K) << wbits_q, 3, L),
                 torch.int32),
                *_lane_inputs(B, r8, rpn8, premask, 32, torch.uint8)],
           aligned=("g_tab", "q_tab", "r", "rpn"))
    if w1.device.type == "cpu":
        return tree_verify_windows_plain(w1, w2, key_idx, g_tab, q_tab, K,
                                         wbits_g, wbits_q, r8, rpn8, premask)
    out = torch.empty(B, dtype=torch.bool, device=w1.device)
    _launch(w1.device, "ptree_windows_launch", w1, w2, key_idx, g_tab, q_tab,
            r8, rpn8, premask, out, B, K, wbits_g, wbits_q, T)
    return out


# ---------------------------------------------------------------------------
# The field core's self-test (csrc/field_selftest.cu)
# ---------------------------------------------------------------------------

# Operands at the carry chains' edges (csrc/p256_field.cuh's PTX path):
# a word of all ones at each position, all ones above each word boundary,
# p - 1, 2^256 - 1 and d = 2^256 - p with its small multiples; the
# self-test takes every pair of them.
_D = (1 << 256) - p256.P
CARRY_EDGES = ([0xFFFFFFFF << (32 * k) for k in range(8)]
               + [(1 << 256) - (1 << (32 * k)) for k in range(1, 8)]
               + [p256.P - 1, (1 << 256) - 1, _D, 2 * _D, 3 * _D - 1,
                  p256.P - _D])


def field_selftest_plain(a13, b13, p13, q13):
    """Python ints, the reference of csrc/p256_field.cuh: a13, b13
    (n, 20) int32 13-bit limbs -> (n, 32) int64 words of a mod p, a + b,
    a - b, a * b; p13, q13 (m, 60) 13-bit points -> (m, 24) int64 words
    of p256.cadd4_int (RCB15 Alg. 4) on the canonical coordinates."""
    P = p256.P
    ops = []
    for a, b in zip(a13.tolist(), b13.tolist()):
        a, b = limb.limbs_to_int(a) % P, limb.limbs_to_int(b) % P
        ops.append(limb.ints_to_words((a, (a + b) % P, (a - b) % P,
                                       a * b % P)))
    adds = []
    for p, q in zip(p13.tolist(), q13.tolist()):
        pt = [tuple(limb.limbs_to_int(c[20 * k:20 * k + 20]) % P
                    for k in range(3)) for c in (p, q)]
        adds.append(limb.ints_to_words(p256.cadd4_int(*pt)))
    return (torch.tensor(ops, dtype=torch.int64).reshape(-1, 32),
            torch.tensor(adds, dtype=torch.int64).reshape(-1, 24))


def field_selftest(a13, b13, p13, q13):
    """The field core on the same cases as field_selftest_plain: CPU
    tensors run the plain version, CUDA tensors launch
    csrc/field_selftest.cu (the nvcc build of p256_field.cuh)."""
    n, m = a13.shape[0], p13.shape[0]
    _check(a13, [("a13", a13, (n, L), torch.int32),
                 ("b13", b13, (n, L), torch.int32),
                 ("p13", p13, (m, 3 * L), torch.int32),
                 ("q13", q13, (m, 3 * L), torch.int32)])
    if a13.device.type == "cpu":
        return field_selftest_plain(a13, b13, p13, q13)
    from fabric_tpu_torch import kernels

    lib = kernels.load("field_selftest")
    dev = a13.device
    out_ops = torch.empty((n, 32), dtype=torch.int32, device=dev)
    out_add = torch.empty((m, 24), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.field_selftest_launch(
            a13.data_ptr(), b13.data_ptr(), ctypes.c_int(n), p13.data_ptr(),
            q13.data_ptr(), ctypes.c_int(m), out_ops.data_ptr(),
            out_add.data_ptr(), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(
            f"field_selftest launch failed: CUDA error {err} "
            f"({lib.field_selftest_error_string(err).decode()})")
    return tuple(t.to(torch.int64) & 0xFFFFFFFF for t in (out_ops, out_add))
