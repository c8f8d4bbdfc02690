"""Batched BN254 optimal-ate pairings and G2 MSMs (the idemix path).

Port of fabric_tpu/ops/bn254.py. The plain torch versions follow the JAX
package operation for operation on the port's tower (ops/tower.py, over
`ops/mont.MontMod(P)`: 13-bit limbs, Montgomery R = 2^260), so their
limbs agree with it exactly:

  * `miller_loop_batch`: the 6t+2 loop of complete RCB15 a = 0 twist
    doublings and additions with their sparse lines, then the two
    optimal-ate Frobenius correction additions (Q1 = pi_p(Q) and
    nQ2 = -pi_{p^2}(Q), precomputed on the host by `stage_g2`);
  * `final_exp_batch`: 1/f, then the register-machine program of
    `_final_exp_program` (the easy part, three pow_t of the 63-bit t and
    the Scott et al. chain);
  * `pairing_product_is_one`: the product terms stacked into the batch
    axis, one Miller loop, the terms' values multiplied, one final
    exponentiation and the identity test;
  * `g2_msm_scan`: per scalar bit one complete doubling and T masked
    mixed additions.

The card entries, each a hand-written CUDA kernel (csrc/bn254_pairing.cu,
csrc/g2_msm.cu) on the 32-bit Montgomery core csrc/bn254_field.cuh and
the tower csrc/bn254_tower.cuh; the pairing entries run a lane over a
group of threads on the cooperative layer csrc/pairing_coop.cuh (the
lane's Fp12 values in shared memory, each operation's independent Fp2
products spread over the group in rounds), `layout(B)` threads a lane:

    miller_loop_batch(xP, yP, Q, Q1, nQ2, loop)
        CPU tensors: the plain version; CUDA tensors: the Miller entry,
        one launch (`miller_launches`);
    final_exp_batch(f), pairing_product_is_one(...)
        CPU: the plain versions; CUDA: the final-exp entry, which
        multiplies the T terms' Miller values, runs the program (its
        squarings cyclotomic from `cyclotomic_row` on, as the plain
        version's) and writes the GT value and the identity verdict
        (`final_exp_launches`; the product check also launches the
        Miller entry once);
    g2_msm(k_words, *Q_flat)
        CPU: the plain scan; CUDA: the MSM entry (`msm_launches`), which
        reads the 254-bit scalars as 32-bit words. `g2_msm_scan`, the JAX
        package's signature over bool columns, is the plain scan alone:
        on the card the columns would only be packed back into words.

Anything else raises; nothing falls back. The kernels take and return the
plain version's layout (13-bit limbs in Montgomery form for R = 2^260)
and work inside on 8 x 32-bit words for R = 2^256, converting on load
and store with one Montgomery product each; their outputs are
canonical, so a kernel's value and the plain version's agree after
`F.canonical`. The tower's constants (b3', the gammas, xi, t, the
domain factors) reach the kernels as words computed here from
`bn254_ref` (`kernel_consts`).

Staging is the JAX package's: `stage_g1`, `stage_g2`, `stage_g2_msm`
return numpy arrays byte-identical to it (stage_g2 computes the
correction points with `bn254_ref.g2_frobenius_fast`, the same points as
the exact map).
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.ops import bn254_ref as ref
from fabric_tpu_torch.ops import limb, tower
from fabric_tpu_torch.ops.limb import L
from fabric_tpu_torch.ops.mont import MontMod

F = MontMod(ref.P)

# b3 = 3 * b' = 9/(9+u) on the twist, as exact Fp2 ints
_XI_INV = ref.f2_inv(ref.XI)
_B3_TW = ref.f2_mul((3, 0), ref.f2_mul((3, 0), _XI_INV))


def _f2_pow_int(a, e: int):
    """Host: exact Fp2 pow (for Frobenius constants)."""
    out = (1, 0)
    base = a
    while e:
        if e & 1:
            out = ref.f2_mul(out, base)
        base = ref.f2_mul(base, base)
        e >>= 1
    return out


# gamma = xi^((p-1)/6); (v^j w^i)^p = conj-coeffs * gamma^(2j+i)
_GAMMA = [_f2_pow_int(ref.XI, k * (ref.P - 1) // 6) for k in range(6)]

_T = tower.Tower(F, xi=ref.XI, b3_tw=_B3_TW, gammas=_GAMMA, mtwist=False)

f2_mul = _T.f2_mul
f12_mul = _T.f12_mul
f12_sqr = _T.f12_sqr
f12_one_like = _T.f12_one_like
g2_dbl_line = _T.g2_dbl_line
g2_add_line = _T.g2_add_line
g2_dbl = _T.g2_dbl
g2_add_mixed = _T.g2_add_mixed
gt_is_one = _T.gt_is_one

NBITS_R = 254                       # ref.R.bit_length()

_I32 = (torch.int32,)

# The pairing entries' layouts, the threads a lane (csrc/bn254_pairing.cu
# `group`): 8 (four lanes a warp, their state in shared memory: ~36 lanes
# an SM, so a short chain a lane) for a launch of up to SERIAL_ABOVE
# lanes, one thread on the serial formulas (hundreds of lanes an SM) for
# more. Measured on an H100 80GB HBM3 at 700 W (bn_timing.py, PERF.md):
# Miller lanes 32,768 / 8,192 / 2,048: one thread 28.5 / 11.0 / 11.0 ms,
# 8 threads 85.0 / 20.3 / 5.9; final-exp lanes 16,384 / 4,096 / 1,024:
# 17.1 / 10.9 / 10.7 and 35.0 / 10.7 / 4.6.
LAYOUTS = (8, 1)
SERIAL_ABOVE = 4096

# kernel launches since import (or since a caller last set them to 0),
# and the pairing entries' launches by (entry, threads a lane)
miller_launches = 0
final_exp_launches = 0
msm_launches = 0
layout_launches = {(e, g): 0 for e in ("miller", "final_exp")
                   for g in LAYOUTS}


def layout(B: int) -> int:
    """The threads a lane for a launch of B lanes (either entry)."""
    return 8 if B <= SERIAL_ABOVE else 1


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------

def miller_loop_plain(xP, yP, Q, Q1, nQ2, loop: int = ref.ATE_LOOP):
    """fabric_tpu's miller_loop_batch in plain torch: xP, yP (B, L)
    Montgomery limbs of G1 points; Q, Q1, nQ2 affine twist points as
    ((x0, x1), (y0, y1)) of (B, L) limbs. The addition runs where the
    loop's static bit is set (fabric_tpu computes it on every step and
    selects it by the bit: the same limbs)."""
    one = _T._one(xP)
    T = (Q[0], Q[1], (one, torch.zeros_like(one)))
    f = f12_one_like(xP)
    for bit in bin(loop)[3:]:              # after the leading 1
        f = f12_sqr(f)
        T, line = g2_dbl_line(T, xP, yP)
        f = f12_mul(f, line)
        if bit == "1":
            T, line = g2_add_line(T, Q, xP, yP)
            f = f12_mul(f, line)
    T, l1 = g2_add_line(T, Q1, xP, yP)
    f = f12_mul(f, l1)
    _, l2 = g2_add_line(T, nQ2, xP, yP)
    return f12_mul(f, l2)


def _flat_points(xP, yP, Q, Q1, nQ2):
    return [xP, yP] + [c for q in (Q, Q1, nQ2) for xy in q for c in xy]


def miller_loop_batch(xP, yP, Q, Q1, nQ2, loop: int = ref.ATE_LOOP,
                      group: int | None = None):
    """f_{loop,Q}(P) with the optimal-ate corrections, per lane: the
    plain version on CPU tensors, csrc/bn254_pairing.cu's Miller entry on
    CUDA tensors (one launch, `group` threads a lane: `layout(B)` unless
    given). Returns the Fp12 value as nested tuples of (B, L) tensors."""
    global miller_launches
    flat = _flat_points(xP, yP, Q, Q1, nQ2)
    B = xP.shape[0]
    kernels.check_args(xP, [(f"p{i}", t, (B, L), _I32)
                            for i, t in enumerate(flat)], "BN254 Miller")
    if xP.device.type == "cpu":
        return miller_loop_plain(xP, yP, Q, Q1, nQ2, loop)
    bits = bin(loop)[3:]
    if not 1 <= len(bits) <= 64:
        raise ValueError("the Miller kernel takes a loop of 2..65 bits")
    rest = int(bits, 2)
    pts = torch.stack(flat)                              # (14, B, L)
    out = torch.empty((12, B, L), dtype=torch.int32, device=xP.device)
    group = group or layout(B)
    kernels.launch(xP.device, "bn254_pairing", "bn254_miller_launch", pts,
                   kernel_consts(xP.device), out, B, rest & 0xFFFFFFFF,
                   rest >> 32, len(bits), group)
    miller_launches += 1
    layout_launches["miller", group] += 1
    return tower.f12_from_flat(out)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------

def f12_pow_t(m):
    """m^t for the BN parameter t (63 bits)."""
    return tower.pow_scan(m, ref.T_BN, f12_mul, f12_sqr)


class _Asm(tower.Asm):
    """BN-flavored assembler: pow_t is pow by the static parameter t."""

    def pow_t(self, dst, src, tmp):
        self.pow_static(dst, src, tmp, ref.T_BN)


def _final_exp_program() -> np.ndarray:
    """Registers: 0=f (input), 1=inv_f (input), 2=m, 3=mx, 4=mx2,
    5=mx3, 6=t0/scratch, 7=t1/scratch. Mirrors
    ref.final_exponentiation_chain exactly (fabric_tpu's program, row
    for row)."""
    A = _Asm()
    # easy part: m = frob^2(f^(p^6-1)) * f^(p^6-1)
    A.conj(2, 0)                 # m <- conj(f)
    A.mul(2, 2, 1)               # m <- conj(f)*inv(f) = f^(p^6-1)
    A.frob(6, 2)
    A.frob(6, 6)                 # t0 <- m^(p^2)
    A.mul(2, 6, 2)               # m <- m^(p^2+1)
    # hard part powers of t
    A.pow_t(3, 2, 6)             # mx  = m^t
    A.pow_t(4, 3, 6)             # mx2 = mx^t
    A.pow_t(5, 4, 6)             # mx3 = mx2^t
    # y0 = mp*mp2*mp3 -> reg 6
    A.frob(6, 2)                 # mp
    A.frob(7, 6)                 # mp2
    A.mul(6, 6, 7)               # mp*mp2
    A.frob(7, 7)                 # mp3
    A.mul(6, 6, 7)               # y0
    # T0 = y6^2 * y4 * y5;  y6 = conj(mx3 * frob(mx3)); regs 0 and 1
    # (f and inv_f, no longer needed) as scratch
    A.frob(0, 5)                 # frob(mx3)
    A.mul(0, 5, 0)               # mx3*mx3p
    A.conj(0, 0)                 # y6
    A.sqr(0, 0)                  # y6^2
    A.frob(1, 4)                 # mx2p
    A.mul(1, 3, 1)               # mx*mx2p
    A.conj(1, 1)                 # y4
    A.mul(0, 0, 1)               # y6^2*y4
    A.conj(1, 4)                 # y5
    A.mul(0, 0, 1)               # T0 = y6^2*y4*y5
    # T1 = y3*y5*T0; y3 = conj(frob(mx))
    A.frob(7, 3)
    A.conj(7, 7)                 # y3
    A.mul(7, 7, 1)               # y3*y5
    A.mul(7, 7, 0)               # T1
    # T0 = T0 * y2; y2 = frob^2(mx2)
    A.frob(1, 4)
    A.frob(1, 1)                 # y2
    A.mul(0, 0, 1)               # T0*y2
    # T1 = T1^2 * T0; T1 = T1^2
    A.sqr(7, 7)
    A.mul(7, 7, 0)
    A.sqr(7, 7)
    # T0 = T1 * y1; y1 = conj(m)
    A.conj(1, 2)                 # y1
    A.mul(0, 7, 1)               # T0 = T1*y1
    # T1 = T1 * y0 (y0 in reg 6)
    A.mul(7, 7, 6)
    # result = T0^2 * T1 -> reg 0
    A.sqr(0, 0)
    A.mul(0, 0, 7)
    return A.program()


_FINAL_EXP_PROGRAM = _final_exp_program()

EASY_LAST = tower.EASY_LAST
cyclotomic_row = tower.cyclotomic_row


def _final_exp_kernel(f_flat, nterms: int, B: int, program,
                      group: int | None = None):
    """The final-exp entry: f_flat (12, nterms * B, L) Miller values, term
    t of lane i at column t * B + i -> (GT (12, B, L), is-one (B,));
    squarings from cyclotomic_row(program) on cyclotomic, `group`
    threads a lane (`layout(B)` unless given)."""
    global final_exp_launches
    dev = f_flat.device
    prog = torch.as_tensor(np.ascontiguousarray(program, np.int32),
                           device=dev)
    gt = torch.empty((12, B, L), dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    group = group or layout(B)
    kernels.launch(dev, "bn254_pairing", "bn254_final_exp_launch",
                   f_flat.contiguous(), kernel_consts(dev), prog,
                   int(prog.shape[0]), cyclotomic_row(program), gt, ok,
                   nterms, B, group)
    final_exp_launches += 1
    layout_launches["final_exp", group] += 1
    return gt, ok


def final_exp_plain(f, program=_FINAL_EXP_PROGRAM):
    """The register machine in plain torch, every squaring from
    `cyclotomic_row(program)` on a cyclotomic squaring, as the card's
    entry runs it (the same values as fabric_tpu's dense squarings: they
    square elements of the cyclotomic subgroup)."""
    return _T.run_final_exp(f, program, cyc_from=cyclotomic_row(program))


def final_exp_batch(f):
    """The full final exponentiation: the easy part (p^6-1)(p^2+1), then
    the BN hard part via the parameter-t chain. CPU tensors: the plain
    register machine (tower.run_final_exp); CUDA tensors: the final-exp
    entry with one term."""
    flat = tower.flat_from_f12(f)
    B = flat.shape[1]
    kernels.check_args(flat, [("f", flat, (12, B, L), _I32)],
                       "BN254 final exponentiation")
    if flat.device.type == "cpu":
        return final_exp_plain(f)
    gt, _ = _final_exp_kernel(flat, 1, B, _FINAL_EXP_PROGRAM)
    return tower.f12_from_flat(gt)


def pairing_product_is_one(xPs, yPs, Qs, Q1s, nQ2s,
                           loop: int = ref.ATE_LOOP):
    """prod_i e(P_i, Q_i) == 1 for a batch of pairing products: each
    argument is a list over the product terms of staged (B, L) tensors.
    The terms are stacked into the batch axis for one Miller loop
    (`miller_loop_batch`), their values multiplied, and one final
    exponentiation decides: on the card one final-exp launch does both,
    on the CPU the plain versions."""
    nterms, B = len(xPs), xPs[0].shape[0]

    def cat_pt(qs):
        return tuple(tuple(torch.cat([q[i][j] for q in qs])
                           for j in range(2)) for i in range(2))
    f_all = tower.flat_from_f12(miller_loop_batch(
        torch.cat(xPs), torch.cat(yPs), cat_pt(Qs), cat_pt(Q1s),
        cat_pt(nQ2s), loop=loop))
    if f_all.device.type == "cuda":
        return _final_exp_kernel(f_all, nterms, B, _FINAL_EXP_PROGRAM)[1]
    acc = tower.f12_from_flat(f_all[:, :B])
    for t in range(1, nterms):
        acc = f12_mul(acc, tower.f12_from_flat(f_all[:, t * B:(t + 1) * B]))
    return gt_is_one(final_exp_plain(acc))


def stage_pairing_products(products):
    """[[(P_int, Q_tw_int), ...] per lane] (uniform term count) -> the
    staged numpy lists pairing_product_is_one consumes (after
    `to_device`)."""
    nterms = len(products[0])
    assert all(len(p) == nterms for p in products)
    xPs, yPs, Qs, Q1s, nQ2s = [], [], [], [], []
    for t in range(nterms):
        xP, yP = stage_g1([p[t][0] for p in products])
        Q, Q1, nQ2 = stage_g2([p[t][1] for p in products])
        xPs.append(xP)
        yPs.append(yP)
        Qs.append(Q)
        Q1s.append(Q1)
        nQ2s.append(nQ2)
    return xPs, yPs, Qs, Q1s, nQ2s


def to_device(tree, device, lo: int = 0, hi: int | None = None):
    """Nested lists/tuples of numpy arrays -> the same of tensors on
    `device`, rows lo:hi of each."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree[lo:hi])).to(device)
    return type(tree)(to_device(t, device, lo, hi) for t in tree)


# ---------------------------------------------------------------------------
# Batched G2 multi-scalar multiplication (idemix PS Schnorr)
# ---------------------------------------------------------------------------

def g2_msm_plain(bit_cols, *Q_flat):
    """fabric_tpu's g2_msm_scan in plain torch: bit_cols (NBITS, B, T)
    bool, msb first; Q_flat 4*T (B, L) tensors (x0, x1, y0, y1 per term).
    Returns the projective (X, Y, Z) Fp2 triple."""
    nterms = len(Q_flat) // 4
    Qs = [((Q_flat[4 * t], Q_flat[4 * t + 1]),
           (Q_flat[4 * t + 2], Q_flat[4 * t + 3])) for t in range(nterms)]
    one = _T._one(Q_flat[0])
    zero = torch.zeros_like(one)
    acc = ((zero, zero), (one, zero), (zero, zero))      # infinity
    for bits in bit_cols:
        acc = g2_dbl(acc)
        for t, Q in enumerate(Qs):
            acc = tower.select_pt(bits[:, t], g2_add_mixed(acc, Q), acc)
    return acc


def words_to_bits(k_words, nbits: int = NBITS_R):
    """(B, T, 8) little-endian 32-bit scalar words (int32) -> (nbits, B, T)
    bool columns, msb first."""
    w = k_words.to(torch.int64) & 0xFFFFFFFF
    i = torch.arange(nbits - 1, -1, -1, device=k_words.device)
    bits = (w[..., i // 32] >> (i % 32)) & 1                 # (B, T, nbits)
    return bits.permute(2, 0, 1).to(torch.bool)


def g2_msm(k_words, *Q_flat, nbits: int = NBITS_R):
    """sum_t k_t * Q_t per lane: k_words (B, T, 8) int32 little-endian
    words of the scalars (below 2^nbits), Q_flat 4*T (B, L) Montgomery
    limbs. CPU: the plain scan over words_to_bits; CUDA: csrc/g2_msm.cu
    (one launch). Returns the projective (X, Y, Z) Fp2 triple (the
    kernel's canonical)."""
    global msm_launches
    B, nterms = k_words.shape[0], k_words.shape[1]
    kernels.check_args(k_words, [("k_words", k_words, (B, nterms, 8), _I32)]
                       + [(f"q{i}", q, (B, L), _I32)
                          for i, q in enumerate(Q_flat)], "G2 MSM")
    if len(Q_flat) != 4 * nterms or not 1 <= nbits <= 256:
        raise ValueError("g2_msm: 4 coordinates a term, 1..256 bits")
    if k_words.device.type == "cpu":
        return g2_msm_plain(words_to_bits(k_words, nbits), *Q_flat)
    out = torch.empty((6, B, L), dtype=torch.int32, device=k_words.device)
    kernels.launch(k_words.device, "g2_msm", "g2_msm_launch", k_words,
                   torch.stack(Q_flat), kernel_consts(k_words.device), out,
                   B, nterms, nbits)
    msm_launches += 1
    return ((out[0], out[1]), (out[2], out[3]), (out[4], out[5]))


def g2_msm_scan(bit_cols, *Q_flat):
    """fabric_tpu's signature: bit_cols (NBITS, B, T) bool -> the plain
    scan on CPU tensors. The card's MSM takes the scalars as words:
    CUDA tensors raise here (call `g2_msm`)."""
    if bit_cols.device.type != "cpu":
        raise ValueError("g2_msm_scan is the plain scan on the CPU; on the "
                         "card call g2_msm with the scalars as words")
    return g2_msm_plain(bit_cols, *Q_flat)


def stage_g2_msm_words(lanes):
    """[[(k, Q_affine_int | None), ...] x T per lane] -> (k_words (B, T, 8)
    uint32 little-endian words of k mod r, q_flat list of 4*T (B, L)
    limb arrays). None/zero terms get k = 0 and the G2 placeholder (the
    point is never added)."""
    nterms = len(lanes[0])
    assert all(len(lane) == nterms for lane in lanes)
    B = len(lanes)
    kb = np.zeros((B, nterms, 32), dtype=np.uint8)
    g2 = (ref.G2_X, ref.G2_Y)
    cols = [[[] for _ in range(4)] for _ in range(nterms)]
    for i, lane in enumerate(lanes):
        for t, (k, q) in enumerate(lane):
            k %= ref.R
            if q is None:
                k = 0
            if k:
                kb[i, t] = np.frombuffer(k.to_bytes(32, "little"), np.uint8)
            p = q if (q is not None and k) else g2
            for c, v in zip(cols[t], (p[0][0], p[0][1], p[1][0], p[1][1])):
                c.append(F.to_mont(v))
    q_flat = [np.stack(c) for col in cols for c in col]
    return kb.view("<u4"), q_flat


def stage_g2_msm(lanes, nbits: int = NBITS_R):
    """fabric_tpu's staging: (bit_cols (nbits, B, T) bool msb first,
    q_flat), byte-identical to it."""
    kw, q_flat = stage_g2_msm_words(lanes)
    be = kw.view(np.uint8)[..., ::-1]                        # big-endian
    bits = np.unpackbits(be, axis=-1)[..., 256 - nbits:]      # (B, T, nbits)
    return np.ascontiguousarray(bits.transpose(2, 0, 1).astype(bool)), q_flat


def read_g2_msm(out) -> list:
    """Projective mont limb result -> affine int points (None for
    infinity), via host Fp2 inversion per lane."""
    (X0, X1), (Y0, Y1), (Z0, Z1) = out
    X0, X1, Y0, Y1, Z0, Z1 = (np.asarray(a.cpu() if isinstance(
        a, torch.Tensor) else a) for a in (X0, X1, Y0, Y1, Z0, Z1))
    res = []
    for i in range(X0.shape[0]):
        z = (F.from_limbs(Z0[i]), F.from_limbs(Z1[i]))
        if z == (0, 0):
            res.append(None)
            continue
        zi = ref.f2_inv(z)
        x = ref.f2_mul((F.from_limbs(X0[i]), F.from_limbs(X1[i])), zi)
        y = ref.f2_mul((F.from_limbs(Y0[i]), F.from_limbs(Y1[i])), zi)
        res.append((x, y))
    return res


def bls_products(pk_tw, msgs, sig_points):
    """Per-lane BLS verify as a 2-term pairing product:
    e(sig, G2) * e(H(m), -pk) == 1."""
    g2 = (ref.G2_X, ref.G2_Y)
    npk = ref.g2_neg_tw(pk_tw)
    return [[(sig, g2), (ref.hash_to_g1(m), npk)]
            for m, sig in zip(msgs, sig_points)]


# ---------------------------------------------------------------------------
# Host staging + verification helpers
# ---------------------------------------------------------------------------

def stage_g1(points) -> tuple[np.ndarray, np.ndarray]:
    """[(x, y) ints] -> (B, L) Montgomery limb arrays."""
    xs = np.stack([F.to_mont(p[0]) for p in points])
    ys = np.stack([F.to_mont(p[1]) for p in points])
    return xs, ys


def stage_g2(points):
    """[((x0,x1),(y0,y1)) ints] -> twist-point limb tuples + the
    host-precomputed Frobenius correction points (Q1 = pi_p(Q),
    nQ2 = -pi_{p^2}(Q); one computation per distinct point)."""
    def pack(pts):
        return ((np.stack([F.to_mont(p[0][0]) for p in pts]),
                 np.stack([F.to_mont(p[0][1]) for p in pts])),
                (np.stack([F.to_mont(p[1][0]) for p in pts]),
                 np.stack([F.to_mont(p[1][1]) for p in pts])))

    memo: dict = {}
    for q in points:
        if q not in memo:
            q1 = ref.g2_frobenius_fast(q)
            memo[q] = (q1, ref.g2_neg_tw(ref.g2_frobenius_fast(q1)))
    return (pack(points), pack([memo[q][0] for q in points]),
            pack([memo[q][1] for q in points]))


def f12_from_device(f) -> list:
    """Fp12 (nested tuples of (B, L) mont limbs, any device) -> list of
    int-reference Fp12 elements, for differential comparison."""
    flat = tower.flat_from_f12(f).cpu().numpy()             # (12, B, L)
    out = []
    for i in range(flat.shape[1]):
        c = [F.from_limbs(flat[k, i]) for k in range(12)]
        out.append((tuple((c[2 * j], c[2 * j + 1]) for j in range(3)),
                    tuple((c[6 + 2 * j], c[7 + 2 * j]) for j in range(3))))
    return out


# ---------------------------------------------------------------------------
# The kernels' constants and self-tests (csrc/bn254_pairing.cu)
# ---------------------------------------------------------------------------

R256 = 1 << 256
N_CONSTS = 4 * 8 + 7 * 16 + 4


def _m256(v: int) -> list[int]:
    return limb.ints_to_words([v % ref.P * R256 % ref.P])


def consts_words() -> np.ndarray:
    """The kernels' BnConsts (csrc/bn254_tower.cuh) as uint32 words: mont
    one, R^2, the domain factors into and out of R = 2^256 (2^252 and
    2^260 mod p), b3' and gamma_0..5 in Montgomery form, xi's two small
    ints and t's low and high words."""
    P = ref.P
    w = limb.ints_to_words([R256 % P, R256 * R256 % P, pow(2, 252, P),
                            pow(2, 260, P)]) + _m256(_B3_TW[0]) + _m256(
                                _B3_TW[1])
    for g in _GAMMA:
        w += _m256(g[0]) + _m256(g[1])
    w += [ref.XI[0], ref.XI[1], ref.T_BN & 0xFFFFFFFF, ref.T_BN >> 32]
    assert len(w) == N_CONSTS
    return np.array(w, dtype=np.uint32)


_consts: dict = {}


def kernel_consts(device) -> torch.Tensor:
    """consts_words() as int32 on `device` (cached)."""
    key = str(device)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.from_numpy(
            consts_words().view(np.int32)).to(device)
    return t


FP_OUT = 6 * 8


def fp_selftest_plain(a, b):
    """Python ints, the reference of csrc/bn254_field.cuh: a, b (n, 8)
    little-endian 32-bit words (values below 2p) -> (n, 48) int64
    canonical words of a mod p, a + b, a - b, a * b and a^-1 (0 for 0)
    twice (Fermat's and the binary Euclid algorithm's)."""
    P = ref.P
    rows = []
    for ra, rb in zip(a.tolist(), b.tolist()):
        x, y = limb.words_to_ints(ra)[0], limb.words_to_ints(rb)[0]
        inv = pow(x, P - 2, P)
        rows.append(limb.ints_to_words([x % P, (x + y) % P, (x - y) % P,
                                        x * y % P, inv, inv]))
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, FP_OUT)


# tower self-test case: x, y (Fp12, 12 values each), P (2), T (6,
# projective), Q (4, affine) = 36 values; outputs, in this order:
# f2_mul(x.c0, y.c0), f2_sqr(x.c0), f2_inv(x.c0), f12_mul(x, y),
# f12_frob(x), f12_inv(x), g2_dbl_line(T, P) (T' then the line),
# g2_add_line(T, Q, P) (T' then the line), g2_dbl(T), g2_add_mixed(T, Q)
TOWER_IN = 36
TOWER_OUT = 2 + 2 + 2 + 12 + 12 + 12 + 18 + 18 + 6 + 6


def _tower_cases_plain(vals):
    """The tower self-test's outputs by the plain torch tower (CPU):
    vals (n, 36) plain ints -> (n, TOWER_OUT) canonical plain ints."""
    n = len(vals)
    cols = [torch.as_tensor(np.stack([F.to_mont(v[k]) for v in vals]))
            for k in range(TOWER_IN)]
    x = tower.f12_from_flat(cols[0:12])
    y = tower.f12_from_flat(cols[12:24])
    xP, yP = cols[24], cols[25]
    T = ((cols[26], cols[27]), (cols[28], cols[29]), (cols[30], cols[31]))
    Q = ((cols[32], cols[33]), (cols[34], cols[35]))
    x0, y0 = x[0][0], y[0][0]
    Td, ld = g2_dbl_line(T, xP, yP)
    Ta, la = g2_add_line(T, Q, xP, yP)
    outs = [*f2_mul(x0, y0), *_T.f2_sqr(x0), *_T.f2_inv(x0),
            *tower.flat_from_f12(f12_mul(x, y)),
            *tower.flat_from_f12(_T.f12_frob(x)),
            *tower.flat_from_f12(_T.f12_inv(x)),
            *[c for p in Td for c in p], *tower.flat_from_f12(ld),
            *[c for p in Ta for c in p], *tower.flat_from_f12(la),
            *[c for p in g2_dbl(T) for c in p],
            *[c for p in g2_add_mixed(T, Q) for c in p]]
    assert len(outs) == TOWER_OUT
    return [[F.from_limbs(o[i].numpy()) for o in outs] for i in range(n)]


def tower_selftest_plain(cases):
    """The plain tower on the cases of tower_selftest: cases (n, 288)
    int32 words (36 plain values a case) -> (n, 8 * TOWER_OUT) int64
    canonical words."""
    vals = [limb.words_to_ints(r) for r in cases.tolist()]
    rows = [limb.ints_to_words(r) for r in _tower_cases_plain(vals)]
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 8 * TOWER_OUT)


def _selftest(fn: str, plain, width: int, *xs):
    n = xs[0].shape[0]
    kernels.check_args(xs[0], [(f"x{i}", x, (n, x.shape[1]), _I32)
                               for i, x in enumerate(xs)], "self-test")
    if xs[0].device.type == "cpu":
        return plain(*xs)
    out = torch.empty((n, width), dtype=torch.int32, device=xs[0].device)
    kernels.launch(xs[0].device, "bn254_pairing", fn, *xs,
                   kernel_consts(xs[0].device), n, out)
    return out.to(torch.int64) & 0xFFFFFFFF


def fp_selftest(a, b):
    """The BN254 core on the cases of fp_selftest_plain (a, b (n, 8) int32
    words): CPU tensors run the plain version, CUDA tensors
    csrc/bn254_pairing.cu's entry (the nvcc build of bn254_field.cuh)."""
    return _selftest("bn_fp_selftest_launch", fp_selftest_plain, FP_OUT,
                     a, b)


def tower_selftest(cases):
    """csrc/bn254_tower.cuh on the cases of tower_selftest_plain (cases
    (n, 288) int32 words): CPU tensors run the plain tower, CUDA tensors
    bn254_pairing.cu's entry."""
    return _selftest("bn_tower_selftest_launch", tower_selftest_plain,
                     8 * TOWER_OUT, cases)


# the cooperative layer's self-test case: x, y (Fp12, 12 values each), a
# line's A, B, C (6) and c (Fp12, 12: cyclotomic) = 42 values; outputs,
# canonical: x^2 by the serial f12_sqr and by the group, x * the D-type
# line by f12_mul_line and by the group, c^2 by f12_sqr_cyclotomic and by
# the group, the group's x * y, 1/x and x^p, and the inverse of x's first
# coefficient by the binary Euclid algorithm and by Fermat; then
# COOP_CYCLES words of the card's clock cycles (0 on the CPU): those two
# inverses on one thread, the group's Fp12 product and cyclotomic squaring,
# and one thread's f2_mul and f2_add
COOP_IN = 42
COOP_OUT = 9 * 12 + 2
COOP_CYCLES = 6
COOP_CYCLE_NAMES = ("fermat_inverse", "binary_euclid_inverse", "coop_mul",
                    "coop_cyc", "f2_mul", "f2_add")


def coop_selftest_plain(cases):
    """The plain tower on the cases of coop_selftest: cases (n, 336) int32
    words (42 plain values a case) -> (n, 8 * COOP_OUT + COOP_CYCLES)
    int64 canonical words, the cycle words 0."""
    vals = [limb.words_to_ints(r) for r in cases.tolist()]
    rows = [limb.ints_to_words(r) + [0] * COOP_CYCLES
            for r in _T.coop_selftest_rows(vals)]
    return torch.tensor(rows, dtype=torch.int64).reshape(
        -1, 8 * COOP_OUT + COOP_CYCLES)


def coop_selftest(cases):
    """csrc/pairing_coop.cuh on BN254's tower and the serial formulas it
    distributes, on the cases of coop_selftest_plain (cases (n, 336) int32
    words): CPU tensors run the plain tower, CUDA tensors
    bn254_pairing.cu's entry, a warp a case. The last COOP_CYCLES words of
    a row are the card's clock cycles (COOP_CYCLE_NAMES; 0 on the CPU)."""
    return _selftest("bn_coop_selftest_launch", coop_selftest_plain,
                     8 * COOP_OUT + COOP_CYCLES, cases)


# ---------------------------------------------------------------------------
# The pairing entries' products (csrc/pairing_coop.cuh's schedule)
# ---------------------------------------------------------------------------

# The serial entries' Fp products (one thread a lane on bn254_tower.cuh's
# serial forms, an Fp2 square 2 products, a scaling by an Fp value 2): a
# doubling step is f^2 (36), the tangent step (43) and f times the line
# (39); an addition step the chord step (55) and the line product; a
# final-exp row a Karatsuba product (54), a cyclotomic squaring (18) or a
# Frobenius (15); 1/f 111 (four Karatsuba Fp6 products and the Fp6
# inverse, its Fp inverse by the binary Euclid algorithm); a domain
# conversion on load or store one.
SERIAL_DBL, SERIAL_ADD, SERIAL_INV = 36 + 43 + 39, 55 + 39, 111
SERIAL_ROW = {"mul": 54, "cyc": 18, "frob": 15, "conj": 0}


def miller_products(loop: int = ref.ATE_LOOP, group: int | None = None,
                    B: int = 1) -> tuple[int, int]:
    """(chain, executed) Fp products of a Miller lane on `group` threads
    (`layout(B)` unless given): the loop over Q, then the chord steps
    through Q1 and nQ2 (tower.coop_miller_products, three points; one
    thread: the serial forms, chain = executed)."""
    group = group or layout(B)
    if group > 1:
        return tower.coop_miller_products(loop, 3, group)
    bits = bin(loop)[3:]
    n = (14 + 12 + len(bits) * SERIAL_DBL
         + (bits.count("1") + 2) * SERIAL_ADD)
    return n, n


def final_exp_products(program=_FINAL_EXP_PROGRAM, nterms: int = 2,
                       group: int | None = None, B: int = 1
                       ) -> tuple[int, int]:
    """(chain, executed) Fp products of a final-exp lane of `nterms`
    terms on `group` threads (`layout(B)` unless given; one thread: the
    serial forms)."""
    group = group or layout(B)
    if group > 1:
        return tower.coop_final_exp_products(program, nterms, group)
    cyc_from = cyclotomic_row(program)
    n = 12 * nterms + SERIAL_ROW["mul"] * (nterms - 1) + SERIAL_INV + 12
    for row, (op, _, a, b) in enumerate(np.asarray(program).tolist()):
        n += SERIAL_ROW["conj" if op == tower.OP_CONJ else "frob"
                        if op == tower.OP_FROB else "cyc"
                        if a == b and row >= cyc_from else "mul"]
    return n, n
