"""Batched BLS12-381 Miller products and the aggregate check on the card.

Port of fabric_tpu/ops/bls12_381_kernel.py. The plain torch versions
follow the JAX package operation for operation on the port's tower
(ops/tower.py, M-type twist over xi = 1 + u, on `mont.MontMod(P)`'s 30
limbs of 13 bits, Montgomery R = 2^390), so their limbs agree with it
exactly:

  * `miller_loop_plain`: f_{|x|,Q}(P) per lane over the static bits of
    |x| = 0xd201000000010000, plain double-and-add with complete RCB15
    twist steps and their sparse lines (no correction steps: with x
    negative this is e(P, Q)^-1 up to factors the final exponentiation
    kills). The JAX scan becomes a Python loop that branches on each
    static bit where the scan selects (the same limbs);
  * `product_reduce_plain`: the lanes' product by halving,
    f12_mul(lo, hi) per level, as fabric_tpu's `_product_reduce`;
  * `final_exp_plain`: 1/f, then the register-machine program of
    `final_exp_program` (the Hayashida-Hayasaka-Teruya chain, equal to
    bls12_381_ref.final_exponentiation_chain = fast^3, the same verdict
    since gcd(3, r) = 1);
  * `pairs_product_is_one_plain`: Miller, the mask (padded lanes become
    Fp12 one), the reduce, the final exponentiation and the identity test.

The card entries, hand-written CUDA kernels (csrc/bls12_381_pairing.cu on
the 32-bit core csrc/bls12_381_field.cuh, the tower
csrc/bls12_381_tower.cuh and, for the Miller and final-exp entries, the
cooperative layer csrc/pairing_coop.cuh: a lane's Fp12 values in shared
memory, each operation's independent Fp2 products spread over the
lane's threads in rounds):

    miller_loop_batch(xP, yP, Q, loop, mask)
        CPU tensors: the plain version (then the mask, when given); CUDA
        tensors: the Miller entry, one launch (`miller_launches`), a warp
        a lane, which writes one on masked lanes;
    product_reduce(f)
        CPU: the plain version; CUDA: the reduce entry, one launch a level,
        log2(B) a call (`reduce_launches`);
    final_exp_batch(f, program)
        CPU: the plain version; CUDA: the final-exp entry, one launch
        (`final_exp_launches`), a warp a lane: the provider gives it one
        lane, the product of every pair; both square cyclotomically from
        `cyclotomic_row(program)` on;
    pairs_product_is_one(xP, yP, qx0, qx1, qy0, qy1, mask, loop)
        the three in a row: one Miller, log2(B) reduce and one final-exp
        launch, and the verdict the final-exp entry writes.

Anything else raises; nothing falls back. The kernels take and return the
plain version's layout (13-bit limbs, R = 2^390) and work inside on 12 x
32-bit words for R = 2^384, converting on load and store with one
Montgomery product each; their outputs are canonical, so a kernel's value
and the plain version's agree after `F.canonical`. The tower's constants
(b3', the gammas, xi, the domain factors) reach the kernels as words
computed here from bls12_381_ref (`kernel_consts`).

Staging is the JAX package's: `stage_pairs` returns numpy arrays
byte-identical to it (masked filler lanes hold (G1, G2)), and
`f12_from_device` reads values back as the int reference's Fp12.

Oracles: bls12_381_ref.miller_loop at the same loop (the ratio of the
two is a single Fp2 * w^(3k) monomial, killed by the final
exponentiation) and final_exponentiation_chain for the program.
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.common import torchenv
from fabric_tpu_torch.ops import bls12_381_ref as ref
from fabric_tpu_torch.ops import limb, tower
from fabric_tpu_torch.ops.mont import MontMod

# the 381-bit field on the 30-limb layout that layout_for_bits derives
F = MontMod(ref.P)
L = F.L

# b3 = 3 * b' = 12 * (1 + u) on the M-type twist, as exact Fp2 ints
_B3_TW = ref.f2_mul((3 * ref.B_G1, 0), ref.XI)

# gamma = xi^(k(p-1)/6): the p-power Frobenius constants
_GAMMA = [ref.pow_xi(k * (ref.P - 1) // 6) for k in range(6)]

_T = tower.Tower(F, xi=ref.XI, b3_tw=_B3_TW, gammas=_GAMMA, mtwist=True)

f2_mul = _T.f2_mul
f6_mul = _T.f6_mul
f12_mul = _T.f12_mul
f12_sqr = _T.f12_sqr
f12_sqr_complex = _T.f12_sqr_complex
f12_sqr_cyclotomic = _T.f12_sqr_cyclotomic
f12_mul_line = _T.f12_mul_line
f12_conj = _T.f12_conj
f12_frob = _T.f12_frob
f12_inv = _T.f12_inv
f12_one_like = _T.f12_one_like
g2_dbl_line = _T.g2_dbl_line
g2_add_line = _T.g2_add_line
gt_is_one = _T.gt_is_one

# kernel launches since import (or since a caller last set them to 0)
miller_launches = 0
reduce_launches = 0
final_exp_launches = 0

_I32 = (torch.int32,)
_LIB = "bls12_381_pairing"


# ---------------------------------------------------------------------------
# Miller loop (BLS12 shape: no correction steps)
# ---------------------------------------------------------------------------

def miller_loop_plain(xP, yP, Q, loop: int = ref.X_BLS):
    """fabric_tpu's miller_loop_batch in plain torch: xP, yP (B, L)
    Montgomery limbs of G1 points; Q an affine twist point ((x0, x1),
    (y0, y1)) of (B, L) limbs. The addition runs where the loop's static
    bit is set (fabric_tpu computes it on every step and selects it by
    the bit: the same limbs)."""
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
    return f


def miller_loop_batch(xP, yP, Q, loop: int = ref.X_BLS, mask=None):
    """f_{loop,Q}(P) per lane, and Fp12 one on lanes whose `mask` (B,)
    bool is False (None: every lane live): the plain version on CPU
    tensors, csrc/bls12_381_pairing.cu's Miller entry on CUDA tensors
    (one launch, a warp a lane). Returns the Fp12 value as nested tuples
    of (B, L) tensors."""
    global miller_launches
    flat = [xP, yP, Q[0][0], Q[0][1], Q[1][0], Q[1][1]]
    B = xP.shape[0]
    if mask is None:
        mask = torch.ones(B, dtype=torch.bool, device=xP.device)
    kernels.check_args(xP, [(f"p{i}", t, (B, L), _I32)
                            for i, t in enumerate(flat)]
                       + [("mask", mask, (B,), (torch.bool,))],
                       "BLS12-381 Miller")
    if xP.device.type == "cpu":
        f = miller_loop_plain(xP, yP, Q, loop)
        return tower.select_f12(mask, f, f12_one_like(xP))
    bits = bin(loop)[3:]
    if not 1 <= len(bits) <= 64:
        raise ValueError("the Miller kernel takes a loop of 2..65 bits")
    rest = int(bits, 2)
    out = torch.empty((12, B, L), dtype=torch.int32, device=xP.device)
    kernels.launch(xP.device, _LIB, "bls_miller_launch", torch.stack(flat),
                   mask, kernel_consts(xP.device), out, B, rest & 0xFFFFFFFF,
                   rest >> 32, len(bits))
    miller_launches += 1
    return tower.f12_from_flat(out)


# ---------------------------------------------------------------------------
# Product reduce
# ---------------------------------------------------------------------------

def _check_pow2(B: int, what: str) -> None:
    if B < 1 or B & (B - 1):
        raise ValueError(f"{what} needs a power-of-two lane count, got {B}")


def product_reduce_plain(f):
    """fabric_tpu's _product_reduce: the (B, L) lanes (B a power of two)
    multiplied into one (1, L) lane by halving, f12_mul(lo, hi) a
    level."""
    n = f[0][0][0].shape[0]
    while n > 1:
        half = n // 2
        lo = tuple(tuple((c[0][:half], c[1][:half]) for c in h) for h in f)
        hi = tuple(tuple((c[0][half:], c[1][half:]) for c in h) for h in f)
        f = f12_mul(lo, hi)
        n = half
    return f


def product_reduce(f):
    """The lanes' product as one lane, by halving: the plain version on
    CPU tensors; on CUDA tensors the reduce entry, one launch a level
    (log2(B) in all) on a copy of the lanes. Returns nested tuples of
    (1, L) tensors."""
    global reduce_launches
    flat = tower.flat_from_f12(f)
    B = flat.shape[1]
    kernels.check_args(flat, [("f", flat, (12, B, L), _I32)],
                       "BLS12-381 product reduce")
    _check_pow2(B, "BLS12-381 product reduce")
    if flat.device.type == "cpu":
        return product_reduce_plain(f)
    buf = flat.clone(memory_format=torch.contiguous_format)
    consts = kernel_consts(flat.device)
    half = B // 2
    while half:
        kernels.launch(flat.device, _LIB, "bls_reduce_launch", buf, consts,
                       B, half)
        reduce_launches += 1
        half //= 2
    return tower.f12_from_flat(buf[:, :1].contiguous())


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------

def final_exp_program(u: int = ref.X_BLS) -> np.ndarray:
    """Registers: 0=f (input), 1=inv_f (input), 2=m, 3=t0, 4=y1,
    5=y2, 6/7=scratch. Mirrors ref.final_exponentiation_chain
    instruction for instruction (fabric_tpu's program, row for row);
    `u` is overridable so tests can run the register machine on short
    chains."""
    A = tower.Asm()
    # easy part: m = frob^2(f^(p^6-1)) * f^(p^6-1)
    A.conj(2, 0)                 # m <- conj(f)
    A.mul(2, 2, 1)               # m <- conj(f)*inv(f) = f^(p^6-1)
    A.frob(6, 2)
    A.frob(6, 6)                 # t <- m^(p^2)
    A.mul(2, 6, 2)               # m <- m^(p^2+1)
    # hard part (HHT chain, x = -u)
    A.pow_static(3, 2, 6, u)
    A.mul(3, 3, 2)               # t0 = m^u * m         = m^-(x-1)
    A.pow_static(4, 3, 6, u)
    A.mul(4, 4, 3)               # y1 = t0^u * t0       = m^((x-1)^2)
    A.pow_static(5, 4, 6, u)
    A.conj(5, 5)                 # conj(y1^u)           = y1^x
    A.frob(6, 4)
    A.mul(5, 5, 6)               # y2 = y1^x * frob(y1) = y1^(x+p)
    A.pow_static(0, 5, 6, u)     # y2^u  (f no longer needed)
    A.pow_static(1, 0, 6, u)     # y2^(u^2) = y2^(x^2)  (inv_f done)
    A.frob(6, 5)
    A.frob(6, 6)                 # frob^2(y2)
    A.mul(1, 1, 6)
    A.conj(6, 5)                 # y2^-1
    A.mul(1, 1, 6)               # y3 = y2^(x^2+p^2-1)
    A.sqr(6, 2)
    A.mul(6, 6, 2)               # m^3
    A.mul(0, 1, 6)               # result = y3 * m^3
    return A.program()


_FINAL_EXP_PROGRAM = final_exp_program()

EASY_LAST = tower.EASY_LAST
cyclotomic_row = tower.cyclotomic_row


def final_exp_plain(f, program=_FINAL_EXP_PROGRAM):
    """The register machine in plain torch, every squaring from
    `cyclotomic_row(program)` on a cyclotomic squaring, as the card's
    entry runs it."""
    return _T.run_final_exp(f, program, cyc_from=cyclotomic_row(program))


def _final_exp_kernel(flat, program):
    """The final-exp entry on (12, B, L) lanes -> (GT (12, B, L), is-one
    (B,)): a warp a lane, squarings from cyclotomic_row(program) on
    cyclotomic."""
    global final_exp_launches
    dev = flat.device
    B = flat.shape[1]
    prog = torch.as_tensor(np.ascontiguousarray(program, np.int32),
                           device=dev)
    gt = torch.empty((12, B, L), dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    kernels.launch(dev, _LIB, "bls_final_exp_launch", flat.contiguous(),
                   kernel_consts(dev), prog, int(prog.shape[0]),
                   cyclotomic_row(program), gt, ok, B)
    final_exp_launches += 1
    return gt, ok


def final_exp_batch(f, program: np.ndarray | None = None):
    """The final exponentiation (by default the HHT chain, = fast^3):
    CPU tensors run the plain register machine (final_exp_plain), CUDA
    tensors the final-exp entry, a warp a lane."""
    if program is None:
        program = _FINAL_EXP_PROGRAM
    flat = tower.flat_from_f12(f)
    B = flat.shape[1]
    kernels.check_args(flat, [("f", flat, (12, B, L), _I32)],
                       "BLS12-381 final exponentiation")
    if flat.device.type == "cpu":
        return final_exp_plain(f, program)
    return tower.f12_from_flat(_final_exp_kernel(flat, program)[0])


# ---------------------------------------------------------------------------
# Pair products: Miller -> mask -> reduce -> ONE final exponentiation
# ---------------------------------------------------------------------------

def pairs_product_is_one_plain(xP, yP, qx0, qx1, qy0, qy1, mask,
                               loop: int = ref.X_BLS):
    """fabric_tpu's pairs_product_is_one in plain torch."""
    f = miller_loop_plain(xP, yP, ((qx0, qx1), (qy0, qy1)), loop=loop)
    f = tower.select_f12(mask, f, f12_one_like(xP))
    f = product_reduce_plain(f)
    return gt_is_one(final_exp_plain(f))


def pairs_product_is_one(xP, yP, qx0, qx1, qy0, qy1, mask,
                         loop: int = ref.X_BLS):
    """prod_i e(P_i, Q_i)^-1 == 1 for ONE aggregate-verify call: (B, L)
    Montgomery limbs (B a power of two; padded lanes hold any valid
    points with mask False and contribute one), mask (B,) bool. Returns a
    (1,) bool. CPU tensors: the plain version; CUDA tensors: one Miller
    launch, log2(B) reduce launches and one final-exp launch on the
    product's one lane, whose verdict is the result."""
    _check_pow2(xP.shape[0], "BLS12-381 pairs product")
    if xP.device.type == "cpu":
        return pairs_product_is_one_plain(xP, yP, qx0, qx1, qy0, qy1, mask,
                                          loop)
    f = miller_loop_batch(xP, yP, ((qx0, qx1), (qy0, qy1)), loop=loop,
                          mask=mask)
    f = tower.flat_from_f12(product_reduce(f))
    return _final_exp_kernel(f, _FINAL_EXP_PROGRAM)[1]


# ---------------------------------------------------------------------------
# Host staging + readback
# ---------------------------------------------------------------------------

def stage_pairs(pairs, pad_to: int | None = None):
    """[(g1_point, g2_twist_point) ints] (the bls12_381.stage_pairs
    output) -> (xP, yP, qx0, qx1, qy0, qy1, mask) numpy limb arrays,
    padded to `pad_to` lanes (next power of two when None) with masked
    generator pairs."""
    n = len(pairs)
    assert n >= 1
    if pad_to is None:
        pad_to = 1 << (n - 1).bit_length()
    assert pad_to >= n and pad_to & (pad_to - 1) == 0
    filler = (ref.G1, (ref.G2_X, ref.G2_Y))
    padded = list(pairs) + [filler] * (pad_to - n)
    xP = np.stack([F.to_mont(p[0]) for p, _ in padded])
    yP = np.stack([F.to_mont(p[1]) for p, _ in padded])
    qx0 = np.stack([F.to_mont(q[0][0]) for _, q in padded])
    qx1 = np.stack([F.to_mont(q[0][1]) for _, q in padded])
    qy0 = np.stack([F.to_mont(q[1][0]) for _, q in padded])
    qy1 = np.stack([F.to_mont(q[1][1]) for _, q in padded])
    mask = np.zeros(pad_to, dtype=bool)
    mask[:n] = True
    return xP, yP, qx0, qx1, qy0, qy1, mask


def to_device(staged, device):
    """stage_pairs' arrays -> tensors on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in staged)


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


def verify_pairs(pairs, loop: int = ref.X_BLS, device=None) -> bool:
    """Stage, run `pairs_product_is_one` on `device` (cuda:0 unless the
    caller passes another; raises without CUDA), read the verdict (the
    provider dispatches the same functions itself)."""
    dev = torchenv.resolve_device(device)
    out = pairs_product_is_one(*to_device(stage_pairs(pairs), dev),
                               loop=loop)
    return bool(out.cpu()[0])


# ---------------------------------------------------------------------------
# The kernels' constants and self-tests (csrc/bls12_381_pairing.cu)
# ---------------------------------------------------------------------------

R384 = 1 << 384
NW = 12                             # 32-bit words a value on the card
N_CONSTS = 4 * NW + 7 * 2 * NW + 2


def _m384(v: int) -> list[int]:
    return limb.ints_to_words([v % ref.P * R384 % ref.P], NW)


def consts_words() -> np.ndarray:
    """The kernels' BlsConsts (csrc/bls12_381_tower.cuh) as uint32 words:
    mont one, R^2, the domain factors into and out of R = 2^384 (2^378
    and 2^390 mod p), b3' and gamma_0..5 in Montgomery form, and xi's two
    small ints."""
    P = ref.P
    w = limb.ints_to_words([R384 % P, R384 * R384 % P, pow(2, 378, P),
                            pow(2, 390, P)], NW)
    w += _m384(_B3_TW[0]) + _m384(_B3_TW[1])
    for g in _GAMMA:
        w += _m384(g[0]) + _m384(g[1])
    w += [ref.XI[0], ref.XI[1]]
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


FP_OUT = 6 * NW


def fp_selftest_plain(a, b):
    """Python ints, the reference of csrc/bls12_381_field.cuh: a, b (n, 12)
    little-endian 32-bit words (values below 2p) -> (n, 72) int64
    canonical words of a mod p, a + b, a - b, a * b, a^-1 (0 for 0) and
    a mod p again (the value through the 13-bit layout)."""
    P = ref.P
    rows = []
    for ra, rb in zip(a.tolist(), b.tolist()):
        x, y = limb.words_to_ints(ra, NW)[0], limb.words_to_ints(rb, NW)[0]
        rows.append(limb.ints_to_words([x % P, (x + y) % P, (x - y) % P,
                                        x * y % P, pow(x, P - 2, P), x % P],
                                       NW))
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
            *tower.flat_from_f12(f12_frob(x)),
            *tower.flat_from_f12(f12_inv(x)),
            *[c for p in Td for c in p], *tower.flat_from_f12(ld),
            *[c for p in Ta for c in p], *tower.flat_from_f12(la),
            *[c for p in _T.g2_dbl(T) for c in p],
            *[c for p in _T.g2_add_mixed(T, Q) for c in p]]
    assert len(outs) == TOWER_OUT
    return [[F.from_limbs(o[i].numpy()) for o in outs] for i in range(n)]


def tower_selftest_plain(cases):
    """The plain tower on the cases of tower_selftest: cases (n, 432)
    int32 words (36 plain values a case) -> (n, 12 * TOWER_OUT) int64
    canonical words."""
    vals = [limb.words_to_ints(r, NW) for r in cases.tolist()]
    rows = [limb.ints_to_words(r, NW) for r in _tower_cases_plain(vals)]
    return torch.tensor(rows, dtype=torch.int64).reshape(-1,
                                                         NW * TOWER_OUT)


def _selftest(fn: str, plain, width: int, *xs):
    n = xs[0].shape[0]
    kernels.check_args(xs[0], [(f"x{i}", x, (n, x.shape[1]), _I32)
                               for i, x in enumerate(xs)], "self-test")
    if xs[0].device.type == "cpu":
        return plain(*xs)
    out = torch.empty((n, width), dtype=torch.int32, device=xs[0].device)
    kernels.launch(xs[0].device, _LIB, fn, *xs,
                   kernel_consts(xs[0].device), n, out)
    return out.to(torch.int64) & 0xFFFFFFFF


def fp_selftest(a, b):
    """The 381-bit core on the cases of fp_selftest_plain (a, b (n, 12)
    int32 words): CPU tensors run the plain version, CUDA tensors
    csrc/bls12_381_pairing.cu's entry (the nvcc build of
    bls12_381_field.cuh)."""
    return _selftest("bls_fp_selftest_launch", fp_selftest_plain, FP_OUT,
                     a, b)


def tower_selftest(cases):
    """csrc/bls12_381_tower.cuh on the cases of tower_selftest_plain
    (cases (n, 432) int32 words): CPU tensors run the plain tower, CUDA
    tensors bls12_381_pairing.cu's entry."""
    return _selftest("bls_tower_selftest_launch", tower_selftest_plain,
                     NW * TOWER_OUT, cases)


# the cooperative layer's self-test case: x, y (Fp12, 12 values each), a
# line's A, B, C (6) and c (Fp12, 12: cyclotomic) = 42 values; outputs,
# canonical: x^2 by the serial f12_sqr and by the group, x * line by
# f12_mul_line and by the group, c^2 by f12_sqr_cyclotomic and by the
# group, the group's x * y, 1/x and x^p, and the inverse of x's first
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
    """The plain tower on the cases of coop_selftest: cases (n, 504) int32
    words (42 plain values a case) -> (n, 12 * COOP_OUT + COOP_CYCLES)
    int64 canonical words, the cycle words 0."""
    vals = [limb.words_to_ints(r, NW) for r in cases.tolist()]
    rows = [limb.ints_to_words(r, NW) + [0] * COOP_CYCLES
            for r in _T.coop_selftest_rows(vals)]
    return torch.tensor(rows, dtype=torch.int64).reshape(
        -1, NW * COOP_OUT + COOP_CYCLES)


def coop_selftest(cases):
    """csrc/pairing_coop.cuh and the serial formulas it distributes on the
    cases of coop_selftest_plain (cases (n, 504) int32 words): CPU tensors
    run the plain tower, CUDA tensors bls12_381_pairing.cu's entry, a
    warp a case. The last COOP_CYCLES words of a row are the card's clock
    cycles (COOP_CYCLE_NAMES; 0 on the CPU)."""
    return _selftest("bls_coop_selftest_launch", coop_selftest_plain,
                     NW * COOP_OUT + COOP_CYCLES, cases)


# ---------------------------------------------------------------------------
# The cooperative entries' critical paths (csrc/pairing_coop.cuh)
# ---------------------------------------------------------------------------

GROUP = 32


def miller_products(loop: int = ref.X_BLS, group: int = GROUP
                    ) -> tuple[int, int]:
    """(chain, executed) Fp products of a Miller lane on the Miller
    entry's group (tower.coop_miller_products: one point, no correction
    steps)."""
    return tower.coop_miller_products(loop, 1, group)


def final_exp_products(program=_FINAL_EXP_PROGRAM, group: int = GROUP
                       ) -> tuple[int, int]:
    """(chain, executed) Fp products of a final-exp lane on the entry's
    group (tower.coop_final_exp_products, one term)."""
    return tower.coop_final_exp_products(program, 1, group)
