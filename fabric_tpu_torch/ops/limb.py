"""Fixed-limb big-integer modular arithmetic on int32 torch tensors.

Port of fabric_tpu/ops/limb.py with the same layout and the same bounds,
so every later stage can be held against the JAX package limb for limb:

  * a 256-bit integer is a little-endian vector of ``L = 20`` limbs of
    ``W = 13`` bits each, dtype int32, shape ``(..., 20)``;
  * 13-bit limbs make schoolbook products safe in int32: a product
    column accumulates at most 20 terms of (2^13)^2, and
    20 * 2^26 < 2^31;
  * values stay semi-reduced (< 2^256 + eps, limbs in [0, 2^13]); a fold
    at 2^256 (x = hi*2^256 + lo ≡ hi*C + lo mod m) follows every op, and
    canonical form is computed once, for equality checks;
  * subtraction adds a multiple of m redistributed so every limb offset
    is ≥ 2*2^13: intermediate limbs never go negative, so three carry
    rounds always settle.

`LimbLayout` and `layout_for_bits` carry the limb count of a wider
modulus (fabric_tpu's same-named pair): `mont.MontMod` derives 30 limbs
for BLS12-381's 381-bit p from them, with the same int32 column bound.

Where the JAX code accumulates product columns one row at a time, this
port forms the outer product and sums it along anti-diagonals (and the
high-limb fold as one broadcast product): the same integer sums, fewer
eager torch launches. All sums are taken with ``dtype=torch.int32`` —
torch widens integer sums to int64 by default.

SHA-256 digest words travel as int64 masked to 32 bits: torch on the
CPU has no uint32 shift, add, not or compare.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

W = 13                      # bits per limb
L = 20                      # limbs per 256-bit value (13*20 = 260 bits)
MASK = (1 << W) - 1


# ---------------------------------------------------------------------------
# Limb layout (the limb count per modulus width; 13-bit limbs stay)
# ---------------------------------------------------------------------------

class LimbLayout:
    """Limb geometry for one modulus width (fabric_tpu's LimbLayout): the
    20-limb layout above with the limb COUNT a parameter, so that
    BLS12-381's 381-bit field (30 limbs) uses the same carry and multiply
    code. The int32 bound is re-derived per layout: a schoolbook column
    holds at most L terms of (2^W)^2, REDC adds up to L more terms of
    u_i * m_limb into a carried (<= 2^W) limb plus a carry below
    2^(31-W), so

        L * 2^(2W) + 2^(31-W) + 2^W < 2^31,

    which admits L <= 31 at W = 13; a wider layout raises ValueError."""

    def __init__(self, nlimbs: int, w: int = W):
        if nlimbs < 1:
            raise ValueError("LimbLayout needs at least one limb")
        worst = nlimbs * (1 << (2 * w)) + (1 << (31 - w)) + (1 << w)
        if worst >= 1 << 31:
            most = ((1 << 31) - (1 << (31 - w)) - (1 << w)) >> (2 * w)
            raise ValueError(
                f"limb layout L={nlimbs} W={w} overflows int32 column "
                f"accumulation ({worst} >= 2^31); the schoolbook/REDC "
                f"bound admits at most L={most} limbs at W={w}")
        self.W = w
        self.L = nlimbs

    def __repr__(self) -> str:
        return f"LimbLayout(L={self.L}, W={self.W})"


# the 20-limb layout every <= 256-bit field of the port uses
DEFAULT_LAYOUT = LimbLayout(L)


def layout_for_bits(bits: int) -> LimbLayout:
    """The smallest layout whose Montgomery R covers a `bits`-wide odd
    modulus (W*L >= bits + 2): the 20-limb layout for every 251..258-bit
    modulus, 30 limbs for BLS12-381's 381-bit p; widths past ~401 bits
    raise in LimbLayout's int32 bound."""
    if bits < 1:
        raise ValueError("modulus width must be positive")
    n = -(-(bits + 2) // W)          # ceil((bits + 2) / W)
    if n <= DEFAULT_LAYOUT.L:
        return DEFAULT_LAYOUT
    return LimbLayout(n)


# ---------------------------------------------------------------------------
# Host-side converters (numpy; used to stage inputs/constants)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int, n: int = L) -> np.ndarray:
    """Python int -> little-endian canonical limb vector (numpy int32)."""
    if x < 0:
        raise ValueError("negative")
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= W
    if x:
        raise ValueError("value does not fit in limbs")
    return out


def limbs_to_int(a) -> int:
    """Limb vector (any redundant form) -> Python int."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.asarray(a)
    return sum(int(v) << (W * i) for i, v in enumerate(a.tolist()))


def ints_to_words(vals, n: int = 8) -> list[int]:
    """Python ints below 2^(32n) -> their little-endian 32-bit words, n
    each (8 for 256-bit values, 12 for BLS12-381's), concatenated (the
    CUDA cores' layout)."""
    return [(v >> (32 * i)) & 0xFFFFFFFF for v in vals for i in range(n)]


def words_to_ints(words, n: int = 8) -> list[int]:
    """(n*k,) little-endian 32-bit words (any integer type; signed values
    are taken mod 2^32) -> k Python ints of n words each."""
    return [sum((int(w) & 0xFFFFFFFF) << (32 * i)
                for i, w in enumerate(words[j:j + n]))
            for j in range(0, len(words), n)]


def ints_to_limbs(xs, n: int = L) -> np.ndarray:
    """Batch of Python ints -> (B, n) int32 limb array."""
    return np.stack([int_to_limbs(x, n) for x in xs])


def be_bytes_to_limbs_np(raw: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 big-endian 256-bit values -> (B, L) canonical limbs
    (numpy, vectorized)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    B = raw.shape[0]
    bits = np.unpackbits(raw[:, ::-1], axis=1, bitorder="little")
    bits = np.pad(bits, ((0, 0), (0, L * W - 256)))
    weights = (1 << np.arange(W, dtype=np.int32))
    return (bits.reshape(B, L, W) * weights).sum(axis=2, dtype=np.int32)


def be_bytes_to_limbs(raw: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 big-endian -> (B, L) int32 limbs, on the tensor's
    device (the twin of fabric_tpu's `be_bytes_to_limbs_jnp`): the host
    ships 32 B per scalar instead of 80 B of limbs."""
    raw = raw.to(torch.int32)
    B = raw.shape[0]
    k = torch.arange(L * W, device=raw.device)      # 260 bits, top 4 zero
    byte_idx = (31 - k // 8).clamp(0, 31)
    bit_idx = (k % 8).to(torch.int32)
    valid = (k < 256).to(torch.int32)
    bits = ((raw[:, byte_idx] >> bit_idx) & 1) * valid
    weights = (1 << torch.arange(W, dtype=torch.int32, device=raw.device))
    return (bits.reshape(B, L, W) * weights).sum(dim=2, dtype=torch.int32)


def limbs_to_be_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """(B, L) int32 canonical limbs (each below 2^13, value below
    2^256) -> (B, 32) uint8 big-endian rows, the inverse of
    `be_bytes_to_limbs`, on the tensor's device. A byte spans at most
    two limbs."""
    x = limbs.to(torch.int64)
    out = []
    for k in range(31, -1, -1):                     # most significant first
        j0, off = divmod(8 * k, W)
        v = x[:, j0] >> off
        if off + 8 > W:
            v = v | (x[:, j0 + 1] << (W - off))
        out.append(v & 0xFF)
    return torch.stack(out, dim=1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Carry propagation
# ---------------------------------------------------------------------------

def carry3(x: torch.Tensor) -> torch.Tensor:
    """Three vectorized carry rounds: limbs < 2^31 -> limbs in [0, 2^13].

    Requires non-negative limbs. Round 1 leaves limbs ≤ mask + 2^18,
    round 2 ≤ mask + 2^5, round 3 ≤ 2^13: a valid redundant form
    (limb value 2^13 allowed), safe as multiplication input. A round
    moves limb i's carry into limb i+1 in place; the carry out of the
    top limb is dropped.
    """
    for _ in range(3):
        c = x >> W
        x = x & MASK                    # a fresh tensor: add in place
        x[..., 1:].add_(c[..., :-1])
    return x


def full_carry(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry: non-negative limbs -> strict 13-bit limbs
    (a carry out of the top limb is dropped; callers keep values in
    range)."""
    outs = []
    c = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        t = x[..., i] + c
        outs.append(t & MASK)
        c = t >> W
    return torch.stack(outs, dim=-1)


# ---------------------------------------------------------------------------
# Schoolbook multiply
# ---------------------------------------------------------------------------

def mul_columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…, na) x (…, nb) -> (…, na+nb) product columns (no carry).

    Inputs must have limbs ≤ 2^13 (redundant ok): a column holds at most
    L * (2^13)^2 = 20 * 2^26 < 2^31. Column k = sum_i a_i * b_(k-i): the
    outer product's row i is shifted right by i (pad each row by na,
    flatten, drop the tail, re-view with rows one shorter) and summed.
    """
    na, nb = a.shape[-1], b.shape[-1]
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)           # (…, na, nb)
    lead = outer.shape[:-2]
    rows = F.pad(outer, (0, na)).reshape(lead + (na * (na + nb),))
    rows = rows[..., : na * (na + nb - 1)].reshape(lead + (na, na + nb - 1))
    return F.pad(rows.sum(dim=-2, dtype=torch.int32), (0, 1))


# ---------------------------------------------------------------------------
# Modulus context
# ---------------------------------------------------------------------------

class Mod:
    """Precomputed tables for arithmetic mod a 256-bit modulus ``m``.

    Holds numpy constants (moved to each device once, on first use):
      * ``fold_hi``  — (L, L) rows: canonical limbs of 2^(13*(L+k)) mod m;
      * ``c256``     — canonical limbs of 2^256 mod m (fold-at-256);
      * ``sub_off``  — limbs of 4m redistributed so every limb ≥ 2*2^13;
      * ``m_limbs``  — canonical limbs of m.
    """

    def __init__(self, m: int):
        if not (1 << 255) < m < (1 << 256):
            raise ValueError("Mod supports 256-bit moduli")
        self.m = m
        self.m_limbs = int_to_limbs(m)
        self.c256 = int_to_limbs((1 << 256) % m)
        self.fold_hi = np.stack(
            [int_to_limbs(pow(2, W * (L + k), m)) for k in range(L)])
        # 4m redistributed: add 2 units of limb i+1 into limb i, so limbs
        # 0..L-2 gain 16384 and limbs 1..L-1 lose 2 (top limb of 4m is
        # ~2^11, safely ≥ 2)
        off = int_to_limbs(4 * m).astype(np.int64)
        off[: L - 1] += 2 << W
        off[1:] -= 2
        # (a + off - b) ≥ 0 per limb for semi-reduced b: its limbs are
        # ≤ 2^13 except the top limb ≤ 2^10. ValueError, not assert: a
        # wrong-shaped modulus must fail loudly even under python -O.
        if not ((off[: L - 1] >= 1 << W).all() and off[L - 1] >= 1 << 10):
            raise ValueError("modulus shape unsupported (sub offsets)")
        if limbs_to_int(off) != 4 * m:
            raise ValueError("internal: sub_off redistribution broken")
        self.sub_off = off.astype(np.int32)
        # _fold256 places a limb-shifted copy of c256 and needs its top two
        # limbs zero (c256 < 2^234); true for the P-256 prime and order
        if (1 << 256) % m >= (1 << 225):
            raise ValueError("modulus shape unsupported (2^256 mod m too big)")
        self._dev: dict = {}

    def const(self, name: str, device) -> torch.Tensor:
        """Constant `name` as an int32 tensor on `device` (cached)."""
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, name), np.int32),
                                device=device)
            self._dev[key] = t
        return t

    # -- semi-reduction helpers --

    def _fold256(self, x: torch.Tensor) -> torch.Tensor:
        """Fold bits ≥ 256 back in: x ≡ hi*c256 + lo (mod m). Input:
        carried limbs (≤ 2^13) of width L, L+1 or L+2, total value
        < 2^274. Output: width L, value < 2^256 + 2^243."""
        k = x.shape[-1]
        lo = torch.cat([x[..., : L - 1], x[..., L - 1 : L] & 0x1FF], dim=-1)
        h0 = x[..., L - 1] >> 9
        h1 = None
        if k > L:
            h0 = h0 + ((x[..., L] & 0x1FF) << 4)
            h1 = x[..., L] >> 9
            if k > L + 1:
                h1 = h1 + ((x[..., L + 1] & 0x1FF) << 4)
        c256 = self.const("c256", x.device)
        acc = lo + h0.unsqueeze(-1) * c256            # limbs ≤ 2^13 + 2^26
        if h1 is not None:
            # h1 weighs 2^13 more than h0: c256 shifted up one limb (its
            # top two limbs are zero, checked in __init__)
            acc = acc + F.pad(h1.unsqueeze(-1) * c256[: L - 1], (1, 0))
        return carry3(acc)

    def mulmod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Semi-reduced modular multiply: inputs/output limbs ≤ 2^13,
        output value < 2^256 + 2^243."""
        x = carry3(mul_columns(a, b))                 # width 2L, limbs ≤ 2^13
        lo, hi = x[..., :L], x[..., L:]
        fold = self.const("fold_hi", x.device)        # (L, L): [k, i]
        folded = (hi.unsqueeze(-1) * fold).sum(dim=-2, dtype=torch.int32)
        x = carry3(F.pad(lo + folded, (0, 2)))        # width L+2, < 2^274
        x = self._fold256(x)                          # < 2^256 + 2^243
        return self._fold256(x)                       # < 2^256 + 2^226

    def addmod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Semi-reduced add: output < 2^256 + small."""
        return self._fold256(carry3(F.pad(a + b, (0, 1))))

    def submod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Semi-reduced subtract: a - b + 4m, all limbs stay ≥ 0."""
        s = a + self.const("sub_off", a.device) - b
        return self._fold256(carry3(F.pad(s, (0, 1))))

    def canonical(self, a: torch.Tensor) -> torch.Tensor:
        """Semi-reduced -> canonical [0, m), strict 13-bit limbs. The
        value is < 2^256 + 2^243 < 2m, so two conditional subtractions
        reach [0, m)."""
        x = full_carry(a)
        for _ in range(2):
            x = self._cond_sub_m(x)
        return x

    def _cond_sub_m(self, x: torch.Tensor) -> torch.Tensor:
        d = x - self.const("m_limbs", x.device)
        outs = []
        c = torch.zeros_like(x[..., 0])
        for i in range(L):
            t = d[..., i] + c
            outs.append(t & MASK)
            c = t >> W                        # arithmetic shift: borrow = -1
        sub = torch.stack(outs, dim=-1)
        return torch.where((c >= 0).unsqueeze(-1), sub, x)


# ---------------------------------------------------------------------------
# Bit repacking (SHA-256 words -> limbs)
# ---------------------------------------------------------------------------

def words_be_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(…, 8) big-endian 32-bit words (a SHA-256 digest, int64 masked to
    32 bits) -> (…, L) int32 limbs: the digest read as one 256-bit
    big-endian integer, as the reference's ECDSA verify reads it."""
    le = words.to(torch.int64).flip(-1)
    limbs = []
    for i in range(L):
        bit0 = W * i
        j0, s0 = bit0 // 32, bit0 % 32
        v = le[..., j0] >> s0
        if s0 + W > 32 and j0 + 1 < 8:
            v = v | (le[..., j0 + 1] << (32 - s0))
        limbs.append((v & MASK).to(torch.int32))
    return torch.stack(limbs, dim=-1)
