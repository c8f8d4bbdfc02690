"""Montgomery modular arithmetic on 13-bit limb tensors.

Port of fabric_tpu/ops/mont.py `MontMod`, for the fields whose prime
`limb.Mod`'s fold at 2^256 does not serve: 2^255 - 19 (Ed25519, below
2^255), BN254's dense 254-bit p (the pairing tower, ops/tower.py) and
BLS12-381's 381-bit p. All use word-level Montgomery reduction (REDC)
over the limb layout `limb.layout_for_bits` derives from the modulus
width, as the JAX class does: 20 limbs (R = 2^260) for the 251..258-bit
moduli, 30 limbs (R = 2^390) for BLS12-381. Every operation follows the
JAX class step for step, so results agree limb for limb.

Value discipline (R = 2^(13 L), 4m < R):
  * every value is kept below 2m with limbs in [0, 2^13];
  * mul: T = a*b < 4m^2 < m*R, so one REDC pass returns a value below 2m
    (one conditional subtraction of 2m); column sums stay below 2^31;
  * add: a + b < 4m, one conditional subtraction of 2m;
  * sub: a + off4m - b, with 4m redistributed so that every limb covers
    the limb of any carried value below 2m; below 6m, two conditional
    subtractions of 2m.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fabric_tpu_torch.ops import limb
from fabric_tpu_torch.ops.limb import MASK, W, carry3, mul_columns


class MontMod:
    """Montgomery context for an odd modulus m. `layout` pins the limb
    geometry; None derives the smallest layout covering the modulus
    (`limb.layout_for_bits`: 20 limbs for 251..258 bits, 30 for
    BLS12-381's p). A layout too narrow for 4m < R raises ValueError, as
    one past the int32 column bound does in `limb.LimbLayout`."""

    def __init__(self, m: int, layout: limb.LimbLayout | None = None):
        if m < 3 or m % 2 == 0:
            raise ValueError("MontMod needs an odd modulus >= 3")
        if layout is None:
            layout = limb.layout_for_bits(m.bit_length())
        if 4 * m >= 1 << (layout.W * layout.L):
            raise ValueError(
                f"modulus is too wide for {layout!r}: REDC needs 4m < R")
        self.layout = layout
        self.L = layout.L
        self.m = m
        self.R = 1 << (W * self.L)
        self.m_limbs = limb.int_to_limbs(m, self.L)
        self.two_m_limbs = limb.int_to_limbs(2 * m, self.L)
        self.mprime = (-pow(m, -1, 1 << W)) % (1 << W)
        self.r_mod_m = self.R % m               # mont(1)
        self.r2_mod_m = (self.R * self.R) % m   # to-mont factor
        # 4m redistributed: limbs 0..L-2 gain 2<<W, limbs 1..L-1 lose 2,
        # so every limb dominates the limb of any carried subtrahend < 2m
        off = limb.int_to_limbs(4 * m, self.L).astype(np.int64)
        off[: self.L - 1] += 2 << W
        off[1:] -= 2
        if not ((off[: self.L - 1] >= 1 << W).all()
                and off[self.L - 1] > (2 * m) >> (W * (self.L - 1))):
            raise ValueError("modulus shape unsupported (sub offsets)")
        if limb.limbs_to_int(off) != 4 * m:
            raise ValueError("internal: sub_off redistribution broken")
        self.sub_off = off.astype(np.int32)
        self._dev: dict = {}

    def const(self, name: str, device, width: int | None = None):
        """Constant `name` as an int32 tensor on `device`, zero-padded to
        `width` limbs (cached)."""
        key = (name, str(device), width)
        t = self._dev.get(key)
        if t is None:
            a = np.asarray(getattr(self, name), np.int32)
            if width is not None:
                a = np.pad(a, (0, width - len(a)))
            t = self._dev[key] = torch.as_tensor(a, device=device)
        return t

    # -- host converters --

    def to_mont(self, x: int) -> np.ndarray:
        """Python int -> canonical limbs of x*R mod m."""
        return limb.int_to_limbs((x % self.m) * self.R % self.m, self.L)

    def from_limbs(self, a) -> int:
        """Montgomery-domain limbs -> plain Python int (for tests)."""
        return limb.limbs_to_int(a) * pow(self.R, -1, self.m) % self.m

    # -- tensor ops --

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """mont(a*b) = a*b*R^-1 mod m: inputs below 2m with 13-bit limbs;
        output likewise."""
        L = self.L
        # width 2L+2, a fresh tensor: the REDC steps update it in place
        acc = carry3(F.pad(mul_columns(a, b), (0, 2)))
        m_l = self.const("m_limbs", a.device)
        for i in range(L):
            u = (acc[..., i] * self.mprime) & MASK
            acc[..., i:i + L] += u[..., None] * m_l
            acc[..., i + 1] += acc[..., i] >> W
        out = carry3(acc[..., L:])                       # width L+2
        return self._cond_sub_2m(out)[..., :L]

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = carry3(F.pad(a + b, (0, 1)))
        return self._cond_sub_2m(s)[..., :self.L]

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = a + self.const("sub_off", a.device) - b
        s = carry3(F.pad(s, (0, 1)))
        return self._cond_sub_2m(self._cond_sub_2m(s))[..., :self.L]

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def _cond_sub_2m(self, x: torch.Tensor) -> torch.Tensor:
        """x < 4m (any width >= L, carried limbs) -> x - 2m in strict
        limbs when x >= 2m, else x. The JAX class borrows limb by limb;
        here the borrow runs over 52-bit chunks (`_borrow_sub`), which
        gives the same limbs in a quarter of the steps."""
        sub, ge = _borrow_sub(x, self.two_m_limbs)
        return torch.where(ge[..., None], sub, x)

    def canonical(self, a: torch.Tensor) -> torch.Tensor:
        """A value below 2m -> [0, m) in strict limbs (equality checks)."""
        x, _ = _borrow_sub(a, np.zeros(1, np.int32))     # limb.full_carry
        sub, ge = _borrow_sub(x, self.m_limbs)
        return torch.where(ge[..., None], sub, x)


# a chunk of 4 limbs: 52 bits, so a chunk of limbs up to 2^13 and its
# borrow fit an int64; a width that is not a multiple of 4 (30 limbs, or
# 31 in `add` at L = 30) pads its last chunk with zero limbs
_CH = 4
_CW = W * _CH
_SHIFTS = torch.arange(0, _CW, W, dtype=torch.int64)


def _borrow_sub(x: torch.Tensor, m) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., n) limbs in [0, 2^13] minus the constant limbs m (numpy,
    at most n of them): the strict 13-bit limbs of (x - m) mod 2^(13n),
    int32, and whether x >= m. Equal limb for limb to the sequential
    borrow of fabric_tpu's `_cond_sub_2m` and `canonical` (both are the
    unique strict form of the same residue; the final borrow is the sign
    of x - m, as |x - m| < 2^(13n)), with the borrow carried over 52-bit
    chunks instead of limbs."""
    n = x.shape[-1]
    k = -(-n // _CH)
    mm = np.zeros(k * _CH, np.int64)
    mm[:len(m)] = m
    shifts = _SHIFTS.to(x.device)
    xc = (F.pad(x.to(torch.int64), (0, k * _CH - n))
          .reshape(x.shape[:-1] + (k, _CH)) << shifts).sum(dim=-1)
    d = xc - torch.as_tensor((mm.reshape(k, _CH) << np.arange(0, _CW, W))
                             .sum(axis=1), device=x.device)
    outs = []
    c = torch.zeros_like(d[..., 0])
    for i in range(k):
        t = d[..., i] + c
        outs.append(t & ((1 << _CW) - 1))
        c = t >> _CW                                     # borrow = -1
    limbs = (torch.stack(outs, dim=-1)[..., None] >> shifts) & MASK
    return (limbs.reshape(x.shape[:-1] + (k * _CH,))[..., :n]
            .to(torch.int32), c >= 0)
