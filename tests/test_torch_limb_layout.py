"""The limb layouts and the 30-limb MontMod of the port against the JAX
package's.

`limb.LimbLayout` / `layout_for_bits` against fabric_tpu.ops.limb's
(limb counts and widths, the int32 column bound's ValueError at L = 32), and
`mont.MontMod` on BLS12-381's 381-bit p (30 limbs, R = 2^390) against
fabric_tpu.ops.mont.MontMod: constants, to_mont, mul, add, sub, neg and
canonical on seeded values below 2p (edge values 0, 1, p - 1, p,
2p - 1 among them), limb for limb. The 20-limb contexts stay as they
were: their constants equal the JAX ones too. JAX runs each primitive
under jax.jit (an eager 30-limb product takes a fraction of a second).
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax

from fabric_tpu.ops import bls12_381_ref as ref
from fabric_tpu.ops import bn254_ref
from fabric_tpu.ops import limb as jlimb
from fabric_tpu.ops import mont as jmont

from fabric_tpu_torch.ops import limb as tlimb
from fabric_tpu_torch.ops import mont as tmont

P = ref.P
ED = (1 << 255) - 19


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bits", [1, 64, 251, 254, 255, 256, 258, 259, 381,
                                  383, 388, 401])
def test_layout_for_bits_matches_jax(bits):
    t, j = tlimb.layout_for_bits(bits), jlimb.layout_for_bits(bits)
    assert (t.L, t.W) == (j.L, j.W)
    assert (t is tlimb.DEFAULT_LAYOUT) == (j == jlimb.DEFAULT_LAYOUT)
    assert tlimb.layout_for_bits(381).L == 30


@pytest.mark.parametrize("n", [0, 32, 40])
def test_layout_bounds_raise_like_jax(n):
    with pytest.raises(ValueError):
        jlimb.LimbLayout(n)
    with pytest.raises(ValueError):
        tlimb.LimbLayout(n)
    assert tlimb.LimbLayout(31).L == jlimb.LimbLayout(31).L == 31
    for mod in (tlimb, jlimb):
        with pytest.raises(ValueError):
            mod.layout_for_bits(0)
        with pytest.raises(ValueError):
            mod.layout_for_bits(402)           # 32 limbs


@pytest.mark.parametrize("m", [P, bn254_ref.P, ED])
def test_montmod_constants_match_jax(m):
    t, j = tmont.MontMod(m), jmont.MontMod(m)
    assert t.L == j.L == (30 if m == P else 20)
    assert t.layout.L == tlimb.layout_for_bits(m.bit_length()).L
    for name in ("m_limbs", "two_m_limbs", "sub_off"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.mprime, t.r_mod_m, t.r2_mod_m, t.R) == (
        j.mprime, j.r_mod_m, j.r2_mod_m, j.R)


def test_montmod_rejects_a_narrow_layout_like_jax():
    for mod, layout in ((tmont, tlimb.DEFAULT_LAYOUT),
                        (jmont, jlimb.DEFAULT_LAYOUT)):
        with pytest.raises(ValueError):
            mod.MontMod(P, layout=layout)
        with pytest.raises(ValueError):
            mod.MontMod(P + 1)


TF, JF = tmont.MontMod(P), jmont.MontMod(P)


def _operands(seed: int):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(48), "big") % (2 * P)
            for _ in range(10)]
    edge = [0, 1, P - 1, P, 2 * P - 1]
    a = edge + rand + edge[::-1]
    b = edge[::-1] + rand[::-1] + edge
    return (tlimb.ints_to_limbs(a, TF.L), tlimb.ints_to_limbs(b, TF.L))


def test_to_mont_and_from_limbs_match_jax():
    rng = np.random.default_rng(30)
    for v in [0, 1, P - 1, P + 5] + [int.from_bytes(rng.bytes(48), "big")
                                     for _ in range(6)]:
        np.testing.assert_array_equal(TF.to_mont(v), JF.to_mont(v))
        assert TF.from_limbs(TF.to_mont(v)) == JF.from_limbs(
            JF.to_mont(v)) == v % P


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_30_limb_op_matches_jax(op):
    a, b = _operands(31)
    got = getattr(TF, op)(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jax.jit(getattr(JF, op))(a, b))
    np.testing.assert_array_equal(got, want)
    r_inv = pow(TF.R, -1, P)
    for i in range(len(a)):
        va, vb = tlimb.limbs_to_int(a[i]), tlimb.limbs_to_int(b[i])
        v = tlimb.limbs_to_int(got[i])
        want_v = {"mul": va * vb * r_inv, "add": va + vb,
                  "sub": va - vb}[op] % P
        assert v % P == want_v and v < 2 * P, i


@pytest.mark.parametrize("op", ["neg", "canonical"])
def test_30_limb_unary_matches_jax(op):
    a, _ = _operands(32)
    got = getattr(TF, op)(torch.as_tensor(a)).numpy()
    want = np.asarray(jax.jit(getattr(JF, op))(a))
    np.testing.assert_array_equal(got, want)
    if op == "canonical":
        assert all(tlimb.limbs_to_int(r) == tlimb.limbs_to_int(v) % P
                   for r, v in zip(got, a))
