"""The port's pairing tower (fabric_tpu_torch/ops/tower.py, BN254's
instance ops/bn254._T) against fabric_tpu.ops.bn254._T, limb for limb.

Every method runs on the same seeded limbs (B = 3 lanes) in both and must
return identical limb tensors. The JAX tower runs eagerly; only its four
MontMod primitives (mul, add, sub, canonical) are jit-compiled, once per
shape, for the duration of this module: fully eager, JAX takes seconds
for one f12_mul on a CPU (its REDC loop is a fori_loop, traced anew at
every product). The inversions (fabric_tpu's are lax.scan chains) are held to
Python ints instead, canonically. The final-exp program must equal
fabric_tpu's array, and `run_final_exp` on a short program must equal
the int reference. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.ops import bn254 as jdev

from fabric_tpu_torch.ops import bn254 as dev
from fabric_tpu_torch.ops import bn254_ref as ref
from fabric_tpu_torch.ops import tower

B = 3
P = ref.P


@pytest.fixture(scope="module", autouse=True)
def jit_primitives():
    torch.set_num_threads(1)
    F = jdev.F
    for name in ("mul", "add", "sub", "canonical"):
        setattr(F, name, jax.jit(getattr(type(F), name).__get__(F)))
    yield
    for name in ("mul", "add", "sub", "canonical"):
        delattr(F, name)


RNG = np.random.default_rng(606)


def _ints(n=B):
    return [int.from_bytes(RNG.bytes(32), "big") % P for _ in range(n)]


def _fp():
    return np.stack([dev.F.to_mont(v) for v in _ints()])


def _f2():
    return (_fp(), _fp())


def _f6():
    return (_f2(), _f2(), _f2())


def _f12():
    return (_f6(), _f6())


def _pt():
    return (_f2(), _f2(), _f2())


def _aff():
    return (_f2(), _f2())


def J(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def T(t):
    return jax.tree_util.tree_map(torch.as_tensor, t)


def assert_same(jout, tout):
    lj = jax.tree_util.tree_leaves(jout)
    lt = jax.tree_util.tree_leaves(tout)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# method -> argument makers (numpy trees; ints pass through)
CASES = {
    "f2_add": (_f2, _f2), "f2_sub": (_f2, _f2), "f2_mul": (_f2, _f2),
    "f2_sqr": (_f2,), "f2_scale": (_f2, _fp), "f2_neg": (_f2,),
    "f2_conj": (_f2,), "f2_mul_xi": (_f2,), "f2_small": (_f2, lambda: 8),
    "fp_small": (_fp, lambda: 9), "f6_add": (_f6, _f6),
    "f6_sub": (_f6, _f6), "f6_mul": (_f6, _f6), "f6_mul_v": (_f6,),
    "f12_mul": (_f12, _f12), "f12_sqr": (_f12,), "f12_conj": (_f12,),
    "f12_frob": (_f12,), "f12_one_like": (_fp,),
    "line_to_f12": (_f2, _f2, _f2),
    "g2_dbl_line": (_pt, _fp, _fp), "g2_add_line": (_pt, _aff, _fp, _fp),
    "g2_dbl": (_pt,), "g2_add_mixed": (_pt, _aff), "gt_is_one": (_f12,),
}


@pytest.mark.parametrize("method", sorted(CASES))
def test_tower_method_matches_jax(method):
    args = [mk() for mk in CASES[method]]
    jargs = [a if isinstance(a, int) else J(a) for a in args]
    targs = [a if isinstance(a, int) else T(a) for a in args]
    assert_same(getattr(jdev._T, method)(*jargs),
                getattr(dev._T, method)(*targs))


def test_selects_and_flat_match_jax():
    mask = np.array([True, False, True])
    a, b = _f12(), _f12()
    assert_same(jdev._select_f12(jnp.asarray(mask), J(a), J(b)),
                tower.select_f12(torch.as_tensor(mask), T(a), T(b)))
    p, q = _pt(), _pt()
    assert_same(jdev._select_pt(jnp.asarray(mask), J(p), J(q)),
                tower.select_pt(torch.as_tensor(mask), T(p), T(q)))
    flat = tower.flat_from_f12(T(a))
    assert_same(jdev._flat_from_f12(J(a)), flat)
    assert_same(J(a), tower.f12_from_flat(flat))
    assert_same(jdev._f12_select(True, J(a), J(b)),
                dev._T.f12_select(True, T(a), T(b)))


def test_m_type_line_placement_matches_jax():
    """The M-type slots ((C, B, 0), (0, A, 0)), which BLS12-381 needs,
    on towers built with mtwist=True in both packages."""
    from fabric_tpu.ops import tower as jtower
    jt = jtower.Tower(jdev.F, xi=ref.XI, b3_tw=dev._B3_TW,
                      gammas=dev._GAMMA, mtwist=True)
    tt = tower.Tower(dev.F, xi=ref.XI, b3_tw=dev._B3_TW, gammas=dev._GAMMA,
                     mtwist=True)
    A, B_, C = _f2(), _f2(), _f2()
    assert_same(jt.line_to_f12(J(A), J(B_), J(C)),
                tt.line_to_f12(T(A), T(B_), T(C)))


def _canon_ints(x):
    return [dev.F.from_limbs(r) for r in dev.F.canonical(x).numpy()]


def test_inversions_match_ints():
    """fp_inv .. f12_inv against the int tower, canonically (inverses are
    unique, so any exact formula gives these limbs)."""
    x = _f12()
    ints = dev.f12_from_device(T(x))
    inv = dev._T.f12_inv(T(x))
    assert dev.f12_from_device(inv) == [ref.f12_inv(v) for v in ints]
    c0 = T(x[0][0])
    got = dev._T.f2_inv(c0)
    want = [ref.f2_inv(v[0][0]) for v in ints]
    assert list(zip(_canon_ints(got[0]), _canon_ints(got[1]))) == want
    got6 = dev._T.f6_inv(T(x[0]))
    want6 = [ref.f6_inv(v[0]) for v in ints]
    for j in range(3):
        assert list(zip(_canon_ints(got6[j][0]),
                        _canon_ints(got6[j][1]))) == [w[j] for w in want6]
    assert _canon_ints(dev._T.fp_inv(c0[0])) == [
        pow(v[0][0][0], P - 2, P) for v in ints]


def test_final_exp_program_matches_jax():
    np.testing.assert_array_equal(dev._final_exp_program(),
                                  jdev._FINAL_EXP_PROGRAM)
    assert dev._FINAL_EXP_PROGRAM.dtype == np.int32


def test_run_final_exp_short_program_matches_ints():
    """The register machine on a short program (every op, pow_static,
    registers 0/1 as inputs) against the same chain on ints."""
    A = dev._Asm()
    A.conj(2, 0)
    A.mul(2, 2, 1)                 # f^(p^6 - 1)
    A.frob(6, 2)
    A.mul(2, 6, 2)                 # ^(p + 1)
    A.pow_static(3, 2, 6, 0b1011)
    A.mul(0, 3, 2)
    x = _f12()
    out = dev._T.run_final_exp(T(x), A.program())
    want = []
    for f in dev.f12_from_device(T(x)):
        m = ref.f12_mul(ref.f12_conj(f), ref.f12_inv(f))
        m = ref.f12_mul(ref.f12_frob(m), m)
        want.append(ref.f12_mul(ref.f12_pow(m, 0b1011), m))
    assert dev.f12_from_device(out) == want
