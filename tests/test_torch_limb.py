"""fabric_tpu_torch.ops.limb against fabric_tpu.ops.limb, limb for limb.

The same numpy inputs (seeded) go through the JAX functions on the CPU
and the port's torch functions on CPU tensors. Integer arithmetic:
the tolerance is exact equality, semi-reduced limbs included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.ops import limb as jlimb
from fabric_tpu.ops import p256 as jp256

from fabric_tpu_torch.ops import limb as tlimb
from fabric_tpu_torch.ops import p256 as tp256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P, N = jp256.P, jp256.N
TOP = (1 << 256) - 1                  # semi-reduced, not canonical


def _operands(m: int, seed: int):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "big") % m for _ in range(12)]
    edge = [0, 1, m - 1, P - 1, N - 1, TOP]
    a = edge + rand + edge[::-1]
    b = edge[::-1] + rand[::-1] + edge
    return jlimb.ints_to_limbs(a), jlimb.ints_to_limbs(b)


def _jax(x):
    return np.asarray(x)


def _torch(x):
    return x.numpy()


@pytest.mark.parametrize("mod", ["FP", "FN"])
@pytest.mark.parametrize("op", ["mulmod", "addmod", "submod"])
def test_mod_op_matches_jax(mod, op):
    jm, tm = getattr(jp256, mod), getattr(tp256, mod)
    a, b = _operands(jm.m, seed=["FP", "FN"].index(mod) * 10
                      + ["mulmod", "addmod", "submod"].index(op))
    want = _jax(getattr(jm, op)(jnp.asarray(a), jnp.asarray(b)))
    got = _torch(getattr(tm, op)(torch.as_tensor(a), torch.as_tensor(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _torch(tm.canonical(torch.as_tensor(got))),
        _jax(jm.canonical(jnp.asarray(want))))
    ref = {"mulmod": lambda x, y: x * y, "addmod": lambda x, y: x + y,
           "submod": lambda x, y: x - y}[op]
    for i in range(len(a)):
        assert jlimb.limbs_to_int(got[i]) % jm.m == \
            ref(jlimb.limbs_to_int(a[i]), jlimb.limbs_to_int(b[i])) % jm.m


@pytest.mark.parametrize("mod", ["FP", "FN"])
def test_canonical_matches_jax(mod):
    jm, tm = getattr(jp256, mod), getattr(tp256, mod)
    a, _ = _operands(jm.m, seed=11)
    np.testing.assert_array_equal(_torch(tm.canonical(torch.as_tensor(a))),
                                  _jax(jm.canonical(jnp.asarray(a))))


def test_carries_and_columns_match_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 30, size=(16, 42), dtype=np.int32)
    np.testing.assert_array_equal(_torch(tlimb.carry3(torch.as_tensor(x))),
                                  _jax(jlimb.carry3(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _torch(tlimb.full_carry(torch.as_tensor(x))),
        _jax(jlimb.full_carry(jnp.asarray(x))))
    a = rng.integers(0, (1 << 13) + 1, size=(16, 20), dtype=np.int32)
    b = rng.integers(0, (1 << 13) + 1, size=(16, 20), dtype=np.int32)
    np.testing.assert_array_equal(
        _torch(tlimb.mul_columns(torch.as_tensor(a), torch.as_tensor(b))),
        _jax(jlimb.mul_columns(jnp.asarray(a), jnp.asarray(b))))


def test_byte_and_word_conversions_match_jax():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
    raw[0] = 0
    raw[1] = 255
    want = jlimb.be_bytes_to_limbs(raw)
    np.testing.assert_array_equal(tlimb.be_bytes_to_limbs_np(raw), want)
    np.testing.assert_array_equal(
        _torch(tlimb.be_bytes_to_limbs(torch.as_tensor(raw))), want)
    np.testing.assert_array_equal(
        _jax(jlimb.be_bytes_to_limbs_jnp(jnp.asarray(raw))), want)
    words = rng.integers(0, 1 << 32, size=(24, 8), dtype=np.uint64) \
        .astype(np.uint32)
    words[0] = 0xFFFFFFFF
    np.testing.assert_array_equal(
        _torch(tlimb.words_be_to_limbs(
            torch.as_tensor(words.astype(np.int64)))),
        _jax(jlimb.words_be_to_limbs(jnp.asarray(words))))


def test_limbs_to_be_bytes_inverts_jax_conversion():
    """limbs_to_be_bytes undoes the JAX package's be_bytes_to_limbs on
    every byte value at every position, 0 and 2^256 - 1 included."""
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
    raw[0] = 0
    raw[1] = 255
    raw[2] = np.arange(32)
    back = tlimb.limbs_to_be_bytes(torch.as_tensor(
        jlimb.be_bytes_to_limbs(raw)))
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), raw)


def test_int_converters_match_jax():
    xs = [0, 1, P - 1, N - 1, TOP, (1 << 260) - 1]
    np.testing.assert_array_equal(tlimb.ints_to_limbs(xs),
                                  jlimb.ints_to_limbs(xs))
    for x in xs:
        assert tlimb.limbs_to_int(tlimb.int_to_limbs(x)) == x
        assert tlimb.limbs_to_int(torch.as_tensor(tlimb.int_to_limbs(x))) == x
    for bad in (-1, 1 << 260):
        with pytest.raises(ValueError):
            tlimb.int_to_limbs(bad)
        with pytest.raises(ValueError):
            jlimb.int_to_limbs(bad)


@pytest.mark.parametrize("m", [(1 << 255) - 19, 1 << 255, (1 << 255) + 1,
                               1 << 256])
def test_mod_preconditions_raise_like_jax(m):
    with pytest.raises(ValueError):
        jlimb.Mod(m)
    with pytest.raises(ValueError):
        tlimb.Mod(m)


def test_mod_constants_match_jax():
    for jm, tm in ((jp256.FP, tp256.FP), (jp256.FN, tp256.FN)):
        for name in ("m_limbs", "c256", "fold_hi", "sub_off"):
            np.testing.assert_array_equal(getattr(tm, name),
                                          getattr(jm, name))
