"""The port's copy of the BLS12-381 reference (fabric_tpu_torch/ops/
bls12_381_ref.py) against fabric_tpu.ops.bls12_381_ref.

The same constants, the same hash-to-G1 points, keys, signatures and
aggregates from the same seeds, and the same verdict on one aggregate
verify (valid and forged), and the port's staged host path
(ops/bls12_381.py) against the JAX package's. Tolerance: exact ints.
"""

import pytest

from fabric_tpu.ops import bls12_381 as jagg
from fabric_tpu.ops import bls12_381_ref as jref

from fabric_tpu_torch.ops import bls12_381 as tagg
from fabric_tpu_torch.ops import bls12_381_ref as tref

NAMES = ("P", "R", "X_BLS", "H1", "G1", "G2_X", "G2_Y", "B_G1", "XI",
         "F12_ONE")


@pytest.mark.parametrize("name", NAMES)
def test_constants_equal(name):
    assert getattr(tref, name) == getattr(jref, name)


@pytest.mark.parametrize("msg", [b"", b"block 1", b"\x00" * 64])
def test_hash_to_g1_equal(msg):
    p = tref.hash_to_g1(msg)
    assert p == jref.hash_to_g1(msg)
    assert tref.on_curve_g1(p)


def test_keygen_sign_aggregate_equal():
    seeds = [b"orderer-1", b"orderer-2"]
    keys = [tref.bls_keygen(s) for s in seeds]
    assert keys == [jref.bls_keygen(s) for s in seeds]
    msgs = [b"span 0", b"span 1"]
    sigs = [tref.bls_sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    assert sigs == [jref.bls_sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    agg = tref.bls_aggregate(sigs)
    assert agg == jref.bls_aggregate(sigs)
    raw = tref.g1_to_bytes(agg)
    assert raw == jref.g1_to_bytes(agg)
    assert tref.g1_from_bytes(raw) == jref.g1_from_bytes(raw) == agg
    pk_raw = tref.g2_to_bytes(keys[0][1])
    assert tref.g2_from_bytes(pk_raw) == jref.g2_from_bytes(pk_raw)


def test_aggregate_verify_equal():
    sk, pk = tref.bls_keygen(b"one identity")
    msgs = [b"b0", b"b1"]
    agg = tref.bls_aggregate([tref.bls_sign(sk, m) for m in msgs])
    for m in (msgs, [b"b0", b"forged"]):
        want = jref.aggregate_verify([pk, pk], m, agg)
        assert want is (m == msgs)
        assert tref.aggregate_verify([pk, pk], m, agg) is want
        pairs = tagg.stage_pairs([pk, pk], m, agg)
        assert pairs == jagg.stage_pairs([pk, pk], m, agg)
        assert tagg.check_products(tagg.miller_products(pairs)) is want
    assert tagg.stage_pairs([pk], msgs, agg) is None      # length mismatch
