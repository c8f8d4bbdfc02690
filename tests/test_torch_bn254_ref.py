"""The port's copy of the BN254 Python-int reference against fabric_tpu's.

fabric_tpu_torch/ops/bn254_ref.py is a copy (the port imports nothing of
fabric_tpu); it must agree with fabric_tpu.ops.bn254_ref exactly: the
constants, the twisted Frobenius (exact and coordinate form), the host
G2 MSM, hash-to-G1, BLS and one bilinearity check of the pairing.
Tolerance: exact integers.
"""

import random

from fabric_tpu.ops import bn254_ref as jref

from fabric_tpu_torch.ops import bn254_ref as ref

G2 = (ref.G2_X, ref.G2_Y)


def test_constants_match():
    for name in ("P", "R", "T_BN", "ATE_LOOP", "G1", "G2_X", "G2_Y", "XI",
                 "F12_ONE", "F12_W2", "F12_W3"):
        assert getattr(ref, name) == getattr(jref, name), name


def test_frobenius_msm_and_hash_match():
    rng = random.Random(61)
    k = rng.randrange(1, ref.R)
    q = ref.g2_mul_fast(k, G2)
    assert q == jref.g2_mul_fast(k, G2)
    assert ref.g2_frobenius(q) == jref.g2_frobenius(q)
    assert ref.g2_frobenius_fast(q) == jref.g2_frobenius(q)
    lane = [(rng.randrange(ref.R), q), (rng.randrange(ref.R), G2),
            (0, None)]
    assert ref.g2_msm(lane) == jref.g2_msm(lane)
    assert ref.g2_in_subgroup(q) and jref.g2_in_subgroup(q)
    for m in (b"", b"idemix", bytes(range(64))):
        assert ref.hash_to_g1(m) == jref.hash_to_g1(m)
    sk, pk = ref.bls_keygen(b"port")
    assert (sk, pk) == jref.bls_keygen(b"port")
    sig = ref.g1_mul_fast(sk, ref.hash_to_g1(b"m"))
    assert sig == ref.bls_sign(sk, b"m") == jref.bls_sign(sk, b"m")


def test_pairing_bilinear_and_equal():
    """e(aP, Q) = e(P, aQ), and the copy's pairing is fabric_tpu's."""
    a = 7
    P1 = ref.G1
    aP = ref.g1_mul_fast(a, P1)
    aQ = ref.g2_mul_fast(a, G2)
    left = ref.pairing(G2, aP)
    assert left == ref.pairing(aQ, P1) == jref.pairing(G2, aP)
    assert left != ref.F12_ONE
    assert ref.final_exponentiation_chain(ref.miller_loop(G2, aP)) == left
