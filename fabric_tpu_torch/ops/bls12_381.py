"""BLS12-381 aggregate verification — the staged host path.

The port's copy of fabric_tpu/ops/bls12_381.py. One aggregate-verify
call is cut into three stages, the shape the card's path shares:

  * `stage_pairs`: the structural and subgroup gates, then the flat pair
    list [(g1_point, g2_twist_point), ...] whose pairing product must be
    one: e(agg_sig, -G2) * prod_i e(H(m_i), pk_i);
  * `miller_products`: one Miller loop a pair, accumulated into one Fp12
    product (on the card: ops/bls12_381_kernel.py's Miller entry and
    product reduce over every pair at once);
  * `check_products`: ONE final exponentiation a call, whatever the
    number of pairs.

`CUDAProvider.verify_aggregate` stages every call here and serves the
pair lists under its host cutoff (and every call with `BLSPairing` off)
with `miller_products` and `check_products`; the rest go to the card.
Verdicts equal `bls12_381_ref.aggregate_verify`'s, which computes the
same predicate through its own code.
"""

from __future__ import annotations

from typing import Optional, Sequence

from fabric_tpu_torch.ops import bls12_381_ref as bref


def stage_pairs(pks: Sequence, msgs: Sequence[bytes], agg_sig
                ) -> Optional[list]:
    """Flatten one aggregate-verify call into the pairing-product pair
    list [(g1_point, g2_twist_point), ...] whose product must be ONE:
    e(agg_sig, -G2) * prod_i e(H(m_i), pk_i). Returns None when an
    input fails the structural or subgroup gates (the verdict is False
    without a pairing)."""
    if agg_sig is None or len(pks) != len(msgs) or not len(pks):
        return None
    if not bref.g1_in_subgroup(agg_sig):
        return None
    pairs = [(agg_sig, bref.g2_neg((bref.G2_X, bref.G2_Y)))]
    for pk, msg in zip(pks, msgs):
        if pk is None or not bref.g2_in_subgroup(pk):
            return None
        pairs.append((bref.hash_to_g1(msg), pk))
    return pairs


def miller_products(pairs) -> tuple:
    """The Miller stage: one loop a pair, accumulated into a single Fp12
    product."""
    f = bref.F12_ONE
    for p, q in pairs:
        f = bref.f12_mul(f, bref.miller_loop(q, p))
    return f


def check_products(f) -> bool:
    """ONE final exponentiation for the whole call."""
    return bref.final_exponentiation_fast(f) == bref.F12_ONE


def aggregate_verify(pks, msgs, agg_sig) -> bool:
    """The staged pipeline end to end: gates and staging, the Miller
    stage, one final exponentiation. Verdict-identical to
    `bls12_381_ref.aggregate_verify`."""
    pairs = stage_pairs(pks, msgs, agg_sig)
    if pairs is None:
        return False
    return check_products(miller_products(pairs))
