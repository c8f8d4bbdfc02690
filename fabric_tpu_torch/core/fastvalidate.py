"""The peer's block fast path up to its signature verdicts, on the card.

The port's counterpart of fabric_tpu/core/fastvalidate.py `validate_fast`
up to and including the resolve of its early dispatch (88-194 and
382-385), and nothing after it: one native pass over the block's
envelope bytes (`native.block_prep`, csrc/blockprep.cpp: the wire-format
parse, the SHA-256 digest lanes, identity dedup, DER staging), each
unique identity resolved once to a verify key by the caller's resolver
(`msp/identity.py`'s over the channel's MSP ids, or the caller's MSP),
the signature lanes assembled exactly as the reference assembles them,
and one `verify_prepared_start` on the provider before the call
returns, so the caller's host work overlaps the card's.

The lanes: every tx whose status is BP_OK_ENDORSER or BP_OK_CONFIG gives
its creator lane (the payload digest), in block order; then every such
tx's endorsement lanes (prp || endorser digests), tx by tx and slot by
slot, keeping the first slot of an endorser that appears twice in a tx
and dropping the slots whose identity is not deserializable. Lanes whose
identity holds no stageable key still run (the provider rejects them);
their txs are marked to reroute, with every BP_NEEDS_PYTHON tx, in the
reference's order.

What waits for later slices: the policy phase (fastvalidate.py
198-470: creator checks, duplicate txids, endorsement policies, the
key-level validation parameters, the config replay), identity
validation (`ident.validate()`, 110-113) and the per-tx reference path
for the rerouted txs. They assemble the channel's comm, ledger,
policies and MSP, which the port does not have.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from fabric_tpu_torch import native
from fabric_tpu_torch.msp import identity

MAX_E = 8                       # endorsements per tx in the flat tables
# the reference's INVALID_ENDORSER_TRANSACTION failure, which still
# claims its txid (TxValidationCode 5)
_INVALID_ENDORSER = native.BP_FAIL_BASE + 5


@dataclass
class SignaturePhase:
    """What `signature_phase` hands back.

    bp        the block's BlockPrep;
    ci        the txs of the creator lanes, in lane order (nc of them);
    ei, ej    the tx and slot of each endorsement lane, in lane order;
    idents    each unique identity's resolved identity, None where it
              was not deserializable;
    reroute   (n,) bool: the txs the per-tx path decides (BP_NEEDS_PYTHON,
              or, where the native parse did not fail it, an identity
              without a stageable key);
    lanes     the arrays handed to `verify_prepared_start` (digests, r,
              rpn, w, der_ok, key_idx), empty when there is no lane;
    resolve() waits for the card and returns (creator_flag (n,) bool,
              e_flag (n, max_e) bool): each lane's verdict at its tx
              (and slot), False where there was no lane."""

    bp: native.BlockPrep
    ci: np.ndarray
    ei: np.ndarray
    ej: np.ndarray
    idents: list
    reroute: np.ndarray
    lanes: dict
    resolve: Callable[[], tuple[np.ndarray, np.ndarray]]


def signature_phase(envs, channel_id: str, csp, resolve_identity,
                    max_e: int = MAX_E) -> SignaturePhase:
    """Prepare a block's signature lanes and dispatch them on `csp` (a
    provider with `verify_prepared_start`). `resolve_identity(raw)` turns
    a serialized identity into an object with a `key` (the verify key,
    or None), raising where it is not deserializable, an identity of an
    MSP the channel does not hold included: the channel's MSP manager's
    `deserialize_identity`, or `identity.resolve` with `mspids` the
    channel's MSP ids bound (X.509 identities read without an MSP)."""
    envs = list(envs)
    n = len(envs)
    bp = native.block_prep(envs, channel_id, max_e)
    status = bp.status

    # unique identities: resolved once each
    idents: list = [None] * bp.n_unique
    ident_live = np.zeros(bp.n_unique + 1, dtype=bool)
    for uid in range(bp.n_unique):
        try:
            idents[uid] = resolve_identity(bp.unique_identity(uid))
        except Exception:           # noqa: BLE001 (not deserializable)
            continue
        ident_live[uid] = True

    # every structurally OK tx gives lanes, before any policy triage
    ok_mask = (status == native.BP_OK_ENDORSER) | \
              (status == native.BP_OK_CONFIG)
    ci = np.nonzero(ok_mask)[0]
    nc = len(ci)
    e_uid = bp.e_uid
    slot = np.arange(max_e)[None, :]
    lane_mask = ok_mask[:, None] & (slot < bp.e_count[:, None])
    # within-tx dedup: keep the first slot of each identity
    for j in range(1, max_e):
        dup = np.zeros(n, dtype=bool)
        for k in range(j):
            dup |= e_uid[:, j] == e_uid[:, k]
        lane_mask[:, j] &= ~dup
    # drop the endorsers whose identity is not deserializable
    lane_mask &= ident_live[np.clip(e_uid, 0, bp.n_unique)] & (e_uid >= 0)
    ei, ej = np.nonzero(lane_mask)
    ne = len(ei)

    # a live identity without a stageable key reroutes its txs
    keys = [getattr(ident, "key", None) for ident in idents]
    unstageable = np.array([ident is not None and not identity.stageable(
        ident) for ident in idents] + [False])
    tx_unstageable = unstageable[np.clip(bp.creator_uid, 0, bp.n_unique)]
    e_unstageable = unstageable[np.clip(e_uid, 0, bp.n_unique)] & \
        (e_uid >= 0) & (slot < bp.e_count[:, None])
    tx_unstageable = tx_unstageable | e_unstageable.any(axis=1)
    failed = (status >= native.BP_FAIL_BASE) & (status != _INVALID_ENDORSER)
    reroute = (status == native.BP_NEEDS_PYTHON) | (~failed & tx_unstageable)

    lanes: dict = {}
    flags_of = None
    if nc + ne:
        def cat(a_c, a_e):
            return np.concatenate([a_c, a_e])

        lanes = dict(
            digests=cat(bp.payload_digest[ci], bp.e_digest[ei, ej]),
            r=cat(bp.c_r[ci], bp.e_r[ei, ej]),
            rpn=cat(bp.c_rpn[ci], bp.e_rpn[ei, ej]),
            w=cat(bp.c_w[ci], bp.e_w[ei, ej]),
            der_ok=cat(bp.c_ok[ci], bp.e_ok[ei, ej]),
            key_idx=cat(bp.creator_uid[ci].astype(np.int32),
                        e_uid[ei, ej].astype(np.int32)))

        def get_sig(lane: int) -> bytes:
            if lane < nc:
                return bp.slice(int(ci[lane]), bp.csig_off, bp.csig_len)
            i, j = int(ei[lane - nc]), int(ej[lane - nc])
            o = int(bp.e_sig_off[i, j])
            return envs[i][o:o + int(bp.e_sig_len[i, j])]

        flags_of = csp.verify_prepared_start(keys=keys, get_sig=get_sig,
                                             **lanes)

    def resolve() -> tuple[np.ndarray, np.ndarray]:
        creator_flag = np.zeros(n, dtype=bool)
        e_flag = np.zeros((n, max_e), dtype=bool)
        if flags_of is not None:
            flags = np.asarray(flags_of(), dtype=bool)
            creator_flag[ci] = flags[:nc]
            e_flag[ei, ej] = flags[nc:]
        return creator_flag, e_flag

    return SignaturePhase(bp=bp, ci=ci, ei=ei, ej=ej, idents=idents,
                          reroute=reroute, lanes=lanes, resolve=resolve)
