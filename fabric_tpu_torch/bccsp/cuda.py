"""CUDA BCCSP provider — batched signature verification on the card.

The port's counterpart of fabric_tpu/bccsp/tpu.py TPUProvider, for the
slices the port has so far: the P-256 comb-digest path, the fused verify
tier, the Shamir ladder, the Ed25519 batch path, the BN254 pairings of
the idemix credential checks and the BLS12-381 aggregate verify of the
orderer's block signatures. Everything but the batch paths delegates
to the port's SWProvider (the pkcs11-style containment of the
reference). `verify_batch` is the scheme router: it
splits a batch by key scheme (`_lane_scheme`) into a P-256 sub-batch
(`_verify_batch_p256`), an Ed25519 one (`_verify_batch_ed25519`) and
BLS12-381 lanes, which the sw provider verifies one by one (aggregates
arrive through `verify_aggregate`). A P-256 batch is staged on the
host — strict DER, low-S and range gates, w = s^-1 mod n, for the whole
batch in one native call (`native.batch_prep`, csrc/batchprep.cpp) — and
verified on the card; its lanes on ECDSA keys of other curves (P-224,
P-384, P-521) verify on the sw provider.

Message lanes (`verify_batch` items without a digest) take one of three
routes, chosen as `_verify_batch_device` chooses them:

  * the fused tier (`FusedVerify`, on for a CUDA device): the host packs
    SHA-padded blocks (`sha256.pack_messages`) and never hashes; the
    card runs stage A (SHA-256, u1/u2, windows: csrc/sha_windows.cu),
    the gather and the tree kernel — or, on the q8 route with
    FTPU_FUSED_RESIDENT=1 and the key set's tables within
    `fused_verify.RESIDENT_TABLE_BUDGET`, the one resident kernel
    (csrc/fused_resident.cu);
  * `HashOnHost: false` with the fused tier off: SHA-256 on the card
    (the digest-only kernel), then the comb-digest pipeline;
  * `HashOnHost: true` (the default) with the fused tier off: hashlib on
    the host, then the comb-digest pipeline.

Digest lanes — `verify_prepared` (the commit path), and every lane of a
batch whose lanes all carry digests or are hashed before the card — take
the comb-digest pipeline (`fused_verify.digest_verify_with_tables`):
per chunk one stage-A launch (u1, u2 and the windows from the digests
and the scalars' bytes) and one tree launch.

A batch holding a message over `MaxBlocks` SHA blocks is hashed on the
host (`host_hash_fallbacks`): routing by size, as the reference does.

A P-256 batch over more than `MaxKeys` distinct keys has no comb tables:
the whole batch takes the Shamir ladder (`ladder_batches`), one ladder
launch a chunk (csrc/ladder.cu, `ops/verify.py`) — message lanes first
hashed on the card by the digest-only SHA-256 kernel (one more launch a
chunk), then every lane on the ladder's one digest-lanes entry, as
digest lanes (`verify_prepared`, a batch hashed on the host) go straight
there — as fabric_tpu's `_dispatch_arrays` sends such a batch to
`_pipeline`.

Ed25519 lanes: host gates and the SHA-512 challenge per lane
(`ed25519_host.prep_verify`), then one kernel launch a chunk
(csrc/ed25519_verify.cu, `ops/ed25519.py`); sub-batches under
`MinBatch` and the `Ed25519: false` knob serve the sw provider.

BN254 pairings (the idemix MSP's consumers, fabric_tpu/msp/idemix.py
392-427): `pairing_check_batch` pads a batch of pairing products to a
power-of-two bucket (a 2-term pad lane is e(P0, Q0) e(P0, -Q0), the
reference's rule), stages it (`bn254.stage_pairing_products`) and runs,
per chunk, one Miller launch over the products' terms and one final-exp
launch (csrc/bn254_pairing.cu); `g2_msm_batch` runs the G2 MSM kernel
(csrc/g2_msm.cu) a chunk at a time; `bls_verify_batch` checks the lanes
with a signature as 2-term products. Batches under the host cutoffs
(`max(2, MinBatch // 4)` products, `max(2, MinBatch // 8)` MSM lanes),
and products of other than 2 terms that would need padding, are served
by the sw provider and `bn254_ref.g2_msm`: routing by size, as the
reference does.

BLS12-381 aggregates (the orderer's span of block signatures,
fabric_tpu/orderer/blockwriter.py 131-170): `verify_aggregate` gates and
stages the call on the host (`bls12_381.stage_pairs`: the signature's and
keys' subgroup checks, H(m_i)), pads its pairs to a power-of-two bucket
(masked filler lanes) and runs one Miller launch over every pair, one
reduce launch (the lanes' product) and one final-exp launch on the
product's lane (csrc/bls12_381_pairing.cu, `ops/bls12_381_kernel.py`):
one verdict.
Pair lists under `max(2, MinBatch // 4)`, and every call with the
`BLSPairing` knob off (on by default for a CUDA device), take the staged
host path (`bls12_381.miller_products`, `check_products`): routing by
size, as the reference does.

The comb's per-key-set Q tables follow fabric_tpu's lifecycle
(`_q16_cached`, `_q8_cached`): Q16 in a byte-bounded cache that pins hot
tables and serves overflow sets on the 8-bit route, a set being built or
restored by another thread riding the 8-bit route meanwhile, and with
`WarmKeysDir` the key sets and table bytes persisted (sha256 sidecars)
and restored by `prewarm`'s background thread. A device error in the
persist or restore thread is raised by `flush_warm_tables` and by the
set's next lookup.

Device errors propagate: the port has no breaker and no sw fallback yet
(the reference's pairing methods and `verify_aggregate` fall back to the
host on any device error; here they raise), and no counterpart of
`_try_fused`'s demotion to host hashing.

The batch mesh (`mesh=`, the factory's `CUDA.Devices`; fabric_tpu's
`parallel/mesh.py` sharding and `tpu.py`'s elastic mesh): with a mesh of
two or more positions, every route the reference shards (the comb
digest, the fused tier, device SHA, the ladder, Ed25519) splits each
chunk of its bucket into contiguous slices, one a position
(`parallel.shard_slices`), and runs the same kernels on each slice on
the position's device and stream (`_chunked_mesh`), against a table
copy a device (`_replicas_of`); the pairings, the G2 MSM, BLS and
`verify_aggregate` do not shard. `_shard_put` checks the per-position
fault points and times each position's copies; `_record_shard_stats`
reads each position's ready lag from CUDA events in a rotating order
(`shard_stats`, the `device.{transfer,ready}.d<k>` stages, the
straggler strikes). A per-position breaker ring
(common/devicehealth.py) quarantines a position a device-attributed
failure names: that batch raises `DeviceLostError`, the next admission
(`_admit_mesh`) rebuilds the serving mesh over the survivors, and a
probe after the cooldown takes the position back. The reference serves
sw on a failed sharded batch and on total loss; here the batch raises,
and with every position quarantined a dispatch raises
`MeshUnavailableError`. With no mesh (one device) none of this runs: no
lock, span, event or CUDA API call is added to the single-device path.

Telemetry, under the reference's names (common/devicecost.py,
common/tracing.py): each device dispatch runs in a `tpu.verify` span
(`_dispatch_span`), the dispatchers in `tpu.dispatch`, `tpu.ed25519` and
`tpu.bls_pairing` spans; the first load of each kernel library books one
build event in `device_cost` (the `compile_*` stats); CUDA events around
each dispatch's copies and launches feed `device_cost.busy` and the
`device.ready.d<k>` stage, read while the card works on the next
dispatch or when the busy totals are read (on a mesh, each position's
ready lag instead); `health()` gains the reference's
`degraded_mesh:<k>/<n>` part and `device_stats` one row a full-mesh
position.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from fabric_tpu_torch import kernels, native
from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import ed25519_host as edh
from fabric_tpu_torch.bccsp import sw as swmod
from fabric_tpu_torch.bccsp import utils
from fabric_tpu_torch import parallel
from fabric_tpu_torch.common import devicecost, faults, torchenv, tracing
from fabric_tpu_torch.common.devicehealth import (
    DeviceHealth,
    DeviceLostError,
    MeshUnavailableError,
    device_from_error,
)
from fabric_tpu_torch.ops import bls12_381 as blsagg
from fabric_tpu_torch.ops import bls12_381_kernel as blsk
from fabric_tpu_torch.ops import bn254, comb, ed25519, fused_verify, limb
from fabric_tpu_torch.ops import bn254_ref, ptree, sha256, verify

logger = logging.getLogger("fabric_tpu_torch.bccsp.cuda")

P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = utils.P256_N

# 8-bit Q tables (~1.97 MB per key slot) kept per key set, by count
Q8_CACHE_SETS = 16

# provider stat -> (module, attribute) of each kernel wrapper's launch count
LAUNCH_COUNTERS = {
    "tree_kernel_launches": (ptree, "launches"),
    "sha_windows_launches": (fused_verify, "sha_windows_launches"),
    "sha256_launches": (sha256, "launches"),
    "resident_launches": (fused_verify, "resident_launches"),
    "ladder_launches": (verify, "launches"),
    "ed25519_launches": (ed25519, "launches"),
    "miller_launches": (bn254, "miller_launches"),
    "final_exp_launches": (bn254, "final_exp_launches"),
    "g2_msm_launches": (bn254, "msm_launches"),
    "bls_miller_launches": (blsk, "miller_launches"),
    "bls_reduce_launches": (blsk, "reduce_launches"),
    "bls_final_exp_launches": (blsk, "final_exp_launches"),
}


def host_prep_scalars(pub, signature):
    """Per-lane signature prep: strict DER + low-S + scalar-range gates,
    then the device operands. Returns (r, rpn, w) as 32-byte big-endian
    rows, or None when the host rejects the lane. The plain version of
    `native.batch_prep`, which the main path calls; the tests hold one to
    the other lane for lane."""
    rs = swmod.check_signature(pub, signature)
    if rs is None:
        return None
    r, s = rs
    if r >= N or s >= N:
        # crypto/ecdsa.Verify rejects out-of-range scalars before any
        # curve math
        return None
    rpn = r + N if r + N < P256_P else r
    w = pow(s, -1, N)
    return (r.to_bytes(32, "big"), rpn.to_bytes(32, "big"),
            w.to_bytes(32, "big"))


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class _DispatchSpan:
    """`CUDAProvider._dispatch_span`'s context: the recorder set, a
    `tpu.verify` span, and `mark_steady` when the block succeeds. A class,
    not a generator: it runs twice a commit-path call."""

    __slots__ = ("_rec", "_seam", "_span")

    def __init__(self, rec: devicecost.CompileRecorder):
        self._rec = rec

    def __enter__(self) -> None:
        self._seam = devicecost.recording(self._rec)
        self._seam.__enter__()
        self._span = tracing.span("tpu.verify")
        self._span.__enter__()

    def __exit__(self, et, ev, tb) -> bool:
        self._span.__exit__(et, ev, tb)
        self._seam.__exit__(et, ev, tb)
        if et is None:
            self._rec.mark_steady()
        return False


class CUDAProvider(api.BCCSP):
    def __init__(self, *, device=None, min_batch: int = 16,
                 max_keys: int = 16, chunk: int = 32768,
                 use_g16: bool | None = None,
                 table_cache_bytes: int = 6 << 30,
                 hash_on_host: bool = True,
                 fused_verify: bool | None = None,
                 max_blocks: int = 64, ed25519_enabled: bool = True,
                 bls_pairing: bool | None = None,
                 warm_keys_dir: str | None = None, keystore=None,
                 mesh=None, device_health=None, mesh_requested=None):
        # the batch mesh: a BatchMesh or a device list; one of a single
        # position is no mesh. Its first position's device is the
        # provider's device (tables are built there and copied a device).
        if mesh is not None and not isinstance(mesh, parallel.BatchMesh):
            mesh = parallel.batch_mesh(devices=mesh)
        if mesh is not None:
            if device is not None and torch.device(device) != \
                    mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"position ({mesh.devices[0]})")
            device = mesh.devices[0]
            if mesh.size == 1:
                mesh = None
        self.device = torchenv.resolve_device(device)
        # every non-batch method (keys, signing) is the sw provider's, its
        # keys in `keystore` when one is given (bccsp/keystore.py)
        self._sw = swmod.SWProvider(keystore)
        self._min_batch = min_batch
        self._max_keys = max_keys       # comb path cutoff (distinct keys)
        self._chunk = chunk             # lanes per kernel launch
        # 16-bit windows on both bases: 32 points per signature instead
        # of 64, for ~252 MB of G table plus ~252 MB per key slot of Q
        # table resident. None = on for the card, off on the CPU, where
        # the table builds take minutes.
        self._use_g16 = (self.device.type == "cuda" if use_g16 is None
                         else use_g16)
        self._table_cache_bytes = table_cache_bytes
        # with the fused tier off: hash message lanes with hashlib (True)
        # or with the SHA-256 kernel on the card (False)
        self._hash_on_host = hash_on_host
        # the fused tier; None = on for a CUDA device, off on the CPU
        # (FTPU_FUSED=0/1 overrides, see _fused_enabled)
        self._fused_verify = fused_verify
        # the largest power-of-two SHA block count a device batch pads
        # its messages to; a longer message sends its batch to hashlib
        self._max_blocks = max_blocks
        # the Ed25519 kernel (CUDA.Ed25519); False serves Ed25519 lanes on
        # the sw provider
        self._ed25519 = ed25519_enabled
        # the BLS12-381 aggregate kernels (CUDA.BLSPairing); None = on for
        # a CUDA device; off serves every aggregate on the staged host path
        self._bls_pairing = bls_pairing
        # where key sets and their Q table bytes persist across restarts
        # (CUDA.WarmKeysDir); None disables persistence
        self._warm_keys_dir = warm_keys_dir
        self._lock = threading.Lock()       # the Ed25519 B table
        self._ed_tab = None
        # Every Q table structure below is guarded by _q16_lock (an RLock:
        # helpers nest); the table builds, disk reads and copies run
        # outside it. _warm_lock serializes the warm dir's file updates
        # and never serializes a cache lookup.
        self._q16_lock = threading.RLock()
        self._warm_lock = threading.Lock()
        # per-key-set tables, least recently used first: Q16 bounded by
        # bytes (numel * 4 of the resident tensors), Q8 (~1.97 MB per key
        # slot) by count
        self._q16_cache: OrderedDict = OrderedDict()
        self._q16_bytes = 0
        self._q8_cache: OrderedDict = OrderedDict()
        # cache_key -> Event: a Q8 load or build in flight; a concurrent
        # miss for the same set waits for it
        self._q8_loading: dict = {}
        # adaptive residency (see _q16_cached): a lookup counter as the
        # clock, per set its last use, denial, decayed request rate and
        # last request
        self._q16_batch_no = 0
        self._q16_last_use: dict = {}
        self._q16_denied: dict = {}
        self._q16_heat: dict = {}
        self._q16_last_req: dict = {}
        # restored by prewarm from persisted sets and not yet asked for by
        # a live batch: cold, the first eviction candidates
        self._q16_prewarmed: set = set()
        # sets whose Q16 table is being restored or built: a live miss
        # for one rides the 8-bit route instead of waiting or building
        self._q16_loading: set = set()
        # device errors met by the persist and restore threads, by key
        # set (None: the restore thread's G16 build); raised by
        # flush_warm_tables and by the set's next lookup
        self._table_errors: dict = {}
        self._persist_threads: list = []
        self._restore_thread = None
        # the elastic mesh (fabric_tpu's tpu.py 529-828): `_mesh` is the
        # serving mesh, rebuilt over the survivors on a quarantine and
        # grown back on a readmission; `_mesh_full` the configured one,
        # whose positions are the index space of the fault points, the
        # health ring and the gauges; `_mesh_pos` maps each serving
        # position to its full-mesh position
        self._mesh = self._mesh_full = mesh
        self._mesh_pos = list(range(mesh.size)) if mesh is not None else []
        # an unmet multi-device ask of the factory: degraded_mesh:1/<n>
        self._mesh_requested = mesh_requested
        self._devhealth = (DeviceHealth(mesh.size, device_health)
                           if mesh is not None else None)
        self._mesh_lock = threading.Lock()      # serializes rebuilds
        # in-flight dispatches, drained before a mesh swap; new ones hold
        # at the gate while a rebuild drains
        self._dispatch_cv = threading.Condition()
        self._dispatch_inflight = 0
        self._rebuild_pending = False
        self._probe_threads: dict = {}          # position -> live probe
        # per-batch rotation of the ready sampling order
        self._ready_rot = 0
        # id(table) -> (weakref to the table, {device: its copy}): the
        # copies on the mesh's other devices, one a device
        self._replicas: dict = {}
        self._replica_lock = threading.Lock()
        # per-position readings of the last sharded batch (the
        # bccsp_shard_* gauges); empty lists with no mesh
        self.shard_stats: dict = {"transfer_s": [], "ready_s": [],
                                  "lanes": []}
        size = mesh.size if mesh is not None else 1
        self.stats = {"comb_batches": 0, "host_hashed_lanes": 0,
                      "host_hash_fallbacks": 0, "fused_batches": 0,
                      "fused_lanes": 0,
                      "q8_builds": 0, "q16_builds": 0,
                      "q16_oversize_skips": 0, "q16_evictions": 0,
                      "q16_adaptive_skips": 0, "q16_loading_skips": 0,
                      "q16_cache_bytes": 0, "q16_resident_sets": 0,
                      "q16_disk_loads": 0, "q8_disk_loads": 0,
                      "warm_table_persist_failures": 0,
                      "nonp256_sw_lanes": 0,
                      "table_build_s": 0.0, "table_load_s": 0.0,
                      "tree_kernel_launches": 0,
                      "sha_windows_launches": 0, "sha256_launches": 0,
                      "resident_launches": 0, "ladder_batches": 0,
                      "ladder_launches": 0, "ed25519_batches": 0,
                      "ed25519_sw_lanes": 0, "ed25519_launches": 0,
                      "ed25519_prep_s": 0.0, "pairing_batches": 0,
                      "pairing_pairs": 0, "g2_msm_batches": 0,
                      "miller_launches": 0, "final_exp_launches": 0,
                      "g2_msm_launches": 0, "bls_aggregate_checks": 0,
                      "bls_sw_lanes": 0, "bls_miller_launches": 0,
                      "bls_reduce_launches": 0,
                      "bls_final_exp_launches": 0,
                      "shard_devices": size, "shard_dispatches": 0,
                      "shard_skew_s": 0.0, "mesh_devices_full": size,
                      "mesh_rebuilds": 0, "device_quarantines": 0,
                      "device_readmits": 0,
                      "device_straggler_strikes": 0}
        # the build seam's bookkeeper: the compile_* stats, build events
        # and the card's busy time
        self._devicecost = devicecost.CompileRecorder(stats=self.stats)
        # the busy events' free list (None on the CPU: nothing is timed);
        # a pair goes back once read, so a dispatch makes no new event
        self._events = [] if self.device.type == "cuda" else None
        self._ready_stage = f"device.ready.d{self.device.index or 0}"
        self._stream = None     # the last current stream `_mark` saw

    def _fused_enabled(self) -> bool:
        """The fused-tier knob (CUDA.FusedVerify): FTPU_FUSED=0/1 first,
        then the knob, then on for a CUDA device and off for the CPU."""
        env = os.environ.get("FTPU_FUSED")
        if env is not None:
            return env != "0"
        if self._fused_verify is not None:
            return self._fused_verify
        return self.device.type == "cuda"

    @staticmethod
    def _fused_resident_enabled() -> bool:
        """The resident kernel's gate: FTPU_FUSED_RESIDENT=1 (default
        off, as in the reference; the tiered pair is the serving
        configuration)."""
        return os.environ.get("FTPU_FUSED_RESIDENT") == "1"

    # -- everything non-batch delegates --

    def key_gen(self, opts):
        return self._sw.key_gen(opts)

    def key_import(self, raw, opts):
        return self._sw.key_import(raw, opts)

    def get_key(self, ski):
        return self._sw.get_key(ski)

    def hash(self, msg, opts=None):
        return self._sw.hash(msg, opts)

    def sign(self, key, digest, opts=None):
        # secret keys and nonces never leave the host
        return self._sw.sign(key, digest, opts)

    def verify(self, key, signature, digest, opts=None):
        return self._sw.verify(key, signature, digest, opts)

    # -- telemetry surface --

    def health(self) -> str:
        """The provider's state for /healthz: "device", with the
        elastic-mesh sub-state appended when the serving mesh is smaller
        than the configured one ("device;degraded_mesh:<k>/<n>", also
        "1/<requested>" when the factory could not build the mesh it was
        asked for) and the HBM-headroom sub-state
        ("...;hbm_low:d<k>:<free>%free") when the card's free memory
        drops under FTPU_HBM_HEADROOM_FRAC. The port has no breaker
        (device errors propagate), so the state is never the reference's
        "degraded" or "probing"."""
        parts = [p for p in (self._mesh_substate(), self._hbm_substate())
                 if p]
        return ";".join(["device"] + parts)

    def _mesh_substate(self):
        """`degraded_mesh:<k>/<n>` when serving on fewer positions than
        the configured mesh (quarantine, or an unmet factory ask), else
        None."""
        if self._mesh_full is None:
            if self._mesh_requested is not None:
                return f"degraded_mesh:1/{self._mesh_requested}"
            return None
        cur, full = self._mesh.size, self._mesh_full.size
        return f"degraded_mesh:{cur}/{full}" if cur < full else None

    def _hbm_substate(self):
        """devicecost.hbm_substate(), or None when the probe itself
        fails: a failing probe is not a health failure."""
        try:
            return devicecost.hbm_substate()
        except Exception:           # noqa: BLE001
            return None

    @property
    def device_stats(self) -> dict:
        """Per-position health rows (one slot a full-mesh position),
        published as the device-labeled `bccsp_device_{state,trips,
        quarantines,readmits}` gauges; empty lists with no mesh."""
        if self._devhealth is None:
            return {"state": [], "trips": [], "quarantines": [],
                    "readmits": []}
        return self._devhealth.snapshot()

    @property
    def device_cost(self) -> devicecost.CompileRecorder:
        """The build/busy recorder, read by
        profiling.publish_devicecost_stats."""
        return self._devicecost

    def _dispatch_span(self):
        """One device dispatch: a `tpu.verify` span, the provider's
        recorder for the library loads inside it, and the steady mark
        after the first dispatch that succeeds. With a mesh, also the
        reference's rebuild gate (`_mesh_dispatch_span`); without one no
        rebuild can happen, so the single-device path takes no lock."""
        if self._mesh_full is None:
            return _DispatchSpan(self._devicecost)
        return self._mesh_dispatch_span()

    # -- the elastic mesh (fail in place; common/devicehealth.py) --

    @contextlib.contextmanager
    def _mesh_dispatch_span(self):
        """Mark one dispatch live so a concurrent rebuild drains it before
        it swaps the serving mesh; new dispatches hold at the gate while
        a rebuild drains (bounded: the drain is). A failure is attributed
        once the dispatch has left the in-flight count (the rebuild it
        triggers drains the others): a position it names is quarantined
        and the dispatch raises `DeviceLostError` for it."""
        with self._dispatch_cv:
            deadline = None
            while self._rebuild_pending:
                if deadline is None:
                    deadline = time.monotonic() + 10.0
                if time.monotonic() >= deadline:
                    break            # never wedge a dispatch on the gate
                self._dispatch_cv.wait(0.1)
            self._dispatch_inflight += 1
        err = None
        try:
            with _DispatchSpan(self._devicecost):
                yield
        except Exception as e:
            err = e
            raise
        finally:
            with self._dispatch_cv:
                self._dispatch_inflight -= 1
                self._dispatch_cv.notify_all()
            if err is not None:
                struck = self._attribute_device_failure(err)
                if struck and not isinstance(err, DeviceLostError):
                    raise DeviceLostError(struck[0], err) from err

    def _device_index(self, pos: int) -> int:
        """A serving position's FULL-mesh position (devices may repeat, so
        the position, not the device, is the index): stable across
        rebuilds, the space of the fault points, the health ring and the
        `bccsp_device_*` labels."""
        return self._mesh_pos[pos]

    def _attribute_device_failure(self, exc: BaseException) -> list:
        """Quarantine the positions a failed dispatch names: a
        DeviceLostError carries its full-mesh position; another error
        naming a CUDA device ("cuda:1", "device 1") strikes every position
        on that device. Then rebuild the serving mesh at once, so the next
        batch dispatches on the survivors. Returns the struck positions."""
        dh = self._devhealth
        if isinstance(exc, DeviceLostError):
            struck = [exc.device]
        else:
            devs = self._mesh_full.devices
            k = device_from_error(str(exc), max(
                (d.index or 0 for d in devs if d.type == "cuda"),
                default=-1) + 1)
            struck = [p for p, d in enumerate(devs)
                      if k is not None and d.type == "cuda"
                      and (d.index or 0) == k]
        for p in struck:
            dh.record_fault(p, exc)
        if struck:
            self.stats.update(dh.totals())
            self._maybe_probe_and_rebuild(probe=False)
        return struck

    def _admit_mesh(self) -> None:
        """The admission hook before a dispatch that may shard: kick due
        probes and apply a pending shrink or growth of the serving mesh;
        with every position quarantined, raise at once (the reference
        serves sw here)."""
        if not self._maybe_probe_and_rebuild():
            raise MeshUnavailableError(self._devhealth.quarantined())

    def _maybe_probe_and_rebuild(self, probe: bool = True) -> list:
        """Start any due re-admission probes (on threads: a wedged
        position's probe never stalls a batch), then swap the serving
        mesh when its healthy membership changed. Returns the healthy
        full-mesh positions."""
        dh = self._devhealth
        if probe:
            for d in dh.probe_candidates():
                self._spawn_probe(d)
        healthy = dh.healthy()
        if healthy and healthy != self._mesh_pos:
            self._rebuild_mesh(healthy)
        return healthy

    def _spawn_probe(self, d: int) -> None:
        """Run one position's re-admission probe on a daemon thread; a
        later admission grows the mesh once the outcome lands. The probe
        slot was taken in probe_candidates(), so admissions cannot probe
        twice."""
        dh = self._devhealth

        def work():
            ok = False
            try:
                with dh.probe_execution(d):
                    ok = self._probe_device(d)
            finally:
                dh.probe_result(d, ok)
                if ok:
                    self.stats.update(dh.totals())
                self._probe_threads.pop(d, None)

        t = threading.Thread(target=work, daemon=True,
                             name=f"bccsp-device-probe-{d}")
        self._probe_threads[d] = t
        t.start()

    def _probe_device(self, d: int) -> bool:
        """One bounded probe of position `d`: a small tensor op on its
        device, on a watchdog thread (a wedged device cannot stall the
        prober past `probe_timeout_s`), through the same
        `tpu.device_lost` point as the span feeder, so an armed fault
        keeps the position benched."""
        timeout = self._devhealth.config.probe_timeout_s
        box: dict = {}
        done = threading.Event()

        def work():
            try:
                faults.check("tpu.device_lost", arg=d)
                x = torch.arange(8, dtype=torch.int32,
                                 device=self._mesh_full.devices[d])
                box["ok"] = int((x + 1).sum()) == 36
            except Exception as e:      # the probe's outcome: failed
                box["error"] = e
            finally:
                done.set()

        threading.Thread(target=work, daemon=True,
                         name=f"bccsp-device-probe-op-{d}").start()
        if not done.wait(timeout) or not box.get("ok"):
            logger.warning("device %d re-admission probe failed (%s); "
                           "staying quarantined", d, box.get(
                               "error", f"no answer in {timeout:.1f}s"))
            return False
        return True

    @tracing.traced("tpu.mesh_rebuild")
    def _rebuild_mesh(self, healthy: list) -> None:
        """Swap the serving mesh for one over `healthy` (full-mesh
        positions): drain in-flight dispatches (bounded: a wedged one
        must not hold the rebuild), re-home the table copies, install
        the new mesh."""
        with self._mesh_lock:
            if healthy == self._mesh_pos:
                return              # another thread already rebuilt
            with self._dispatch_cv:
                self._rebuild_pending = True
            try:
                deadline = time.monotonic() + 5.0
                with self._dispatch_cv:
                    while (self._dispatch_inflight > 0
                           and time.monotonic() < deadline):
                        self._dispatch_cv.wait(
                            max(0.0, deadline - time.monotonic()))
                    if self._dispatch_inflight > 0:
                        logger.warning(
                            "mesh rebuild proceeding with %d dispatch(es) "
                            "still in flight after the drain deadline",
                            self._dispatch_inflight)
                full = self._mesh_full
                mesh = (full if len(healthy) == full.size else
                        parallel.BatchMesh([full.devices[i]
                                            for i in healthy]))
                self._rehome_tables(mesh)
                self._mesh, self._mesh_pos = mesh, list(healthy)
            finally:
                with self._dispatch_cv:
                    self._rebuild_pending = False
                    self._dispatch_cv.notify_all()
        self.stats["shard_devices"] = mesh.size
        self.stats["mesh_rebuilds"] += 1
        tracing.instant("tpu.mesh_rebuild", devices=mesh.size,
                        full=full.size)
        if mesh.size < full.size:
            logger.warning("serving mesh REBUILT over %d/%d position(s) "
                           "(quarantined: %s)", mesh.size, full.size,
                           self._devhealth.quarantined())
        else:
            logger.info("serving mesh restored to the full %d position(s)",
                        mesh.size)

    def _rehome_tables(self, mesh) -> None:
        """Drop the table copies on devices the new mesh does not hold
        (a quarantined device's), and copy every table back onto a device
        it regains, from the table or a copy on a surviving device."""
        keep = set(mesh.distinct())
        with self._replica_lock:
            for ref, copies in self._replicas.values():
                for d in [d for d in copies if d not in keep]:
                    del copies[d]
                t = ref()
                if t is not None:
                    self._copy_to(t, copies, keep)

    @staticmethod
    def _copy_to(t, copies: dict, devices) -> None:
        """Give every device in `devices` a copy of `t` in `copies` (t's
        own device needs none), copied from t, or from a copy when t's
        device is not among them."""
        for d in devices:
            if d != t.device and d not in copies:
                src = t if t.device in devices else next(
                    iter(copies.values()), t)
                copies[d] = src.to(d)

    def _replicas_of(self, t: torch.Tensor, mesh) -> dict:
        """{device: t or its copy} over the mesh's distinct devices: a
        table copied once a device, not a position, and kept while t
        lives."""
        devices = mesh.distinct()
        with self._replica_lock:
            entry = self._replicas.get(id(t))
            if entry is None:
                entry = self._replicas[id(t)] = (weakref.ref(t), {})
                weakref.finalize(t, self._replicas.pop, id(t), None)
            copies = entry[1]
            self._copy_to(t, copies, devices)
            return {d: t if d == t.device else copies[d] for d in devices}

    def _mark(self):
        """A timing event recorded now on the device's current stream,
        from the free list when it holds one; None on the CPU, where
        nothing is timed."""
        if self._events is None:
            return None
        try:
            ev = self._events.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        # torch.cuda.current_stream builds a Stream object a call, on the
        # commit path before the copies; its raw reading tells whether
        # the stream seen last is still the current one
        s = self._stream
        if s is None or torch._C._cuda_getCurrentStream(
                s.device_index)[0] != s.stream_id:
            s = self._stream = torch.cuda.current_stream(self.device)
        ev.record(s)
        return ev

    def _mark_end(self):
        """`_mark` after a dispatch's last launch; then, while the card
        runs that dispatch, read and book the pairs of the dispatches
        before it."""
        ev = self._mark()
        if ev is not None:
            self._devicecost.busy.drain()
        return ev

    def _note_busy(self, start, end) -> None:
        """Hand the card's time between two `_mark` events to the busy
        time (DeviceBusy's single-chip contract: the whole-batch device
        stage, its copies and host-paced gaps included, so not kernel
        occupancy) and the `device.ready.d<k>` stage. Called after the
        caller's wait for the results has passed `end`; the reading
        itself waits for the next `_mark_end` or busy read
        (`DeviceBusy.drain`)."""
        if start is None:
            return
        self._devicecost.busy.note_events(self.device.index or 0, start,
                                          end, self._booked)

    def _booked(self, start, end, seconds: float) -> None:
        """A busy pair read: feed the ready stage and return the events
        to the free list."""
        tracing.observe_stage(self._ready_stage, seconds)
        self._events.extend((start, end))

    # -- the item path --

    @staticmethod
    def _lane_scheme(item) -> str:
        """The router's partition key for one lane: "ed25519" for an
        Ed25519 key, "bls" for a BLS12-381 key, else "p256" (ECDSA keys of
        every curve and dead non-ECDSA keys, which the P-256 staging sorts
        inline: other curves to sw, dead keys to reject)."""
        scheme = getattr(item.key, "scheme", None)
        if scheme == "ed25519":
            return "ed25519"
        if scheme == "bls12381":
            return "bls"
        return "p256"

    def verify_batch(self, items: Sequence[api.VerifyItem]) -> list[bool]:
        """The scheme router (fabric_tpu's `verify_batch`): a batch under
        `MinBatch` serves the sw provider; otherwise its lanes are split
        by `_lane_scheme` into per-scheme sub-batches, each verified on
        its path (BLS lanes one by one on the sw provider, as fabric_tpu's
        router sends them), and the verdicts go back in the items' order.
        A batch of P-256 lanes alone takes the P-256 path as it is."""
        if len(items) < self._min_batch:
            return self._sw.verify_batch(items)
        schemes = [self._lane_scheme(it) for it in items]
        if all(s == "p256" for s in schemes):
            return self._verify_batch_p256(items)
        by_scheme: dict[str, list[int]] = {}
        for i, s in enumerate(schemes):
            by_scheme.setdefault(s, []).append(i)
        result = [False] * len(items)
        for scheme, lanes in by_scheme.items():
            sub = [items[i] for i in lanes]
            if scheme == "ed25519":
                out = self._verify_batch_ed25519(sub)
            elif scheme == "bls":
                self.stats["bls_sw_lanes"] += len(sub)
                out = self._sw.verify_batch(sub)
            else:
                out = self._verify_batch_p256(sub)
            for i, v in zip(lanes, out):
                result[i] = v
        return result

    def _verify_batch_p256(self, items) -> list[bool]:
        """The P-256 branch of fabric_tpu's `_verify_batch_device`; a
        sub-batch under `MinBatch` serves the sw provider. Message lanes
        take the fused tier, the device-SHA route or host hashing (see
        the module docstring), or the ladder over more than `MaxKeys`
        keys; digest lanes are digests on every route. Lanes on non-ECDSA
        keys reject; lanes on an ECDSA key of another curve, and P-256
        lanes with a digest other than 32 bytes, verify on the sw path
        without degrading the rest of the batch. The P-256 lanes'
        signatures are prepared in one native call (`native.batch_prep`:
        strict DER, low-S and range gates, w = s^-1 mod n)."""
        if len(items) < self._min_batch:
            return self._sw.verify_batch(items)
        if self._devhealth is not None:
            self._admit_mesh()
        n = len(items)
        bucket = self._bucket(n)
        fused = self._fused_enabled()
        hash_here = self._hash_on_host and not fused
        pubs = [it.key.public_key() for it in items]
        sw_lanes: list[int] = []
        device = np.zeros(n, dtype=bool)        # P-256 lanes for the card
        for i, (it, pub) in enumerate(zip(items, pubs)):
            if not isinstance(pub, swmod.ECDSAPublicKey):
                continue                    # premask stays False: reject
            if not pub.is_p256() or (it.digest is not None
                                     and len(it.digest) != 32):
                sw_lanes.append(i)
            else:
                device[i] = True
        with devicecost.recording(self._devicecost):
            ok, r8, rpn8, w8 = native.batch_prep(
                [it.signature if device[i] else b""
                 for i, it in enumerate(items)])
        premask = np.zeros(bucket, dtype=bool)
        premask[:n] = ok
        r_b = np.zeros((bucket, 32), dtype=np.uint8)
        rpn_b = np.zeros((bucket, 32), dtype=np.uint8)
        w_b = np.zeros((bucket, 32), dtype=np.uint8)
        r_b[:n], rpn_b[:n], w_b[:n] = r8, rpn8, w8  # zero rows where not ok
        key_idx = np.zeros(bucket, dtype=np.int32)
        digests = np.zeros((bucket, 8), dtype=np.uint32)
        has_digest = np.zeros(bucket, dtype=bool)
        msgs = [b""] * bucket
        # key slots in first-appearance order over the live lanes (a lane
        # the gates reject registers no key), one lookup per key object
        key_map: dict[bytes, int] = {}
        slot_of: dict[int, int] = {}
        hashed = 0
        for i in np.flatnonzero(ok).tolist():
            it, pub = items[i], pubs[i]
            j = slot_of.get(id(pub))
            if j is None:
                kb = pub.x_bytes().tobytes() + pub.y_bytes().tobytes()
                j = slot_of[id(pub)] = key_map.setdefault(kb, len(key_map))
            key_idx[i] = j
            digest = it.digest
            if digest is None and hash_here:
                # an empty message still hashes to SHA-256(b"")
                digest = self._sw.hash(it.message)
                hashed += 1
            if digest is not None:
                digests[i] = np.frombuffer(digest, dtype=">u4")
                has_digest[i] = True
            else:
                msgs[i] = it.message
        nb = None                   # None: every live lane is a digest lane
        pending = np.nonzero(premask & ~has_digest)[0]
        if len(pending):
            max_len = max(len(msgs[i]) for i in pending)
            nb = self._nb_bucket(max_len)
            if nb is None:
                # a message over the block budget: hash the batch's
                # message lanes on the host instead
                self.stats["host_hash_fallbacks"] += 1
                logger.info("message of %d bytes exceeds the %d-block "
                            "device budget; hashing the batch host-side",
                            max_len, self._max_blocks)
                for i in pending:
                    digests[i] = np.frombuffer(self._sw.hash(msgs[i]),
                                               dtype=">u4")
                has_digest[pending] = True
                hashed += len(pending)
        self.stats["host_hashed_lanes"] += hashed
        result = [False] * n
        if key_map:
            with self._dispatch_span():
                result = self._dispatch_p256(
                    bucket, key_map, key_idx, r_b, rpn_b, w_b, premask,
                    digests, has_digest, msgs, nb, fused)()[:n].tolist()
        if sw_lanes:
            self.stats["nonp256_sw_lanes"] += len(sw_lanes)
            for i, v in zip(sw_lanes, self._sw.verify_batch(
                    [items[i] for i in sw_lanes])):
                result[i] = v
        return result

    def _dispatch_p256(self, bucket, key_map, key_idx, r_b, rpn_b, w_b,
                       premask, digests, has_digest, msgs, nb, fused):
        """The staged batch's dispatcher: the ladder over more than
        `MaxKeys` keys, else the comb-digest pipeline when every live
        lane is a digest lane (nb None), else the fused tier or the
        device-SHA route. Returns the dispatcher's thunk."""
        ladder = len(key_map) > self._max_keys
        if nb is None:
            dispatch = (self._dispatch_ladder if ladder
                        else self._dispatch_comb_digest)
            return dispatch(bucket, key_map, key_idx, r_b, rpn_b, w_b,
                            premask, digests)
        blocks, nblocks = sha256.pack_messages(msgs, nb)
        # digest lanes skip the device hash: no live block
        nblocks[has_digest] = 0
        if ladder:
            return self._dispatch_ladder(
                bucket, key_map, key_idx, r_b, rpn_b, w_b, premask,
                digests, (blocks, nblocks, has_digest))
        dispatch = (self._dispatch_fused_verify if fused
                    else self._dispatch_device_sha)
        return dispatch(bucket, key_map, key_idx, blocks, nblocks, r_b,
                        rpn_b, w_b, premask, digests, has_digest)

    # -- the prepared-block path --

    def verify_prepared(self, digests: np.ndarray, r: np.ndarray,
                        rpn: np.ndarray, w: np.ndarray, der_ok: np.ndarray,
                        key_idx: np.ndarray, keys, get_sig) -> list[bool]:
        return self.verify_prepared_start(
            digests, r, rpn, w, der_ok, key_idx, keys, get_sig)()

    def verify_prepared_start(self, digests: np.ndarray, r: np.ndarray,
                              rpn: np.ndarray, w: np.ndarray,
                              der_ok: np.ndarray, key_idx: np.ndarray,
                              keys, get_sig):
        """Batched verify over pre-staged operands: digests (n, 32)
        uint8, r/rpn/w (n, 32) uint8 big-endian (`native.batch_prep`),
        der_ok (n,) bool, key_idx (n,) int indexing `keys` (Key objects),
        get_sig(i) -> lane i's DER (read on the sw path only).

        Returns a resolver: the device work is enqueued now and the
        resolver waits for it, so the caller's host work overlaps the
        card's. Verdicts equal verify_batch over the same items."""
        n = len(der_ok)
        if n == 0:
            return lambda: []
        if n < self._min_batch:
            out = self._verify_prepared_sw(range(n), digests, key_idx, keys,
                                           get_sig)
            return lambda: out
        if self._devhealth is not None:
            self._admit_mesh()

        # per-key gates (fabric_tpu's `_verify_prepared_device`): lanes on
        # a P-256 key go to the card, lanes on an ECDSA key of another
        # curve to the sw path, lanes on a non-ECDSA key reject
        pubs = [k.public_key() if k is not None else None for k in keys]
        ecdsa = [isinstance(p, swmod.ECDSAPublicKey) for p in pubs]
        key_ok = np.array([e and p.is_p256() for e, p in zip(ecdsa, pubs)],
                          dtype=bool)
        key_sw = np.array([e and not p.is_p256()
                           for e, p in zip(ecdsa, pubs)], dtype=bool)
        lane_key = np.asarray(key_idx, dtype=np.int64)
        bucket = self._bucket(n)
        premask = np.zeros(bucket, dtype=bool)
        premask[:n] = np.asarray(der_ok, dtype=bool) & key_ok[lane_key]
        # key slots over the P-256 keys; dead lanes keep slot 0 (masked)
        key_map: dict[bytes, int] = {}
        slot_of = np.zeros(len(keys), dtype=np.int32)
        for j in np.flatnonzero(key_ok).tolist():
            p = pubs[j]
            kb = p.x_bytes().tobytes() + p.y_bytes().tobytes()
            slot_of[j] = key_map.setdefault(kb, len(key_map))
        lane_slot = np.zeros(bucket, dtype=np.int32)
        lane_slot[:n] = slot_of[lane_key]
        dg = np.zeros((bucket, 8), dtype=np.uint32)
        dg[:n] = np.ascontiguousarray(digests).view(">u4").reshape(n, 8)

        def pad(a):
            out = np.zeros((bucket, 32), dtype=np.uint8)
            out[:n] = a
            return out

        thunk = None
        if key_map:
            dispatch = (self._dispatch_ladder
                        if len(key_map) > self._max_keys
                        else self._dispatch_comb_digest)
            # one tpu.verify span for the enqueue, one for the wait, as
            # the reference's prepared path
            with self._dispatch_span():
                thunk = dispatch(bucket, key_map, lane_slot, pad(r),
                                 pad(rpn), pad(w), premask, dg)
        # the sw lanes run while the card works
        sw_lanes = np.flatnonzero(key_sw[lane_key]).tolist()
        sw_out = self._verify_prepared_sw(sw_lanes, digests, key_idx, keys,
                                          get_sig)
        self.stats["nonp256_sw_lanes"] += len(sw_lanes)

        def resolve():
            result = [False] * n
            if thunk is not None:
                with self._dispatch_span():
                    result = thunk()[:n].tolist()
            for i, v in zip(sw_lanes, sw_out):
                result[i] = v
            return result
        return resolve

    def _verify_prepared_sw(self, lanes, digests, key_idx, keys,
                            get_sig) -> list[bool]:
        out = []
        for i in lanes:
            k = keys[key_idx[i]]
            try:
                out.append(k is not None and self._sw.verify(
                    k, get_sig(i), bytes(digests[i])))
            except TypeError:               # a non-ECDSA key rejects
                out.append(False)
        return out

    # -- dispatch --

    @staticmethod
    def _canonical_key_order(key_map: dict, key_idx: np.ndarray):
        """Reassign key indices by sorted key bytes: table slot order and
        the cache key must not depend on first-appearance order (a hit
        with another slot order would comb against the wrong key).
        Returns (ordered key bytes, remapped key_idx)."""
        order = sorted(key_map)
        remap = np.zeros(len(key_map), dtype=np.int32)
        for j, kb in enumerate(order):
            remap[key_map[kb]] = j
        return order, remap[key_idx]

    def _bucket(self, n: int) -> int:
        """The power-of-two bucket from `MinBatch` up; with a mesh,
        rounded up to a multiple of its size (fabric_tpu's `_bucket`)."""
        b = self._min_batch
        while b < n:
            b *= 2
        if self._mesh is not None:
            m = self._mesh.size
            b = -(-b // m) * m
        return b

    def _mesh_chunk(self, bucket: int) -> int:
        """Lanes a chunk on the mesh: `chunk`, kept a multiple of the mesh
        size, so each chunk splits evenly over the positions."""
        m = self._mesh.size
        return max(m, (min(bucket, self._chunk) // m) * m)

    def _nb_bucket(self, max_len: int) -> int | None:
        """Power-of-two SHA block count covering max_len, else None."""
        nb = 1
        while sha256.max_message_len(nb) < max_len:
            nb *= 2
            if nb > self._max_blocks:
                return None
        return nb

    @tracing.traced("tpu.dispatch")
    def _dispatch_comb_digest(self, bucket, key_map, key_idx, r8, rpn8, w8,
                              premask, digests):
        """Enqueue the comb-digest pipeline for a staged batch, per
        `chunk` lanes one stage-A launch (digest lanes: u1, u2 and the
        windows) and one tree launch; returns a thunk that waits and
        hands back the (bucket,) numpy verdicts."""
        key_idx, K, q_flat, g16, q16 = self._resolve_tables(key_map, key_idx)
        self.stats["comb_batches"] += 1
        words = digests.view(np.int32)        # the same bits
        return self._chunked(bucket, lambda c, q_flat, g16: (
            fused_verify.digest_verify_with_tables(
                c(words), c(key_idx), q_flat, c(r8), c(rpn8), c(w8),
                c(premask), g16=g16, q16=q16)), (q_flat, g16))

    @tracing.traced("tpu.dispatch")
    def _dispatch_device_sha(self, bucket, key_map, key_idx, blocks,
                             nblocks, r8, rpn8, w8, premask, digests,
                             has_digest):
        """`HashOnHost: false` with the fused tier off (fabric_tpu's
        `_comb_pipeline_locked` fused body): SHA-256 on the card by the
        digest-only kernel, the lanes' digests where they have one, then
        the comb-digest pipeline; one chunk at a time."""
        key_idx, K, q_flat, g16, q16 = self._resolve_tables(key_map, key_idx)
        self.stats["comb_batches"] += 1
        blocks = blocks.view(np.int32)
        words = digests.view(np.int32)

        def run(c, q_flat, g16):
            # int64 words masked to 32 bits -> int32, the same bits
            hashed = sha256.sha256_blocks(c(blocks), c(nblocks))
            dw = torch.where(c(has_digest)[:, None], c(words),
                             hashed.to(torch.int32))
            return fused_verify.digest_verify_with_tables(
                dw, c(key_idx), q_flat, c(r8), c(rpn8), c(w8), c(premask),
                g16=g16, q16=q16)
        return self._chunked(bucket, run, (q_flat, g16))

    @tracing.traced("tpu.dispatch")
    def _dispatch_fused_verify(self, bucket, key_map, key_idx, blocks,
                               nblocks, r8, rpn8, w8, premask, digests,
                               has_digest):
        """The fused tier, one chunk at a time: padded SHA blocks and
        compact u8 scalars go to the card, the verdicts come back. The
        tiered pair (stage A, gather, tree), or the resident kernel as
        fabric_tpu's `_fused_pipeline` picks it: only on the q8 route,
        only with FTPU_FUSED_RESIDENT=1, only within the budget."""
        key_idx, K, q_flat, g16, q16 = self._resolve_tables(key_map, key_idx)
        resident = (not q16 and self._fused_resident_enabled()
                    and fused_verify.resident_table_bytes(K)
                    <= fused_verify.RESIDENT_TABLE_BUDGET)
        self.stats["fused_batches"] += 1
        self.stats["fused_lanes"] += int(np.sum(premask & ~has_digest))
        blocks = blocks.view(np.int32)
        digests = digests.view(np.int32)

        def run(c, q_flat, g16):
            args = (c(blocks), c(nblocks), c(key_idx), q_flat, c(r8),
                    c(rpn8), c(w8), c(premask), c(digests), c(has_digest))
            if resident:
                return fused_verify.fused_verify_resident(*args)
            return fused_verify.fused_verify_with_tables(
                *args, g16=g16, q16=q16)
        return self._chunked(bucket, run, (q_flat, g16))

    @tracing.traced("tpu.dispatch")
    def _dispatch_ladder(self, bucket, key_map, key_idx, r8, rpn8, w8,
                         premask, digests, message=None):
        """The Shamir ladder for a batch over more than `MaxKeys` keys
        (fabric_tpu's `_dispatch_arrays` ladder branch), one ladder launch
        a chunk: each lane's key goes to the card as 64 bytes (x then y,
        big-endian). With `message` = (blocks, nblocks, has_digest) the
        lanes without a digest are first hashed on the card by the
        digest-only SHA-256 kernel (`verify.ladder_verify`: one more
        launch a chunk); without it every lane is a digest lane."""
        self.stats["ladder_batches"] += 1
        qk = np.zeros((len(key_map), 64), dtype=np.uint8)
        for kb, j in key_map.items():
            qk[j] = np.frombuffer(kb, dtype=np.uint8)
        q8 = qk[key_idx]
        words = digests.view(np.int32)        # the same bits
        if message is None:
            return self._chunked(bucket, lambda c: (
                verify.ladder_verify_digests(c(words), c(q8), c(r8),
                                             c(rpn8), c(w8), c(premask))))
        blocks, nblocks, has_digest = message
        blocks = blocks.view(np.int32)
        return self._chunked(bucket, lambda c: verify.ladder_verify(
            c(blocks), c(nblocks), c(words), c(has_digest), c(q8), c(r8),
            c(rpn8), c(w8), c(premask)))

    # -- the Ed25519 batch path (the router's "ed25519" lanes) --

    def _verify_batch_ed25519(self, items) -> list[bool]:
        """fabric_tpu's `_verify_batch_ed25519` without its breaker: a
        sub-batch under `MinBatch`, or any with the kernel switched off
        (`Ed25519: false`), serves the sw provider with the same
        verdicts; the rest is one device dispatch. Device errors
        propagate."""
        if len(items) < self._min_batch or not self._ed25519:
            self.stats["ed25519_sw_lanes"] += len(items)
            return self._sw.verify_batch(items)
        if self._devhealth is not None:
            self._admit_mesh()
        with self._dispatch_span():
            return self._dispatch_ed25519(items)

    @tracing.traced("tpu.ed25519")
    def _dispatch_ed25519(self, items) -> list[bool]:
        """Host prep (the gates and the SHA-512 challenge of
        `ed25519_host.prep_verify`, the policy the sw path shares), the
        kernel's operand rows (`ed25519.stage_rows`), one launch a
        chunk; the prep's seconds go to stats["ed25519_prep_s"]."""
        n = len(items)
        t0 = time.perf_counter()
        prep = []
        for it in items:
            msg = it.message if it.message is not None else it.digest
            prep.append(None if msg is None else edh.prep_verify(
                it.key.public_key().bytes(), it.signature, msg))
        bucket = self._bucket(n)
        rows = ed25519.stage_rows(prep, bucket)
        self.stats["ed25519_prep_s"] += time.perf_counter() - t0
        out = self._chunked(bucket, lambda c, tab: ed25519.ed25519_verify(
            tab, *(c(a) for a in rows)), (self._ed_table(),))
        self.stats["ed25519_batches"] += 1
        return out()[:n].tolist()

    def _ed_table(self) -> torch.Tensor:
        """The fixed-base B table in the layout the device's path takes
        (`ed25519.device_table`: the kernel's 32-bit plain-domain words
        on the card, the JAX layout on the CPU), moved to the device once
        per provider."""
        with self._lock:
            if self._ed_tab is None:
                self._ed_tab = self._timed(ed25519.device_table,
                                           self.device)
            return self._ed_tab

    # -- BN254 pairings (idemix; BASELINE config 4) --

    def pairing_check_batch(self, products) -> list[bool]:
        """prod_j e(P_j, Q_j) == 1 per lane, on the card (fabric_tpu's
        `pairing_check_batch` without its host fallback on device errors).

        products: [[(P_int_affine, Q_twist_int_affine), ...] per lane]
        with a uniform term count. Batches under the host cutoff, and
        products of other than 2 terms that would need padding, go to
        the sw provider's exact pairing."""
        if len(products) < max(2, self._min_batch // 4):
            return self._sw.pairing_check_batch(products)
        nterms, n = len(products[0]), len(products)
        bucket = _pow2(n)
        if nterms != 2 and bucket != n:
            return self._sw.pairing_check_batch(products)
        with self._dispatch_span():
            return self._dispatch_pairing(products, nterms, n, bucket)

    @tracing.traced("tpu.bls_pairing")
    def _dispatch_pairing(self, products, nterms, n, bucket) -> list[bool]:
        """The BN254 pairing dispatch: pad to the bucket, stage, one
        Miller and one final-exp launch a chunk."""
        # pad with a trivially-true product: infinity is not representable
        # affine, so a VALID identity product e(P, Q) * e(P, -Q) from lane
        # 0's first term
        p0, q0 = products[0][0]
        pad = [(p0, q0), (p0, bn254_ref.g2_neg_tw(q0))]
        staged = bn254.stage_pairing_products(
            list(products) + [pad] * (bucket - n))
        outs = []
        start = self._mark()
        with self._count_launches():
            for lo in range(0, bucket, self._chunk):
                hi = lo + self._chunk
                outs.append(bn254.pairing_product_is_one(
                    *bn254.to_device(staged, self.device, lo, hi)))
        end = self._mark_end()
        out = torch.cat(outs).cpu().numpy()
        self._note_busy(start, end)
        self.stats["pairing_batches"] += 1
        self.stats["pairing_pairs"] += n * nterms
        return out[:n].tolist()

    def g2_msm_batch(self, lanes) -> list:
        """Per lane sum_t k_t * Q_t over the BN254 twist (affine int
        points or None; returns affine int points, None for infinity), on
        the card: the idemix PS presentations' Schnorr recombinations and
        subgroup lanes in one dispatch. Only the live lanes go to the
        card, in class order (`bn254.msm_order`: a warp's lanes then
        share their length); the results come back in the caller's
        order. Batches under the host cutoff take the host Strauss MSM
        (bn254_ref.g2_msm)."""
        if len(lanes) < max(2, self._min_batch // 8):
            return [bn254_ref.g2_msm(lane) for lane in lanes]
        n = len(lanes)
        kw, q_flat = bn254.stage_g2_msm_words(lanes)
        order = bn254.msm_order(kw)
        kw = np.ascontiguousarray(kw[order]).view(np.int32)
        q_flat = [np.ascontiguousarray(a[order]) for a in q_flat]
        outs = []
        with self._dispatch_span():
            start = self._mark()
            with self._count_launches():
                for lo in range(0, n, self._chunk):
                    hi = lo + self._chunk
                    outs.append(bn254.g2_msm(*bn254.to_device(
                        [kw, *q_flat], self.device, lo, hi)))
            end = self._mark_end()
            out = tuple(tuple(torch.cat([o[i][j] for o in outs]).cpu()
                              for j in range(2)) for i in range(3))
            self._note_busy(start, end)
        self.stats["g2_msm_batches"] += 1
        res = [None] * n
        for i, pt in zip(order.tolist(), bn254.read_g2_msm(out)):
            res[i] = pt
        return res

    def bls_verify_batch(self, pk_tw, msgs, sig_points) -> list[bool]:
        """Issuer-credential BLS verify: e(sig, G2) e(H(m), -pk) == 1 per
        lane. None entries of `sig_points` (malformed) are False without
        touching the card. The card's work is pairing_check_batch's
        dispatch, in its tpu.verify span."""
        idx = [i for i, s in enumerate(sig_points) if s is not None]
        out = [False] * len(msgs)
        if idx:
            prods = bn254.bls_products(pk_tw, [msgs[i] for i in idx],
                                       [sig_points[i] for i in idx])
            for i, v in zip(idx, self.pairing_check_batch(prods)):
                out[i] = v
        return out

    # -- BLS12-381 aggregate verify (the orderer's block signatures) --

    def verify_aggregate(self, keys, messages, signature) -> bool:
        """BLS12-381 aggregate verify (fabric_tpu's `verify_aggregate`
        without its sw fallback): the structural and subgroup gates stage
        the pairing-product pair list (`bls12_381.stage_pairs`), then
        `_bls_pairing_check` decides it, on the card or on the staged host
        path. Verdicts equal the sw provider's on every route."""
        ops = swmod.bls_aggregate_operands(keys, signature)
        if ops is None:
            return False
        pairs = blsagg.stage_pairs(ops[0], list(messages), ops[1])
        out = False if pairs is None else self._bls_pairing_check(pairs)
        self.stats["bls_aggregate_checks"] += 1
        return out

    def _bls_pairing_enabled(self) -> bool:
        """The BLS kernels' knob (CUDA.BLSPairing): as set, else on for a
        CUDA device and off on the CPU."""
        if self._bls_pairing is not None:
            return self._bls_pairing
        return self.device.type == "cuda"

    def _bls_pairing_check(self, pairs) -> bool:
        """One staged pair list: the card's kernels when the knob is on
        and the pair count reaches `max(2, MinBatch // 4)`, else the
        staged host path (routing by size, as the reference does)."""
        if (not self._bls_pairing_enabled()
                or len(pairs) < max(2, self._min_batch // 4)):
            return blsagg.check_products(blsagg.miller_products(pairs))
        with self._dispatch_span():
            return self._dispatch_bls_pairing(pairs)

    @tracing.traced("tpu.bls_pairing")
    def _dispatch_bls_pairing(self, pairs) -> bool:
        """Pad the pairs to a power-of-two bucket (masked filler lanes
        contribute Fp12 one), stage them, and run one Miller, one reduce
        and one final-exp launch; one verdict comes back."""
        n = len(pairs)
        staged = blsk.stage_pairs(pairs, pad_to=_pow2(n))
        start = self._mark()
        staged = blsk.to_device(staged, self.device)
        with self._count_launches():
            out = blsk.pairs_product_is_one(*staged)
        end = self._mark_end()
        ok = bool(out.cpu()[0])
        self._note_busy(start, end)
        self.stats["pairing_batches"] += 1
        self.stats["pairing_pairs"] += n
        return ok

    @contextlib.contextmanager
    def _count_launches(self):
        """Add the kernels launched inside the block to the stats."""
        before = {k: getattr(*c) for k, c in LAUNCH_COUNTERS.items()}
        try:
            yield
        finally:
            for k, c in LAUNCH_COUNTERS.items():
                self.stats[k] += getattr(*c) - before[k]

    def _chunked(self, bucket, run, tables=()):
        """Call run(c, *tables) for each `chunk` of the bucket, c(a)
        putting a chunk of host array `a` on the card; count the kernels
        launched and return a thunk that waits for the (bucket,) numpy
        verdicts and books the card's time from the first copy to the
        last launch. With a mesh, `_chunked_mesh` instead."""
        if self._mesh is not None:
            return self._chunked_mesh(bucket, run, tables)
        outs = []
        start = self._mark()
        with self._count_launches():
            for lo in range(0, bucket, self._chunk):
                def c(a, lo=lo):
                    return torch.from_numpy(np.ascontiguousarray(
                        a[lo:lo + self._chunk])).to(self.device)
                outs.append(run(c, *tables))
        end = self._mark_end()

        def wait():
            out = torch.cat(outs).cpu().numpy()
            self._note_busy(start, end)
            return out
        return wait

    def _chunked_mesh(self, bucket, run, tables):
        """`_chunked` over the serving mesh (fabric_tpu's sharded
        dispatch): each chunk (`_mesh_chunk`) split into contiguous
        slices, one a position (`parallel.shard_slices`); a position's
        slice staged by `_shard_put` and run(c, *tables) launched on its
        stream, against the tables' copies on its device. The thunk waits
        for every position, records the per-position readings
        (`_record_shard_stats`) and returns the verdicts in lane
        order."""
        mesh = self._mesh
        pos_full = [self._device_index(p) for p in range(mesh.size)]
        copies = [None if t is None else self._replicas_of(t, mesh)
                  for t in tables]
        for pos, s in enumerate(mesh.streams):
            if s is not None:
                # table builds and copies ran on the device's current
                # stream; a table evicted meanwhile must outlive the
                # position's use of it
                s.wait_stream(torch.cuda.current_stream(mesh.devices[pos]))
                for r in copies:
                    if r is not None:
                        r[mesh.devices[pos]].record_stream(s)
        chunk = self._mesh_chunk(bucket)
        tdev = [0.0] * mesh.size
        lanes = [0] * mesh.size
        outs = []                   # (position, verdicts) in lane order
        t_disp0 = time.perf_counter()
        with self._count_launches():
            for lo in range(0, bucket, chunk):
                hi = min(lo + chunk, bucket)
                for pos, sl in enumerate(parallel.shard_slices(hi - lo,
                                                               mesh)):
                    if sl.start == sl.stop:
                        continue
                    dev = mesh.devices[pos]
                    c = self._shard_put(pos, pos_full[pos], dev,
                                        lo + sl.start, lo + sl.stop, tdev)
                    with mesh.stream(pos):
                        outs.append((pos, run(c, *(
                            None if r is None else r[dev] for r in copies))))
                    lanes[pos] = sl.stop - sl.start
                self.stats["shard_dispatches"] += 1
        ends = []
        for s in mesh.streams:
            ev = None
            if s is not None:
                ev = torch.cuda.Event()
                ev.record(s)
            ends.append(ev)

        def wait():
            self._record_shard_stats(mesh, pos_full, ends, tdev, lanes,
                                     t_disp0)
            return torch.cat([o.cpu() for _, o in outs]).numpy()
        return wait

    def _shard_put(self, pos, full_pos, dev, lo, hi, tdev):
        """The span feeder of one position (fabric_tpu's `_shard_put`):
        c(a) puts lanes [lo, hi) of host array `a` on `dev`, on the
        position's stream (the caller's context), after the per-position
        fault points (arg = the full-mesh position, so chaos targets
        position k whatever the serving mesh). Its host seconds go to
        tdev[pos]; a failure becomes DeviceLostError(full_pos)."""
        def c(a):
            t0 = time.perf_counter()
            try:
                faults.check("tpu.device_lost", arg=full_pos)
                faults.check("tpu.device_straggler", arg=full_pos)
                return torch.from_numpy(np.ascontiguousarray(
                    a[lo:hi])).to(dev)
            except Exception as e:
                raise DeviceLostError(full_pos, e) from e
            finally:
                tdev[pos] += time.perf_counter() - t0
        return c

    def _record_shard_stats(self, mesh, pos_full, ends, tdev, lanes,
                            t_disp0) -> None:
        """The per-position readings of a sharded batch, at its wait:
        transfer seconds (`_shard_put`), lanes of the last chunk, and the
        ready lag from the first dispatch to each position's end event,
        sampled in a per-batch rotating order (a reading is an upper
        bound given the positions sampled before it, so a straggler shows
        as a step; the rotation keeps a slow position from always being
        sampled first). They feed `shard_stats`, the
        `device.{transfer,ready}.d<k>` stages, the busy time and the
        straggler strikes."""
        npos = mesh.size
        rot = self._ready_rot % npos
        self._ready_rot += 1
        order = list(range(rot, npos)) + list(range(rot))
        ready = [0.0] * npos
        for pos in order:
            if ends[pos] is not None:
                ends[pos].synchronize()
            ready[pos] = round(time.perf_counter() - t_disp0, 6)
        self.shard_stats = {"transfer_s": [round(t, 6) for t in tdev],
                            "ready_s": ready, "lanes": list(lanes)}
        for pos in range(npos):
            gi = pos_full[pos]
            tracing.observe_stage(f"device.transfer.d{gi}", tdev[pos])
            tracing.observe_stage(f"device.ready.d{gi}", ready[pos])
            self._devicecost.busy.note(gi, ready[pos])
        self.stats["shard_devices"] = npos
        self.stats["shard_skew_s"] = round(max(ready) - min(ready), 6)
        dh = self._devhealth
        dh.observe_shard([pos_full[p] for p in order],
                         [tdev[p] for p in order], [ready[p] for p in order])
        self.stats.update(dh.totals())

    def _resolve_tables(self, key_map, key_idx):
        """Canonical slot order + the key set's tables: Q16 (with G16)
        when it is resident or may be made resident (`_q16_cached`), else
        Q8 with the 8-bit G table. Returns (key_idx remapped, K, q_flat,
        g16 or None, q16?)."""
        order, key_idx = self._canonical_key_order(key_map, key_idx)
        K = 1
        while K < len(order):
            K *= 2
        qk = np.zeros((K, 64), dtype=np.uint8)
        for i, kb in enumerate(order):
            qk[i] = np.frombuffer(kb, dtype=np.uint8)
        cache_key = tuple(order)
        if self._use_g16:
            q16 = self._q16_cached(cache_key, K, qk)
            if q16 is not None:
                g16 = comb.g16_resident(self.device)
                if g16 is None:
                    g16 = self._timed(comb.g16_tables, self.device)
                return key_idx, K, q16, g16, True
        return key_idx, K, self._q8_cached(cache_key, K, qk), None, False

    def _timed(self, fn, *args):
        """Run a table build to completion on the card and add its
        seconds to stats["table_build_s"]."""
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._bump("table_build_s", time.perf_counter() - t0)
        return out

    def _bump(self, stat: str, by=1) -> None:
        with self._q16_lock:
            self.stats[stat] += by

    # -- the Q tables' lifecycle: fabric_tpu's _q16_cached, q8_cached and
    #    warm-key persistence --

    def _q16_est_bytes(self, K: int) -> int:
        return comb.NWIN_G16 * K * comb.NENT_G16 * 3 * limb.L * 4

    def _q8_est_bytes(self, K: int) -> int:
        return comb.NWIN * K * comb.NENT * 3 * limb.L * 4

    # a victim used within this many lookups is "hot": never evicted for
    # a no-hotter newcomer, which is denied Q16 for _DENY_TTL lookups
    # instead (a working set larger than the budget pins the resident
    # tables and serves the overflow on the 8-bit route rather than
    # rebuilding tables every few blocks). _HOT_WINDOW is also the
    # half-life of the per-set request rate.
    _HOT_WINDOW = 16
    _DENY_TTL = 256
    _HEAT_MAX_ENTRIES = 4096

    def _q16_heat_bump(self, cache_key, now) -> float:
        """The set's request rate, decayed with a half-life of
        _HOT_WINDOW lookups, after this request. Denied sets accrue it
        too, so a live working set can out-bid cooling residents."""
        heat = self._q16_heat
        last = self._q16_last_req.get(cache_key, now)
        h = (heat.get(cache_key, 0.0)
             * 0.5 ** ((now - last) / self._HOT_WINDOW) + 1.0)
        heat[cache_key] = h
        self._q16_last_req[cache_key] = now
        if len(heat) > self._HEAT_MAX_ENTRIES:
            # bound the bookkeeping of a node that sees many key sets
            stale = [k for k, t in self._q16_last_req.items()
                     if now - t > 4 * self._DENY_TTL
                     and k not in self._q16_cache]
            for k in stale:
                heat.pop(k, None)
                self._q16_last_req.pop(k, None)
                self._q16_denied.pop(k, None)
        return h

    def _evict_q16(self, victim) -> None:
        """Drop a resident Q16 table (under _q16_lock); a prewarmed set no
        live batch asked for is stale and leaves the warm dir too."""
        evicted = self._q16_cache.pop(victim)
        self._q16_last_use.pop(victim, None)
        self._q16_bytes -= evicted.numel() * 4
        self.stats["q16_evictions"] += 1
        self.stats["q16_cache_bytes"] = self._q16_bytes
        self.stats["q16_resident_sets"] = len(self._q16_cache)
        if victim in self._q16_prewarmed:
            self._q16_prewarmed.discard(victim)
            self._drop_warm_keys(victim)

    def _q16_cached(self, cache_key, K: int, qk: np.ndarray,
                    prewarm: bool = False):
        """The key set's 16-bit Q table from a byte-bounded LRU; on a miss
        the warm dir's persisted bytes, else a build. None keeps the set
        on the 8-bit route: one table alone exceeds the budget, the set is
        being restored or built by another thread, or the budget is full
        of hotter tables in use (adaptive residency).

        prewarm=True is a restore of a persisted set: it fills only free
        budget, goes in cold (evictable by any live request) and is not
        recorded as most recently used. The disk read and the build run
        outside _q16_lock; a table raced in meanwhile is kept and ours
        dropped, without counting its bytes twice."""
        if not prewarm:
            self._raise_table_error(cache_key)
        with self._q16_lock:
            self._q16_batch_no += 1
            now = self._q16_batch_no
            my_heat = (0.0 if prewarm
                       else self._q16_heat_bump(cache_key, now))
            q16 = self._q16_cache.pop(cache_key, None)
            if q16 is not None:
                self._q16_cache[cache_key] = q16          # most recent
                if not prewarm:
                    self._q16_last_use[cache_key] = now
                    # a live batch claims a prewarmed table
                    self._q16_prewarmed.discard(cache_key)
                return q16
            est = self._q16_est_bytes(K)
            if est > self._table_cache_bytes:
                self.stats["q16_oversize_skips"] += 1
                logger.warning(
                    "16-bit Q table for %d keys needs %.1f GB > "
                    "TableCacheMB budget (%.1f GB); staying on the 8-bit "
                    "Q path for this key set", K, est / 2**30,
                    self._table_cache_bytes / 2**30)
                return None
            denied_at = self._q16_denied.get(cache_key)
            if denied_at is not None and now - denied_at < self._DENY_TTL:
                # a denied set hotter than the coldest resident re-earns an
                # eviction attempt before its TTL runs out
                coldest = min((self._q16_heat.get(k, 0.0)
                               for k in self._q16_cache), default=0.0)
                if my_heat <= coldest:
                    self.stats["q16_adaptive_skips"] += 1
                    return None
            if not prewarm and cache_key in self._q16_loading:
                # restored or built by another thread: ride the 8-bit
                # route now, and evict nothing for a None
                self.stats["q16_loading_skips"] += 1
                return None
            while (self._q16_cache
                   and self._q16_bytes + est > self._table_cache_bytes):
                if prewarm:
                    # a restore fills free budget only
                    return None
                victim = next(iter(self._q16_cache))
                if (victim not in self._q16_prewarmed
                        and now - self._q16_last_use.get(victim, 0)
                        < self._HOT_WINDOW
                        and self._q16_heat.get(victim, 0.0) >= my_heat):
                    # every evictable resident is hotter and in use:
                    # deny this set the 16-bit route for a while
                    self._q16_denied[cache_key] = now
                    if len(self._q16_denied) > self._HEAT_MAX_ENTRIES:
                        self._q16_denied = {
                            k: t for k, t in self._q16_denied.items()
                            if now - t < self._DENY_TTL}
                    self.stats["q16_adaptive_skips"] += 1
                    logger.warning(
                        "q16 table budget (%.1f GB) is full of hot key "
                        "sets; serving this %d-key set on the 8-bit path "
                        "(q16_adaptive_skips counts these; raise "
                        "TableCacheMB to fit the working set)",
                        self._table_cache_bytes / 2**30, K)
                    return None
                self._evict_q16(victim)
            # in flight: a concurrent live miss for this set rides the
            # 8-bit route instead of building it again
            self._q16_loading.add(cache_key)
        try:
            t0 = time.perf_counter()
            preloaded = self._load_q16_table(cache_key, K)
            if preloaded is not None:
                q16 = self._table_to_device(preloaded)
                self._bump("table_load_s", time.perf_counter() - t0)
                self._bump("q16_disk_loads")
            else:
                if not prewarm:
                    # recorded before the persist threads start: their
                    # publish step deletes the bytes of unrecorded sets
                    self._record_warm_keys(cache_key)
                q16 = self._build_q16_table(cache_key, K, qk)
                self._persist_q16_table(cache_key, q16)
            with self._q16_lock:
                raced = self._q16_cache.pop(cache_key, None)
                if raced is not None:
                    # another thread restored or built it meanwhile: keep
                    # the resident table (already counted), drop ours
                    self._q16_cache[cache_key] = raced
                    if not prewarm:
                        self._q16_last_use[cache_key] = now
                        self._q16_prewarmed.discard(cache_key)
                        self._q16_denied.pop(cache_key, None)
                    return raced
                self._q16_cache[cache_key] = q16
                self._q16_bytes += q16.numel() * 4
                if prewarm:
                    self._q16_prewarmed.add(cache_key)
                    self._q16_last_use[cache_key] = 0     # cold until used
                else:
                    self._q16_last_use[cache_key] = now
                    self._q16_denied.pop(cache_key, None)
                    # concurrent misses for different sets may both have
                    # passed the eviction check: shed cold LRU tables
                    # until the budget holds (hot ones stay)
                    while (self._q16_bytes > self._table_cache_bytes
                           and len(self._q16_cache) > 1):
                        victim = next(iter(self._q16_cache))
                        if victim == cache_key or (
                                victim not in self._q16_prewarmed
                                and now - self._q16_last_use.get(victim, 0)
                                < self._HOT_WINDOW):
                            break
                        self._evict_q16(victim)
                self.stats["q16_cache_bytes"] = self._q16_bytes
                self.stats["q16_resident_sets"] = len(self._q16_cache)
        finally:
            with self._q16_lock:
                self._q16_loading.discard(cache_key)
        if not prewarm and preloaded is not None:
            # a set restored from disk is live again: most recent in the
            # warm file
            self._record_warm_keys(cache_key)
        return q16

    def _build_q16_table(self, cache_key, K: int, qk: np.ndarray):
        """Q8 (the resident one, else built), handed to persistence: it is
        the route a restarted node serves on while this set's Q16 bytes
        stream back; then Q16 from it on the device."""
        q8 = self._q8_once(cache_key, lambda: self._build_q8_table(K, qk))
        self._persist_q8_table(cache_key, q8)
        q16 = self._timed(comb.build_q16_tables, q8, K)
        self._bump("q16_builds")
        return q16

    def _build_q8_table(self, K: int, qk: np.ndarray) -> torch.Tensor:
        q = torch.from_numpy(qk).to(self.device)
        q8 = self._timed(comb.build_q_tables,
                         limb.be_bytes_to_limbs(q[:, :32]),
                         limb.be_bytes_to_limbs(q[:, 32:]))
        self._bump("q8_builds")
        return q8

    def _q8_once(self, cache_key, make) -> torch.Tensor:
        """The key set's 8-bit Q table from the count-bounded LRU, else
        make()'s: one make at a time per set, a concurrent miss waiting
        for it (a make that raises leaves the next waiter to try)."""
        while True:
            with self._q16_lock:
                q8 = self._q8_cache.pop(cache_key, None)
                if q8 is not None:
                    self._q8_cache[cache_key] = q8        # most recent
                    return q8
                pending = self._q8_loading.get(cache_key)
                if pending is None:
                    mine = self._q8_loading[cache_key] = threading.Event()
                    break
            pending.wait()
        try:
            q8 = make()
            with self._q16_lock:
                self._q8_cache[cache_key] = q8
                while len(self._q8_cache) > Q8_CACHE_SETS:
                    self._q8_cache.popitem(last=False)
        finally:
            with self._q16_lock:
                del self._q8_loading[cache_key]
            mine.set()
        return q8

    def _q8_cached(self, cache_key, K: int, qk: np.ndarray) -> torch.Tensor:
        """The 8-bit route's table: resident, else the warm dir's bytes,
        else a build. With UseG16 false the Q8 file is the set's warm
        state (recorded and persisted); with G16 on it is persisted for
        recorded sets only, the restore window's route."""
        self._raise_table_error(cache_key)

        def load_or_build():
            t0 = time.perf_counter()
            pre = self._load_q8_table(cache_key, K)
            if pre is not None:
                q8 = self._table_to_device(pre)
                self._bump("table_load_s", time.perf_counter() - t0)
                self._bump("q8_disk_loads")
                if not self._use_g16:
                    self._record_warm_keys(cache_key)     # most recent
                return q8
            q8 = self._build_q8_table(K, qk)
            if not self._use_g16:
                # recorded first, or the publish step deletes the file
                self._record_warm_keys(cache_key)
                self._persist_q8_table(cache_key, q8)
            elif [kb.hex() for kb in cache_key] in self._load_warm_keys():
                self._persist_q8_table(cache_key, q8)
            return q8
        return self._q8_once(cache_key, load_or_build)

    # -- device errors of the background threads --

    def _store_table_error(self, cache_key, err: BaseException) -> None:
        with self._q16_lock:
            self._table_errors.setdefault(cache_key, err)

    def _raise_table_error(self, cache_key) -> None:
        """Raise, once, a device error a background thread met on this key
        set (or on the restore thread's G16 build)."""
        with self._q16_lock:
            err = (self._table_errors.pop(cache_key, None)
                   or self._table_errors.pop(None, None))
        if err is not None:
            raise err

    def _first_table_error(self):
        with self._q16_lock:
            return next(iter(self._table_errors.values()), None)

    # -- device <-> host copies of a table, off the serving stream --

    def _table_to_host(self, table: torch.Tensor, ready) -> np.ndarray:
        """The table's bytes on the host. On the card: a copy on a side
        stream into pinned memory, after the `ready` event (recorded when
        the table was built), the table kept alive for the copy even if it
        is evicted meanwhile."""
        if not table.is_cuda:
            return table.contiguous().numpy()
        side = torch.cuda.Stream(table.device)
        host = torch.empty(table.shape, dtype=table.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            table.record_stream(side)
            host.copy_(table, non_blocking=True)
        side.synchronize()
        return host.numpy()

    def _table_to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Persisted bytes as a table on the provider's device. On the
        card: pinned host memory, a copy on a side stream (serving kernels
        on the default stream are not queued behind it), synchronized
        before the table is returned and published."""
        host = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return host
        out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        side = torch.cuda.Stream(self.device)
        # the new block may be one the default stream's queued work frees
        side.wait_stream(torch.cuda.current_stream(self.device))
        host = host.pin_memory()
        with torch.cuda.stream(side):
            out.copy_(host, non_blocking=True)
        side.synchronize()
        return out

    # -- warm-key persistence (restart-to-first-block latency) --

    _WARM_FILE = "warm_keysets.json"
    _WARM_MAX_SETS = 8

    def _table_path(self, cache_key, prefix: str = "qtab16") -> str:
        h = hashlib.sha256(b"".join(cache_key)).hexdigest()[:32]
        return os.path.join(self._warm_keys_dir, f"{prefix}_{h}.npy")

    def _write_warm_keys(self, sets: list) -> None:
        path = os.path.join(self._warm_keys_dir, self._WARM_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sets, f)
        os.replace(tmp, path)

    def _drop_table_files(self, cache_key) -> None:
        for prefix in ("qtab16", "qtab8"):
            tab = self._table_path(cache_key, prefix)
            if os.path.exists(tab):
                os.remove(tab)
            comb.drop_digest_sidecar(tab)

    def _record_warm_keys(self, cache_key) -> None:
        """Put the key set first in the warm file (hex keys in canonical
        order, MRU first, at most _WARM_MAX_SETS), reclaiming the table
        bytes of the sets it pushes off. Disk failures only log."""
        if not self._warm_keys_dir:
            return
        try:
            os.makedirs(self._warm_keys_dir, exist_ok=True)
            with self._warm_lock:
                sets = self._load_warm_keys()
                entry = [kb.hex() for kb in cache_key]
                if entry in sets:
                    sets.remove(entry)
                sets.insert(0, entry)
                trimmed = sets[self._WARM_MAX_SETS:]
                del sets[self._WARM_MAX_SETS:]
                self._write_warm_keys(sets)
                for old in trimmed:
                    self._drop_table_files(
                        tuple(bytes.fromhex(k) for k in old))
        except OSError:
            logger.exception("could not persist warm key set")

    def _drop_warm_keys(self, cache_key) -> None:
        """Remove a stale persisted key set (prewarmed, never used by a
        live batch before its eviction) and its table bytes. Disk
        failures only log."""
        if not self._warm_keys_dir:
            return
        try:
            with self._warm_lock:
                sets = self._load_warm_keys()
                entry = [kb.hex() for kb in cache_key]
                if entry in sets:
                    sets.remove(entry)
                    self._write_warm_keys(sets)
                self._drop_table_files(cache_key)
        except OSError:
            logger.exception("could not drop stale warm key set")

    def _load_warm_keys(self) -> list:
        if not self._warm_keys_dir:
            return []
        path = os.path.join(self._warm_keys_dir, self._WARM_FILE)
        try:
            with open(path) as f:
                sets = json.load(f)
        except FileNotFoundError:
            return []
        except (OSError, ValueError):
            logger.exception("unreadable warm key sets; ignoring")
            return []
        if not isinstance(sets, list):
            return []
        return [s for s in sets if isinstance(s, list) and all(
            isinstance(k, str) and len(k) == 128 for k in s)]

    def _persist_table(self, cache_key, table: torch.Tensor,
                       prefix: str) -> None:
        """Write a built table's bytes (`np.save`, a sha256 sidecar, tmp +
        rename) in a background thread: the serving path does not wait for
        the copy or the write. A failed write is counted
        (warm_table_persist_failures) and logged; a failed device copy is
        stored and raised by flush_warm_tables and the set's next
        lookup."""
        if not self._warm_keys_dir:
            return
        ready = None
        if table.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(table.device))

        def work():
            try:
                arr = self._table_to_host(table, ready)
            except Exception as e:      # re-raised on the serving path
                self._store_table_error(cache_key, e)
                return
            try:
                os.makedirs(self._warm_keys_dir, exist_ok=True)
                path = self._table_path(cache_key, prefix)
                tmp = f"{path}.tmp{threading.get_ident()}"
                with open(tmp, "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
                digest = comb.file_sha256(tmp)
                # published under the warm lock: a concurrent drop or trim
                # either sees the file and deletes it, or has already
                # removed the set, and then we delete our own write
                with self._warm_lock:
                    os.replace(tmp, path)
                    if [kb.hex() for kb in cache_key] \
                            not in self._load_warm_keys():
                        os.remove(path)
                        comb.drop_digest_sidecar(path)
                    else:
                        comb.write_digest_sidecar(path, digest)
            except OSError:
                self._bump("warm_table_persist_failures")
                logger.exception("could not persist %s table bytes", prefix)

        t = threading.Thread(target=work, daemon=True,
                             name=f"{prefix}-table-persist")
        with self._q16_lock:
            self._persist_threads = [p for p in self._persist_threads
                                     if p.is_alive()] + [t]
        t.start()

    def _persist_q16_table(self, cache_key, q16) -> None:
        self._persist_table(cache_key, q16, "qtab16")

    def _persist_q8_table(self, cache_key, q8) -> None:
        self._persist_table(cache_key, q8, "qtab8")

    def flush_warm_tables(self, timeout: float = 120.0) -> None:
        """Join the table persist writers and the background restore
        (shutdown, benchmarks, tests), `timeout` bounding the whole wait;
        then raise a device error either met."""
        deadline = time.monotonic() + timeout
        if self._restore_thread is not None:
            self._restore_thread.join(max(0.0, deadline - time.monotonic()))
        with self._q16_lock:
            threads = list(self._persist_threads)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        stuck = [t for t in threads if t.is_alive()]
        if stuck:
            logger.warning(
                "%d warm-table persist writer(s) still running after the "
                "%.0fs flush deadline; leaving them detached", len(stuck),
                timeout)
        err = self._first_table_error()
        if err is not None:
            raise err

    def _load_table(self, cache_key, want_bytes: int, prefix: str):
        """A persisted table's array, or None (absent, failing its sidecar,
        unreadable, or of another size or type: the caller rebuilds)."""
        if not self._warm_keys_dir:
            return None
        path = self._table_path(cache_key, prefix)
        try:
            if comb.verify_digest_sidecar(path) is False:
                logger.warning("persisted %s table %s fails its sha256 "
                               "sidecar; rebuilding", prefix, path)
                return None
            arr = np.load(path)
        except FileNotFoundError:
            return None
        except (OSError, ValueError, EOFError):
            logger.exception("unreadable persisted %s table; rebuilding",
                             prefix)
            return None
        if arr.dtype != np.int32 or arr.nbytes != want_bytes:
            logger.warning("persisted %s table %s is %d bytes (%s), want "
                           "%d; rebuilding", prefix, path, arr.nbytes,
                           arr.dtype, want_bytes)
            return None
        return arr

    def _load_q16_table(self, cache_key, K: int):
        return self._load_table(cache_key, self._q16_est_bytes(K), "qtab16")

    def _load_q8_table(self, cache_key, K: int):
        return self._load_table(cache_key, self._q8_est_bytes(K), "qtab8")

    def _warm_candidates(self) -> list:
        """The persisted key sets with Q16 bytes on disk, MRU first, each
        marked in flight (_q16_loading) until its restore ends."""
        out = []
        with self._q16_lock:
            for entry in self._load_warm_keys():
                cache_key = tuple(bytes.fromhex(k) for k in entry)
                if os.path.exists(self._table_path(cache_key)):
                    out.append(cache_key)
                    self._q16_loading.add(cache_key)
        return out

    def _prewarm_tables(self, candidates=None) -> int:
        """Restore the persisted key sets' Q16 tables, MRU first, until
        the byte budget is full, from their bytes (a set whose file fails
        its checks is rebuilt). A device error is stored for the set.
        Returns the sets restored."""
        if candidates is None:
            candidates = self._warm_candidates()
        warmed = 0
        try:
            for cache_key in candidates:
                try:
                    K = 1
                    while K < len(cache_key):
                        K *= 2
                    qk = np.zeros((K, 64), dtype=np.uint8)
                    for i, kb in enumerate(cache_key):
                        qk[i] = np.frombuffer(kb, dtype=np.uint8)
                    got = self._q16_cached(cache_key, K, qk, prewarm=True)
                    if got is not None:
                        warmed += 1
                    else:
                        with self._q16_lock:
                            full = self._q16_bytes and (
                                self._q16_est_bytes(K) + self._q16_bytes
                                > self._table_cache_bytes)
                        if full:
                            # older sets stay on disk for live misses
                            break
                except Exception as e:      # re-raised on the serving path
                    self._store_table_error(cache_key, e)
                finally:
                    with self._q16_lock:
                        self._q16_loading.discard(cache_key)
        finally:
            with self._q16_lock:
                self._q16_loading.difference_update(candidates)
        if warmed:
            logger.info("restored Q tables for %d persisted key set(s)",
                        warmed)
        return warmed

    def prewarm(self, wait_restore: bool = False) -> None:
        """Ready the provider before the node's first block: build or load
        the native batch prep and, on the card, every kernel library; with
        G16 on, start one background thread that builds the 16-bit G
        table and then restores the warm dir's persisted key sets (see
        _prewarm_tables). Until a set's restore lands, live batches for it
        ride the 8-bit route. wait_restore=True joins the thread and
        raises a device error it met. The reference's buckets,
        key_counts, msg_nbs and bounded arguments choose the shapes to
        compile ahead of time; the port's kernels take any shape, so it
        has none of them."""
        with devicecost.recording(self._devicecost):
            native.load()
            if self.device.type == "cuda":
                kernels.build_all()
        if not self._use_g16:
            return
        candidates = self._warm_candidates()

        def restore():
            try:
                comb.g16_tables(self.device)
                self._prewarm_tables(candidates)
            except Exception as e:          # re-raised on the serving path
                self._store_table_error(None, e)
            finally:
                with self._q16_lock:
                    self._q16_loading.difference_update(candidates)

        self._restore_thread = threading.Thread(
            target=restore, daemon=True, name="qtab-restore")
        self._restore_thread.start()
        if wait_restore:
            self._restore_thread.join()
            err = self._first_table_error()
            if err is not None:
                raise err
