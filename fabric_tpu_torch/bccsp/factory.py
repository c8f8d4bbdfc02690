"""BCCSP factory for the port: config-driven provider selection.

The counterpart of fabric_tpu/bccsp/factory.py. `BCCSP.Default` chooses
"CUDA" (the card) or "SW" (the port's pure-Python provider); the `SW:`
block carries the reference's software options (`SwOpts`) and the
`CUDA:` block the knobs the port has, named as in the JAX package's
`TPU:` block (`TpuOpts`):

    {"Default": "CUDA",
     "SW": {"Hash": "SHA2", "Security": 256,
            "FileKeyStore": {"KeyStore": "/var/hyperledger/keystore"}},
     "CUDA": {"Device": "cuda:0" | "cpu", "MinBatch": 16, "MaxKeys": 16,
              "Chunk": 32768, "UseG16": true, "TableCacheMB": 6144,
              "HashOnHost": true, "FusedVerify": true, "MaxBlocks": 64,
              "Ed25519": true, "BLSPairing": true,
              "WarmKeysDir": "/var/lib/peer/warmkeys",
              "Devices": 0,
              "DeviceHealth": {"TripThreshold": 1, "CooldownS": 30,
                               "StragglerSkewS": 2.0,
                               "StragglerStrikes": 3,
                               "ProbeTimeoutS": 5.0}}}

With no Device the provider runs on cuda:0 and raises where CUDA is
absent; "cpu" runs the plain torch versions (the tests' choice).
Devices sizes the batch mesh (the reference's `TPU.Devices`): unset or 0
is every visible CUDA device, 1 no mesh (the single-device path, no mesh
object), N the first N; an ask over the visible count clamps with a
warning, and a failed enumeration serves without a mesh and reports
`degraded_mesh:1/<ask>` in `health()`. A Device and a Devices over 1
together are an error (one names a device, the other a mesh); a Device
with Devices unset is that device alone. DeviceHealth takes the
reference's per-position quarantine keys (common/devicehealth.py).
WarmKeysDir (unset: no persistence) is where the provider keeps the key
sets it built Q tables for and those tables' bytes, which
`CUDAProvider.prewarm()` restores in a restarted process.
SW.FileKeyStore.KeyStore (unset: keys in memory only) is the directory of
`bccsp/keystore.py`'s FileKeyStore, in the reference's file format; the
software provider of either default writes its non-ephemeral ECDSA keys
there and `get_key` reads it first. SW.Hash and SW.Security are read and
kept as the reference keeps them: SHA2 at 256 bits is what both
packages implement.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from fabric_tpu_torch.bccsp.bccsp import BCCSP
from fabric_tpu_torch.common.devicehealth import DeviceHealthConfig

logger = logging.getLogger("fabric_tpu_torch.bccsp.factory")


@dataclass
class SwOpts:
    hash_family: str = "SHA2"
    security: int = 256
    keystore_path: Optional[str] = None


@dataclass
class CudaOpts:
    device: Optional[str] = None
    min_batch: int = 16
    max_keys: int = 16
    chunk: int = 32768
    # None = on for the card, off on the CPU
    use_g16: Optional[bool] = None
    table_cache_bytes: int = 6 << 30
    # with the fused tier off: hash message lanes on the host (True) or
    # with the SHA-256 kernel on the card (False)
    hash_on_host: bool = True
    # the fused tier (device SHA-256 + scalars + windows); None = on for
    # the card, off on the CPU; FTPU_FUSED=0/1 overrides
    fused_verify: Optional[bool] = None
    max_blocks: int = 64
    # the Ed25519 kernel; False serves Ed25519 lanes on the sw provider
    # (verdicts identical)
    ed25519: bool = True
    # the BLS12-381 aggregate kernels; None = on for the card, off on the
    # CPU; off serves every aggregate on the staged host path
    bls_pairing: Optional[bool] = None
    # key sets and Q table bytes persist here across restarts; None = off
    warm_keys_dir: Optional[str] = None
    # the batch mesh's size: None/0 = every visible CUDA device, 1 = no
    # mesh, N = the first N
    n_devices: Optional[int] = None
    # the per-position quarantine of the mesh
    device_health: DeviceHealthConfig = field(
        default_factory=DeviceHealthConfig)


@dataclass
class FactoryOpts:
    default: str = "SW"
    sw: SwOpts = field(default_factory=SwOpts)
    cuda: CudaOpts = field(default_factory=CudaOpts)

    @classmethod
    def from_config(cls, cfg: dict) -> "FactoryOpts":
        """Build from a core.yaml-style `BCCSP:` mapping."""
        cfg = cfg or {}
        s = cfg.get("SW") or {}
        c = cfg.get("CUDA") or {}
        dh = c.get("DeviceHealth") or {}
        dd = DeviceHealthConfig()
        return cls(
            default=(cfg.get("Default") or "SW").upper(),
            sw=SwOpts(
                hash_family=s.get("Hash", "SHA2"),
                security=int(s.get("Security", 256)),
                keystore_path=(s.get("FileKeyStore") or {}).get(
                    "KeyStore") or None),
            cuda=CudaOpts(
                device=c.get("Device") or None,
                min_batch=int(c.get("MinBatch", 16)),
                max_keys=int(c.get("MaxKeys", 16)),
                chunk=int(c.get("Chunk", 32768)),
                use_g16=(bool(c["UseG16"]) if c.get("UseG16") is not None
                         else None),
                table_cache_bytes=int(c.get("TableCacheMB", 6144)) << 20,
                hash_on_host=bool(c.get("HashOnHost", True)),
                fused_verify=(bool(c["FusedVerify"])
                              if c.get("FusedVerify") is not None else None),
                max_blocks=int(c.get("MaxBlocks", 64)),
                ed25519=bool(c.get("Ed25519", True)),
                bls_pairing=(bool(c["BLSPairing"])
                             if c.get("BLSPairing") is not None else None),
                warm_keys_dir=c.get("WarmKeysDir") or None,
                n_devices=(int(c["Devices"]) if c.get("Devices") is not None
                           else None),
                device_health=DeviceHealthConfig(
                    trip_threshold=int(dh.get("TripThreshold",
                                              dd.trip_threshold)),
                    cooldown_s=float(dh.get("CooldownS", dd.cooldown_s)),
                    straggler_skew_s=float(dh.get("StragglerSkewS",
                                                  dd.straggler_skew_s)),
                    straggler_strikes=int(dh.get("StragglerStrikes",
                                                 dd.straggler_strikes)),
                    probe_timeout_s=float(dh.get("ProbeTimeoutS",
                                                 dd.probe_timeout_s)),
                ),
            ),
        )


def _resolve_mesh(device: Optional[str], n_devices: Optional[int]):
    """CUDA.Device and CUDA.Devices -> (mesh, requested) for the provider
    (the reference's `_resolve_mesh`). A named Device with Devices unset,
    0 or 1 is that device alone; with Devices over 1 it is an error.
    Otherwise None/0 = every visible CUDA device, 1 = no mesh, N = the
    first N, clamped to the visible count with a warning. An enumeration
    that fails gives no mesh, and `requested` (the unmet ask, or "all")
    for the `degraded_mesh:1/<requested>` health part."""
    if device is not None:
        if n_devices is not None and n_devices > 1:
            raise ValueError(
                f"CUDA.Device {device!r} with CUDA.Devices {n_devices}: "
                "Device names one device, Devices a mesh")
        return None, None
    if n_devices == 1:
        return None, None
    import torch

    from fabric_tpu_torch import parallel
    try:
        avail = torch.cuda.device_count()
    except Exception:
        logger.exception(
            "could not enumerate CUDA devices for the %s-device mesh; "
            "serving on one device (set CUDA.Devices: 1 to silence)",
            n_devices or "all")
        return None, (n_devices if n_devices and n_devices > 1
                      else "all")
    nd = avail if not n_devices or n_devices <= 0 else n_devices
    if nd > avail:
        logger.warning("CUDA.Devices: %d exceeds the %d visible device(s); "
                       "clamping to %d", nd, avail, avail)
        nd = avail
    if nd <= 1:
        return None, None
    return parallel.batch_mesh(nd), None


def new_bccsp(opts) -> BCCSP:
    """A provider from FactoryOpts or from a `BCCSP:` config mapping."""
    if isinstance(opts, dict):
        opts = FactoryOpts.from_config(opts)
    ks = None
    if opts.sw.keystore_path:
        from fabric_tpu_torch.bccsp.keystore import FileKeyStore
        ks = FileKeyStore(opts.sw.keystore_path)
    if opts.default == "SW":
        from fabric_tpu_torch.bccsp.sw import SWProvider
        return SWProvider(ks)
    if opts.default == "CUDA":
        from fabric_tpu_torch.bccsp.cuda import CUDAProvider
        c = opts.cuda
        mesh, unmet = _resolve_mesh(c.device, c.n_devices)
        return CUDAProvider(device=c.device, min_batch=c.min_batch,
                            max_keys=c.max_keys, chunk=c.chunk,
                            use_g16=c.use_g16,
                            table_cache_bytes=c.table_cache_bytes,
                            hash_on_host=c.hash_on_host,
                            fused_verify=c.fused_verify,
                            max_blocks=c.max_blocks,
                            ed25519_enabled=c.ed25519,
                            bls_pairing=c.bls_pairing,
                            warm_keys_dir=c.warm_keys_dir,
                            keystore=ks, mesh=mesh,
                            device_health=c.device_health,
                            mesh_requested=unmet)
    raise ValueError(f"unknown BCCSP default {opts.default!r}")
