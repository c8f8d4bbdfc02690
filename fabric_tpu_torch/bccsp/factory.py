"""BCCSP factory for the port: config-driven provider selection.

The counterpart of fabric_tpu/bccsp/factory.py. `BCCSP.Default` chooses
"CUDA" (the card) or "SW" (the port's pure-Python P-256 provider); the
`CUDA:` block carries the knobs the slice has, named as in the JAX
package's `TPU:` block (`TpuOpts`):

    {"Default": "CUDA",
     "CUDA": {"Device": "cuda:0" | "cpu", "MinBatch": 16, "MaxKeys": 16,
              "Chunk": 32768, "UseG16": true, "TableCacheMB": 6144,
              "HashOnHost": true, "FusedVerify": true, "MaxBlocks": 64,
              "Ed25519": true, "BLSPairing": true}}

With no Device the provider runs on cuda:0 and raises where CUDA is
absent; "cpu" runs the plain torch versions (the tests' choice).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from fabric_tpu_torch.bccsp.bccsp import BCCSP


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


@dataclass
class FactoryOpts:
    default: str = "SW"
    cuda: CudaOpts = field(default_factory=CudaOpts)

    @classmethod
    def from_config(cls, cfg: dict) -> "FactoryOpts":
        """Build from a core.yaml-style `BCCSP:` mapping."""
        cfg = cfg or {}
        c = cfg.get("CUDA") or {}
        return cls(
            default=(cfg.get("Default") or "SW").upper(),
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
            ),
        )


def new_bccsp(opts) -> BCCSP:
    """A provider from FactoryOpts or from a `BCCSP:` config mapping."""
    if isinstance(opts, dict):
        opts = FactoryOpts.from_config(opts)
    if opts.default == "SW":
        from fabric_tpu_torch.bccsp.sw import SWProvider
        return SWProvider()
    if opts.default == "CUDA":
        from fabric_tpu_torch.bccsp.cuda import CUDAProvider
        c = opts.cuda
        return CUDAProvider(device=c.device, min_batch=c.min_batch,
                            max_keys=c.max_keys, chunk=c.chunk,
                            use_g16=c.use_g16,
                            table_cache_bytes=c.table_cache_bytes,
                            hash_on_host=c.hash_on_host,
                            fused_verify=c.fused_verify,
                            max_blocks=c.max_blocks,
                            ed25519_enabled=c.ed25519,
                            bls_pairing=c.bls_pairing)
    raise ValueError(f"unknown BCCSP default {opts.default!r}")
