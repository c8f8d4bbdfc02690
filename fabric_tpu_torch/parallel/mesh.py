"""The batch mesh: the port's counterpart of fabric_tpu/parallel/mesh.py.

The reference shards the signature-batch axis of one XLA program over a
1-D `jax.sharding.Mesh` (`P("batch")`: contiguous slices, one a device),
with the per-key tables replicated and no collective in the path. The
port does the same by hand: a `BatchMesh` is an ordered tuple of
`torch.device`s, a position each, with a CUDA stream a position; a
sharded call copies each position's contiguous slice to its device on
its stream and launches the same kernels there, against the table copy
on that device. Positions may repeat a device: two positions on cuda:0
are two streams sharing one card (how a one-card host runs the split),
and they share one table copy.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from fabric_tpu_torch.ops import comb

class BatchMesh:
    """Ordered mesh positions over devices, each with its own stream
    (None on the CPU, where work runs in the caller's order)."""

    def __init__(self, devices):
        devs = [torch.device(d) for d in devices]
        # "cuda" alone means the current card: name its index, so equal
        # devices compare equal
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.streams = tuple(
            torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> list:
        """The mesh's devices, each once, in position order."""
        return list(dict.fromkeys(self.devices))

    def stream(self, pos: int):
        """A context running position `pos`'s launches on its stream
        (nothing on the CPU)."""
        s = self.streams[pos]
        return (torch.cuda.stream(s) if s is not None
                else contextlib.nullcontext())


def batch_mesh(n_devices: int | None = None, devices=None) -> BatchMesh:
    """A mesh over the first `n_devices` of `devices` (default: every
    visible CUDA device, cuda:0 first)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return BatchMesh(devices)


def shard_slices(n: int, mesh: BatchMesh) -> list[slice]:
    """The contiguous slice of an n-lane batch each position takes: for
    n a multiple of the mesh size (callers pad to a bucket that is)
    `P("batch")`'s deal, n / size lanes each in position order; else
    ceil(n / size) each, the last positions taking what is left (a
    batch bucketed for a mesh that a rebuild has since resized)."""
    k = -(-n // mesh.size)
    return [slice(min(p * k, n), min((p + 1) * k, n))
            for p in range(mesh.size)]


def replicate(t: torch.Tensor, mesh: BatchMesh) -> dict:
    """{device: copy of t} over the mesh's distinct devices: one copy a
    device, not a position (t itself on its own device)."""
    return {d: t if t.device == d else t.to(d) for d in mesh.distinct()}


def sharded_comb_verify(mesh: BatchMesh, digest_words, key_idx, q_flat,
                        r, rpn, w, premask, g16=None, q16: bool = False):
    """The comb pipeline as a per-position program (the counterpart of
    `shardmap_comb_verify` and `sharded_comb_fns`): every lane operand
    split on the batch axis, the tables replicated a device, each
    position running `comb.comb_verify_with_tables` on its slice on its
    stream. Operands as `comb.comb_verify_with_tables` (host arrays or
    tensors); returns the (B,) bool verdicts on the CPU."""
    qs = replicate(q_flat, mesh)
    gs = replicate(g16, mesh) if g16 is not None else None
    outs, done = [], []
    for pos, sl in enumerate(shard_slices(int(premask.shape[0]), mesh)):
        if sl.start == sl.stop:
            continue
        dev = mesh.devices[pos]
        s = mesh.streams[pos]
        if s is not None:
            # the table copies were made on the device's current stream
            s.wait_stream(torch.cuda.current_stream(dev))
        with mesh.stream(pos):
            def put(a):
                return torch.as_tensor(np.asarray(a[sl]) if isinstance(
                    a, np.ndarray) else a[sl]).to(dev)
            outs.append(comb.comb_verify_with_tables(
                put(digest_words), put(key_idx), qs[dev], put(r), put(rpn),
                put(w), put(premask), g16=None if gs is None else gs[dev],
                q16=q16))
            if s is not None:
                ev = torch.cuda.Event()
                ev.record(s)
                done.append(ev)
    for ev in done:
        ev.synchronize()
    return torch.cat([o.cpu() for o in outs])
