from fabric_tpu_torch.parallel.mesh import (  # noqa: F401
    BatchMesh,
    batch_mesh,
    replicate,
    shard_slices,
    sharded_comb_verify,
)
