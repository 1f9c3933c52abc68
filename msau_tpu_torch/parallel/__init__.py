"""Data- and spatial-parallel training over ``torch.distributed`` (port of
``msau_tpu.parallel``): meshes and batch shards (``sharding``), H-shards
with halo exchange (``spatial``)."""

from msau_tpu_torch.parallel.sharding import (
    batch_sharding,
    make_mesh,
    maybe_initialize_distributed,
    replicated,
    shard_batch,
    spatial_sharding,
)
from msau_tpu_torch.parallel.spatial import (
    SpatialShards,
    halo_exchange,
    sharded_conv2d,
    spatial_shardings,
)

__all__ = ["make_mesh", "batch_sharding", "spatial_sharding", "replicated",
           "shard_batch", "maybe_initialize_distributed", "SpatialShards",
           "halo_exchange", "sharded_conv2d", "spatial_shardings"]
