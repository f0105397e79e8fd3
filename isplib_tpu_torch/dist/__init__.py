"""The row-sharded SpMM path: partition, halo exchange and per-shard
kernels (the counterpart of ``isplib_tpu.dist``)."""

from .partition import Shard, ShardedGraph, partition_rows
from .spmm_dist import (GroupMesh, LocalMesh, get_mesh, pad_features,
                        set_mesh, spmm_sharded, unpad_output)

__all__ = ["ShardedGraph", "Shard", "partition_rows", "spmm_sharded",
           "LocalMesh", "GroupMesh", "set_mesh", "get_mesh", "pad_features",
           "unpad_output"]
