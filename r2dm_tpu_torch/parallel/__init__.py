"""Parallelism across processes, one per card: the data axis and the width
axis of a (data, width) mesh (the port of ``r2dm_tpu/parallel``)."""

from .mesh import (
    World,
    all_gather_objects,
    any_rank,
    broadcast_object,
    check_mesh_shape,
    gather_objects,
    init,
    parse_mesh,
)
from .width import all_reduce_max_bits_, all_reduce_sum_, gather_columns, halo_exchange, shard_columns, sharded

__all__ = [
    "World", "all_gather_objects", "all_reduce_max_bits_", "all_reduce_sum_", "any_rank", "broadcast_object",
    "check_mesh_shape", "gather_columns", "gather_objects", "halo_exchange", "init", "parse_mesh", "shard_columns",
    "sharded",
]
