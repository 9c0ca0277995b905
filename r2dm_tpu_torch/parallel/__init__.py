"""Data parallelism across processes, one per card (the port of
``r2dm_tpu/parallel``; the width axis is not ported)."""

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

__all__ = [
    "World", "all_gather_objects", "any_rank", "broadcast_object", "check_mesh_shape", "gather_objects", "init",
    "parse_mesh",
]
