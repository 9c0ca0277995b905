"""The width axis: each image's azimuth columns split over a width group.

GSPMD has no counterpart to copy: the JAX package shards W with a
``PartitionSpec`` (r2dm_tpu/parallel/mesh.py:74-81) and XLA inserts the halo
permutes around every ring conv and FIR resample and the cross-shard sums of
GroupNorm's statistics. Here those collectives are written out, over the
width group of a ``World`` (``mesh.py``; rank ``w`` of a group holds columns
``[w*Wimg/W, (w+1)*Wimg/W)``):

- ``shard_columns`` / ``gather_columns``: this rank's columns of a full
  image, and the full image from every rank's columns;
- ``halo_exchange``: the left neighbour's last columns and the right
  neighbour's first, the ring wrapping across ranks (rank 0's left
  neighbour is rank W-1), from one ``all_gather`` of the two edge strips;
- ``all_reduce_sum_``: a sum over the width group, in place.

The W axis is dim 2 of NHWC (the default) and dim 3 of NCHW. Tensors cross
the group as raw bytes, so any dtype arrives bit for bit. Nothing is copied
to the host here: a group whose backend cannot take the tensor's device
raises. Each collective adds its host time to ``world.collective_seconds``
and one to ``world.collective_calls``.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .mesh import World


def sharded(world) -> bool:
    """Whether ``world`` splits the columns over more than one rank."""
    return world is not None and world.width_size > 1


def _all_gather(t: torch.Tensor, world: World) -> list:
    """Every width rank's ``t`` (all of one shape), in width-rank order."""
    t = t.contiguous()
    raw = t.view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(world.width_size)]
    t0 = time.perf_counter()
    dist.all_gather(parts, raw, group=world.width_group)
    world.collective_seconds += time.perf_counter() - t0
    world.collective_calls += 1
    return [p.view(t.dtype).reshape(t.shape) for p in parts]


def shard_columns(x: torch.Tensor, world: World, dim: int = 2) -> torch.Tensor:
    """This width rank's columns of the full-width ``x`` along ``dim``."""
    if not sharded(world):
        return x
    W, n = x.shape[dim], world.width_size
    if W % n:
        raise ValueError(f"{W} columns do not split over a {n}-way width axis")
    return x.narrow(dim, world.width_rank * (W // n), W // n).contiguous()


def gather_columns(x: torch.Tensor, world: World, dim: int = 2) -> torch.Tensor:
    """The full-width tensor from every width rank's columns, in order."""
    if not sharded(world):
        return x
    return torch.cat(_all_gather(x, world), dim=dim)


def halo_exchange(x: torch.Tensor, left: int, right: int, world: World, dim: int = 2):
    """(the left neighbour's last ``left`` columns, the right neighbour's
    first ``right`` columns) of ``x`` along ``dim``, each contiguous, from
    one all_gather of this rank's two edge strips."""
    Wl = x.shape[dim]
    if left > Wl or right > Wl:
        raise ValueError(f"a halo of ({left}, {right}) columns needs at least that many a rank, have {Wl}")
    edges = torch.cat([x.narrow(dim, 0, right), x.narrow(dim, Wl - left, left)], dim=dim)
    parts = _all_gather(edges, world)
    w, n = world.width_rank, world.width_size
    return (parts[(w - 1) % n].narrow(dim, right, left).contiguous(),
            parts[(w + 1) % n].narrow(dim, 0, right).contiguous())


def all_reduce_sum_(t: torch.Tensor, world: World) -> torch.Tensor:
    """``t`` summed over the width group, in place; returns ``t``."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=world.width_group)
    world.collective_seconds += time.perf_counter() - t0
    world.collective_calls += 1
    return t
