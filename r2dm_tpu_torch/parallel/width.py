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
- ``pad_columns``: the exchanged columns concatenated on both sides, the
  ring wrapping across ranks or, past the image's outer columns, a fill
  value (zero padding, max pooling's -inf);
- ``all_reduce_sum_``: a sum over the width group, in place, and
  ``sum_over_width``, its differentiable form;
- ``all_reduce_max_bits_``: the maximum over the width group of a float's
  bits as int32 (a NaN as the quiet NaN above +inf, so it survives).

``gather_columns`` and ``halo_exchange`` are differentiable: each backward
is its forward's adjoint, and so gives each rank the gradient of its own
columns, with every other rank's share of it added. The adjoint of the
gather sums each rank's gradient of the whole image over the group (an
all_reduce in fp32, whatever the dtype) and keeps the rank's columns. The
adjoint of the exchange sends the gradient of the received left strip back
to the left neighbour, which adds it to its last columns, and the right
strip's to the right neighbour's first columns, from one ``all_gather`` of
the two gradient strips (with W = 2 both neighbours are one rank, which
adds both). ``all_reduce_sum_`` is not differentiable; ``sum_over_width``
is: every rank reads the sum, so the gradient of each rank's term is the
sum of every rank's gradient of it, one all-reduce of the gradients. (A
caller may instead write its whole adjoint out, as ``ops/gn_silu.py``
does.)

The W axis is dim 2 of NHWC (the default) and dim 3 of NCHW. Tensors cross
the group as raw bytes, so any dtype arrives bit for bit. Nothing is copied
to the host here: a group whose backend cannot take the tensor's device
raises. Each collective adds one to ``world.collective_calls`` and, while
tracing is on, records a ``parallel.collective`` span (``utils/trace.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import trace
from .mesh import World


def sharded(world) -> bool:
    """Whether ``world`` splits the columns over more than one rank."""
    return world is not None and world.width_size > 1


def _all_gather(t: torch.Tensor, world: World) -> list:
    """Every width rank's ``t`` (all of one shape), in width-rank order."""
    t = t.contiguous()
    raw = t.view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(world.width_size)]
    with trace.span("parallel.collective", device=raw):
        dist.all_gather(parts, raw, group=world.width_group)
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


class _GatherColumns(torch.autograd.Function):
    """``gather_columns`` under autograd; its backward the adjoint."""

    @staticmethod
    def forward(ctx, x, world, dim):
        ctx.world, ctx.dim, ctx.width = world, dim, x.shape[dim]
        return torch.cat(_all_gather(x, world), dim=dim)

    @staticmethod
    def backward(ctx, dy):
        world, dim = ctx.world, ctx.dim
        total = all_reduce_sum_(dy.to(torch.float32, memory_format=torch.contiguous_format, copy=True), world)
        own = total.narrow(dim, world.width_rank * ctx.width, ctx.width)
        return own.to(dy.dtype).contiguous(), None, None


def gather_columns(x: torch.Tensor, world: World, dim: int = 2) -> torch.Tensor:
    """The full-width tensor from every width rank's columns, in order;
    differentiable (the module docstring)."""
    if not sharded(world):
        return x
    return _GatherColumns.apply(x, world, dim)


def _edge_strips(x: torch.Tensor, left: int, right: int, world: World, dim: int):
    """(the left neighbour's last ``left`` columns, the right neighbour's
    first ``right``) from one all_gather of this rank's two edge strips."""
    Wl = x.shape[dim]
    edges = torch.cat([x.narrow(dim, 0, right), x.narrow(dim, Wl - left, left)], dim=dim)
    parts = _all_gather(edges, world)
    w, n = world.width_rank, world.width_size
    return (parts[(w - 1) % n].narrow(dim, right, left).contiguous(),
            parts[(w + 1) % n].narrow(dim, 0, right).contiguous())


class _HaloExchange(torch.autograd.Function):
    """``halo_exchange`` under autograd; its backward the adjoint: this
    rank's received strips' gradients go back to where the strips came
    from, and the neighbours' come here."""

    @staticmethod
    def forward(ctx, x, left, right, world, dim):
        ctx.args = (left, right, world, dim, x.shape[dim])
        return _edge_strips(x, left, right, world, dim)

    @staticmethod
    def backward(ctx, d_left, d_right):
        left, right, world, dim, Wl = ctx.args
        parts = _all_gather(torch.cat([d_left, d_right], dim=dim), world)
        w, n = world.width_rank, world.width_size
        shape = list(d_left.shape)
        shape[dim] = Wl
        dx = d_left.new_zeros(shape)
        # the right neighbour's d_left is the gradient of this rank's last
        # `left` columns, the left neighbour's d_right of its first `right`
        dx.narrow(dim, Wl - left, left).add_(parts[(w + 1) % n].narrow(dim, 0, left))
        dx.narrow(dim, 0, right).add_(parts[(w - 1) % n].narrow(dim, left, right))
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, left: int, right: int, world: World, dim: int = 2):
    """(the left neighbour's last ``left`` columns, the right neighbour's
    first ``right`` columns) of ``x`` along ``dim``, each contiguous, from
    one all_gather of this rank's two edge strips; differentiable (the
    module docstring)."""
    Wl = x.shape[dim]
    if left > Wl or right > Wl:
        raise ValueError(f"a halo of ({left}, {right}) columns needs at least that many a rank, have {Wl}")
    return _HaloExchange.apply(x, left, right, world, dim)


def pad_columns(x: torch.Tensor, left: int, right: int, world: World, dim: int = 2, edge=None) -> torch.Tensor:
    """``x`` with the left neighbour's last ``left`` columns before it and the
    right neighbour's first ``right`` after it along ``dim``
    (``halo_exchange``, differentiable). ``edge`` is what lies past the
    image's outer columns, rank 0's left margin and the last width rank's
    right one: None wraps the ring, a number fills them (0.0 for zero
    padding, -inf for max pooling's)."""
    lft, rgt = halo_exchange(x, left, right, world, dim)
    if edge is not None:
        if world.width_rank == 0:
            lft = torch.full_like(lft, edge)
        if world.width_rank == world.width_size - 1:
            rgt = torch.full_like(rgt, edge)
    return torch.cat([lft, x, rgt], dim=dim)


def all_reduce_sum_(t: torch.Tensor, world: World) -> torch.Tensor:
    """``t`` summed over the width group, in place; returns ``t``."""
    with trace.span("parallel.collective", device=t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=world.width_group)
    world.collective_calls += 1
    return t


QUIET_NAN_BITS = 0x7FC00000  # above +inf (0x7f800000) as an int32


def all_reduce_max_bits_(t: torch.Tensor, world: World) -> torch.Tensor:
    """The maximum over the width group of the non-negative fp32 ``t``, in
    place, reduced on its bits as int32 (the order of non-negative floats
    is the order of their bits): exact, and a NaN on any rank, mapped to
    the quiet NaN above +inf, gives a NaN on every rank, where a float MAX
    may drop it. Returns ``t``."""
    bits = t.view(torch.int32)
    bits.masked_fill_(t.isnan(), QUIET_NAN_BITS)
    with trace.span("parallel.collective", device=bits):
        dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=world.width_group)
    world.collective_calls += 1
    return t


class _SumOverWidth(torch.autograd.Function):
    """``sum_over_width`` under autograd: the backward all-reduces the
    gradients (every rank reads the sum)."""

    @staticmethod
    def forward(ctx, t, world):
        ctx.world = world
        return all_reduce_sum_(t.to(memory_format=torch.contiguous_format, copy=True), world)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_sum_(dy.to(memory_format=torch.contiguous_format, copy=True), ctx.world), None


def sum_over_width(t: torch.Tensor, world) -> torch.Tensor:
    """``t`` summed over the width group, as a new tensor (``t`` itself
    without a width axis); differentiable (the module docstring)."""
    if not sharded(world):
        return t
    return _SumOverWidth.apply(t, world)
