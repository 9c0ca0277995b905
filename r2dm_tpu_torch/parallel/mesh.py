"""Parallelism across processes: one process per card, on a (data, width)
mesh.

The counterpart of ``r2dm_tpu/parallel/mesh.py``. The JAX package drives
every device of a host from one process through a ``jax.sharding.Mesh``
whose ``data`` axis splits the batch and whose ``width`` axis splits each
image's azimuth columns; here each card has its own process (the torch
idiom, as the reference's accelerate DDP does, reference train.py:45-53),
and the mesh is the process group:

- ``init(device)`` joins the group ``torchrun`` describes in the environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
  NCCL on CUDA, gloo on the CPU. Without that environment the world has one
  process and no group, and nothing changes. A group the caller has already
  initialised (a test, a launcher of its own) is used as it stands, with its
  backend. A group that fails to initialise raises; so do two NCCL ranks on
  one card. Each rank runs on ``cuda:LOCAL_RANK``.
- One gloo side group carries host objects: the stop flag, gathered
  features, per-rank results. It is the default group when that is gloo.
- The mesh ``(D, W)`` lays the ranks out as the JAX package reshapes its
  devices (r2dm_tpu/parallel/mesh.py:42-43): rank ``d*W + w``, so a width
  group is W consecutive ranks. ``init(device, mesh=...)`` builds every
  width group with ``dist.new_group`` on every rank, in the same order.
  Rank ``w`` of a group holds columns ``[w*Wimg/W, (w+1)*Wimg/W)`` of each
  image of its data group's batch (``parallel/width.py``); the data index
  ``d`` strides the seeds, so every width rank of a group holds the same
  seeds.
- ``parse_mesh`` (the CLIs' ``--mesh``) keeps the JAX function's checks and
  messages: ``'N'`` or ``'DxW'`` must multiply to the world size.
  ``check_mesh_shape`` (``training.mesh_shape``, a tuple) does the same for
  the trainer, with ValueErrors; ``init(device, mesh=shape)`` takes either.
"""

from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

@dataclass
class World:
    """This process's place on the (data, width) mesh: rank ``d*W + w``."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    distributed: bool = False  # a process group exists (possibly of one rank)
    side: Any = None  # the gloo group for host objects (None: no group)
    owns_group: bool = False  # init() created the default group and close() destroys it
    width_size: int = 1  # W: the ranks that split each image's columns
    width_group: Any = None  # this rank's width group (None when W = 1)
    # the width collectives made (parallel/width.py counts them)
    collective_calls: int = 0

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def width_rank(self) -> int:
        return self.rank % self.width_size

    @property
    def data_index(self) -> int:
        return self.rank // self.width_size

    @property
    def data_size(self) -> int:
        return self.size // self.width_size

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _launched() -> bool:
    """Whether the environment describes a process group (torchrun's)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(device="cuda", mesh=None, batch_size: Optional[int] = None) -> World:
    """This process's ``World``: the caller's group, torchrun's, or none;
    with ``mesh`` laid out on it, the width groups built. ``mesh`` is a
    ``--mesh`` spec (``parse_mesh``: a mesh that does not fit exits) or a
    ``training.mesh_shape`` tuple (``check_mesh_shape``: it raises)."""
    world = _join(device)
    try:
        if isinstance(mesh, (tuple, list)):
            check_mesh_shape(mesh, world.size)
            shape = tuple(int(s) for s in mesh)
        else:
            shape = parse_mesh(mesh, world.size, batch_size)
        if shape is not None and len(shape) == 2 and shape[1] > 1:
            _build_width_groups(world, shape[1])
    except BaseException:
        world.close()
        raise
    return world


def _build_width_groups(world: World, width: int) -> None:
    """Every rank creates every width group, in the same order (new_group
    is collective over the default group), and keeps its own."""
    for d in range(world.size // width):
        group = dist.new_group(list(range(d * width, (d + 1) * width)))
        if d == world.rank // width:
            world.width_group = group
    world.width_size = width


def _join(device) -> World:
    device = torch.device(device)
    owns = False
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if not dist.is_initialized():
        if not _launched():
            return World(device=_rank_device(device, 0))
        if device.type == "cuda":
            torch.cuda.set_device(local_rank)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")  # env://; raises on failure
        owns = True
    backend = dist.get_backend()
    side = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    world = World(rank=dist.get_rank(), size=dist.get_world_size(), local_rank=local_rank,
                  device=_rank_device(device, local_rank), distributed=True, side=side, owns_group=owns)
    if backend == "nccl" and world.size > 1:
        _check_one_card_per_rank(world)
    return world


def _rank_device(device: torch.device, local_rank: int) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def _check_one_card_per_rank(world: World) -> None:
    """NCCL cannot run two ranks on one card: refuse before the first
    collective hangs or fails inside NCCL."""
    me = (socket.gethostname(), str(torch.cuda.get_device_properties(world.device).uuid))
    cards = all_gather_objects(world, me)
    if len(set(cards)) != len(cards):
        shared = sorted({c for c in cards if cards.count(c) > 1})
        raise RuntimeError(
            f"NCCL needs one card per rank, but ranks share {shared}: start one process per card "
            "(torchrun --nproc_per_node N with N cards), or initialise a gloo group yourself"
        )


# ------------------------------------------------------------- host objects
def any_rank(world: World, flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any: one all-reduce of a
    CPU tensor on the gloo side group (a host round trip, no device sync)."""
    if not world.distributed:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world.side)
    return bool(t.item())


def gather_objects(world: World, obj) -> Optional[list]:
    """Every rank's ``obj`` in rank order on rank 0; None on the others."""
    if not world.distributed:
        return [obj]
    out = [None] * world.size if world.is_main else None
    dist.gather_object(obj, out, dst=0, group=world.side)
    return out


def all_gather_objects(world: World, obj) -> list:
    """Every rank's ``obj`` in rank order, on every rank."""
    if not world.distributed:
        return [obj]
    out = [None] * world.size
    dist.all_gather_object(out, obj, group=world.side)
    return out


def broadcast_object(world: World, obj):
    """Rank 0's ``obj`` on every rank."""
    if not world.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=world.side)
    return box[0]


# ------------------------------------------------------------------- meshes
def _mesh_error(shape: tuple, world_size: int) -> Optional[str]:
    """Why a (data,) or (data, width) mesh cannot run on ``world_size``
    processes (a phrase that follows the mesh's name), or None."""
    n = math.prod(shape)
    if n != world_size:
        return (f"needs {n} devices, have {world_size} (one process per device: start "
                f"{n} with torchrun --nproc_per_node {n})")
    return None


def parse_mesh(spec, world_size: int, batch_size: Optional[int] = None) -> Optional[tuple]:
    """CLI mesh spec -> its shape: '' / 0 / '0' -> None (every rank on the
    data axis), 'N' -> (N,), 'DxW' -> (D, W), whose product must equal the
    world size. With ``batch_size``, the batch must divide over the data
    axis."""
    if not spec or str(spec) == "0":
        return None
    try:
        shape = tuple(int(s) for s in str(spec).lower().split("x"))
        assert all(s > 0 for s in shape) and len(shape) in (1, 2)
    except (ValueError, AssertionError):
        raise SystemExit(f"--mesh must be 'N' or 'DxW' with positive ints, got {spec!r}")
    msg = _mesh_error(shape, world_size)
    if msg is not None:
        raise SystemExit(f"--mesh {spec} {msg}")
    if batch_size is not None and batch_size % shape[0]:
        raise SystemExit(f"batch size {batch_size} not divisible by the {shape[0]}-way data axis")
    return shape


def check_mesh_shape(mesh_shape, world_size: int) -> None:
    """``training.mesh_shape`` under the rules of ``parse_mesh``: None puts
    every rank on the data axis; (N,) or (D, W) must match the world."""
    if mesh_shape is None:
        return
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) not in (1, 2) or not all(s > 0 for s in shape):
        raise ValueError(f"training.mesh_shape={mesh_shape}: expected (N,) or (D, W) with positive ints")
    msg = _mesh_error(shape, world_size)
    if msg is not None:
        raise ValueError(f"training.mesh_shape={mesh_shape} {msg}")
