"""Meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

Two kinds of mesh, as in the reference:

  * the LM's meshes (``make_production_mesh``, ``make_debug_mesh``): a
    ``Mesh`` that wraps a ``torch.distributed.device_mesh.DeviceMesh``
    with the reference's axis names and shapes, (16, 16) ``("data",
    "model")`` for one pod, (2, 16, 16) ``("pod", "data", "model")`` for
    two, (world, 1) ``("data", "model")`` for a debug run.  One rank
    holds one device of the mesh; ``models/sharding.py`` lays the LM's
    parameters over it as DTensors.  It answers ``shape[axis]``,
    ``group(axis)`` and ``blocks(axis)`` as ``ClassMesh`` does, so the
    data-parallel fits take either;
  * the class-sharded estimator's ``ClassMesh`` below.

The JAX package lays its class shards one to a device of a
``jax.sharding.Mesh``.  Here a ``ClassMesh`` is a logical grid of shards,
``shape = {"data": Dp, "class": S}`` (the reference's mesh shape), laid
over the ranks of the initialised process group:

  * W ranks form a (replica, data, class) grid of (W_r, W_d, W_c) with
    W_c = gcd(S, W) and W_d = gcd(Dp, W / W_c); the class axis takes the
    ranks first, since it is the axis whose memory grows with C;
  * a rank holds S / W_c consecutive class shards and Dp / W_d consecutive
    data shards; ranks that differ only in their replica coordinate hold
    the same shards and compute the same values;
  * each axis has its process group: the ranks that differ only along it.

Without a process group one rank holds every shard and no collective is
called, so one card runs S = 8 and Dp = 2 with the same code path; with a
group, the collectives are called even at world 1.  ``torchrun`` (or
``init_process_group`` with an explicit address, world size and rank)
sets the group up, or ``join_group`` does for an entry point; nothing
else here initialises one, and an LM mesh needs one (``init_device_mesh``
does, even at world 1).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import socket

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.common import resolve_device

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "ClassMesh",
           "make_class_mesh", "make_debug_mesh", "distributed",
           "world_size", "rank", "all_reduce_sum", "all_gather_stack",
           "group_size", "collectives", "join_group"]

AXES = ("data", "class")

# Collective calls by kind ("all_reduce", "all_gather"), counted where one
# is made; none without a process group.
collectives: collections.Counter = collections.Counter()


def join_group(device=None) -> bool:
    """Initialise the default process group unless there is one: from
    ``torchrun``'s environment, else a group of this process alone on a
    free local port (NCCL on the card, gloo on the CPU).  True when this
    call made it, for the caller to destroy."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return True
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    return True


def distributed() -> bool:
    """True when a default process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def group_size(group) -> int:
    """Ranks in `group` (None: the world's), 1 without a process group."""
    return dist.get_world_size(group) if distributed() else 1


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group`, in place; `t` itself without a process
    group."""
    if distributed():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        collectives["all_reduce"] += 1
    return t


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """`t` of every rank of `group`, stacked in group-rank order: (|group|,
    *t.shape); ``t[None]`` without a process group."""
    if not distributed():
        return t[None]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    collectives["all_gather"] += 1
    return torch.stack(parts)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An LM mesh: named axes over a ``DeviceMesh`` (None without a
    process group, where one rank holds the whole (1, 1) mesh and no
    collective is made).

    ``shape`` maps each axis to its size, in ``axis_names`` order (the
    counterpart of ``jax.sharding.Mesh.shape``); ``group(axis)`` is the
    axis's process group, ``coord(axis)`` this rank's index along it and
    ``blocks(axis)`` the shards it holds (one; the dp fits read it)."""

    device_mesh: Optional[object]
    axis_names: tuple
    shape: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type if self.device_mesh else "cpu"

    def dim(self, axis: str) -> int:
        """The mesh dimension of `axis`."""
        return self.axis_names.index(axis)

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def blocks(self, axis: str) -> range:
        c = self.coord(axis)
        return range(c, c + 1)


def make_mesh(shape: tuple, axes: tuple, device=None) -> Mesh:
    """An LM mesh of `shape` with the axis names `axes` over the process
    group's ranks (``init_device_mesh``, every rank calling it), on
    `device`'s type (None: the card); without a process group only the
    one-rank mesh, which holds every shard (the counterpart of
    ``jax.make_mesh``)."""
    if not distributed():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a {shape} {axes} mesh needs an initialised process group "
                f"of {math.prod(shape)} ranks")
        return Mesh(None, axes, dict(zip(axes, shape)))
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(resolve_device(device).type, shape,
                          mesh_dim_names=axes)
    return Mesh(dm, axes, dict(zip(axes, shape)))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16 x 16 = 256 ranks ("data", "model"); `multi_pod` adds the 2-pod
    axis (512 ranks).  Needs a process group of that world size (the dry
    run's fake group gives one on the host); `device` ("cpu" or "cuda",
    None: the card) is the device type the ranks' shards live on."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if world_size() != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} needs "
                           f"{math.prod(shape)} ranks, the group has "
                           f"{world_size()}")
    return make_mesh(shape, axes, device)


@dataclasses.dataclass(frozen=True, eq=False)
class ClassMesh:
    """A ("data", "class") grid of shards over the process group.

    ``shape`` counts shards per axis, ``grid`` ranks per axis (and
    "replica"), ``coords`` this rank's place in the grid and ``groups`` each
    axis's process group (None without a process group)."""

    shape: dict
    grid: dict
    coords: dict
    groups: dict

    def blocks(self, axis: str) -> range:
        """The shards of `axis` this rank holds, consecutive."""
        per = self.shape[axis] // self.grid[axis]
        start = self.coords[axis] * per
        return range(start, start + per)

    def group(self, axis: str):
        return self.groups[axis]


def _grid(n_class: int, n_data: int, world: int) -> dict:
    w_c = math.gcd(n_class, world)
    w_d = math.gcd(n_data, world // w_c)
    return {"replica": world // (w_c * w_d), "data": w_d, "class": w_c}


def _rank_of(grid: dict, r: int, d: int, c: int) -> int:
    return (r * grid["data"] + d) * grid["class"] + c


def make_class_mesh(n_class_shards: int, n_data_shards: int = 1) -> ClassMesh:
    """The ("data", "class") mesh of ``n_data_shards`` x ``n_class_shards``
    shards for the class-sharded estimator (``repro_torch.api.sharded``):
    profile and codebook rows shard over "class", fit examples over
    "data".  With a process group every rank must call it, in the same
    order, since it creates the axes' groups."""
    s, dp = int(n_class_shards), int(n_data_shards)
    if s < 1 or dp < 1:
        raise ValueError(f"class mesh needs >= 1 shard per axis, got "
                         f"data {dp} x class {s}")
    shape = {"data": dp, "class": s}
    if not distributed():
        return ClassMesh(shape, {"replica": 1, "data": 1, "class": 1},
                         {"replica": 0, "data": 0, "class": 0},
                         {"data": None, "class": None})
    world, me = dist.get_world_size(), dist.get_rank()
    grid = _grid(s, dp, world)
    coords = {"class": me % grid["class"],
              "data": me // grid["class"] % grid["data"],
              "replica": me // (grid["class"] * grid["data"])}
    groups = {}
    for axis in AXES:
        if grid[axis] == world:
            groups[axis] = dist.group.WORLD
            continue
        other = "class" if axis == "data" else "data"
        for r in range(grid["replica"]):
            for o in range(grid[other]):
                ranks = [_rank_of(grid, r, *((i, o) if axis == "data"
                                             else (o, i)))
                         for i in range(grid[axis])]
                g = dist.new_group(ranks)
                if me in ranks:
                    groups[axis] = g
    return ClassMesh(shape, grid, coords, groups)


def make_debug_mesh(device=None) -> Mesh:
    """The smallest honest LM mesh: ("data", "model") of (world, 1), every
    rank on the data axis, on `device`'s type (None: the card).  Without a
    process group it is the (1, 1) mesh of one rank holding every shard,
    with no ``DeviceMesh`` and no collective."""
    return make_mesh((world_size(), 1), ("data", "model"), device)
