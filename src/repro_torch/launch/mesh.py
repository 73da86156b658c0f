"""Shard layouts over ``torch.distributed`` (port of ``repro.launch.mesh``).

The JAX package lays its shards one to a device of a ``jax.sharding.Mesh``.
Here a mesh is a logical grid of shards, ``shape = {"data": Dp, "class":
S}`` (the reference's mesh shape), laid over the ranks of the initialised
process group:

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
sets the group up; nothing here initialises one.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = ["ClassMesh", "make_class_mesh", "make_debug_mesh", "distributed",
           "world_size", "rank", "all_reduce_sum", "all_gather_stack",
           "group_size", "collectives"]

AXES = ("data", "class")

# Collective calls by kind ("all_reduce", "all_gather"), counted where one
# is made; none without a process group.
collectives: collections.Counter = collections.Counter()


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


def make_debug_mesh() -> ClassMesh:
    """Every rank on the data axis: (data = W shards, class = 1)."""
    return make_class_mesh(1, world_size())
