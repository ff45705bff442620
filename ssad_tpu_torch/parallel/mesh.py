"""The (model, data) grid of ranks, and the devices shards run on.

Counterpart of ssad_tpu/parallel/mesh.py.  The JAX package lays a
('model', 'data') mesh over devices and writes global-view programs that
XLA partitions.  ``torch.distributed`` runs one process, a rank, per
device, so here the mesh is a grid of ranks, laid out row-major as JAX
reshapes its device list: rank = model_index · n_data + data_index, so
a data row is n_data consecutive ranks (one host, when n_data divides
the ranks a host launches).

* data axis: the ranks of one row train one category's batch together
  (train/trainer.py ``DataGroup``: BatchNorm statistics and gradients
  all-reduced over the row);
* model axis: the rows split each chunk of stacked categories, stack /
  n_model categories a row; categories never communicate
  (parallel/category_parallel.py).

``ShardingError`` is what a request for more shards than devices, or for
two parallelisms at once, raises; the CLI exits 2 on it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch
import torch.distributed as dist


class ShardingError(ValueError):
    """More shards than devices, or two parallelisms asked at once."""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n_model × n_data ranks, row-major."""

    n_model: int
    n_data: int

    @property
    def shape(self) -> dict:
        return {"model": self.n_model, "data": self.n_data}

    @property
    def size(self) -> int:
        return self.n_model * self.n_data

    def coords(self, rank: int) -> tuple:
        """(model index, data index) of ``rank``."""
        return divmod(rank, self.n_data)

    def data_ranks(self, model_index: int) -> List[int]:
        """The ranks of one data row (they share a category's batch)."""
        return [model_index * self.n_data + j for j in range(self.n_data)]

    def model_ranks(self, data_index: int) -> List[int]:
        """The ranks of one model column (one per row)."""
        return [i * self.n_data + data_index for i in range(self.n_model)]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_model: int = 1, n_data: Optional[int] = None,
              world: Optional[int] = None) -> Mesh:
    """(model, data) grid over ``world`` ranks (default: the process
    group's world size, 1 without one).  ``n_data`` defaults to the ranks
    left after the model axis; a world the model axis does not divide, or
    a grid larger than the world, raises ``ValueError``."""
    world = world_size() if world is None else world
    if n_model < 1:
        raise ValueError(f"model={n_model} < 1")
    if n_data is None:
        if world % n_model:
            raise ValueError(f"{world} devices not divisible by model={n_model}")
        n_data = world // n_model
    if n_data < 1 or n_model * n_data > world:
        raise ValueError(f"a {n_model}×{n_data} mesh does not fit {world} devices")
    return Mesh(n_model, n_data)


def mesh_from_config(mesh_cfg, world: Optional[int] = None) -> Mesh:
    """The grid a ``MeshConfig`` describes (``data_axis`` -1: every rank
    left): a checkpoint's config rebuilds the layout its run used."""
    n_data = None if mesh_cfg.data_axis in (-1, None) else mesh_cfg.data_axis
    return make_mesh(n_model=mesh_cfg.model_axis, n_data=n_data, world=world)


@dataclasses.dataclass
class Groups:
    """One rank's place in the grid and its process groups (None where
    its row or column is that rank alone)."""

    mesh: Mesh
    rank: int
    data: Optional[object]
    model: Optional[object]

    @property
    def model_index(self) -> int:
        return self.mesh.coords(self.rank)[0]

    @property
    def data_index(self) -> int:
        return self.mesh.coords(self.rank)[1]


def new_groups(mesh: Mesh) -> Groups:
    """This rank's data and model groups.  Every rank of the world creates
    every row's and column's group, in the same order (torch.distributed's
    rule for ``new_group``), and keeps its own."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    mine = {"data": None, "model": None}
    for axis, count, ranks_of in (("data", mesh.n_model, mesh.data_ranks),
                                  ("model", mesh.n_data, mesh.model_ranks)):
        for i in range(count):
            ranks = ranks_of(i)
            if len(ranks) < 2:
                continue
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = group
    return Groups(mesh, rank, mine["data"], mine["model"])


def local_devices(kind) -> List[torch.device]:
    """The devices shards of one process may take: every card for
    ``cuda``; for ``cpu``, one entry of the CPU device per core (as the
    JAX tests give the CPU virtual devices)."""
    kind = torch.device(kind).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (os.cpu_count() or 1)


def shard_devices(n: int, kind, what: str = "data_shards") -> List[torch.device]:
    """The first ``n`` of ``local_devices(kind)``; more raises
    ``ShardingError``."""
    devices = local_devices(kind)
    if n > len(devices):
        raise ShardingError(f"{what}={n} exceeds {len(devices)} available devices")
    return devices[:n]
