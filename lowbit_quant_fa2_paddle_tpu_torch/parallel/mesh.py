"""Process groups for the parallel layer: ``init_distributed`` and a named
mesh of groups.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/mesh.py``. JAX builds
a mesh of devices and runs one program over global arrays (``shard_map``);
here every rank runs its own process on its local shard, and a mesh is the
set of ``torch.distributed`` groups along each named axis that holds this
rank:

* ``make_mesh(degrees)`` lays the ranks out over the axes ``data``, ``pp``,
  ``seq``, ``model`` (outer to inner, JAX's order with the pipeline axis
  after ``data``; the xfuser degrees map as data/CFG-parallel -> ``data``,
  PipeFusion -> ``pp``, Ulysses/ring -> ``seq``, tensor parallel ->
  ``model``), with JAX's ``-1`` rule;
* ``shard`` / ``gather`` split a global tensor into this rank's shard and
  join the shards again, as ``shard_map``'s in and out specs do, for tests
  and the smoke run.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from lowbit_quant_fa2_paddle_tpu_torch.parallel import transport

#: Axis order, outer to inner.
AXES = ("data", "pp", "seq", "model")


def init_distributed(
    backend: Optional[str] = None,
    *,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the default process group. ``rank`` and ``world_size`` default to
    torchrun's ``RANK`` and ``WORLD_SIZE``, ``init_method`` to ``env://``
    (torchrun's ``MASTER_ADDR``/``MASTER_PORT``). ``backend`` defaults to
    NCCL (one card a rank); ranks that share a card, or CPU tensors, pass
    ``"gloo"``. A world of one joins nothing, as JAX's ``init_distributed``
    does."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if world_size <= 1:
        return
    dist.init_process_group(
        backend or "nccl", init_method=init_method or "env://", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a named mesh: the size of each axis, this rank's
    index along it and the group of the ranks that share every other index
    (``None`` for an axis of size 1, or for a rank outside the mesh)."""

    shape: Dict[str, int]
    coords: Optional[Dict[str, int]]
    groups: Dict[str, Optional[dist.ProcessGroup]]

    @property
    def member(self) -> bool:
        return self.coords is not None

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(degrees: Optional[Mapping[str, int]] = None) -> Mesh:
    """The mesh ``degrees`` (axis -> size; missing axes 1, one axis may be -1
    to take the remaining ranks) over the ranks of the default group, rank
    ``r`` at row-major position ``r`` of the axes in ``AXES`` order. Every
    rank must call this (each group is made collectively); ranks past the
    mesh's size get ``member == False``. Without a process group the world
    is this process alone."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    degrees = dict(degrees or {})
    unknown = set(degrees) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; axes are {AXES}")
    sizes = [int(degrees.get(a, 1)) for a in AXES]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} ranks do not divide by the fixed degrees {dict(zip(AXES, sizes))}")
        sizes[sizes.index(-1)] = n // known
    used = math.prod(sizes)
    if used > n:
        raise ValueError(f"mesh {dict(zip(AXES, sizes))} needs {used} ranks, have {n}")
    layout = torch.arange(used).reshape(sizes)
    coords = None
    if me < used:
        coords = {a: int(i) for a, i in zip(AXES, (layout == me).nonzero()[0])}
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for ax, axis in enumerate(AXES):
        groups[axis] = None
        if sizes[ax] == 1:
            continue
        lines = layout.movedim(ax, -1).reshape(-1, sizes[ax]).tolist()
        for line in lines:  # every rank makes every group, in the same order
            g = dist.new_group(line)
            if me in line:
                groups[axis] = g
    return Mesh(dict(zip(AXES, sizes)), coords, groups)


def _dims(spec: Sequence[Optional[str]]):
    return [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]


def shard(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's shard of the global ``x`` as a tensor of its own
    (contiguous, as a rank that holds only its shard has it): dim ``i`` cut
    over the axis ``spec[i]`` (``None``: kept whole), as a
    ``PartitionSpec``."""
    for dim, axis in _dims(spec):
        n = mesh.size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axis}={n}")
        x = x.chunk(n, dim=dim)[mesh.index(axis)]
    return x.contiguous()


def gather(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]], *, site: str = "gather") -> torch.Tensor:
    """The global tensor from each rank's shard ``x`` (the inverse of
    :func:`shard`), on every rank of the mesh."""
    for dim, axis in _dims(spec):
        x = transport.all_gather(x, mesh.group(axis), dim=dim, site=site)
    return x
