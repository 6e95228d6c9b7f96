"""A 1-D data mesh over the process group (counterpart of the JAX
package's `parallel/mesh.py`).

Training batches and render wavefronts are both batch-parallel, and the
nets are tiny (at most 6 x 64), so the port has one axis, "data": each
rank holds a contiguous block of the rows and a full copy of the
parameters and the scene. Gradients cross ranks in one `all_reduce` a
training step and the film in one a render pass; parameters are broadcast
from rank 0 at the start of a stage. The port calls no collective but
`all_reduce`, `broadcast` and `barrier`, which gloo also runs on CUDA
tensors, so two ranks can share one card.

A mesh made in a process without a process group has size 1 and no group:
its collectives do nothing, and the paths that take it compute what they
compute without one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from bsdf_diffusion_sampling_tpu_torch.core.tree import tree_leaves, tree_map
from bsdf_diffusion_sampling_tpu_torch.parallel.distributed import local_device, rank_and_world

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the data axis: the group (None without one),
    the rank, the axis size and this rank's device."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_name: str = DATA_AXIS

    def block(self, n: int) -> tuple[int, int]:
        """(start, rows) of this rank's contiguous block of n rows; n must
        divide by the axis size."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over a mesh of {self.size}")
        per = n // self.size
        return self.rank * per, per


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS, device_type: str = "cuda") -> Mesh:
    """The 1-D mesh over the whole default group (size 1 without one).
    `n_devices` None or -1 means the whole group; another count raises, since
    a sub-mesh would need every rank to form a subgroup."""
    rank, world = rank_and_world()
    if n_devices not in (None, -1) and n_devices != world:
        raise ValueError(f"the mesh spans the whole group of {world} ranks; asked for {n_devices}")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(group, rank, world, local_device(device_type), axis_name)


def batch_sharding(mesh: Mesh):
    """The placement of a batch on the mesh: its rows split over the axis
    (a DTensor placement; the port's own paths split rows with `Mesh.block`)."""
    from torch.distributed.tensor import Shard

    return Shard(0)


def replicated_sharding(mesh: Mesh):
    """The placement of parameters, optimizer state and the scene: a full
    copy on every rank (a DTensor placement; the port's own paths use
    `replicate`)."""
    from torch.distributed.tensor import Replicate

    return Replicate()


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a tree of (N, ...) tensors (tuples come back as
    lists)."""

    def rows(t):
        start, per = mesh.block(t.shape[0])
        return t[start:start + per]

    return tree_map(rows, tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's values of a tree of tensors on every rank, in place: one
    broadcast a dtype, of one flat buffer of that dtype's leaves (all on
    one device). Returns the tree."""
    if mesh.group is None:
        return tree
    by_dtype: dict = {}
    for t in tree_leaves(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for leaves in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in leaves])
            dist.broadcast(flat, src=0, group=mesh.group)
            if mesh.rank == 0:
                continue
            at = 0
            for t in leaves:
                t.copy_(flat[at:at + t.numel()].view(t.shape))
                at += t.numel()
    return tree


def all_reduce_(mesh: Optional[Mesh], t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced over the mesh, in place; unchanged without a mesh or a
    group."""
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)
