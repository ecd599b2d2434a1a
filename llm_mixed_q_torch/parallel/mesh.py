"""The (data, model) mesh (counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package lays parameters and batches out on a
``jax.sharding.Mesh`` and lets XLA emit the collectives. The port runs one
process a rank (``torchrun``, or ``parallel.distributed.initialize``) and
takes its groups from ``torch.distributed.device_mesh.init_device_mesh``
with dims named ("data", "model"): "data" carries the batch and the
gradient sums (DP, and ``fully_shard``'s shards under ``fsdp``), "model" the
Megatron collectives of tensor parallelism (``parallel/tp.py``).
``shard`` and ``shard_params`` return this rank's local tree, not a
global array: the model code runs on local shapes.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

AXES = ("data", "model")
_BATCH_AXES = ("dcn", "data")  # a batch is cut over these (``batch_spec_hybrid``)


class Mesh:
    """A grid of ranks over named axes (("data", "model"), or ("dcn",
    "data", "model") for ``distributed.make_hybrid_mesh``): ``shape``
    {axis: size}, this rank's ``coords`` {axis: index}, and
    ``group(axes)``, the process group of the ranks that differ from this
    one only along ``axes`` (None where they all have size 1). A mesh of
    one rank needs no process group. ``host_size`` is the ranks a host
    (the port's counterpart of a JAX process's devices), recorded when the
    mesh is built (``distributed._host_size``); ``groups`` holds the groups
    of several axes, which the mesh's maker builds."""

    def __init__(self, data: int = 1, model: int = 1, device_mesh=None, dcn: int | None = None,
                 host_size: int = 1, groups: dict | None = None):
        self.shape = {"data": data, "model": model}
        if dcn is not None:
            self.shape = {"dcn": dcn, **self.shape}
        self.device_mesh = device_mesh
        self.host_size = host_size
        self.groups = groups or {}
        if device_mesh is None:
            self.coords = dict.fromkeys(self.shape, 0)
        else:
            self.coords = dict(zip(self.shape, device_mesh.get_coordinate()))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def host(self) -> tuple[int, int]:
        """(this rank's host, the hosts of the world): a host is
        ``host_size`` contiguous ranks."""
        if self.device_mesh is None:
            return 0, 1
        return dist.get_rank() // self.host_size, max(dist.get_world_size() // self.host_size, 1)

    def group(self, axes):
        """``axes``: an axis name, or a tuple of them (those the mesh lacks
        are left out)."""
        axes = (axes,) if isinstance(axes, str) else axes
        axes = tuple(a for a in axes if self.shape.get(a, 1) > 1)
        if self.device_mesh is None or not axes:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self.groups[axes]

    def whole_group(self):
        """The group of every rank of the mesh (None for one rank)."""
        if self.device_mesh is None or self.size == 1:
            return None
        return dist.group.WORLD if self.size == dist.get_world_size() else None

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(data: int = 1, model: int = 1, device_type: str | None = None) -> Mesh:
    """The (data, model) mesh over the ranks of the process group, which
    must number data * model (``init_device_mesh``; every rank calls it).
    ``device_type`` defaults to the card when there is one. A mesh of one
    rank in a process without a process group is the trivial mesh."""
    if data * model == 1 and not dist.is_initialized():
        return Mesh()
    if not dist.is_initialized():
        raise RuntimeError(f"a {data} x {model} mesh needs torch.distributed "
                           "(parallel.distributed.initialize, or torchrun)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, the world has "
                         f"{world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    from .distributed import _host_size

    return Mesh(data, model, init_device_mesh(device_type, (data, model), mesh_dim_names=AXES),
                host_size=_host_size())


def shard(mesh: Mesh, tree, spec_tree):
    """This rank's local part of ``tree`` under ``spec_tree`` (a spec, a
    tuple of axis names or None a dim, for each tensor, at the same
    paths): each dim named by an axis is cut in ``mesh.shape[axis]`` even
    parts and this rank keeps part ``mesh.coords[axis]``."""
    from .sharding import local_part

    if isinstance(tree, torch.Tensor):
        return local_part(tree, spec_tree, mesh.coords, mesh.shape)
    if isinstance(tree, dict):
        return {k: shard(mesh, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard(mesh, v, s) for v, s in zip(tree, spec_tree))
    return tree


def batch_spec() -> tuple:
    """The batch's spec: its leading dim over "data"."""
    return ("data",)
