"""The multi-process runtime (counterpart of the JAX package's
``parallel/distributed.py``).

The JAX package wraps ``jax.distributed.initialize`` and builds a
(dcn, data, model) mesh whose "dcn" axis crosses hosts only. The port runs
one process a rank under ``torchrun`` (or any launcher that sets its
variables):

- ``initialize()`` reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT`` and ``LOCAL_RANK`` and starts ``torch.distributed``; a
  no-op returning 1 for a single process, so every call site can wire it
  unconditionally. The backend is chosen and logged: NCCL when every rank
  of a host owns a card of its own; gloo on the CPU, and where ranks share
  a card (NCCL refuses two ranks on one device);
- ``make_hybrid_mesh(dcn, data, model)`` groups ranks by host
  (``LOCAL_WORLD_SIZE``: torchrun numbers a host's ranks contiguously), so
  that every [data, model] plane lies on one host and only the "dcn" axis
  crosses hosts: DP across the slow network, TP and FSDP within a host;
- ``global_batch`` gives each rank its slice of a global batch (every rank
  loads the same global batch, as each JAX process holds the global
  array's shape), and ``process_allgather_scalar`` gathers a host scalar
  from every rank (metrics).
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

logger = logging.getLogger(__name__)


def choose_backend(local_world_size: int) -> str:
    """"nccl" when the host has a card for each of its ranks, else "gloo"."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize(backend: str | None = None, timeout_s: float = 600.0) -> int:
    """Start ``torch.distributed`` from torchrun's variables -> the world
    size (1, and nothing started, for a single process). ``backend`` None
    takes ``choose_backend``; a rank with a card selects card ``LOCAL_RANK``
    modulo the cards it sees."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if backend is None:
        backend = choose_backend(local_world)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    logger.info(f"torch.distributed up: rank {rank}/{world}, local rank {local_rank}/"
                f"{local_world}, backend {backend}")
    return world


def hybrid_layout(world: int, local_world: int, dcn: int | None, data: int, model: int):
    """The ranks of a (dcn, data, model) mesh, [dcn, data, model], with
    the hosts (``local_world`` contiguous ranks each) along "dcn": raises
    where a [data, model] plane would span hosts."""
    hosts = max(world // local_world, 1)
    if dcn is None:
        dcn = hosts
    need = dcn * data * model
    if need > world:
        raise ValueError(f"need {need} ranks, have {world}")
    ranks = np.arange(need).reshape(dcn, data, model)
    for s in range(dcn):
        on = {int(r) // local_world for r in ranks[s].flat}
        if len(on) != 1 and hosts > 1:
            raise ValueError(f"dcn slice {s} spans hosts {sorted(on)}; pick data * model = "
                             f"ranks a host")
    return ranks


def make_hybrid_mesh(dcn: int | None = None, data: int = 1, model: int = 1,
                     device_type: str | None = None) -> Mesh:
    """The (dcn, data, model) mesh, the "dcn" axis the host boundary
    (``hybrid_layout``); a single process gets dcn = 1, the trivial
    mesh."""
    if not dist.is_initialized():
        if (dcn or 1) * data * model != 1:
            raise RuntimeError("a hybrid mesh of several ranks needs torch.distributed")
        return Mesh(dcn=1)
    world = dist.get_world_size()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    ranks = hybrid_layout(world, local_world, dcn, data, model)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    from torch.distributed.device_mesh import DeviceMesh

    device_mesh = DeviceMesh(device_type, torch.as_tensor(ranks),
                             mesh_dim_names=("dcn", "data", "model"))
    return Mesh(data, model, device_mesh, dcn=ranks.shape[0])


def global_batch(mesh: Mesh, batch: dict) -> tuple[dict, dict]:
    """(this rank's slice of the global ``batch``, the global shapes): the
    leading dim cut in ``dcn * data`` even slices, slice ``dcn index *
    data + data index`` kept (the model ranks of a slice share it), as a
    DataLoader with a DistributedSampler would hand it out."""
    index, count = mesh.data_index
    local, shapes = {}, {}
    for key, value in batch.items():
        shapes[key] = tuple(np.shape(value))
        n = shapes[key][0]
        if n % count:
            raise ValueError(f"global batch of {n} ({key}) does not split in {count} slices")
        m = n // count
        local[key] = value[index * m:(index + 1) * m]
    return local, shapes


def process_allgather_scalar(x: float) -> np.ndarray:
    """One host scalar from every rank, in rank order (a single process:
    [x])."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return np.asarray([x], np.float32)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, float(x))
    return np.asarray(parts, np.float32)
