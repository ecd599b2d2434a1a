"""The multi-process runtime (counterpart of the JAX package's
``parallel/distributed.py``).

The JAX package wraps ``jax.distributed.initialize`` and builds a
(dcn, data, model) mesh whose "dcn" axis crosses hosts only. The port runs
one process a rank under ``torchrun`` (or any launcher that sets its
variables):

- ``initialize()`` starts ``torch.distributed`` from its arguments or
  torchrun's variables (``_launch_settings`` maps them); a no-op returning
  1 for a single process, so every call site can wire it unconditionally.
  The backend is chosen and logged: NCCL when every rank of a host owns a
  card of its own; gloo on the CPU, and where ranks share a card (NCCL
  refuses two ranks on one device);
- a JAX process is a host here: its ``local_device_count`` devices are the
  host's ranks, which torchrun numbers contiguously (``LOCAL_WORLD_SIZE``,
  or ``initialize(local_device_count=)``). Each mesh records this host size
  when it is built (``Mesh.host_size``);
- ``make_hybrid_mesh(dcn, data, model)`` groups ranks by host, so that
  every [data, model] plane lies on one host and only the "dcn" axis
  crosses hosts: DP across the slow network, TP and FSDP within a host;
- ``global_batch`` assembles the global batch from each host's local
  batch, as JAX's does from each process's, and gives each rank its part
  under ``batch_spec_hybrid()``; ``process_allgather_scalar`` gathers a
  host scalar from every rank (metrics).
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import _BATCH_AXES, Mesh

logger = logging.getLogger(__name__)

_HOST_SIZE = None  # ranks a host, from ``initialize(local_device_count=)``


def choose_backend(local_world_size: int) -> str:
    """"nccl" when the host has a card for each of its ranks, else "gloo"."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def _host_size() -> int:
    """The ranks a host: ``initialize``'s ``local_device_count``, else
    torchrun's ``LOCAL_WORLD_SIZE``, else the whole world (one host)."""
    if _HOST_SIZE is not None:
        return _HOST_SIZE
    world = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))


def _launch_settings(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, local_device_count: int | None = None,
                     env=os.environ) -> dict:
    """What ``initialize`` starts from: an argument wins over torchrun's
    variable in ``env``. -> {"world", "local_world"} and, for a world of
    several ranks, {"rank", "local_rank", "init_method"}:

    - ``num_processes`` is the world size (``WORLD_SIZE``, else 1);
    - ``process_id`` is the rank (``RANK``);
    - ``local_device_count`` is the ranks a host (``LOCAL_WORLD_SIZE``, else
      the world), the counterpart of a JAX process's devices; the local rank
      is ``LOCAL_RANK`` for torchrun's rank, else the rank modulo it (a
      host's ranks are contiguous);
    - ``coordinator_address`` "host:port" gives the init method
      ``tcp://host:port`` (``MASTER_ADDR`` and ``MASTER_PORT``, else
      localhost:29500)."""
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    local_world = (local_device_count if local_device_count is not None
                   else int(env.get("LOCAL_WORLD_SIZE", str(world))))
    out = {"world": world, "local_world": local_world}
    if world == 1:
        return out
    rank = process_id if process_id is not None else int(env["RANK"])
    local_rank = (int(env["LOCAL_RANK"]) if process_id is None and "LOCAL_RANK" in env
                  else rank % local_world)
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    return {**out, "rank": rank, "local_rank": local_rank,
            "init_method": f"tcp://{coordinator_address}"}


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_count: int | None = None,
               backend: str | None = None, timeout_s: float = 600.0) -> int:
    """Start ``torch.distributed`` -> the world size (1, and nothing
    started, for a single process). The JAX package's arguments map as
    ``_launch_settings`` says: ``coordinator_address`` "host:port" is the
    ``tcp://`` init method, ``num_processes`` the world size, ``process_id``
    the rank, ``local_device_count`` the ranks a host (which the meshes
    record); each argument left None takes torchrun's variable. ``backend``
    None takes ``choose_backend``; a rank with a card selects card
    ``local_rank`` modulo the cards it sees."""
    global _HOST_SIZE
    if local_device_count is not None:
        _HOST_SIZE = local_device_count
    settings = _launch_settings(coordinator_address, num_processes, process_id,
                                local_device_count)
    world = settings["world"]
    if world == 1:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    rank, local_rank, local_world = settings["rank"], settings["local_rank"], settings["local_world"]
    if backend is None:
        backend = choose_backend(local_world)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=settings["init_method"], rank=rank,
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
    (``hybrid_layout``, hosts of ``_host_size()`` ranks, which the mesh
    records), with the group of its batch axes (dcn, data) built; a single
    process gets dcn = 1, the trivial mesh."""
    if not dist.is_initialized():
        if (dcn or 1) * data * model != 1:
            raise RuntimeError("a hybrid mesh of several ranks needs torch.distributed")
        return Mesh(dcn=1)
    world = dist.get_world_size()
    host_size = _host_size()
    ranks = hybrid_layout(world, host_size, dcn, data, model)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    from torch.distributed.device_mesh import DeviceMesh

    device_mesh = DeviceMesh(device_type, torch.as_tensor(ranks),
                             mesh_dim_names=("dcn", "data", "model"))
    groups = {}
    if ranks.shape[0] > 1 and data > 1:  # every rank makes every group, in one order
        for m in range(model):
            members = ranks[:, :, m].flatten().tolist()
            group = dist.new_group(members)
            if dist.get_rank() in members:
                groups[_BATCH_AXES] = group
    return Mesh(data, model, device_mesh, dcn=ranks.shape[0], host_size=host_size,
                groups=groups)


def batch_spec_hybrid() -> tuple:
    """The global batch's spec on the hybrid mesh: its leading dim over
    "dcn" and "data" together, "dcn" major (the JAX package's
    ``P(("dcn", "data"))``)."""
    return (_BATCH_AXES,)


def _rows(mesh: Mesh, batch: dict, host: int, hosts: int) -> tuple[dict, dict]:
    """(this rank's rows, the global shapes) of the global batch that stacks
    ``hosts`` hosts' batches like ``batch``, host ``host``'s being
    ``batch``: the leading dim cut over ``batch_spec_hybrid()``'s axes, the
    first major (an axis the mesh lacks has size 1)."""
    index, count = 0, 1
    for axis in batch_spec_hybrid()[0]:
        n = mesh.shape.get(axis, 1)
        index, count = index * n + mesh.coords.get(axis, 0), count * n
    local, shapes = {}, {}
    for key, value in batch.items():
        n_local = np.shape(value)[0]
        shapes[key] = (n_local * hosts,) + tuple(np.shape(value)[1:])
        n = shapes[key][0]
        if n % count:
            raise ValueError(f"global batch of {n} ({key}) does not split in {count} parts")
        m = n // count
        lo = index * m - host * n_local
        if lo < 0 or lo + m > n_local:
            raise ValueError(f"rows {index * m}..{index * m + m} of the global batch ({key}) are "
                             f"not in host {host}'s local batch of {n_local}")
        local[key] = value[lo:lo + m]
    return local, shapes


def global_batch(mesh: Mesh, local_batch: dict) -> tuple[dict, dict]:
    """(this rank's part of the global batch, the global shapes), from this
    host's ``local_batch``, as the JAX package assembles its global array
    from each process's local batch.

    Every rank of a host passes the host's local batch [local_bs, ...]. The
    global batch is the hosts' local batches stacked in host order,
    [local_bs * hosts, ...], cut over ``batch_spec_hybrid()``: the rank
    keeps the rows that JAX's device at the same (dcn, data, model)
    coordinates holds, and the model ranks of a slice share them. Raises
    where those rows are not all in this host's local batch (JAX too needs
    each process's devices to hold its own rows)."""
    return _rows(mesh, local_batch, *mesh.host)


def _global_batch_slice(mesh: Mesh, batch: dict) -> dict:
    """This rank's part of a GLOBAL ``batch`` that every rank holds whole
    (``train_qat``'s batches), as a DataLoader with a DistributedSampler
    would hand it out: ``global_batch``'s cut of one host's batch."""
    return _rows(mesh, batch, 0, 1)[0]


def process_allgather_scalar(x: float) -> np.ndarray:
    """One host scalar from every rank, in rank order (a single process:
    [x])."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return np.asarray([x], np.float32)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, float(x))
    return np.asarray(parts, np.float32)
