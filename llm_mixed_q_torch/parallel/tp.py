"""What XLA places by itself in the JAX package, placed by hand: the
Megatron collectives of tensor parallelism and the context the model code
reads.

Inside ``spmd(mesh)`` the model functions run on this rank's local tree
(``parallel.shard_params``): each rank holds ``heads / tp`` heads, the
column-parallel nodes' out-features and the row-parallel nodes'
in-features, and the model code asks ``size()``, ``local(n)`` and the
collectives below where the unsharded code had none:

- ``copy_to_group`` before a column-parallel node (identity; its backward
  sums the input's gradient over the "model" group);
- ``reduce_from_group`` after a row-parallel node (a sum over the group;
  identity backward) and after the vocab-parallel embedding lookup;
- ``gather_from_group`` where a node or the logits need every rank's
  features (the rank's slice of the gradient backward).

The block quantizers fill a zero block's max with the smallest nonzero
block max of the whole tensor (``ops/quantizers/blocking.py``); JAX takes
it over the global array, so inside ``spmd`` that minimum is taken over
every rank of the mesh (``global_min``): over the "model" shards and the
"data" slices of the batch alike.

Outside ``spmd`` (or on a mesh of one rank) every function is the
identity and the model code is the unsharded code.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch
import torch.distributed as dist


class TPContext(NamedTuple):
    group: object  # the "model" process group (None: size 1)
    rank: int
    size: int
    mesh_group: object  # every rank of the mesh (None: one rank)


_CTX: TPContext | None = None


def size() -> int:
    return 1 if _CTX is None else _CTX.size


def rank() -> int:
    return 0 if _CTX is None else _CTX.rank


def local(n: int, what: str = "heads") -> int:
    """This rank's share of n (heads, features): n / size(), which must be
    whole."""
    tp = size()
    if n % tp:
        raise ValueError(f"{n} {what} do not split over {tp} model-parallel ranks")
    return n // tp


@contextmanager
def spmd(mesh):
    """Run the model code on this rank's local tree of ``mesh`` (a
    ``parallel.mesh.Mesh``): tensor parallelism over its "model" axis and
    quantizer fills over all of it."""
    global _CTX
    prev = _CTX
    _CTX = TPContext(mesh.group("model"), mesh.coords["model"], mesh.shape["model"],
                     mesh.whole_group())
    try:
        yield _CTX
    finally:
        _CTX = prev


def _all_reduce(x, op=dist.ReduceOp.SUM, group=None):
    x = x.clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_along(x, dim: int, group, n: int):
    """Every rank's ``x`` of ``group`` (of ``n``) concatenated along
    ``dim``, in rank order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, group=ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.n, ctx.index = dim, n, index
        return all_gather_along(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), None, None, None, None


def copy_to_group(x):
    """The input of a column-parallel node (backward: the sum over the
    group of the input's gradient)."""
    if size() == 1:
        return x
    return _CopyToGroup.apply(x, _CTX.group)


def reduce_from_group(x):
    """The sum over the "model" group (of a row-parallel node's partial
    products, of a vocab-parallel lookup)."""
    if size() == 1:
        return x
    return _ReduceFromGroup.apply(x, _CTX.group)


def gather_from_group(x, dim: int = -1):
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    if size() == 1:
        return x
    return _GatherFromGroup.apply(x, dim % x.ndim, _CTX.group, _CTX.size, _CTX.rank)


def global_min(x: torch.Tensor) -> torch.Tensor:
    """The minimum of a scalar over every rank of the mesh (no gradient)."""
    if _CTX is None or _CTX.mesh_group is None:
        return x
    return _all_reduce(x.detach(), op=dist.ReduceOp.MIN, group=_CTX.mesh_group)


def everywhere(flag: bool) -> bool:
    """Whether ``flag`` holds on every rank of the mesh: a loop that stops
    early stops on every data slice together, as the JAX package's loop
    over the global batch does, and the ranks' collectives stay paired."""
    if _CTX is None or _CTX.mesh_group is None:
        return flag
    nccl = dist.get_backend(_CTX.mesh_group) == "nccl"  # NCCL sums card tensors only
    t = torch.tensor([int(flag)], device="cuda" if nccl else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=_CTX.mesh_group)
    return bool(t.item())


def vocab_parallel_embed(table, ids):
    """Rows ``ids`` of the embedding whose rank-local part is ``table``
    (vocabulary rows rank * V/tp ..): each rank looks up the ids it holds,
    zeros the others, and the ranks' rows are summed."""
    if size() == 1:
        return table[ids]
    v0 = rank() * table.shape[0]
    local_ids = ids - v0
    hit = (local_ids >= 0) & (local_ids < table.shape[0])
    rows = table[torch.where(hit, local_ids, torch.zeros_like(local_ids))]
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return reduce_from_group(rows.float()).to(table.dtype)  # gloo sums no bf16
