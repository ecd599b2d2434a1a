"""Quantization-aware training (counterpart of the JAX package's
``train/qat.py``), on one device or on a (data, model) mesh.

The QAT property comes from the model: ``quantize_weights=True``
fake-quantizes weights and activations in every forward, and the
straight-through estimator (``ops/quantizers/ste.py``) passes gradients
as if the quantizers were the identity. The float leaves of the parameter
tree require grad; ``torch.optim.AdamW`` steps them over two groups, the
JAX package's decay mask and the rest, with ``LambdaLR`` giving optax's
schedule value at each update.

Gradient accumulation follows ``optax.MultiSteps``: ``grad_accum_steps``
micro-batches are averaged into one update, and the schedule advances
once an update while ``train_qat`` sizes it in micro-steps
(``num_epochs * steps_per_epoch``), as the JAX package does. So under
accumulation the schedule ends early: with 4 micro-steps an update, a
cosine has gone a quarter of its way at the last step (ROADMAP.md,
fault 11).

A checkpoint is ``torch.save`` of the parameters, the optimizer's state
(AdamW's, the schedule's, the accumulation's) and the step, in
``<checkpoint_dir>/<step>/state.pt``; the newest 3 are kept and resume
takes the latest.

On a mesh (``parallel.make_mesh``; one process a rank) each rank trains
its training tree (``shard_for_training``) on its slice of the global
batch (``parallel.global_batch``), as the JAX package's step sees the
global batch sharded: TP over "model" through the model code's
collectives (``parallel/tp.py``); DP over "data", the gradients averaged
over the group after the backward (DDP); with ``fsdp`` the leaves the
plan stores over "data" (the 2-D weights) are sharded there by
``torch.distributed.fsdp.fully_shard`` (``FSDPTree``: gathered for each
step, their gradients reduce-scattered), the others stay DDP's, as JAX
replicates them. The loss is the global batch's mean: each rank's mean
weighted by its share of the loss's elements (the examples, or an LM's
labelled tokens), the same on every rank. A checkpoint holds the whole
tree and state, the one-device format, written by rank 0; a resume cuts
them to each rank's part again.
"""

from __future__ import annotations

import inspect
import json
import logging
import math
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models import get_model_fn
from ..parallel import tp
from ..parallel.distributed import _global_batch_slice, batch_spec_hybrid, process_allgather_scalar
from ..parallel.sharding import leaf_spec, local_part, shard_params

logger = logging.getLogger(__name__)


def lr_schedule(learning_rate: float, total_steps: int | None = None, warmup_steps: int = 0,
                schedule: str = "linear"):
    """``step -> learning rate`` of the JAX package's ``make_adamw``: a
    constant without ``total_steps``; for ``cosine`` optax's
    ``warmup_cosine_decay_schedule(0, lr, warmup, total)`` (at the peak
    from step 0 when warmup is 0; the decay spans total - warmup steps);
    else a linear warmup over max(warmup, 1) steps joined at
    ``warmup_steps`` to a linear decay over max(total - warmup, 1) steps.
    Computed in float64 (optax rounds each operation to float32: the two
    differ by ~1e-7 of the peak)."""
    lr = float(learning_rate)
    if total_steps is None:
        return lambda step: lr

    def linear(init, end, steps, count):
        return (init - end) * (1 - min(max(count, 0), steps) / steps) + end

    if schedule == "cosine":
        decay = total_steps - warmup_steps
        if decay <= 0:
            raise ValueError(f"a cosine schedule needs total_steps > warmup_steps, got "
                             f"{total_steps} and {warmup_steps}")

        def before(count):
            return linear(0.0, lr, warmup_steps, count)

        def after(count):
            return lr * 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))
    else:
        def before(count):
            return linear(0.0, lr, max(warmup_steps, 1), count)

        def after(count):
            return linear(lr, 0.0, max(total_steps - warmup_steps, 1), count)

    return lambda step: before(step) if step < warmup_steps else after(step - warmup_steps)


def named_leaves(tree, path=()):
    """(path, tensor) of every tensor of a parameter tree; a path holds
    dict keys and list indices."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named_leaves(v, path + (i,))


def is_decay(path, leaf) -> bool:
    """The JAX package's decay mask: no decay for a leaf named ``bias``,
    for any leaf under a key containing ``norm``, or of rank below 2."""
    if path and path[-1] == "bias":
        return False
    if any("norm" in str(k).lower() for k in path):
        return False
    return leaf.ndim >= 2


def make_adamw(params, learning_rate: float, weight_decay: float = 0.0,
               total_steps: int | None = None, warmup_steps: int = 0, schedule: str = "linear"):
    """-> (AdamW, LambdaLR) over the leaves of ``params`` that require grad:
    optax's adamw (b1 0.9, b2 0.999, eps 1e-8 added to sqrt(v_hat)),
    ``weight_decay`` (given explicitly: torch's default is 0.01) decoupled
    as lr * wd * p on ``is_decay`` leaves only; the learning rate is
    ``lr_schedule``'s at each update (base lr 1, so the group's lr is the
    schedule's value itself)."""
    leaves = [(p, t) for p, t in named_leaves(params) if t.requires_grad]
    groups = [{"params": [t for p, t in leaves if is_decay(p, t)], "weight_decay": weight_decay},
              {"params": [t for p, t in leaves if not is_decay(p, t)], "weight_decay": 0.0}]
    optimizer = torch.optim.AdamW([g for g in groups if g["params"]], lr=1.0,
                                  betas=(0.9, 0.999), eps=1e-8)
    lr_at = lr_schedule(learning_rate, total_steps, warmup_steps, schedule)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lr_at)


def _optax_adamw(params, learning_rate: float, weight_decay: float = 1e-4):
    """``optax.adamw(learning_rate)`` with its defaults, as the repo's root
    scripts train (b1 0.9, b2 0.999, eps 1e-8, ``weight_decay`` decoupled on
    every leaf that requires grad: no mask, no schedule) -> a ``MultiSteps``
    that updates at every micro-step."""
    leaves = [t for _, t in named_leaves(params) if t.requires_grad]
    optimizer = torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    return MultiSteps(optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambda _: 1.0))


class MultiSteps:
    """Gradient accumulation as ``optax.MultiSteps``: ``step()`` after each
    micro-batch's backward; every ``every_k``-th call divides the summed
    gradients by ``every_k`` (their mean), steps the optimizer and its
    schedule once, and clears the gradients. Between updates the
    parameters do not change."""

    def __init__(self, optimizer, scheduler, every_k: int = 1):
        self.optimizer, self.scheduler, self.every_k = optimizer, scheduler, every_k
        self.mini_step = 0

    def _params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self):
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return
        if self.every_k > 1:
            for p in self._params():
                if p.grad is not None:
                    p.grad.div_(self.every_k)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.mini_step = 0

    def state_dict(self) -> dict:
        """AdamW's and the schedule's state, and the accumulation's: the
        micro-steps since the last update and their summed gradients."""
        return {"adamw": self.optimizer.state_dict(), "schedule": self.scheduler.state_dict(),
                "mini_step": self.mini_step,
                "grads": [p.grad if self.mini_step else None for p in self._params()]}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["schedule"])
        self.mini_step = state["mini_step"]
        for p, g in zip(self._params(), state["grads"]):
            p.grad = None if g is None else g.to(p.device).clone()


def _names(path) -> list[str]:
    """A ``named_leaves`` path as the sharding rules name it."""
    return [f"#{k}" if isinstance(k, int) else str(k) for k in path]


class MeshLayout:
    """How a training tree lies on a mesh: each leaf's spec
    (``parallel.sharding.leaf_spec``), and the whole of a leaf or state
    tensor from the ranks' parts (``full``) or a rank's part of a whole one
    shaped as ``like`` (``part``). A ZeRO-3 leaf is a DTensor of
    ``fully_shard``, its "data" parts FSDP's."""

    def __init__(self, mesh, fsdp: bool):
        self.mesh, self.fsdp = mesh, fsdp

    def spec(self, path, leaf) -> tuple:
        return leaf_spec(_names(path), leaf, self.fsdp)

    def full(self, t, spec):
        if isinstance(t, DTensor):  # FSDP's parts over "data", gathered by plain
            # c10d (DTensor's functional collectives crash under gloo on CUDA
            # tensors with torch 2.11)
            (shard,) = t.placements
            t = tp.all_gather_along(t.to_local(), shard.dim, self.mesh.group("data"),
                                    self.mesh.shape["data"])
            spec = tuple(None if a == "data" else a for a in spec)
        for dim, axis in enumerate(spec):
            if axis is not None and self.mesh.shape[axis] > 1:
                t = tp.all_gather_along(t, dim, self.mesh.group(axis), self.mesh.shape[axis])
        return t

    def part(self, t, spec, like):
        t = local_part(t, spec, self.mesh.coords, self.mesh.shape)
        if isinstance(like, DTensor):
            return DTensor.from_local(t.to(like.device), like.device_mesh, like.placements)
        return t

    def zero3(self, spec) -> int | None:
        """The dim stored in parts over "data" (ZeRO-3), or None."""
        if "data" in spec and self.mesh.shape["data"] > 1:
            return spec.index("data")
        return None


class _ZeroLeaves(torch.nn.Module):
    """The ZeRO-3 leaves of a training tree as the parameters of one module,
    for ``fully_shard``: ``forward(fn)`` calls fn with them whole."""

    def __init__(self, leaves):
        super().__init__()
        self.n = len(leaves)
        for i, t in enumerate(leaves):
            self.register_parameter(f"p{i}", torch.nn.Parameter(t))

    def forward(self, fn):
        return fn([getattr(self, f"p{i}") for i in range(self.n)])


class FSDPTree:
    """A training tree under ``fsdp`` on a mesh of several data ranks:
    ``params``, the tree whose leaves that the plan stores over "data" are
    the parameters (DTensors) of one module sharded by
    ``torch.distributed.fsdp.fully_shard`` over the mesh's "data" dim, each
    on its own dim (``shard_placement_fn``); ``self(fn)`` calls fn with the
    tree whole (FSDP gathers those leaves for the call and reduce-scatters
    their gradients, averaged over "data", after the backward)."""

    def __init__(self, params, layout: MeshLayout):
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        leaves = dict(named_leaves(params))
        dims = {p: layout.zero3(layout.spec(p, t)) for p, t in leaves.items()}
        self.paths = [p for p, d in dims.items() if d is not None]
        n = layout.mesh.shape["data"]
        for p in self.paths:  # even parts: the plan's, and the gather's in ``MeshLayout.full``
            if leaves[p].shape[dims[p]] % n:
                raise ValueError(f"{':'.join(_names(p))}: {leaves[p].shape[dims[p]]} along dim "
                                 f"{dims[p]} does not split in {n} data parts")
        self.module = _ZeroLeaves([leaves[p].detach() for p in self.paths])
        placement = {id(param): Shard(dims[p])
                     for p, param in zip(self.paths, self.module.parameters())}
        fully_shard(self.module, mesh=layout.mesh.device_mesh["data"],
                    shard_placement_fn=lambda param: placement[id(param)])
        sharded = {p: getattr(self.module, f"p{i}") for i, p in enumerate(self.paths)}
        self.params = _map_leaves(lambda p, t: sharded.get(p, t), params)

    def __call__(self, fn):
        def whole_tree(whole):
            by_path = dict(zip(self.paths, whole))
            return fn(_map_leaves(lambda p, t: by_path.get(p, t), self.params))

        return self.module(whole_tree)


def shard_for_training(params, mesh, fsdp: bool = False, config=None):
    """The trainable tree a rank trains on ``mesh`` (the whole tree on none,
    or on one rank): its local part over "model" (``shard_params``), and
    under ``fsdp`` an ``FSDPTree`` over "data". -> tree or FSDPTree"""
    if mesh is None or mesh.size == 1:
        return _trainable(params)
    params = _trainable(shard_params(params, mesh, False, config))
    layout = MeshLayout(mesh, fsdp)
    if any(layout.zero3(layout.spec(p, t)) is not None for p, t in named_leaves(params)):
        return FSDPTree(params, layout)
    return params


def leaves_of(tree):
    """The tensor tree of a training tree (``FSDPTree.params``, or itself)."""
    return tree.params if isinstance(tree, FSDPTree) else tree


def _map_leaves(fn, tree, path=()):
    """The tree with ``fn(path, tensor)`` in place of each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return tree


def _loss_weight(task: str, batch) -> torch.Tensor:
    """The elements a micro-batch's mean loss averages: an LM's labelled
    tokens after the shift, else its examples."""
    labels = batch["labels"]
    if task == "lm":
        return (labels[:, 1:] != -100).sum().double()
    return torch.tensor(float(labels.shape[0]), dtype=torch.float64, device=labels.device)


def make_qat_train_step(arch, task, config, optimizer, mesh=None, fsdp=False):
    """-> ``train_step(params, batch) -> loss``: one micro-step, the
    forward with weights fake-quantized, the backward through the STE,
    then ``optimizer.step()`` (a ``MultiSteps``), which updates ``params``
    in place. ``batch`` = dict(input_ids, attention_mask, labels) of
    tensors on the parameters' device; the loss comes back detached, on
    the device. On a ``mesh`` of several ranks, ``params`` is the rank's
    training tree (``shard_for_training(..., fsdp=fsdp)``), ``batch`` its
    slice of the global batch, and the loss the global batch's, the same
    on every rank."""
    model_fn = get_model_fn(arch, task)

    def forward(params, batch):
        return model_fn(params, batch["input_ids"], batch["attention_mask"],
                        labels=batch["labels"], config=config, quantize_weights=True)["loss"]

    if mesh is None or mesh.size == 1:
        def train_step(params, batch):
            loss = forward(params, batch)
            loss.backward()
            optimizer.step()
            return loss.detach()

        return train_step

    (axes,) = batch_spec_hybrid()
    data = mesh.group(axes)  # the ranks of this rank's "model" index
    n_data = math.prod(mesh.shape.get(a, 1) for a in axes)
    dcn, n_dcn = mesh.group("dcn"), mesh.shape.get("dcn", 1)

    def train_step(params, batch):
        leaves = [t for _, t in named_leaves(leaves_of(params)) if t.requires_grad]
        held = [t.grad for t in leaves]  # the accumulated micro-steps'
        for t in leaves:
            t.grad = None
        weight = _loss_weight(task, batch)
        total = weight.clone()
        if data is not None:
            dist.all_reduce(total, group=data)
        # the rank's share of the global mean, times the batch's parts: every
        # gradient is averaged over them (DDP's sum divided below; FSDP's
        # reduce-scatter over "data", then a sum over "dcn" divided below)
        scale = (weight / total * n_data).float()
        with tp.spmd(mesh):
            if isinstance(params, FSDPTree):
                loss = params(lambda tree: forward(tree, batch)) * scale
            else:
                loss = forward(params, batch) * scale
        loss.backward()
        for t, g in zip(leaves, held):
            if t.grad is not None and isinstance(t, DTensor):
                if dcn is not None:
                    with torch.no_grad():
                        part = t.grad.to_local()
                        dist.all_reduce(part, group=dcn)
                        part.div_(n_dcn)
            elif data is not None and t.grad is not None:
                dist.all_reduce(t.grad, group=data)  # DDP
                t.grad.div_(n_data)
            if g is not None:
                t.grad = g if t.grad is None else g + t.grad
        optimizer.step()
        loss = loss.detach()
        if data is not None:
            dist.all_reduce(loss, group=data)
        return loss / n_data

    return train_step


class MetricsWriter:
    """Per-step losses as JSON lines (the JAX package's ``metrics.jsonl``
    layout: ``{"step", "loss"}`` lines, then an epoch's metrics with a
    ``time``). Losses stay on the device until ``flush``, which reads them
    back at once, so logging a step costs no sync."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._steps: list[int] = []
        self._losses: list[torch.Tensor] = []

    def log(self, step: int, loss):
        self._steps.append(step)
        self._losses.append(loss)

    def flush(self, extra: dict | None = None):
        with self.path.open("a") as f:
            if self._steps:
                losses = torch.stack(self._losses).cpu().tolist()
                for s, l in zip(self._steps, losses):
                    f.write(json.dumps({"step": int(s), "loss": float(l)}) + "\n")
            if extra is not None:
                f.write(json.dumps({**extra, "time": time.time()}) + "\n")
        self._steps, self._losses = [], []


def _trainable(params):
    """A copy of the tree whose float leaves require grad (the caller's
    tree is left as it was)."""
    if isinstance(params, torch.Tensor):
        t = params.detach().clone()
        return t.requires_grad_() if t.is_floating_point() else t
    if isinstance(params, dict):
        return {k: _trainable(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_trainable(v) for v in params]
    return params


def _to_device(batch, device):
    """A numpy batch as tensors on ``device``, floating labels as float32
    (the JAX package's arrays are 32-bit)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v), device=device)
        out[k] = t.float() if t.is_floating_point() else t
    return out


def train_qat(
    arch: str,
    task: str,
    config,
    params,
    train_batches_factory,
    eval_fn=None,
    num_epochs: int = 1,
    learning_rate: float = 2e-5,
    weight_decay: float = 0.0,
    grad_accum_steps: int = 1,
    schedule: str = "cosine",
    warmup_steps: int = 0,
    checkpoint_dir: str | None = None,
    save_every_steps: int | None = None,
    resume: bool = False,
    mesh=None,
    fsdp: bool = False,
    steps_per_epoch: int | None = None,
    log_every: int = 50,
    metrics_path: str | None = None,
):
    """The QAT fine-tune loop with checkpoint and resume, on the device of
    ``params`` (a copy of which is trained; the caller's tree is left as
    it was).

    ``train_batches_factory()`` yields dict batches (numpy arrays) for an
    epoch. A factory with a ``start`` keyword (batches to skip in the
    epoch) lets a mid-epoch resume seek; another is replayed and the
    skipped batches discarded. ``steps_per_epoch`` sizes the schedule
    (``num_epochs * steps_per_epoch`` micro-steps) and places a resume
    in its epoch. ``metrics_path`` defaults to
    ``<checkpoint_dir>/metrics.jsonl`` when checkpointing is on.
    ``eval_fn(params) -> dict`` runs after each epoch.
    On a ``mesh`` of several ranks (every rank calls this with the same
    whole ``params`` and the same global batches) each rank trains its
    local tree on its slice of each batch; ``eval_fn`` and the result get
    the whole tree on every rank, and rank 0 alone writes the checkpoints
    and the metrics.
    Returns (params, history): history holds each epoch's last loss and
    its eval metrics."""
    total_steps = num_epochs * steps_per_epoch if steps_per_epoch is not None else None
    layout = MeshLayout(mesh, fsdp) if mesh is not None and mesh.size > 1 else None
    tree = shard_for_training(params, mesh, fsdp, config)
    params = leaves_of(tree)
    device = next(t for _, t in named_leaves(params)).device
    optimizer = MultiSteps(*make_adamw(params, learning_rate, weight_decay, total_steps,
                                       warmup_steps, schedule), every_k=grad_accum_steps)
    step_fn = make_qat_train_step(arch, task, config, optimizer, mesh, fsdp)
    writer = layout is None or dist.get_rank() == 0
    whole = (lambda p: p) if layout is None else (lambda p: whole_params(layout, p))

    start_step = 0
    mngr = None
    if checkpoint_dir is not None:
        mngr = _checkpoint_manager(checkpoint_dir)
        if resume:
            restored = restore_checkpoint(mngr, params, optimizer, layout)
            if restored is not None:
                params, optimizer, start_step = restored
                logger.info(f"Resumed from step {start_step}")
        if metrics_path is None:
            metrics_path = str(Path(checkpoint_dir) / "metrics.jsonl")
    metrics = MetricsWriter(metrics_path) if metrics_path and writer else None

    factory_seekable = "start" in inspect.signature(train_batches_factory).parameters
    start_epoch, skip_in_epoch = 0, 0
    if start_step:
        if steps_per_epoch:
            start_epoch, skip_in_epoch = divmod(start_step, steps_per_epoch)
        else:
            skip_in_epoch = start_step
            if not factory_seekable:
                logger.warning(
                    "resume without steps_per_epoch and a non-seekable batch factory: "
                    "replaying %d batches (pass a factory accepting `start=` to seek)",
                    start_step)

    history = []
    global_step = start_step
    for epoch in range(start_epoch, num_epochs):
        skip = skip_in_epoch if epoch == start_epoch else 0
        if factory_seekable:
            batches = train_batches_factory(start=skip)
            skip = 0
        else:
            batches = train_batches_factory()
        loss = None
        for batch in batches:
            if skip > 0:
                skip -= 1
                continue
            if layout is not None:
                batch = _global_batch_slice(mesh, batch)
            loss = step_fn(tree, _to_device(batch, device))
            global_step += 1
            if metrics is not None:
                metrics.log(global_step, loss)
            if global_step % log_every == 0:
                logger.info(f"step {global_step} loss {float(loss):.4f}")
            if mngr is not None and save_every_steps and global_step % save_every_steps == 0:
                save_checkpoint(mngr, params, optimizer, global_step, layout)
        if loss is None:
            # an empty epoch (a resume on the epoch boundary, or a source that
            # yielded nothing)
            logger.warning(f"epoch {epoch}: no batches")
            epoch_metrics = {"epoch": epoch, "loss": None}
        else:
            epoch_metrics = {"epoch": epoch, "loss": _allgather_mean_scalar(float(loss))}
        if eval_fn is not None:
            epoch_metrics.update(eval_fn(whole(params)))
            logger.info(f"epoch {epoch}: {epoch_metrics}")
        history.append(epoch_metrics)
        if metrics is not None:
            metrics.flush(extra=epoch_metrics)
    if mngr is not None and mngr.latest_step() != global_step:
        save_checkpoint(mngr, params, optimizer, global_step, layout)
    if metrics is not None:
        metrics.flush()
    return whole(params), history


def _allgather_mean_scalar(x: float) -> float:
    """The mean of a host scalar over the ranks (the JAX package's
    ``_allgather_mean_scalar``; each rank's epoch loss is the global
    batch's already, so the mean is that loss)."""
    return float(np.mean(process_allgather_scalar(x)))


def whole_params(layout: MeshLayout, params):
    """The whole tree (detached) from the ranks' local trees; every rank
    calls it."""
    return _map_leaves(lambda p, t: layout.full(t.detach(), layout.spec(p, t)), params)


def _map_state(state: dict, params, fn):
    """``MultiSteps.state_dict()`` with ``fn(tensor, param path, param)`` in
    place of each tensor that has its parameter's shape (AdamW's moments,
    the accumulated gradients)."""
    leaves = [(p, t) for p, t in named_leaves(params) if t.requires_grad]
    # make_adamw's order: the decayed leaves, then the others
    order = ([x for x in leaves if is_decay(*x)] + [x for x in leaves if not is_decay(*x)])
    adamw = dict(state["adamw"])
    groups = [i for g in adamw["param_groups"] for i in g["params"]]
    new = {}
    for key, st in adamw["state"].items():
        path, t = order[groups.index(key)]
        new[key] = {k: fn(v, path, t) if k != "step" else v for k, v in st.items()}
    adamw["state"] = new
    grads = [None if g is None else fn(g, p, t) for g, (p, t) in zip(state["grads"], order)]
    return {**state, "adamw": adamw, "grads": grads}


# ------------------------------------------------------------- checkpointing


class CheckpointManager:
    """Checkpoints as ``<directory>/<step>/state.pt``; the newest
    ``max_to_keep`` stay. A checkpoint is written to a temporary file and
    renamed into place, so a cut save leaves no step behind."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(d.name) for d in self.directory.iterdir()
                      if d.name.isdigit() and (d / "state.pt").is_file())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict):
        d = self.directory / str(step)
        d.mkdir(exist_ok=True)
        torch.save(state, d / "state.pt.tmp")
        os.replace(d / "state.pt.tmp", d / "state.pt")
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def restore(self, step: int, device) -> dict:
        return torch.load(self.directory / str(step) / "state.pt", map_location=device,
                          weights_only=True)


def _checkpoint_manager(checkpoint_dir: str) -> CheckpointManager:
    return CheckpointManager(checkpoint_dir, max_to_keep=3)


@torch.no_grad()
def save_checkpoint(mngr, params, opt_state, step: int, layout: MeshLayout | None = None):
    """``opt_state``: the ``MultiSteps`` that trains ``params``. On a mesh
    (``layout``) every rank calls it: the whole tree and state are
    gathered, and rank 0 writes them in the one-device format."""
    state = opt_state.state_dict()
    if layout is not None:
        full = lambda v, p, t: layout.full(v, layout.spec(p, t))
        state = _map_state(state, params, full)
        params = whole_params(layout, params)
    if layout is None or dist.get_rank() == 0:
        detached = {".".join(map(str, p)): t.detach() for p, t in named_leaves(params)}
        mngr.save(step, {"params": detached, "opt_state": state, "step": step})
    if layout is not None:
        dist.barrier()


@torch.no_grad()
def restore_checkpoint(mngr, params_like, opt_state_like, layout: MeshLayout | None = None):
    """The latest checkpoint copied into ``params_like`` and
    ``opt_state_like`` in place -> (params, opt_state, step), or None
    when there is none. On a mesh (``layout``) the one-device checkpoint is
    cut to each rank's part."""
    step = mngr.latest_step()
    if step is None:
        return None
    leaves = list(named_leaves(params_like))
    state = mngr.restore(step, leaves[0][1].device)
    saved = state["params"]
    names = [".".join(map(str, p)) for p, _ in leaves]
    if set(names) != set(saved):
        raise ValueError(f"checkpoint {step} holds another tree: "
                         f"{sorted(set(names) ^ set(saved))[:4]}")
    part = (lambda v, p, t: v) if layout is None else (
        lambda v, p, t: layout.part(v, layout.spec(p, t), t))
    for name, (p, t) in zip(names, leaves):
        value = part(saved[name], p, t)
        if isinstance(t, DTensor):  # FSDP's part over "data"
            t.to_local().copy_(value.to_local())
        else:
            t.copy_(value)
    opt_state_like.load_state_dict(_map_state(state["opt_state"], params_like, part))
    return params_like, opt_state_like, step
