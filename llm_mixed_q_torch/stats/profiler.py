"""Statistic profiling (counterpart of the JAX package's
``stats/profiler.py``; reference statstic_profiler/stat_profiler.py:9-81).

The ``model_fn`` path, the CLI's, runs the forward under ``torch.no_grad()``
with a tap router that streams every data_in / data_out tensor into the
manager as the forward makes it, so that no forward's taps are held at once
(at 4 x 2048 tokens and 32 layers of Llama-2-7B widths they would be ~50
GB); the weight and bias statistics are read from the parameter tree. Its
result has the keys of the JAX package's ``model_fn`` path in the same
order: the activation entries sorted by node name, then entry name (the
order in which ``jax.jit`` returns a dict), then the weight and bias
entries layer by layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..eval.eval_lm import _first_tensor
from ..ops.linear import capture_quant_node_taps
from .capture import PARAM_PATH_SPECS, TAP_ENTRY_SPECS, StatTapRouter
from .manager import StatManager

DEFAULT_ACT_STATS = ("range_min_max", "variance_online")
DEFAULT_WEIGHT_STATS = ("range_min_max", "variance_precise")


def _collect_weight_stats(manager: StatManager, params: dict, arch: str, prefix: str):
    entry_spec = TAP_ENTRY_SPECS[arch]
    for i, layer in enumerate(params["layers"]):
        for suffix, path in PARAM_PATH_SPECS[arch].items():
            entries = entry_spec[suffix]
            node = layer
            for p in path:
                node = node[p]
            base = f"{prefix}:model_layer_{i}:{suffix}"
            if "weight" in entries:
                manager.update_weight(f"{base}:weight", node["weight"])
            if "bias" in entries and node.get("bias") is not None:
                manager.update_weight(f"{base}:bias", node["bias"])


def _batch_size(batch) -> int:
    if isinstance(batch, dict):
        batch = next(iter(batch.values()))
    return int(batch.shape[0])


def profile_statistics(
    forward_fn=None,
    batches=None,
    arch: str = "llama",
    act_stats=DEFAULT_ACT_STATS,
    weight_stats=DEFAULT_WEIGHT_STATS,
    root_name: str = "root",
    num_samples: int | None = None,
    model_fn=None,
    config=None,
    params=None,
) -> dict:
    """Activation and weight statistics at every profiled quant node, by
    entry name.

    - ``model_fn``, ``config``, ``params``: each batch's input_ids and
      attention_mask go to the parameters' device and through
      ``model_fn(params, input_ids, attention_mask, config=...,
      quantize_weights=False)``; weights and biases come from ``params``.
    - ``forward_fn(batch)``: runs a forward of the caller's own; every
      tapped entry, weights included, is taken from the taps in the order
      they arrive.
    Either way it stops once ``num_samples`` samples have been seen."""
    manager = StatManager(act_stats=act_stats, weight_stats=weight_stats)

    if model_fn is not None:
        if config is None or params is None:
            raise ValueError("the model_fn path needs config and params")
        device = _first_tensor(params).device
        router = StatTapRouter(manager, arch=arch, prefix=root_name, weights=False)
        seen = 0
        with torch.no_grad(), capture_quant_node_taps(router):
            for batch in batches:
                ids, mask = (torch.as_tensor(np.asarray(batch[k]), device=device)
                             for k in ("input_ids", "attention_mask"))
                model_fn(params, ids, mask, config=config, quantize_weights=False)
                seen += _batch_size(batch)
                if num_samples is not None and seen >= num_samples:
                    break
        _collect_weight_stats(manager, params, arch, root_name)
        profile = manager.finalize()
        weights = manager.weight_collect_updated
        acts = sorted((k for k in profile if k not in weights),
                      key=lambda k: k.rpartition(":")[::2])
        return {k: profile[k] for k in acts + [k for k in profile if k in weights]}

    seen = 0
    with capture_quant_node_taps(StatTapRouter(manager, arch=arch, prefix=root_name)):
        for batch in batches:
            forward_fn(batch)
            seen += _batch_size(batch)
            if num_samples is not None and seen >= num_samples:
                break
    return manager.finalize()
