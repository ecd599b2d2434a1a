"""Tap routing: quant-node taps -> StatManager entries (counterpart of the
JAX package's ``stats/capture.py``).

The entry specs by arch follow the reference's hook registrations:
- llama: profiler_llama.py:155-180 (q/k/v with data_out; o/gate/down/up
  data_in and weight only; no bias);
- opt: profiler_opt.py:116-180 (bias entries too);
- bert: profiler_bert.py:184-236 (bias entries too).
Entry names: ``<prefix>:model_layer_<i>:...:<entry>``.

Statistics are profiled on the float tree, as the CLI builds it. A packed
weight reaching the router raises ``TypeError`` naming its node.
"""

from __future__ import annotations

import torch

from .manager import StatManager

TAP_ENTRY_SPECS = {
    "llama": {
        "self_attn:q_proj": ("data_in", "weight", "data_out"),
        "self_attn:k_proj": ("data_in", "weight", "data_out"),
        "self_attn:v_proj": ("data_in", "weight", "data_out"),
        "self_attn:o_proj": ("data_in", "weight"),
        "mlp:gate_proj": ("data_in", "weight"),
        "mlp:down_proj": ("data_in", "weight"),
        "mlp:up_proj": ("data_in", "weight"),
    },
    "opt": {
        "self_attn:q_proj": ("data_in", "weight", "bias", "data_out"),
        "self_attn:k_proj": ("data_in", "weight", "bias", "data_out"),
        "self_attn:v_proj": ("data_in", "weight", "bias", "data_out"),
        "self_attn:out_proj": ("data_in", "weight", "bias"),
        "fc1": ("data_in", "weight", "bias"),
        "fc2": ("data_in", "weight", "bias"),
    },
    "bert": {
        "attention:query": ("data_in", "weight", "bias", "data_out"),
        "attention:key": ("data_in", "weight", "bias", "data_out"),
        "attention:value": ("data_in", "weight", "bias", "data_out"),
        "attention:output:dense": ("data_in", "weight", "bias"),
        "intermediate:dense": ("data_in", "weight", "bias"),
        "output:dense": ("data_in", "weight", "bias"),
    },
}

# node-name suffix -> path in a layer of the parameter tree, by arch (the
# weight and bias statistics are read from the tree, not from a forward)
PARAM_PATH_SPECS = {
    "llama": {
        "self_attn:q_proj": ("self_attn", "q_proj"),
        "self_attn:k_proj": ("self_attn", "k_proj"),
        "self_attn:v_proj": ("self_attn", "v_proj"),
        "self_attn:o_proj": ("self_attn", "o_proj"),
        "mlp:gate_proj": ("mlp", "gate_proj"),
        "mlp:down_proj": ("mlp", "down_proj"),
        "mlp:up_proj": ("mlp", "up_proj"),
    },
    "opt": {
        "self_attn:q_proj": ("self_attn", "q_proj"),
        "self_attn:k_proj": ("self_attn", "k_proj"),
        "self_attn:v_proj": ("self_attn", "v_proj"),
        "self_attn:out_proj": ("self_attn", "out_proj"),
        "fc1": ("fc1",),
        "fc2": ("fc2",),
    },
    "bert": {
        "attention:query": ("attention", "query"),
        "attention:key": ("attention", "key"),
        "attention:value": ("attention", "value"),
        "attention:output:dense": ("attention", "output", "dense"),
        "intermediate:dense": ("intermediate", "dense"),
        "output:dense": ("output", "dense"),
    },
}


def _entries(spec: dict, node_name: str, w):
    """The entries of a tapped node (None for a node the spec does not
    profile); raises on a packed weight."""
    # node_name = "model_layer_<i>:<suffix>"
    entries = spec.get(node_name.partition(":")[2])
    if entries is not None and not isinstance(w, torch.Tensor):
        raise TypeError(f"{node_name}: statistics are profiled on the float tree; this "
                        f"node's weight is a packed {type(w).__name__}")
    return entries


class StatTapRouter:
    """Routes ``on_linear`` taps into a StatManager by entry spec, each
    tensor as it arrives. ``weights=False`` routes the data_in and data_out
    entries only (the weights are then read from the parameter tree)."""

    def __init__(self, stat_manager: StatManager | None, arch: str, prefix: str = "root",
                 weights: bool = True):
        self.manager = stat_manager
        self.spec = TAP_ENTRY_SPECS[arch]
        self.prefix = prefix
        self.weights = weights

    def on_linear(self, node_name: str, x, w, b, out):
        entries = _entries(self.spec, node_name, w)
        if entries is None:
            return
        tensors = {"data_in": x, "data_out": out}
        if self.weights:
            tensors.update(weight=w, bias=b)
        for entry in entries:  # data_in, weight, bias, data_out
            if tensors.get(entry) is not None:
                self.take(node_name, entry, tensors[entry])

    def take(self, node_name: str, entry: str, tensor):
        """One entry's tensor, into the manager."""
        name = f"{self.prefix}:{node_name}:{entry}"
        if entry.startswith("data_"):
            self.manager.update_act(name, tensor)
        else:
            self.manager.update_weight(name, tensor)


class _TapKeeper(StatTapRouter):
    """The router's selection of data_in / data_out entries, kept as
    ``taps[node_name][entry]``."""

    def __init__(self, arch: str):
        super().__init__(None, arch, weights=False)
        self.taps: dict[str, dict] = {}

    def take(self, node_name: str, entry: str, tensor):
        self.taps.setdefault(node_name, {})[entry] = tensor


def make_tapped_forward(model_fn, config, arch: str, quantize_weights: bool = False):
    """``fwd(params, input_ids, attention_mask) -> {node: {entry: tensor}}``,
    the data_in / data_out tensors of every profiled node of one forward,
    under ``torch.no_grad()``."""
    from ..ops.linear import capture_quant_node_taps

    @torch.no_grad()
    def fwd(params, input_ids, attention_mask):
        keeper = _TapKeeper(arch)
        with capture_quant_node_taps(keeper):
            model_fn(params, input_ids, attention_mask, config=config,
                     quantize_weights=quantize_weights)
        return keeper.taps

    return fwd
