"""Quantized linear (counterpart of the JAX package's ``ops/linear.py``).

Weights keep the ``[out_features, in_features]`` layout. Modes:
- bypass: plain ``x @ W^T + b``;
- PTQ (``quantize_weights=False``): weights were fake-quantized once at
  prepare time, only activations are quantized per call;
- QAT / one-shot (``quantize_weights=True``): activations, weights and bias
  are fake-quantized every call;
- packed: ``w`` is a ``PackedBFP`` / ``PackedBFPSub`` / ``PackedBFPSubT``
  and the product goes through ``bfp_matmul`` (the Hopper kernels at
  decode sizes), with the data_in quantizer folded into the kernel when it
  is eligible.

Under tensor parallelism (``parallel/tp.py``) a node runs on its rank's
part: a column-parallel node is ``quantized_linear`` on the local
out-features (its input through ``tp.copy_to_group``, by the model code);
``row_parallel_linear`` takes the local in-features, its partial products
summed over the group before the bias; a row-parallel node that the
sharding rules keep whole (a sub-byte packed one) takes the ranks' inputs
gathered instead, and no sum.

A node given ``node_name`` reports ``(name, x, w, b, out)`` to the collector
set by ``capture_quant_node_taps`` (statistic profiling): the raw x, w and
b, before any quantization, and the output. With no collector set it costs
one ``is None`` test a call.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from ..kernels.dequant_matmul import actq_spec, bfp_matmul
from ..kernels.packing import PACKED_TYPES
from ..parallel import tp
from .functions import make_entry_quantizer

# the active tap collector of statistic profiling (the reference's forward
# hooks, stat_manager.py:84-128); None outside ``capture_quant_node_taps``
_TAP_COLLECTOR = None


@contextmanager
def capture_quant_node_taps(collector):
    """Route every named node's tensors to ``collector.on_linear(name, x, w,
    b, out)`` inside the block; the collector found on entry is restored on
    exit."""
    global _TAP_COLLECTOR
    prev = _TAP_COLLECTOR
    _TAP_COLLECTOR = collector
    try:
        yield collector
    finally:
        _TAP_COLLECTOR = prev


def quantize_weight(w, config: dict):
    """Fake-quantize a weight with the node's weight_* keys."""
    if config.get("bypass", False):
        return w
    return make_entry_quantizer(config, "weight", skip_first_dim=False)(w)


def quantize_bias(b, config: dict):
    """Fake-quantize a bias with the bias_* keys, when the config has them."""
    if b is None or config.get("bypass", False) or "bias_width" not in config:
        return b
    return make_entry_quantizer(config, "bias", skip_first_dim=False)(b)


def quantized_linear(x, w, b, config: dict, quantize_weights: bool,
                     node_name: str | None = None):
    """y = q_a(x) @ q_w(W)^T + q_b(b); ``w`` is [out, in] or a packed tensor.
    ``node_name`` names the node to the stat tap."""
    x_raw, w_raw, b_raw = x, w, b
    if isinstance(w, PACKED_TYPES):
        aq = None
        if not config.get("bypass", False):
            aq = actq_spec(config)
            if aq is None:
                x = make_entry_quantizer(config, "data_in", skip_first_dim=True)(x)
        out = bfp_matmul(x, w, actq=aq)
    else:
        if not config.get("bypass", False):
            x = make_entry_quantizer(config, "data_in", skip_first_dim=True)(x)
            if quantize_weights:
                w = quantize_weight(w, config)
                b = quantize_bias(b, config)
        out = torch.matmul(x, w.t())
    out = out if b is None else out + b
    if _TAP_COLLECTOR is not None and node_name is not None:
        _TAP_COLLECTOR.on_linear(node_name, x_raw, w_raw, b_raw, out)
    return out


def _in_features(w) -> int:
    return w.in_features if isinstance(w, PACKED_TYPES) else w.shape[-1]


def row_parallel_linear(x, node: dict, config: dict, quantize_weights: bool,
                        node_name: str | None = None):
    """A row-parallel node: x holds the rank's in-features; the partial
    products are summed over the group, then the bias is added once. A
    node kept whole on every rank (its K is the full width) takes the
    ranks' x gathered, and no sum."""
    w, b = node["weight"], node.get("bias")
    if tp.size() == 1:
        return quantized_linear(x, w, b, config, quantize_weights, node_name)
    if x.shape[-1] != _in_features(w):
        return quantized_linear(tp.gather_from_group(x), w, b, config, quantize_weights)
    out = tp.reduce_from_group(quantized_linear(x, w, None, config, quantize_weights))
    if b is None:
        return out
    if quantize_weights and not isinstance(w, PACKED_TYPES):
        b = quantize_bias(b, config)
    return out + b
