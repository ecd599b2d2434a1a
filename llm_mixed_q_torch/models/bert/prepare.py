"""One-off PTQ weight quantization over the BERT parameter dict (counterpart
of the JAX package's ``models/bert/prepare.py``): after
``quantize_bert_params_ptq`` the model serves with ``quantize_weights=False``
and only activations are quantized per call."""

from __future__ import annotations

import torch

from ..opt.prepare import _quantize_node

# (path of the node in a layer) of each quantized linear
BERT_LINEARS = (("attention", "query"), ("attention", "key"), ("attention", "value"),
                ("attention", "output", "dense"), ("intermediate", "dense"),
                ("output", "dense"))


def map_linear_nodes(layer: dict, layer_cfg: dict, fn) -> dict:
    """A new layer with ``fn(node, node_cfg)`` in place of each linear node
    of ``BERT_LINEARS``."""
    new_layer = dict(layer)
    for path in BERT_LINEARS:
        parent, cfg = new_layer, layer_cfg
        for key in path[:-1]:
            parent[key] = dict(parent[key])
            parent, cfg = parent[key], cfg[key]
        parent[path[-1]] = fn(parent[path[-1]], cfg[path[-1]])
    return new_layer


@torch.no_grad()
def quantize_bert_params_ptq(params: dict, config) -> dict:
    """A new parameter dict with linear weights/biases fake-quantized once."""
    if config.quant_config is None:
        return params
    new_params = dict(params)
    new_params["layers"] = [
        map_linear_nodes(layer, config.quant_config[f"model_layer_{i}"], _quantize_node)
        for i, layer in enumerate(params["layers"])
    ]
    return new_params
