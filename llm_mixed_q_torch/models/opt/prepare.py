"""One-off PTQ weight quantization over the OPT parameter dict: after
``quantize_opt_params_ptq`` the model serves with ``quantize_weights=False``
and only activations are quantized per call."""

from __future__ import annotations

import torch

from ...ops.linear import quantize_bias, quantize_weight

OPT_ATTN_LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj")
OPT_MLP_LINEARS = ("fc1", "fc2")


def map_linear_nodes(layer: dict, layer_cfg: dict, fn) -> dict:
    """A new layer with ``fn(node, node_cfg)`` in place of each linear node
    (self_attn.{q,k,v,out}_proj, fc1, fc2)."""
    new_layer = dict(layer)
    new_layer["self_attn"] = dict(layer["self_attn"])
    for name in OPT_ATTN_LINEARS:
        new_layer["self_attn"][name] = fn(layer["self_attn"][name],
                                          layer_cfg["self_attn"][name])
    for name in OPT_MLP_LINEARS:
        new_layer[name] = fn(layer[name], layer_cfg[name])
    return new_layer


def _quantize_node(node: dict, node_cfg: dict) -> dict:
    node = dict(node)
    node["weight"] = quantize_weight(node["weight"], node_cfg)
    if node.get("bias") is not None:
        node["bias"] = quantize_bias(node["bias"], node_cfg)
    return node


@torch.no_grad()
def quantize_opt_params_ptq(params: dict, config) -> dict:
    """A new parameter dict with linear weights/biases fake-quantized once."""
    if config.quant_config is None:
        return params
    new_params = dict(params)
    new_params["layers"] = [
        map_linear_nodes(layer, config.quant_config[f"model_layer_{i}"], _quantize_node)
        for i, layer in enumerate(params["layers"])
    ]
    return new_params
