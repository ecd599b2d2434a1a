"""One-off PTQ weight quantization over the Llama parameter dict: after
``quantize_llama_params_ptq`` the model serves with
``quantize_weights=False`` and only activations are quantized per call."""

from __future__ import annotations

import torch

from ...ops.linear import quantize_bias, quantize_weight

_LLAMA_LINEARS = {
    "self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
    "mlp": ("gate_proj", "down_proj", "up_proj"),
}


@torch.no_grad()
def quantize_llama_params_ptq(params: dict, config) -> dict:
    """A new parameter dict with linear weights/biases fake-quantized once."""
    if config.quant_config is None:
        return params
    new_params = dict(params)
    new_layers = []
    for i, layer in enumerate(params["layers"]):
        layer_cfg = config.quant_config[f"model_layer_{i}"]
        new_layer = dict(layer)
        for group, names in _LLAMA_LINEARS.items():
            new_group = dict(layer[group])
            for name in names:
                node_cfg = layer_cfg[group][name]
                node = dict(new_group[name])
                node["weight"] = quantize_weight(node["weight"], node_cfg)
                if node.get("bias") is not None:
                    node["bias"] = quantize_bias(node["bias"], node_cfg)
                new_group[name] = node
            new_layer[group] = new_group
        new_layers.append(new_layer)
    new_params["layers"] = new_layers
    return new_params
