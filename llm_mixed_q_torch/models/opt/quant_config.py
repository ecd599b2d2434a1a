"""OPT per-layer quant-config expansion (counterpart of the JAX package's
``models/opt/quant_config.py``).

Precedence: ``model_layer_<i>`` > ``model_layer`` > op-type
(``linear``/``bmm``) > ``default``. Per-layer nodes:
self_attn.{q,k,v,out}_proj, self_attn.bmm_0/1, fc1, fc2.
"""

from __future__ import annotations

from copy import deepcopy

from ...config.schema import parse_node_config
from ...utils.toml_io import convert_str_na_to_none, load_config


def create_a_layer_config(linear_qc=None, bmm_qc=None, layer_qc=None, strict=True) -> dict:
    if (layer_qc is None and bmm_qc is None) and layer_qc is None:
        raise ValueError("Must provide either (linear_qc & bmm_qc) or layer_qc")
    if layer_qc is None:
        layer_qc = {}
    attn = layer_qc.get("self_attn", {})

    def linear(node):
        return deepcopy(parse_node_config(node, "linear", strict=strict))

    qc = {
        "self_attn": {
            name: linear(attn.get(name, linear_qc))
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")
        },
        "fc1": linear(layer_qc.get("fc1", linear_qc)),
        "fc2": linear(layer_qc.get("fc2", linear_qc)),
    }
    for bmm in ("bmm_0", "bmm_1"):
        qc["self_attn"][bmm] = deepcopy(
            parse_node_config(attn.get(bmm, bmm_qc), "matmul", strict=strict))
    return qc


def _parse_and_complete_config(config: dict, num_hidden_layers: int, strict=True) -> dict:
    if "default" not in config:
        raise ValueError("Must provide default config")
    default_qc = config["default"]
    linear_qc = parse_node_config(config.get("linear", default_qc), "linear", strict=strict)
    bmm_qc = parse_node_config(config.get("bmm", default_qc), "matmul", strict=strict)
    general_layer_qc = config.get("model_layer", None)
    p_config = {}
    for i in range(num_hidden_layers):
        layer_entry = f"model_layer_{i}"
        layer_qc = config.get(layer_entry, general_layer_qc)
        p_config[layer_entry] = create_a_layer_config(linear_qc, bmm_qc, layer_qc,
                                                      strict=strict)
    p_config["default"] = default_qc
    return p_config


def parse_opt_quantized_config(config: str | dict | None, num_hidden_layers: int,
                               strict: bool = True) -> dict | None:
    if not isinstance(config, (str, dict, type(None))):
        raise TypeError(f"quant config must be a path, a dict or None, not {type(config)}")
    if config is None:
        return None
    if isinstance(config, str):
        config = load_config(config)
    config = convert_str_na_to_none(config)
    return _parse_and_complete_config(config, num_hidden_layers, strict=strict)
