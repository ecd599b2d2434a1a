"""BERT per-layer quant-config expansion (counterpart of the JAX package's
``models/bert/quant_config.py``; its statistics formatter waits for the
port's statistics path).

Precedence: ``model_layer_<i>`` > ``model_layer`` > op-type
(``linear``/``matmul``) > ``default``. Per-layer nodes:
attention.{query,key,value}, attention.matmul_0/1, attention.output.dense,
intermediate.dense, output.dense.
"""

from __future__ import annotations

from copy import deepcopy

from ...config.schema import parse_node_config
from ...utils.toml_io import convert_str_na_to_none, load_config


def create_a_layer_config(linear_qc=None, matmul_qc=None, layer_qc=None, strict=True) -> dict:
    if layer_qc is None and matmul_qc is None:
        raise ValueError("Must provide either (linear_qc & matmul_qc) or layer_qc")
    if layer_qc is None:
        layer_qc = {}
    attn = layer_qc.get("attention", {})

    def linear(node):
        return deepcopy(parse_node_config(node, "linear", strict=strict))

    qc = {
        "attention": {name: linear(attn.get(name, linear_qc))
                      for name in ("query", "key", "value")},
        "intermediate": {"dense": linear(layer_qc.get("intermediate", {}).get("dense",
                                                                              linear_qc))},
        "output": {"dense": linear(layer_qc.get("output", {}).get("dense", linear_qc))},
    }
    for mm in ("matmul_0", "matmul_1"):
        qc["attention"][mm] = deepcopy(
            parse_node_config(attn.get(mm, matmul_qc), "matmul", strict=strict))
    qc["attention"]["output"] = {
        "dense": linear(attn.get("output", {}).get("dense", linear_qc))}
    return qc


def _parse_and_complete_config(config: dict, num_hidden_layers: int, strict=True) -> dict:
    if "default" not in config:
        raise ValueError("Must provide a default config")
    default_qc = config["default"]
    linear_qc = parse_node_config(config.get("linear", default_qc), "linear", strict=strict)
    matmul_qc = parse_node_config(config.get("matmul", default_qc), "matmul", strict=strict)
    general_layer_qc = config.get("model_layer", None)
    p_config = {}
    for i in range(num_hidden_layers):
        layer_entry = f"model_layer_{i}"
        layer_qc = config.get(layer_entry, general_layer_qc)
        p_config[layer_entry] = create_a_layer_config(linear_qc, matmul_qc, layer_qc,
                                                      strict=strict)
    p_config["default"] = default_qc
    return p_config


def parse_bert_quantized_config(config: str | dict | None, num_hidden_layers: int,
                                strict: bool = True) -> dict | None:
    if not isinstance(config, (str, dict, type(None))):
        raise TypeError(f"quant config must be a path, a dict or None, not {type(config)}")
    if config is None:
        return None
    if isinstance(config, str):
        config = load_config(config)
    config = convert_str_na_to_none(config)
    return _parse_and_complete_config(config, num_hidden_layers, strict=strict)


def format_stat_profiled_int_config_bert_quantized(
    config: dict,
    num_hidden_layers: int,
    default_config: dict = None,
    is_ptq: bool = True,
    bypass: bool = False,
):
    """Synthesize matmul_0/1 from query/key/value data_out stats
    (reference quant_config_bert.py:133-214)."""
    if default_config is None:
        default_config = {
            "name": "integer",
            "bypass": bypass,
            "is_ptq": is_ptq,
            "data_in_width": 8,
            "data_in_frac_width": 4,
            "weight_width": 8,
            "weight_frac_width": 8,
            "bias_width": 8,
            "bias_frac_width": 8,
        }
    for i in range(num_hidden_layers):
        layer_entry = f"model_layer_{i}"
        if layer_entry not in config:
            raise ValueError(f"Cannot find {layer_entry} in config")
        attn = config[layer_entry]["attention"]
        attn["matmul_0"] = {
            "name": "integer",
            "bypass": bypass,
            "is_ptq": is_ptq,
            "data_in_width": attn["query"]["data_out_width"],
            "data_in_frac_width": attn["query"]["data_out_frac_width"],
            "weight_width": attn["key"]["data_out_width"],
            "weight_frac_width": attn["key"]["data_out_frac_width"],
        }
        try:
            matmul_1_x_width = default_config[layer_entry]["attention"]["matmul_1"][
                "data_in_width"
            ]
        except KeyError:
            matmul_1_x_width = default_config["data_in_width"]
        attn["matmul_1"] = {
            "name": "integer",
            "bypass": bypass,
            "is_ptq": is_ptq,
            "data_in_width": matmul_1_x_width,
            "data_in_frac_width": matmul_1_x_width - 1,
            "weight_width": attn["value"]["data_out_width"],
            "weight_frac_width": attn["value"]["data_out_frac_width"],
        }
        for node in ("query", "key", "value"):
            attn[node].pop("data_out_width")
            attn[node].pop("data_out_frac_width")
    if "default" not in config:
        config["default"] = default_config.get("default", dict(default_config))
    return config
