"""Llama per-layer quant-config expansion and precedence (counterpart of
the JAX package's ``models/llama/quant_config.py``).

Precedence: ``model_layer_<i>`` > ``model_layer`` > op-type
(``linear``/``matmul``/``rotary_positional_encoding``) > ``default``.
Per-layer nodes: self_attn.{q,k,v,o}_proj, self_attn.rotary_positional_encoding,
self_attn.matmul_0/1, mlp.{gate,down,up}_proj.

Deviation: ``strict`` propagates into the op-type default parses too (the
reference forgets it at quant_config_llama.py:78-88, which would crash
conditional search's width-only seeds).
"""

from __future__ import annotations

from copy import deepcopy

from ...config.schema import parse_node_config
from ...utils.toml_io import convert_str_na_to_none, load_config

LLAMA_LINEAR_NODES = (
    ("self_attn", "q_proj"),
    ("self_attn", "k_proj"),
    ("self_attn", "v_proj"),
    ("self_attn", "o_proj"),
    ("mlp", "gate_proj"),
    ("mlp", "down_proj"),
    ("mlp", "up_proj"),
)
LLAMA_MATMUL_NODES = (("self_attn", "matmul_0"), ("self_attn", "matmul_1"))


def create_a_layer_config(
    linear_qc=None, matmul_qc=None, rotary_qc=None, layer_qc=None, strict=True
) -> dict:
    if (layer_qc is None and matmul_qc is None) and layer_qc is None:
        raise ValueError("Must provide either (linear_qc & matmul_qc) or layer_qc")
    if layer_qc is None:
        layer_qc = {}
    attn = layer_qc.get("self_attn", {})
    mlp = layer_qc.get("mlp", {})
    qc = {
        "self_attn": {
            name: deepcopy(
                parse_node_config(attn.get(name, linear_qc), "linear", strict=strict)
            )
            for name in ("q_proj", "k_proj", "v_proj", "o_proj")
        },
        "mlp": {
            name: deepcopy(
                parse_node_config(mlp.get(name, linear_qc), "linear", strict=strict)
            )
            for name in ("gate_proj", "down_proj", "up_proj")
        },
    }
    qc["self_attn"]["rotary_positional_encoding"] = deepcopy(
        parse_node_config(
            attn.get("rotary_positional_encoding", rotary_qc),
            "rotary_positional_encoding",
            strict=strict,
        )
    )
    for mm in ("matmul_0", "matmul_1"):
        qc["self_attn"][mm] = deepcopy(
            parse_node_config(attn.get(mm, matmul_qc), "matmul", strict=strict)
        )
    return qc


def _parse_and_complete_config(config: dict, num_hidden_layers: int, strict=True):
    if "default" not in config:
        raise ValueError("Must provide default config")
    default_qc = config["default"]
    linear_qc = parse_node_config(
        config.get("linear", default_qc), "linear", strict=strict
    )
    rotary_qc = parse_node_config(
        config.get("rotary_positional_encoding", default_qc),
        "rotary_positional_encoding",
        strict=strict,
    )
    matmul_qc = parse_node_config(
        config.get("matmul", default_qc), "matmul", strict=strict
    )
    general_layer_qc = config.get("model_layer", None)

    p_config = {}
    for i in range(num_hidden_layers):
        layer_entry = f"model_layer_{i}"
        layer_qc = config.get(layer_entry, general_layer_qc)
        p_config[layer_entry] = create_a_layer_config(
            linear_qc, matmul_qc, rotary_qc, layer_qc, strict=strict
        )
    p_config["default"] = default_qc
    return p_config


def parse_llama_quantized_config(
    config: str | dict | None, num_hidden_layers: int, strict: bool = True
) -> dict | None:
    if not isinstance(config, (str, dict, type(None))):
        raise TypeError(f"quant config must be a path, a dict or None, not {type(config)}")
    if config is None:
        return None
    if isinstance(config, str):
        config = load_config(config)
    config = convert_str_na_to_none(config)
    return _parse_and_complete_config(config, num_hidden_layers, strict=strict)


def format_stat_profiled_int_config_llama_quantized(
    config: dict,
    num_hidden_layers: int,
    default_config: dict = None,
    is_ptq: bool = True,
    bypass: bool = False,
):
    """Post-process a stat-derived integer config: synthesize matmul/rope
    nodes from q/k/v data_out widths (functional matmuls can't be hooked) and
    pop data_out_* keys. Reference quant_config_llama.py:119-206."""
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
        lc = config[layer_entry]
        sa = lc["self_attn"]
        sa["matmul_0"] = {
            "name": "integer",
            "bypass": bypass,
            "is_ptq": is_ptq,
            "data_in_width": sa["q_proj"]["data_out_width"],
            # RoPE output can't be hooked; coarse estimate (reference :147-156)
            "data_in_frac_width": sa["q_proj"]["data_out_frac_width"] - 1,
            "weight_width": sa["k_proj"]["data_out_width"],
            "weight_frac_width": sa["k_proj"]["data_out_frac_width"] - 1,
        }
        try:
            matmul_1_x_width = default_config[layer_entry]["self_attn"]["matmul_1"][
                "data_in_width"
            ]
        except KeyError:
            matmul_1_x_width = default_config["data_in_width"]
        sa["matmul_1"] = {
            "name": "integer",
            "bypass": bypass,
            "is_ptq": is_ptq,
            "data_in_width": matmul_1_x_width,
            "data_in_frac_width": matmul_1_x_width - 1,
            "weight_width": sa["v_proj"]["data_out_width"],
            "weight_frac_width": sa["v_proj"]["data_out_frac_width"],
        }
        try:
            rope_x_width = default_config[layer_entry]["self_attn"][
                "rotary_positional_encoding"
            ]["data_in_width"]
        except KeyError:
            rope_x_width = default_config["data_in_width"]
        sa["rotary_positional_encoding"] = {
            "name": "integer",
            "bypass": bypass,
            "is_ptq": is_ptq,
            "data_in_width": rope_x_width,
            "data_in_frac_width": rope_x_width - 1,
        }
        for node in ("k_proj", "q_proj", "v_proj"):
            sa[node].pop("data_out_width")
            sa[node].pop("data_out_frac_width")
    if "default" not in config:
        config["default"] = default_config.get(
            "default",
            {
                "name": "integer",
                "bypass": bypass,
                "is_ptq": is_ptq,
                "data_in_width": 8,
                "data_in_frac_width": 4,
                "weight_width": 8,
                "weight_frac_width": 8,
                "bias_width": 8,
                "bias_frac_width": 8,
            },
        )
    return config
