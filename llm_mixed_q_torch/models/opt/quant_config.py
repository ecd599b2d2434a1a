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


def format_stat_profiled_int_config_opt_quantized(
    config: dict,
    num_hidden_layers: int,
    default_config: dict = None,
    is_ptq: bool = True,
    bypass: bool = False,
):
    """Synthesize bmm_0/1 nodes from q/k/v data_out stats.

    Reference quant_config_opt.py:106-186. (The reference's inner
    ``default_config`` swaps bypass/is_ptq at :117-119; we use the evident
    intent — correct assignment — since that branch only fires when no
    default_config is supplied.)
    """
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
        sa["bmm_0"] = {
            "name": "integer",
            "bypass": bypass,
            "is_ptq": is_ptq,
            "data_in_width": sa["q_proj"]["data_out_width"],
            "data_in_frac_width": sa["q_proj"]["data_out_frac_width"],
            "weight_width": sa["k_proj"]["data_out_width"],
            "weight_frac_width": sa["k_proj"]["data_out_frac_width"],
        }
        try:
            bmm_1_x_width = default_config[layer_entry]["self_attn"]["bmm_1"][
                "data_in_width"
            ]
        except KeyError:
            bmm_1_x_width = default_config["data_in_width"]
        sa["bmm_1"] = {
            "name": "integer",
            "bypass": bypass,
            "is_ptq": is_ptq,
            "data_in_width": bmm_1_x_width,
            "data_in_frac_width": bmm_1_x_width - 1,
            "weight_width": sa["v_proj"]["data_out_width"],
            "weight_frac_width": sa["v_proj"]["data_out_frac_width"],
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
