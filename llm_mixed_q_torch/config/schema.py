"""Per-arithmetic quant-config schemas and node-config parsing.

Reference: src/llm_mixed_q/models/quantize/quant_config_parser.py:32-304.
Defines which keys exist per arithmetic for weight/data_in/bias/data_out
entries, which entries each op type requires, and validates/filters one op's
config dict. ``strict=False`` tolerates missing keys (used by conditional
search). ``bypass=True`` short-circuits.
"""

from __future__ import annotations

from copy import deepcopy


def _entries(arith_keys: dict[str, tuple[str, ...]]) -> dict[str, tuple[str, ...]]:
    return {
        f"{prefix}_entries": tuple(f"{prefix}_{k}" for k in keys)
        for prefix, keys in arith_keys.items()
    }


QUANT_ARITH_ENTRIES = {
    "integer": _entries(
        {p: ("width", "frac_width") for p in ("weight", "data_in", "bias", "data_out")}
    ),
    "minifloat_ieee": _entries(
        {
            p: ("width", "exponent_width", "exponent_bias")
            for p in ("weight", "data_in", "bias", "data_out")
        }
    ),
    "minifloat_denorm": _entries(
        {
            p: ("width", "exponent_width", "exponent_bias")
            for p in ("weight", "data_in", "bias", "data_out")
        }
    ),
    "log": _entries(
        {
            p: ("width", "exponent_bias")
            for p in ("weight", "data_in", "bias", "data_out")
        }
    ),
    "block_fp": _entries(
        {
            p: ("width", "exponent_width", "exponent_bias", "block_size")
            for p in ("weight", "data_in", "bias", "data_out")
        }
    ),
    "block_minifloat": _entries(
        {
            p: ("width", "exponent_width", "exponent_bias_width", "block_size")
            for p in ("weight", "data_in", "bias", "data_out")
        }
    ),
    "block_log": _entries(
        {
            p: ("width", "exponent_bias_width", "block_size")
            for p in ("weight", "data_in", "bias", "data_out")
        }
    ),
}

# op name -> (required entries, optional entries)
# (reference quant_config_parser.py:236-267)
OP_TO_ENTRIES = {
    "add": (("name", "data_in_entries"), ("bypass",)),
    "bmm": (("name", "data_in_entries", "weight_entries"), ("bypass",)),
    "conv1d": (
        ("name", "is_ptq", "data_in_entries", "weight_entries"),
        ("bias_entries", "bypass"),
    ),
    "conv2d": (
        ("name", "is_ptq", "data_in_entries", "weight_entries"),
        ("bias_entries", "bypass"),
    ),
    "matmul": (("name", "data_in_entries", "weight_entries"), ("bypass",)),
    "mul": (("name", "data_in_entries"), ("bypass",)),
    "linear": (
        ("name", "is_ptq", "data_in_entries", "weight_entries"),
        ("bias_entries", "data_out_entries", "bypass"),
    ),
    "relu": (("name", "data_in_entries"), ("bypass",)),
    "rotary_positional_encoding": (("name", "data_in_entries"), ("bypass",)),
    "sub": (("name", "data_in_entries"), ("bypass",)),
}


def _cp(src: dict, dst: dict, keys: tuple, strict: bool):
    for key in keys:
        if not strict and key not in src:
            continue
        dst[key] = deepcopy(src[key])


def _optional_entry_exists(config: dict, entry_name: str) -> bool:
    prefix = entry_name.removesuffix("_entries")
    return any(k.startswith(prefix) for k in config)


def parse_node_config(config: dict, op: str, strict: bool = True) -> dict:
    """Validate/filter one op's config against its schema.

    Reference quant_config_parser.py:278-304: required entries are copied
    (missing keys tolerated when ``strict`` is False), optional entries only
    when the config has keys of that entry.
    """
    if op not in OP_TO_ENTRIES:
        raise ValueError(f"Unknown op: {op}")
    if config.get("bypass", False):
        return config
    arith = config["name"]
    entries = QUANT_ARITH_ENTRIES[arith]
    required, optional = OP_TO_ENTRIES[op]
    p_config: dict = {}
    for entry in required:
        if entry == "name":
            _cp(config, p_config, ("name",), strict)
        elif entry == "is_ptq":
            _cp(config, p_config, ("is_ptq",), strict)
        else:
            _cp(config, p_config, entries[entry], strict)
    for entry in optional:
        if not _optional_entry_exists(config, entry):
            continue
        if entry == "bypass":
            _cp(config, p_config, ("bypass",), strict)
        else:
            _cp(config, p_config, entries[entry], strict)
    return p_config


def cp_weight_entries_to_bias(config: dict, p_config: dict, arith: str, strict=True):
    """Copy a node's weight entries to its bias keys where the bias keys are
    missing (reference quant_config_parser.py:184-200)."""
    entries = QUANT_ARITH_ENTRIES[arith]
    if all(k in config for k in entries["bias_entries"]):
        _cp(config, p_config, entries["bias_entries"], strict)
    else:
        for wk, bk in zip(entries["weight_entries"], entries["bias_entries"]):
            if not strict and wk not in config:
                continue
            p_config[bk] = deepcopy(config[wk])
